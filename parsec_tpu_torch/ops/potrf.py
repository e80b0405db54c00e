"""Tiled Cholesky (POTRF) bodies and DAG builder.

The second headline benchmark: right-looking tiled Cholesky — the canonical
PaRSEC/DPLASMA example (dplasma's dpotrf; the reference exercises the same
DAG shape in its DTD tests):

    for k in range(T):
        A[k,k] = POTRF(A[k,k])
        for m > k:    A[m,k] = TRSM(A[k,k], A[m,k])
        for m > k:    A[m,m] = SYRK(A[m,k], A[m,m])
        for m > n > k: A[m,n] = GEMM(A[m,k], A[n,k], A[m,n])

The bodies are torch library calls (cholesky, triangular solve, matmul), as
the reference leaves them to its compiler's library; float32 dots run at full
float32 precision (TF32 off, :func:`~parsec_tpu_torch.ops.cuda_kernels.
dot_precision`). The DAG (RAW on panels, WAW on trailing updates) is
discovered by the DTD tile chains.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.matrix import TiledMatrix
from ..dsl.dtd import AFFINITY, DTDTaskpool, READ, RW
from .cuda_kernels import dot_precision


def tile_potrf(a):
    """Cholesky of the diagonal tile (lower), from its symmetrized value.
    ``cholesky_ex`` reports a non-SPD tile in its info output instead of
    synchronizing with the card to raise."""
    dot_precision()
    return torch.linalg.cholesky_ex((a + a.mT) * 0.5).L


def tile_trsm(akk, amk):
    """A[m,k] <- A[m,k] · L(k,k)^{-T}  (right, lower, transposed)."""
    dot_precision()
    # X L^T = A  with L^T upper triangular
    return torch.linalg.solve_triangular(akk.mT, amk, upper=True, left=False)


def tile_syrk(amk, amm):
    """A[m,m] <- A[m,m] - A[m,k] · A[m,k]^T."""
    dot_precision()
    return amm - torch.matmul(amk, amk.mT).to(amm.dtype)


def tile_gemm_update(amk, ank, amn):
    """A[m,n] <- A[m,n] - A[m,k] · A[n,k]^T."""
    dot_precision()
    return amn - torch.matmul(amk, ank.mT).to(amn.dtype)


def insert_potrf_tasks(tp: DTDTaskpool, A: TiledMatrix) -> int:
    """Insert the right-looking tiled Cholesky DAG (lower). Returns task count.

    Priorities follow the critical path (panel first), the standard trick the
    reference relies on priority-aware schedulers for.
    """
    T = A.mt
    if A.mt != A.nt:
        raise ValueError("POTRF needs a square tile grid")
    n0 = tp.inserted
    for k in range(T):
        prio = (T - k) * 10000
        tp.insert_task(tile_potrf, (tp.tile_of(A, k, k), RW | AFFINITY),
                       priority=prio + 3000, name="POTRF")
        for m in range(k + 1, T):
            tp.insert_task(tile_trsm,
                           (tp.tile_of(A, k, k), READ),
                           (tp.tile_of(A, m, k), RW | AFFINITY),
                           priority=prio + 2000, name="TRSM")
        for m in range(k + 1, T):
            tp.insert_task(tile_syrk,
                           (tp.tile_of(A, m, k), READ),
                           (tp.tile_of(A, m, m), RW | AFFINITY),
                           priority=prio + 1000, name="SYRK")
            for n in range(k + 1, m):
                tp.insert_task(tile_gemm_update,
                               (tp.tile_of(A, m, k), READ),
                               (tp.tile_of(A, n, k), READ),
                               (tp.tile_of(A, m, n), RW | AFFINITY),
                               priority=prio, name="GEMM")
    return tp.inserted - n0


def potrf_flops(N: int) -> float:
    """N^3/3 (+ lower order), the standard dpotrf count."""
    return N ** 3 / 3.0 + N ** 2 / 2.0


def make_spd(n: int, seed: int = 0, dtype=np.float32) -> np.ndarray:
    """A well-conditioned SPD matrix for tests/benchmarks."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)).astype(np.float64) / np.sqrt(n)
    spd = a @ a.T + np.eye(n) * n * 0.05
    return spd.astype(dtype)
