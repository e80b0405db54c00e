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
    A tile that is not positive definite gives the reference's failed
    factor: NaN on and below the diagonal, 0 above it. ``cholesky_ex``
    reports the failure in its ``info`` output and the NaN is chosen on the
    device from that output, so the body never waits for the card (and can
    be captured in a CUDA graph)."""
    dot_precision()
    factor, info = torch.linalg.cholesky_ex((a + a.mT) * 0.5)
    lower = torch.ones_like(factor, dtype=torch.bool).tril_()
    return factor.masked_fill(lower & (info != 0), float("nan"))


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


# --------------------------------------------------------------- SPD solve

def _sub_product(c, a, b):
    """c - a @ b, the product taken in float32 for a float32 c (exact
    widening of narrower tiles), else rounded once to c's dtype."""
    dot_precision()
    if c.dtype == torch.float32:
        return c - torch.matmul(a.float(), b.float())
    return c - torch.matmul(a, b).to(c.dtype)


def tile_trsv_l(lkk, bk):
    """B[k] <- L(k,k)^{-1} B[k] (forward substitution step)."""
    dot_precision()
    return torch.linalg.solve_triangular(lkk, bk, upper=False)


def tile_trsv_lt(lkk, bk):
    """B[k] <- L(k,k)^{-T} B[k] (backward substitution step)."""
    dot_precision()
    return torch.linalg.solve_triangular(lkk.mT, bk, upper=True)


def tile_gemv_sub(lmk, yk, bm):
    """B[m] <- B[m] - L(m,k) Y[k]."""
    return _sub_product(bm, lmk, yk)


def tile_gemv_sub_t(lkm, xk, ym):
    """Y[m] <- Y[m] - L(k,m)^T X[k]."""
    return _sub_product(ym, lkm.mT, xk)


def insert_posv_tasks(tp: DTDTaskpool, A: TiledMatrix,
                      B: TiledMatrix) -> int:
    """Solve A X = B for SPD A (the DPLASMA dposv shape): Cholesky
    factorization followed by tiled forward and backward substitution, one
    taskpool — the solves chain onto the factorization through the tile
    dependencies, so panels start solving while trailing updates still run.
    B is a (T x 1)-tile right-hand-side collection, overwritten with X.
    Works under both execution modes (scheduler and capture). Returns the
    task count."""
    T = A.mt
    if not (A.mt == A.nt and B.mt == T and B.nt == 1):
        raise ValueError(f"posv needs a square tile grid and a T x 1 right-"
                         f"hand side: A {A.mt}x{A.nt}, B {B.mt}x{B.nt}")
    n0 = tp.inserted
    insert_potrf_tasks(tp, A)
    # forward: L Y = B
    for k in range(T):
        tp.insert_task(tile_trsv_l, (tp.tile_of(A, k, k), READ),
                       (tp.tile_of(B, k, 0), RW | AFFINITY), name="TRSV_L")
        for m in range(k + 1, T):
            tp.insert_task(tile_gemv_sub, (tp.tile_of(A, m, k), READ),
                           (tp.tile_of(B, k, 0), READ),
                           (tp.tile_of(B, m, 0), RW | AFFINITY),
                           name="GEMV_SUB")
    # backward: L^T X = Y
    for k in reversed(range(T)):
        tp.insert_task(tile_trsv_lt, (tp.tile_of(A, k, k), READ),
                       (tp.tile_of(B, k, 0), RW | AFFINITY), name="TRSV_LT")
        for m in range(k):
            tp.insert_task(tile_gemv_sub_t, (tp.tile_of(A, k, m), READ),
                           (tp.tile_of(B, k, 0), READ),
                           (tp.tile_of(B, m, 0), RW | AFFINITY),
                           name="GEMV_SUB_T")
    return tp.inserted - n0
