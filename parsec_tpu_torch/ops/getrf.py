"""Tiled LU factorization (dgetrf, no pivoting) as a DTD task graph.

The DPLASMA-style right-looking tile algorithm without pivoting (the
reference's dplasma offers nopiv and incpiv flavors; nopiv matches
well-conditioned or diagonally dominant inputs, which the test generator
provides):

    for k:  A[k,k] = LU(A[k,k])
            A[k,n] = L(k,k)^-1 A[k,n]          (row panel, n > k)
            A[m,k] = A[m,k] U(k,k)^-1          (col panel, m > k)
            A[m,n] -= A[m,k] A[k,n]            (trailing update)

The in-tile LU is a loop of rank-1 updates, the triangular solves and the
trailing product are torch library calls (cuBLAS/cuSOLVER on the card), as
the reference leaves them to its compiler's library; float32 dots run at
full float32 precision (TF32 off).
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.matrix import TiledMatrix
from ..dsl.dtd import AFFINITY, DTDTaskpool, READ, RW
from .cuda_kernels import dot_precision


def tile_getrf(a):
    """In-tile LU without pivoting: returns packed L\\U (unit lower).

    The same sequence of operations on every device: for each pivot j, the
    column below it is divided by it, then the trailing block takes the
    rank-1 update, on a copy of the tile. (``torch.linalg.lu_factor`` with
    ``pivot=False`` exists only on CUDA, so it would run other arithmetic on
    the card than on the CPU.)"""
    out = a.clone()
    n = min(out.shape)
    for j in range(n):
        out[j + 1:, j] = out[j + 1:, j] / out[j, j]
        out[j + 1:, j + 1:] -= torch.outer(out[j + 1:, j], out[j, j + 1:])
    return out


def tile_trsm_l(akk, akn):
    """A[k,n] <- L(k,k)^{-1} A[k,n] (unit lower from the packed LU)."""
    dot_precision()
    return torch.linalg.solve_triangular(akk, akn, upper=False,
                                         unitriangular=True)


def tile_trsm_u(akk, amk):
    """A[m,k] <- A[m,k] U(k,k)^{-1}."""
    dot_precision()
    return torch.linalg.solve_triangular(akk, amk, upper=True, left=False)


def tile_gemm_lu(amk, akn, amn):
    """A[m,n] -= A[m,k] @ A[k,n]."""
    dot_precision()
    return amn - torch.matmul(amk, akn).to(amn.dtype)


def insert_getrf_tasks(tp: DTDTaskpool, A: TiledMatrix) -> int:
    """Right-looking tiled LU (no pivoting). Returns task count."""
    T = A.mt
    if A.mt != A.nt:
        raise ValueError("GETRF needs a square tile grid")
    n0 = tp.inserted
    for k in range(T):
        prio = (T - k) * 10000
        tp.insert_task(tile_getrf, (tp.tile_of(A, k, k), RW | AFFINITY),
                       priority=prio + 3000, name="GETRF")
        for n in range(k + 1, T):
            tp.insert_task(tile_trsm_l, (tp.tile_of(A, k, k), READ),
                           (tp.tile_of(A, k, n), RW | AFFINITY),
                           priority=prio + 2000, name="TRSM_L")
        for m in range(k + 1, T):
            tp.insert_task(tile_trsm_u, (tp.tile_of(A, k, k), READ),
                           (tp.tile_of(A, m, k), RW | AFFINITY),
                           priority=prio + 2000, name="TRSM_U")
        for m in range(k + 1, T):
            for n in range(k + 1, T):
                tp.insert_task(tile_gemm_lu,
                               (tp.tile_of(A, m, k), READ),
                               (tp.tile_of(A, k, n), READ),
                               (tp.tile_of(A, m, n), RW | AFFINITY),
                               priority=prio, name="GEMM")
    return tp.inserted - n0


def getrf_flops(N: int) -> float:
    return 2.0 * N ** 3 / 3.0


def make_dd(n: int, seed: int = 0, dtype=np.float32) -> np.ndarray:
    """Diagonally-dominant matrix: safe for LU without pivoting."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)).astype(np.float64)
    a += np.eye(n) * (np.abs(a).sum(axis=1).max() + 1.0)
    return a.astype(dtype)


def unpack_lu(packed: np.ndarray):
    L = np.tril(packed, -1) + np.eye(packed.shape[0], dtype=packed.dtype)
    U = np.triu(packed)
    return L, U
