"""Tiled QR factorization (dgeqrf) as a DTD task graph.

The DPLASMA-style tile QR (GEQRT / UNMQR / TSQRT / TSMQR kernel quartet),
with explicit per-step Q factors held in scratch tiles instead of compact WY
storage, so each kernel is one or two matrix products plus a small in-tile
QR (``torch.linalg.qr``, cuSOLVER on the card):

    for k:
      GEQRT:  A[k,k] -> Q1 (ts×ts), R into A[k,k]
      UNMQR:  A[k,n] = Q1^T A[k,n]                       (n > k)
      for m > k:
        TSQRT:  [A[k,k]; A[m,k]] -> Q2 (2ts×ts), new R into A[k,k],
                A[m,k] = 0 (implicit)
        TSMQR:  [A[k,n]; A[m,n]] = Q2^T [A[k,n]; A[m,n]]  (n > k)

The result's R occupies the upper triangle of A; Q is implicit in the
scratch tiles (enough for least-squares solves and the A^T A = R^T R
correctness contract). LAPACK and cuSOLVER may choose opposite signs for a
row of R, so results are compared through that contract, not element by
element.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.matrix import TiledMatrix
from ..dsl.dtd import AFFINITY, DTDTaskpool, READ, RW, WRITE
from .cuda_kernels import dot_precision


def tile_geqrt(akk, q_out):
    """QR of the diagonal tile: returns (R, Q), one per WRITE flow."""
    q, r = torch.linalg.qr(akk, mode="complete")
    return r, q


def tile_unmqr(q, akn):
    """A[k,n] = Q^T A[k,n]."""
    dot_precision()
    return torch.matmul(q.mT, akn).to(akn.dtype)


def tile_tsqrt(rkk, amk, q_out):
    """QR of the stacked [R(k,k); A(m,k)]: returns (new R, zeroed A[m,k], Q2)."""
    ts = rkk.shape[0]
    stacked = torch.cat([torch.triu(rkk), amk], dim=0)
    q, r = torch.linalg.qr(stacked, mode="complete")   # (2ts, 2ts), (2ts, ts)
    return r[:ts, :], torch.zeros_like(amk), q


def tile_tsmqr(q2, akn, amn):
    """[A[k,n]; A[m,n]] = Q2^T [A[k,n]; A[m,n]]."""
    dot_precision()
    ts = akn.shape[0]
    stacked = torch.cat([akn, amn], dim=0)
    out = torch.matmul(q2.mT, stacked).to(akn.dtype)
    return out[:ts, :], out[ts:, :]


def insert_geqrf_tasks(tp: DTDTaskpool, A: TiledMatrix) -> int:
    """Tile QR DAG; Q factors go to per-(k[,m]) scratch tiles. Returns task
    count."""
    T = A.mt
    if A.mt != A.nt:
        raise ValueError("GEQRF needs a square tile grid")
    ts = A.mb
    n0 = tp.inserted
    for k in range(T):
        prio = (T - k) * 10000
        qk = tp.tile_new((ts, ts), np.float32)
        tp.insert_task(tile_geqrt,
                       (tp.tile_of(A, k, k), RW | AFFINITY),
                       (qk, WRITE),
                       priority=prio + 3000, name="GEQRT")
        for n in range(k + 1, T):
            tp.insert_task(tile_unmqr, (qk, READ),
                           (tp.tile_of(A, k, n), RW | AFFINITY),
                           priority=prio + 2000, name="UNMQR")
        for m in range(k + 1, T):
            q2 = tp.tile_new((2 * ts, 2 * ts), np.float32)
            tp.insert_task(tile_tsqrt,
                           (tp.tile_of(A, k, k), RW | AFFINITY),
                           (tp.tile_of(A, m, k), RW),
                           (q2, WRITE),
                           priority=prio + 1500, name="TSQRT")
            for n in range(k + 1, T):
                tp.insert_task(tile_tsmqr, (q2, READ),
                               (tp.tile_of(A, k, n), RW),
                               (tp.tile_of(A, m, n), RW | AFFINITY),
                               priority=prio, name="TSMQR")
    return tp.inserted - n0


def geqrf_flops(N: int) -> float:
    return 4.0 * N ** 3 / 3.0
