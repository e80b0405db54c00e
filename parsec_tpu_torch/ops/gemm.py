"""Tile GEMM bodies and the DTD algorithm builder.

The compute path of the headline tiled-GEMM benchmark (the reference's
harness: tests/dsl/dtd/dtd_test_simple_gemm.c, gflops = 2MNK/1e9/t at
:1143-1161). Tile bodies are torch functions run by the device layer.

``insert_gemm_tasks`` builds the classic tile-DAG (one RW chain per C tile
over k) through the DTD frontend; ``gemm_flops`` mirrors the reference's
FLOP accounting.
"""

from __future__ import annotations

import functools

import torch

from ..data.matrix import TiledMatrix
from ..dsl.dtd import AFFINITY, DTDTaskpool, READ, RW
from .cuda_kernels import dot_precision, gemm_chain


def _dot(c, a, b):
    """c + a @ b with float32 accumulation, the product rounded once to c's
    dtype (a library call: the reference leaves single tile dots to its
    compiler too). A float32 C takes the product in float32 whatever A's and
    B's dtype: bf16 widens to float32 exactly, so bf16 tiles give float32
    sums of exact products, as the reference's
    ``preferred_element_type=float32`` does."""
    if c.dtype == torch.float32:
        return c + torch.matmul(a.float(), b.float())
    return c + torch.matmul(a, b).to(c.dtype)


def tile_gemm(c, a, b):
    """C += A @ B on one tile triple."""
    dot_precision()
    return _dot(c, a, b)


def tile_gemm_chain(c, a_stack, b_stack):
    """Fused k-chain: C += sum_k A[k] @ B[k] in one dispatch.

    The task-batching analogue (ref: parsec_gpu_task_collect_batch,
    device_gpu.c:2229): a whole k-chain of compatible GEMM tasks collapses
    into one device call, the hand-written kernel
    :func:`parsec_tpu_torch.ops.cuda_kernels.gemm_chain` (at a 512 x 512
    tile its split route: one work unit per output tile and k step, then
    the ordered sum of the rounded step products).
    """
    return gemm_chain(c.contiguous(), a_stack, b_stack)


def insert_gemm_tasks(tp: DTDTaskpool, A: TiledMatrix, B: TiledMatrix,
                      C: TiledMatrix, batch_k: bool = False) -> int:
    """Insert the tile-GEMM DAG: C[m,n] += sum_k A[m,k] B[k,n].

    With ``batch_k`` the whole k-chain per C tile becomes ONE task using the
    fused chain body — fewer, bigger device dispatches. Returns the number
    of inserted tasks.
    """
    mt, nt, kt = C.mt, C.nt, A.nt
    if A.mt != mt or B.nt != nt or B.mt != kt:
        raise ValueError(f"tile grids do not chain: A {A.mt}x{A.nt}, "
                         f"B {B.mt}x{B.nt}, C {mt}x{nt}")
    n0 = tp.inserted

    if batch_k:
        gemm_k = _gemm_chain_body(kt)
        for m in range(mt):
            for n in range(nt):
                args = [(tp.tile_of(C, m, n), RW | AFFINITY)]
                args += [(tp.tile_of(A, m, k), READ) for k in range(kt)]
                args += [(tp.tile_of(B, k, n), READ) for k in range(kt)]
                tp.insert_task(gemm_k, *args, name="GEMM_K")
    else:
        for m in range(mt):
            for n in range(nt):
                tc = tp.tile_of(C, m, n)
                for k in range(kt):
                    tp.insert_task(tile_gemm, (tc, RW | AFFINITY),
                                   (tp.tile_of(A, m, k), READ),
                                   (tp.tile_of(B, k, n), READ),
                                   name="GEMM")
    return tp.inserted - n0


@functools.lru_cache(maxsize=None)
def _gemm_chain_body(kt: int):
    """One body function object per k-chain length, so every pool reuses
    one task class per chain length.

    Short chains unroll the dots directly (no stacking copies); long chains
    stack once and ride the hand-written chain kernel."""
    def gemm_k(c, *abs_):
        if kt <= 16:
            dot_precision()
            for k in range(kt):
                c = _dot(c, abs_[k], abs_[kt + k])
            return c
        a_stack = torch.stack(abs_[:kt])
        b_stack = torch.stack(abs_[kt:])
        return tile_gemm_chain(c, a_stack, b_stack)
    return gemm_k


def gemm_flops(M: int, N: int, K: int) -> float:
    """2·M·N·K (ref: dtd_test_simple_gemm.c gflops computation)."""
    return 2.0 * M * N * K
