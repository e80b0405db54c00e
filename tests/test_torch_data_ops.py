"""The collection helpers (apply, map_operator, the reductions, broadcast,
diag_band_to_rect) through both runtimes.

The reference's own tests (tests/test_aux.py's collection-op tests and
tests/test_collections_variants.py's single-rank diag_band_to_rect tests)
run on the port's CPU context; the cross-checks feed the same tiles, made
with numpy from a seed, through the reference's helpers and the port's and
require the same bits: every helper moves or combines whole tiles in the
same order, and ``diag_band_to_rect``'s single gather places the values the
reference's per-column loop does.
"""

import numpy as np
import pytest
import torch

from parsec_tpu.core.context import Context as RefContext
from parsec_tpu.data import ops as RO
from parsec_tpu.data.matrix import TiledMatrix as RefMatrix
from parsec_tpu.data.matrix import TwoDimBlockCyclic as RefBC
from parsec_tpu.dsl.dtd import DTDTaskpool as RefPool
from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.data.matrix import TiledMatrix, TwoDimBlockCyclic
from parsec_tpu_torch.data.ops import (apply, band_pack, broadcast,
                                       diag_band_to_rect, map_operator,
                                       reduce_all, reduce_col, reduce_row)
from parsec_tpu_torch.dsl.dtd import DTDTaskpool


@pytest.fixture()
def ctx():
    c = Context(nb_cores=1, device="cpu")
    yield c
    c.fini()


@pytest.fixture()
def ref_ctx():
    c = RefContext(nb_cores=1)
    yield c
    c.fini()


def _tile(A, m, n):
    return torch.as_tensor(A.data_of(m, n).newest_copy().payload).numpy()


def test_collection_ops(ctx):
    A = TiledMatrix("A", 16, 16, 4, 4)
    A.fill(lambda m, n: np.full((4, 4), float(m * 4 + n), np.float32))
    tp = DTDTaskpool(ctx, "ops")
    apply(tp, A, lambda m, n, x: x + 1.0)
    reduce_all(tp, A, lambda d, s: d + s)
    tp.wait(); tp.close(); ctx.wait()
    # after apply: tile (m,n) = m*4+n+1; reduce_all sums all 16 into (0,0)
    expect = sum(m * 4 + n + 1 for m in range(4) for n in range(4))
    assert np.allclose(_tile(A, 0, 0), expect)


def test_reduce_row_col_and_broadcast(ctx):
    A = TiledMatrix("A", 8, 8, 4, 4)
    A.fill(lambda m, n: np.full((4, 4), float(10 * m + n), np.float32))
    tp = DTDTaskpool(ctx, "rr")
    reduce_row(tp, A, lambda d, s: d + s)   # col0: 10m + (0+1)
    reduce_col(tp, A, lambda d, s: d + s)   # (0,0): (0+1) + (10+11)
    tp.wait(); tp.close(); ctx.wait()
    assert np.allclose(_tile(A, 0, 0), 22.0)
    tp2 = DTDTaskpool(ctx, "bc")
    broadcast(tp2, A, root=(0, 0))
    tp2.wait(); tp2.close(); ctx.wait()
    for m in range(2):
        for n in range(2):
            assert np.allclose(_tile(A, m, n), 22.0)


def test_map_operator(ctx):
    A = TiledMatrix("A", 8, 8, 4, 4)
    B = TiledMatrix("B", 8, 8, 4, 4)
    A.fill(lambda m, n: np.full((4, 4), 3.0, np.float32))
    B.fill(lambda m, n: np.full((4, 4), 4.0, np.float32))
    tp = DTDTaskpool(ctx, "map2")
    map_operator(tp, A, B, lambda a, b: a * b)
    tp.wait(); tp.close(); ctx.wait()
    assert np.allclose(B.to_dense(), 12.0)


@pytest.mark.parametrize("uplo", ["full", "lower", "upper"])
def test_apply_triangles(ctx, uplo):
    A = TiledMatrix("At", 12, 12, 4, 4)
    A.fill(lambda m, n: np.zeros((4, 4), np.float32))
    tp = DTDTaskpool(ctx, f"ap{uplo}")
    n = apply(tp, A, lambda m, k, x: x + (10 * m + k + 1), uplo=uplo)
    tp.wait(); tp.close(); ctx.wait()
    assert n == (9 if uplo == "full" else 6)
    for m in range(3):
        for k in range(3):
            hit = uplo == "full" or (uplo == "lower" and k <= m) or \
                (uplo == "upper" and k >= m)
            assert np.all(_tile(A, m, k) == (10 * m + k + 1 if hit else 0))


# ------------------------------------------------ diag_band_to_rect

def _band_pack_reference(dense, mb, nt):
    """Direct numpy construction of the packed band storage."""
    out = np.zeros((mb + 1, nt * (mb + 2)), np.float32)
    n = nt * mb
    for j in range(n):
        k, jj = divmod(j, mb)
        col = k * (mb + 2) + jj
        for i in range(mb + 1):
            if j + i < n:
                out[i, col] = dense[j + i, j]
    return out


def _symmetric(n, seed):
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((n, n)).astype(np.float32)
    return np.tril(dense) + np.tril(dense, -1).T


def test_diag_band_to_rect_single_rank(ctx):
    TS, NT = 8, 4
    N = TS * NT
    dense = _symmetric(N, 3)
    A = TwoDimBlockCyclic("bA", N, N, TS, TS, nodes=1)
    B = TwoDimBlockCyclic("bB", TS + 1, NT * (TS + 2), TS + 1, TS + 2,
                          nodes=1)
    A.fill(lambda m, n: dense[m*TS:(m+1)*TS, n*TS:(n+1)*TS])
    B.fill(lambda m, n: np.zeros((TS + 1, TS + 2), np.float32))
    tp = DTDTaskpool(ctx, "band2rect")
    cnt = diag_band_to_rect(tp, A, B)
    assert cnt == NT
    tp.wait(timeout=30)
    tp.close()
    ctx.wait(timeout=10)
    np.testing.assert_array_equal(B.to_dense(),
                                  _band_pack_reference(dense, TS, NT))


def test_diag_band_to_rect_shape_checks(ctx):
    A = TwoDimBlockCyclic("cA", 32, 32, 8, 8, nodes=1)
    Bad = TwoDimBlockCyclic("cB", 8, 32, 8, 8, nodes=1)
    tp = DTDTaskpool(ctx, "bad")
    with pytest.raises(ValueError):
        diag_band_to_rect(tp, A, Bad)
    Apartial = TwoDimBlockCyclic("cC", 36, 36, 8, 8, nodes=1)  # partial edge
    Bok = TwoDimBlockCyclic("cD", 9, 50, 9, 10, nodes=1)
    with pytest.raises(ValueError):
        diag_band_to_rect(tp, Apartial, Bok)
    tp.close()


@pytest.mark.parametrize("mb,seed,last", [(1, 0, False), (5, 1, False),
                                          (8, 2, True), (16, 3, False)])
def test_band_pack_is_the_reference_loop(mb, seed, last):
    """One gather places every value where the reference's per-column loop
    (``np.zeros_like`` and two slice copies a column) does, bit for bit,
    with and without a subdiagonal tile."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((mb, mb)).astype(np.float32)
    sd = None if last else rng.standard_normal((mb, mb)).astype(np.float32)
    b = np.full((mb + 1, mb + 2), 7.0, np.float32)
    want = np.zeros_like(b)
    for j in range(mb):
        want[:mb - j, j] = d[j:mb, j]
        if sd is not None:
            want[mb - j:mb + 1, j] = sd[:j + 1, j]
    got = band_pack(torch.from_numpy(b), torch.from_numpy(d),
                    None if sd is None else torch.from_numpy(sd))
    assert np.array_equal(got.numpy(), want)


def _run_band(pkg, ctx, dense, ts, nt, pad):
    Pool, BC = (RefPool, RefBC) if pkg == "ref" else (DTDTaskpool,
                                                     TwoDimBlockCyclic)
    diag = RO.diag_band_to_rect if pkg == "ref" else diag_band_to_rect
    N = ts * nt
    A = BC("xA", N, N, ts, ts, nodes=1)
    B = BC("xB", ts + 1, (nt + pad) * (ts + 2), ts + 1, ts + 2, nodes=1)
    A.fill(lambda m, n: dense[m*ts:(m+1)*ts, n*ts:(n+1)*ts])
    B.fill(lambda m, n: np.ones((ts + 1, ts + 2), np.float32))
    tp = Pool(ctx, "xband")
    cnt = diag(tp, A, B)
    tp.wait(); tp.close(); ctx.wait()
    return cnt, B.to_dense()


@pytest.mark.parametrize("ts,nt,pad", [(4, 5, 0), (8, 3, 1), (6, 4, 2)])
def test_diag_band_to_rect_matches_the_reference(ctx, ref_ctx, ts, nt, pad):
    dense = _symmetric(ts * nt, ts + nt)
    n_ref, want = _run_band("ref", ref_ctx, dense, ts, nt, pad)
    n_got, got = _run_band("port", ctx, dense, ts, nt, pad)
    assert n_got == n_ref == nt + pad
    assert np.array_equal(got, want)


def _run_ops(pkg, ctx, a, b, ts):
    if pkg == "ref":
        Pool, M, ops = RefPool, RefMatrix, RO
    else:
        Pool, M = DTDTaskpool, TiledMatrix
        ops = __import__("parsec_tpu_torch.data.ops", fromlist=["apply"])
    n = a.shape[0]
    A = M("oA", n, n, ts, ts)
    B = M("oB", n, n, ts, ts)
    A.fill(lambda m, k: a[m*ts:(m+1)*ts, k*ts:(k+1)*ts])
    B.fill(lambda m, k: b[m*ts:(m+1)*ts, k*ts:(k+1)*ts])
    tp = Pool(ctx, "xops")
    ops.apply(tp, A, lambda m, k, x: x * (1.5 + (m - k) * 0.25))
    ops.map_operator(tp, A, B, lambda s, d: d - s)
    ops.reduce_row(tp, B, lambda d, s: d + s)
    ops.reduce_col(tp, B, lambda d, s: d - s)
    ops.reduce_all(tp, A, lambda d, s: d + s, root=(1, 2))
    tp.wait(); tp.close(); ctx.wait()
    tp = Pool(ctx, "xbcast")
    ops.broadcast(tp, B, root=(0, 0))
    tp.wait(); tp.close(); ctx.wait()
    return A.to_dense(), B.to_dense()


def test_collection_ops_match_the_reference_bit_for_bit(ctx, ref_ctx):
    """apply, map_operator, reduce_row, reduce_col, reduce_all (to a
    root that is not (0, 0)) and broadcast on the same seeded tiles: the
    port's results are the reference's bits. Each body is one float32
    operation, so each step rounds once and the order of the steps is the
    helpers' own (a body of two operations would let XLA contract them into
    one FMA, which the port's eager torch does not)."""
    rng = np.random.default_rng(21)
    a = rng.standard_normal((20, 20)).astype(np.float32)
    b = rng.standard_normal((20, 20)).astype(np.float32)
    want = _run_ops("ref", ref_ctx, a, b, 5)
    got = _run_ops("port", ctx, a, b, 5)
    for w, g in zip(want, got):
        assert np.array_equal(g, w)
