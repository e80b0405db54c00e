"""Redistribution through both runtimes (the single-rank half).

The reference's single-rank tests (tests/test_redistribute.py and
tests/test_aux.py's two redistribute tests) run on the port's CPU context;
a cross-check sends the same random geometries, made with numpy from a
seed, through the reference's ``redistribute`` and the port's and requires
the same bits and the same task counts, for the fragment algebra and the
reshuffle fast path. The 4-rank run waits for the distributed slice.
"""

import numpy as np
import pytest
import torch

from parsec_tpu.core.context import Context as RefContext
from parsec_tpu.data.matrix import TiledMatrix as RefMatrix
from parsec_tpu.data.redistribute import redistribute as ref_redistribute
from parsec_tpu.dsl.dtd import DTDTaskpool as RefPool
from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.core.task import DEV_CUDA
from parsec_tpu_torch.data.matrix import SymTwoDimBlockCyclic, TiledMatrix
from parsec_tpu_torch.data.redistribute import redistribute
from parsec_tpu_torch.dsl.dtd import RW, DTDTaskpool
from parsec_tpu_torch.utils import mca


@pytest.fixture()
def ctx():
    c = Context(nb_cores=1, device="cpu")
    yield c
    c.fini()


def _filled(name, lm, ln, mb, nb, base, cls=TiledMatrix):
    M = cls(name, lm, ln, mb, nb)
    M.fill(lambda m, k: base[m * mb:(m + 1) * mb, k * nb:(k + 1) * nb])
    return M


def _payload(M, m, n):
    return M.data_of(m, n).newest_copy().payload


def test_redistribute_aligned(ctx):
    S = TiledMatrix("S", 32, 32, 8, 8)
    T = TiledMatrix("T", 32, 32, 16, 16)   # different tile size
    rng = np.random.default_rng(13)
    dense = rng.standard_normal((32, 32)).astype(np.float32)
    S.fill(lambda m, n: dense[m*8:(m+1)*8, n*8:(n+1)*8])
    T.fill(lambda m, n: np.zeros((16, 16), np.float32))
    tp = DTDTaskpool(ctx, "redist")
    redistribute(tp, S, T)
    tp.wait(); tp.close(); ctx.wait()
    np.testing.assert_allclose(T.to_dense(), dense)


def test_redistribute_unaligned_offsets(ctx):
    """Non-aligned offsets on both sides (ref: redistribute random tests)."""
    S = TiledMatrix("S", 24, 24, 8, 8)
    T = TiledMatrix("T", 24, 24, 5, 5)     # deliberately awkward tiles
    rng = np.random.default_rng(14)
    dense = rng.standard_normal((24, 24)).astype(np.float32)
    S.fill(lambda m, n: dense[m*8:(m+1)*8, n*8:(n+1)*8])
    T.fill(lambda m, n: np.zeros(T.tile_shape(m, n), np.float32))
    tp = DTDTaskpool(ctx, "redist2")
    m, n, si, sj, ti, tj = 13, 11, 3, 5, 7, 2
    redistribute(tp, S, T, m, n, si, sj, ti, tj)
    tp.wait(); tp.close(); ctx.wait()
    got = T.to_dense()
    np.testing.assert_allclose(got[ti:ti+m, tj:tj+n],
                               dense[si:si+m, sj:sj+n])
    mask = np.ones((24, 24), bool)
    mask[ti:ti+m, tj:tj+n] = False
    assert np.allclose(got[mask], 0.0)


def _random_geometry(rng):
    s_mb, s_nb = (int(x) for x in rng.integers(3, 24, 2))
    t_mb, t_nb = (int(x) for x in rng.integers(3, 24, 2))
    s_lm, s_ln = (int(x) for x in rng.integers(30, 80, 2))
    t_lm, t_ln = (int(x) for x in rng.integers(30, 80, 2))
    m = int(rng.integers(1, min(s_lm, t_lm)))
    n = int(rng.integers(1, min(s_ln, t_ln)))
    si = int(rng.integers(0, s_lm - m + 1))
    sj = int(rng.integers(0, s_ln - n + 1))
    ti = int(rng.integers(0, t_lm - m + 1))
    tj = int(rng.integers(0, t_ln - n + 1))
    src = rng.standard_normal((s_lm, s_ln)).astype(np.float32)
    dst = rng.standard_normal((t_lm, t_ln)).astype(np.float32)
    return (s_mb, s_nb, t_mb, t_nb, m, n, si, sj, ti, tj, src, dst)


def test_random_sweep_single_rank(ctx):
    """Property battery: random tile sizes, region sizes and offsets on
    both sides; result must equal the numpy slice assignment."""
    rng = np.random.default_rng(123)
    for trial in range(16):
        (s_mb, s_nb, t_mb, t_nb, m, n, si, sj, ti, tj, src,
         dst) = _random_geometry(rng)
        S = _filled(f"rs{trial}", *src.shape, s_mb, s_nb, src)
        T = _filled(f"rt{trial}", *dst.shape, t_mb, t_nb, dst)
        tp = DTDTaskpool(ctx, f"rsweep{trial}")
        ntasks = redistribute(tp, S, T, m, n, si, sj, ti, tj)
        tp.wait()
        tp.close()
        ctx.wait(timeout=60)
        expect = dst.copy()
        expect[ti:ti + m, tj:tj + n] = src[si:si + m, sj:sj + n]
        np.testing.assert_array_equal(
            T.to_dense(), expect,
            err_msg=f"trial {trial}: S({s_mb}x{s_nb}) T({t_mb}x{t_nb}) "
                    f"m={m} n={n} s=({si},{sj}) t=({ti},{tj}) "
                    f"tasks={ntasks}")
        assert ntasks >= 1


def test_reshuffle_fast_path_moves_by_reference(ctx):
    """Aligned same-geometry redistribution takes whole-tile moves: the
    landed payload IS the source tile's tensor (zero copies), and interior
    tiles produce exactly one task each."""
    rng = np.random.default_rng(7)
    mb = nb = 8
    src = rng.standard_normal((32, 32)).astype(np.float32)
    S = _filled("fpS", 32, 32, mb, nb, src)
    T = _filled("fpT", 32, 32, mb, nb, np.zeros((32, 32), np.float32))
    tp = DTDTaskpool(ctx, "fp")
    ntasks = redistribute(tp, S, T)              # full, aligned
    tp.wait()
    tp.close()
    ctx.wait(timeout=30)
    assert ntasks == 16                          # one per tile, no fragments
    np.testing.assert_array_equal(T.to_dense(), src)
    for tm in range(4):
        for tn in range(4):
            assert _payload(T, tm, tn) is _payload(S, tm, tn)


def test_reshuffle_offset_congruent_but_nonzero(ctx):
    """si-ti congruent mod tile: interior tiles still whole-move; ragged
    edges fall back to fragments. Correctness against numpy either way."""
    rng = np.random.default_rng(8)
    mb = nb = 8
    src = rng.standard_normal((40, 40)).astype(np.float32)
    dst = rng.standard_normal((40, 40)).astype(np.float32)
    S = _filled("ocS", 40, 40, mb, nb, src)
    T = _filled("ocT", 40, 40, mb, nb, dst)
    tp = DTDTaskpool(ctx, "oc")
    redistribute(tp, S, T, m=24, n=24, si=8, sj=8, ti=16, tj=16)
    tp.wait()
    tp.close()
    ctx.wait(timeout=30)
    expect = dst.copy()
    expect[16:40, 16:40] = src[8:32, 8:32]
    np.testing.assert_array_equal(T.to_dense(), expect)
    assert _payload(T, 2, 2) is _payload(S, 1, 1)


def test_unaligned_never_takes_fast_path(ctx):
    """Non-congruent offsets keep the fragment algebra (and stay right)."""
    rng = np.random.default_rng(9)
    mb = nb = 8
    src = rng.standard_normal((32, 32)).astype(np.float32)
    dst = rng.standard_normal((32, 32)).astype(np.float32)
    S = _filled("uaS", 32, 32, mb, nb, src)
    T = _filled("uaT", 32, 32, mb, nb, dst)
    tp = DTDTaskpool(ctx, "ua")
    redistribute(tp, S, T, m=16, n=16, si=3, sj=5, ti=6, tj=2)
    tp.wait()
    tp.close()
    ctx.wait(timeout=30)
    expect = dst.copy()
    expect[6:22, 2:18] = src[3:19, 5:21]
    np.testing.assert_array_equal(T.to_dense(), expect)


def test_redistribute_into_the_stored_triangle(ctx):
    """A symmetric lower target: only its stored tiles get tasks, and they
    hold the source's slices; the other triangle is never touched."""
    rng = np.random.default_rng(10)
    src = rng.standard_normal((32, 32)).astype(np.float32)
    S = _filled("trS", 32, 32, 16, 16, src)
    T = SymTwoDimBlockCyclic("trT", 32, 32, 8, 8, uplo=0)
    T.fill(lambda m, n: np.zeros((8, 8), np.float32))
    tp = DTDTaskpool(ctx, "tri")
    assert redistribute(tp, S, T) == 10          # 4 x 5 / 2 lower tiles
    tp.wait(); tp.close(); ctx.wait()
    lower = np.kron(np.tril(np.ones((4, 4))), np.ones((8, 8))).astype(bool)
    got = T.to_dense()
    assert np.array_equal(got[lower], src[lower])
    assert not got[~lower].any()


def test_reshuffle_moves_the_device_payload_by_reference():
    """On a context with the CUDA module (over CPU tensors), a moved tile's
    device copy holds the source's device tensor itself: the module's
    epilog keeps the body's result as the payload, and nothing in the
    module writes a staged copy in place."""
    mca.set("device_cuda_over_cpu", True)
    try:
        c = Context(nb_cores=1, device="cpu")
        try:
            cuda = c.devices.by_type(DEV_CUDA)[0]
            rng = np.random.default_rng(11)
            src = rng.standard_normal((16, 16)).astype(np.float32)
            S = _filled("dvS", 16, 16, 8, 8, src)
            T = _filled("dvT", 16, 16, 8, 8, np.zeros((16, 16), np.float32))
            # S's tiles first land on the device (a task writes them there)
            tp = DTDTaskpool(c, "dv0")
            for m in range(2):
                for n in range(2):
                    tp.insert_task(lambda x: x * 1.0, (tp.tile_of(S, m, n), RW))
            tp.wait(); tp.close(); c.wait()
            tp = DTDTaskpool(c, "dv")
            assert redistribute(tp, S, T) == 4
            tp.wait(); tp.close(); c.wait()
            for m in range(2):
                for n in range(2):
                    sd = S.data_of(m, n).get_copy(cuda.device_index)
                    td = T.data_of(m, n).get_copy(cuda.device_index)
                    assert td is T.data_of(m, n).newest_copy()
                    assert td.payload is sd.payload
            assert np.array_equal(T.to_dense(), src)
            assert np.array_equal(S.to_dense(), src)
        finally:
            c.fini()
    finally:
        mca.params.unset("device_cuda_over_cpu")



def _sweep(pkg, ctx, geoms, reshuffle):
    Pool, M, redist = (RefPool, RefMatrix, ref_redistribute) if pkg == "ref" \
        else (DTDTaskpool, TiledMatrix, redistribute)
    out = []
    for i, (s_mb, s_nb, t_mb, t_nb, m, n, si, sj, ti, tj, src,
            dst) in enumerate(geoms):
        if reshuffle:
            t_mb, t_nb = s_mb, s_nb
            ti, tj = si % s_mb, sj % s_nb        # congruent offsets
            m = min(m, dst.shape[0] - ti)
            n = min(n, dst.shape[1] - tj)
        S = _filled(f"xs{i}", *src.shape, s_mb, s_nb, src, M)
        T = _filled(f"xt{i}", *dst.shape, t_mb, t_nb, dst, M)
        tp = Pool(ctx, f"x{i}")
        ntasks = redist(tp, S, T, m, n, si, sj, ti, tj)
        tp.wait(); tp.close(); ctx.wait()
        out.append((ntasks, T.to_dense()))
    return out


@pytest.mark.parametrize("reshuffle", [False, True])
def test_random_sweep_matches_the_reference(ctx, reshuffle):
    """The same 12 random geometries through both packages (the fragment
    algebra, or congruent offsets and equal tiles for the reshuffle path):
    the same task counts and the same bits."""
    rng = np.random.default_rng(2024 + reshuffle)
    geoms = [_random_geometry(rng) for _ in range(12)]
    ref_ctx = RefContext(nb_cores=1)
    try:
        want = _sweep("ref", ref_ctx, geoms, reshuffle)
    finally:
        ref_ctx.fini()
    got = _sweep("port", ctx, geoms, reshuffle)
    for i, ((nw, w), (ng, g)) in enumerate(zip(want, got)):
        assert ng == nw, f"geometry {i}: {ng} tasks, the reference {nw}"
        assert np.array_equal(g, w), f"geometry {i} differs"
