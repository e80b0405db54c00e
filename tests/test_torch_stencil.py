"""The stencil slice through both runtimes.

The same grids, made with numpy from a seed, go through the reference's DTD
stencils and the port's (on a CPU context, where the 1D body's kernel
wrapper takes its plain version), and both against the numpy oracles. These
are the reference's own tests (tests/test_apps.py) plus the cross-checks.
Each cross-check says in a comment whether it holds bit for bit or within a
tolerance, and why.
"""

import numpy as np
import pytest
import torch

from parsec_tpu.core.context import Context as RefContext
from parsec_tpu.data.matrix import TiledMatrix as RefMatrix
from parsec_tpu.dsl.dtd import DTDTaskpool as RefPool
from parsec_tpu.ops import stencil as RS
from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.data.matrix import TiledMatrix
from parsec_tpu_torch.device.cuda import CUDADevice
from parsec_tpu_torch.dsl.dtd import DTDTaskpool
from parsec_tpu_torch.ops import cuda_kernels as K
from parsec_tpu_torch.ops import stencil as S
from parsec_tpu_torch.utils import mca


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


def _drain(ctx, tp):
    tp.wait(); tp.close(); ctx.wait()


def _grid(cls, name, dense, mb, nb):
    M = cls(name, dense.shape[0], dense.shape[1], mb, nb)
    M.fill(lambda m, n: dense[m * mb:(m + 1) * mb, n * nb:(n + 1) * nb])
    return M


def _stencil1d(ctx, pool_cls, mat_cls, insert, dense, ts, iters, **kw):
    """Runs a 1D stencil DAG; returns (task count, result as numpy)."""
    A = _grid(mat_cls, "SA", dense, dense.shape[0], ts)
    B = _grid(mat_cls, "SB", np.zeros_like(dense), dense.shape[0], ts)
    tp = pool_cls(ctx, "stencil")
    n = insert(tp, A, B, iters, **kw)
    _drain(ctx, tp)
    return n, (B if iters % 2 else A).to_dense()


def test_stencil1d(ctx):
    """The reference's test_stencil1d on the port: 6 tiles of 16, 5
    iterations, against the float64 oracle at rtol/atol 1e-4."""
    NT, TS, ITERS = 6, 16, 5
    dense = np.random.default_rng(20).standard_normal(
        (1, NT * TS)).astype(np.float32)
    n, out = _stencil1d(ctx, DTDTaskpool, TiledMatrix,
                        S.insert_stencil1d_tasks, dense, TS, ITERS)
    assert n == NT * ITERS
    np.testing.assert_allclose(out, S.reference_stencil1d(dense, ITERS),
                               rtol=1e-4, atol=1e-4)
    assert S.stencil_flops(NT * TS, ITERS) == 5 * NT * TS * ITERS


@pytest.mark.parametrize("rows,weights", [(1, (0.25, 0.5, 0.25)),
                                          (3, (0.3, 0.45, 0.25))])
def test_stencil1d_matches_reference_runtime(ctx, ref_ctx, rows, weights):
    """Both DTD runtimes on the same grid.

    Bit for bit with the default weights (powers of two): every product is
    exact in float32, so the reference's compiled body, which may fuse a
    product into the following sum, rounds the same sums as the port's
    op-by-op evaluation. With other weights the fused product is rounded
    once fewer, so the two agree within iterations x 4 float32 ulps of
    max|x| (the stencil's weights sum to 1, so max|x| bounds every
    iterate)."""
    NT, TS, ITERS = 5, 12, 4
    dense = np.random.default_rng(rows).standard_normal(
        (rows, NT * TS)).astype(np.float32)
    n_ref, want = _stencil1d(ref_ctx, RefPool, RefMatrix,
                             RS.insert_stencil1d_tasks, dense, TS, ITERS,
                             weights=weights)
    n, got = _stencil1d(ctx, DTDTaskpool, TiledMatrix,
                        S.insert_stencil1d_tasks, dense, TS, ITERS,
                        weights=weights)
    assert n == n_ref == NT * ITERS
    if weights == (0.25, 0.5, 0.25):
        np.testing.assert_array_equal(got, want)
    else:
        ulp = np.spacing(np.float32(np.abs(dense).max()))
        assert np.abs(got - want).max() <= ITERS * 4 * ulp


def test_stencil1d_dag_equals_whole_row_iteration(ctx):
    """The tiled DAG against the kernel's plain version over the whole row,
    iteration by iteration: bit for bit (every element sees the same
    operations, and the zero halo at the row's ends is the same zero)."""
    NT, TS, ITERS = 7, 9, 6
    dense = np.random.default_rng(3).standard_normal(
        (1, NT * TS)).astype(np.float32)
    _, got = _stencil1d(ctx, DTDTaskpool, TiledMatrix,
                        S.insert_stencil1d_tasks, dense, TS, ITERS)
    x = torch.from_numpy(dense)
    for _ in range(ITERS):
        x = K.stencil1d_plain(x, None, None)
    np.testing.assert_array_equal(got, x.numpy())


def test_every_stencil1d_task_calls_the_kernel_wrapper(ctx, monkeypatch):
    """All nt·it bodies go through ``cuda_kernels.stencil1d``, the boundary
    tiles too (with a null halo), and the four boundary variants share four
    task classes across the whole DAG."""
    calls = []
    real = S.stencil1d

    def spy(x, left, right, weights):
        calls.append((left is None, right is None))
        return real(x, left, right, weights)

    monkeypatch.setattr(S, "stencil1d", spy)
    NT, TS, ITERS = 4, 8, 3
    dense = np.random.default_rng(4).standard_normal(
        (1, NT * TS)).astype(np.float32)
    A = _grid(TiledMatrix, "SA", dense, 1, TS)
    B = _grid(TiledMatrix, "SB", np.zeros_like(dense), 1, TS)
    tp = DTDTaskpool(ctx, "spy")
    S.insert_stencil1d_tasks(tp, A, B, ITERS)
    classes = len(tp._classes)
    _drain(ctx, tp)
    assert len(calls) == NT * ITERS
    assert calls.count((True, False)) == calls.count((False, True)) == ITERS
    assert classes == 3     # left edge, interior, right edge


def test_stencil1d_on_the_device_module():
    """``device_cuda_over_cpu``: every stencil task runs on the CUDA device
    module (stage-in, dispatch, epilog), and the result is the same."""
    mca.set("device_cuda_over_cpu", True)
    mca.set("device_load_balance_allow_cpu", False)
    c = Context(nb_cores=1, device="cpu")
    try:
        NT, TS, ITERS = 4, 16, 4
        dense = np.random.default_rng(5).standard_normal(
            (1, NT * TS)).astype(np.float32)
        n, got = _stencil1d(c, DTDTaskpool, TiledMatrix,
                            S.insert_stencil1d_tasks, dense, TS, ITERS)
        dev = next(d for d in c.devices.devices if isinstance(d, CUDADevice))
        assert dev.executed_tasks == n == NT * ITERS
        np.testing.assert_allclose(got, S.reference_stencil1d(dense, ITERS),
                                   rtol=1e-5, atol=1e-6)
    finally:
        c.fini()
        mca.params.unset("device_cuda_over_cpu")
        mca.params.unset("device_load_balance_allow_cpu")


def _stencil2d(ctx, pool_cls, mat_cls, insert, dense, ts, iters):
    A = _grid(mat_cls, "S2A", dense, ts, ts)
    B = _grid(mat_cls, "S2B", np.zeros_like(dense), ts, ts)
    tp = pool_cls(ctx, "st2d")
    n = insert(tp, A, B, iters)
    _drain(ctx, tp)
    return n, (B if iters % 2 else A).to_dense()


def test_stencil2d(ctx, ref_ctx):
    """The reference's test_stencil2d (3x3 tiles of 8, 4 iterations) on the
    port against the float64 oracle at rtol/atol 1e-4, and against the
    reference runtime. Within iterations x 4 float32 ulps of max|x|, not bit
    for bit: the reference compiles its body, and the compiler may fuse the
    five products and four sums and round them fewer times than the port's
    op-by-op evaluation."""
    MT, TS, ITERS = 3, 8, 4
    dense = np.random.default_rng(70).standard_normal(
        (MT * TS, MT * TS)).astype(np.float32)
    n, got = _stencil2d(ctx, DTDTaskpool, TiledMatrix,
                        S.insert_stencil2d_tasks, dense, TS, ITERS)
    assert n == MT * MT * ITERS
    np.testing.assert_allclose(got, S.reference_stencil2d(dense, ITERS),
                               rtol=1e-4, atol=1e-4)
    n_ref, want = _stencil2d(ref_ctx, RefPool, RefMatrix,
                             RS.insert_stencil2d_tasks, dense, TS, ITERS)
    assert n_ref == n
    ulp = np.spacing(np.float32(np.abs(dense).max()))
    assert np.abs(got - want).max() <= ITERS * 4 * ulp


def _bricks(tp, dense, sz):
    nz = dense.shape[0] // sz
    a = [tp.tile_new(np.ascontiguousarray(dense[z * sz:(z + 1) * sz]))
         for z in range(nz)]
    b = [tp.tile_new(np.zeros((sz,) + dense.shape[1:], np.float32))
         for _ in range(nz)]
    return a, b


def _payload(tile):
    return np.asarray(tile.data.newest_copy().payload)


def test_stencil3d(ctx, ref_ctx):
    """The reference's test_stencil3d (4 Z-slabs of 4x8x8, 3 iterations) on
    the port against the float32 oracle at rtol/atol 1e-4, and against the
    reference runtime within iterations x 4 float32 ulps of max|x| (the
    reference compiles its seven-term body; see test_stencil2d)."""
    NZ, SZ, NY, NX, ITERS = 4, 4, 8, 8, 3
    dense = np.random.default_rng(77).standard_normal(
        (NZ * SZ, NY, NX)).astype(np.float32)
    outs = []
    for c, pool_cls, mod in ((ctx, DTDTaskpool, S), (ref_ctx, RefPool, RS)):
        tp = pool_cls(c, "st3d")
        bricks_a, bricks_b = _bricks(tp, dense, SZ)
        n = mod.insert_stencil3d_tasks(tp, bricks_a, bricks_b, ITERS)
        assert n == NZ * ITERS
        _drain(c, tp)
        res = bricks_b if ITERS % 2 else bricks_a
        outs.append(np.concatenate([_payload(t) for t in res], axis=0))
    got, want = outs
    np.testing.assert_allclose(got, S.reference_stencil3d(dense, ITERS),
                               rtol=1e-4, atol=1e-4)
    ulp = np.spacing(np.float32(np.abs(dense).max()))
    assert np.abs(got - want).max() <= ITERS * 4 * ulp


@pytest.mark.parametrize("oracle", ["1d", "2d", "3d"])
def test_numpy_oracles_are_the_reference_ones(oracle):
    """The port keeps its own copies of the numpy oracles; they give the
    reference's numbers exactly."""
    rng = np.random.default_rng(9)
    if oracle == "1d":
        x = rng.standard_normal((2, 40)).astype(np.float32)
        pair = (S.reference_stencil1d(x, 3, (0.3, 0.4, 0.3)),
                RS.reference_stencil1d(x, 3, (0.3, 0.4, 0.3)))
    elif oracle == "2d":
        x = rng.standard_normal((12, 10)).astype(np.float32)
        pair = S.reference_stencil2d(x, 3), RS.reference_stencil2d(x, 3)
    else:
        x = rng.standard_normal((6, 5, 4)).astype(np.float32)
        pair = S.reference_stencil3d(x, 2), RS.reference_stencil3d(x, 2)
    np.testing.assert_array_equal(*pair)
