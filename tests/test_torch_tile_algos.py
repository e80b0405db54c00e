"""The other tile algorithms and the apps through both runtimes.

The same matrices and payloads, made with numpy from a seed, go through the
reference's DTD task graphs and the port's (on a CPU context), and both
against numpy. These are the reference's own tests (tests/test_ops.py,
tests/test_apps.py) plus the cross-checks; each states its tolerance.
"""

import functools

import numpy as np
import pytest
import torch

from parsec_tpu import apps as RA
from parsec_tpu.core.context import Context as RefContext
from parsec_tpu.data.matrix import TiledMatrix as RefMatrix
from parsec_tpu.dsl.dtd import DTDTaskpool as RefPool
from parsec_tpu.ops import geqrf as RQ
from parsec_tpu.ops import getrf as RL
from parsec_tpu_torch import apps as A
from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.data.matrix import TiledMatrix
from parsec_tpu_torch.device.cuda import CUDADevice
from parsec_tpu_torch.dsl.dtd import DTDTaskpool
from parsec_tpu_torch.ops import geqrf as Q
from parsec_tpu_torch.ops import getrf as L
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


def _tiled_from(cls, dense, ts, name):
    M = cls(name, dense.shape[0], dense.shape[1], ts, ts)
    M.fill(lambda m, k: dense[m * ts:(m + 1) * ts, k * ts:(k + 1) * ts])
    return M


def _factor(ctx, pool_cls, mat_cls, insert, dense, ts, name):
    """Runs a factorization DAG in place; returns (task count, matrix)."""
    M = _tiled_from(mat_cls, dense, ts, name)
    tp = pool_cls(ctx, name)
    n = insert(tp, M)
    _drain(ctx, tp)
    return n, M


# --- getrf -----------------------------------------------------------------

def test_getrf_dag(ctx):
    """The reference's tiled LU test (tests/test_ops.py) on the port: LU
    of a diagonally dominant 96 x 96 in 32^2 tiles, L U within rtol/atol
    2e-2 of A."""
    n, ts = 96, 32
    a = L.make_dd(n, seed=8)
    T = n // ts
    ntasks, M = _factor(ctx, DTDTaskpool, TiledMatrix, L.insert_getrf_tasks,
                        a, ts, "LU")
    assert ntasks == T + 2 * (T * (T - 1) // 2) + (T * (T - 1) * (2 * T - 1)) // 6
    Lf, U = L.unpack_lu(M.to_dense())
    np.testing.assert_allclose(Lf @ U, a, rtol=2e-2, atol=2e-2)
    assert L.getrf_flops(10) == 2000.0 / 3.0


def test_getrf_matches_reference_runtime(ctx, ref_ctx):
    """Both runtimes on one matrix that is not diagonally dominant (so the
    trailing updates matter): the packed L\\U factors agree within 1e-5 of
    max|LU| (float32 rounding over 4 tile steps; the reference compiles its
    tile bodies and may fuse what the port rounds separately), and the
    port's L U is A to float32 accuracy."""
    n, ts = 128, 32
    rng = np.random.default_rng(21)
    a = (rng.standard_normal((n, n)) / np.sqrt(n) + 2 * np.eye(n)
         ).astype(np.float32)
    n_port, M = _factor(ctx, DTDTaskpool, TiledMatrix, L.insert_getrf_tasks,
                        a, ts, "LU")
    n_ref, R = _factor(ref_ctx, RefPool, RefMatrix, RL.insert_getrf_tasks,
                       a, ts, "LU")
    assert n_port == n_ref
    got, want = M.to_dense(), R.to_dense()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    Lf, U = L.unpack_lu(got.astype(np.float64))
    assert np.linalg.norm(Lf @ U - a) / np.linalg.norm(a) < n * 2.0 ** -24


def test_tile_getrf_matches_the_reference_tile_body():
    """The in-tile LU (a loop of rank-1 updates) against the reference's
    ``lax.scan`` on one 48 x 48 tile: within 1e-5 of max|LU|."""
    import jax.numpy as jnp
    rng = np.random.default_rng(22)
    a = (rng.standard_normal((48, 48)) / 7 + 2 * np.eye(48)).astype(np.float32)
    got = L.tile_getrf(torch.from_numpy(a)).numpy()
    want = np.asarray(RL.tile_getrf(jnp.asarray(a)))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    Lf, U = L.unpack_lu(got.astype(np.float64))
    np.testing.assert_allclose(Lf @ U, a, rtol=0, atol=1e-5)


def test_make_dd_and_unpack_lu_are_the_reference_ones():
    np.testing.assert_array_equal(L.make_dd(40, seed=3), RL.make_dd(40, seed=3))
    p = np.random.default_rng(1).standard_normal((6, 6))
    for x, y in zip(L.unpack_lu(p), RL.unpack_lu(p)):
        np.testing.assert_array_equal(x, y)


# --- geqrf -----------------------------------------------------------------

def _annihilated(M, ts_count):
    """Largest |entry| of the below-diagonal tiles."""
    return max(np.abs(np.asarray(M.data_of(m, k).newest_copy().payload)).max()
               for m in range(1, ts_count) for k in range(m))


def test_geqrf_dag(ctx):
    """The reference's tiled QR test (tests/test_ops.py) on the port:
    R^T R = A^T A within rtol/atol 5e-2, and the below-diagonal tiles
    annihilated (< 1e-3)."""
    n, ts = 64, 16
    a = np.random.default_rng(9).standard_normal((n, n)).astype(np.float32)
    ntasks, M = _factor(ctx, DTDTaskpool, TiledMatrix, Q.insert_geqrf_tasks,
                        a, ts, "QR")
    T = n // ts
    assert ntasks == T + 2 * (T * (T - 1) // 2) + (T * (T - 1) * (2 * T - 1)) // 6
    R = np.triu(M.to_dense())
    np.testing.assert_allclose(R.T @ R, a.T @ a, rtol=5e-2, atol=5e-2)
    assert _annihilated(M, T) < 1e-3
    assert Q.geqrf_flops(3) == 36.0


def test_geqrf_matches_reference_runtime(ctx, ref_ctx):
    """Both runtimes on one matrix. LAPACK (under both packages on the CPU)
    and cuSOLVER may choose opposite signs for a row of R, so R is compared
    up to row signs: |R| within 1e-4 of max|R|; each runtime's R^T R equals
    A^T A within n 2^-24 norm-wise."""
    n, ts = 96, 32
    a = np.random.default_rng(10).standard_normal((n, n)).astype(np.float32)
    n_port, M = _factor(ctx, DTDTaskpool, TiledMatrix, Q.insert_geqrf_tasks,
                        a, ts, "QR")
    n_ref, R = _factor(ref_ctx, RefPool, RefMatrix, RQ.insert_geqrf_tasks,
                       a, ts, "QR")
    assert n_port == n_ref
    got, want = np.triu(M.to_dense()), np.triu(R.to_dense())
    assert np.abs(np.abs(got) - np.abs(want)).max() <= 1e-4 * np.abs(want).max()
    ata = a.astype(np.float64).T @ a
    for r in (got, want):
        r = r.astype(np.float64)
        assert np.linalg.norm(r.T @ r - ata) / np.linalg.norm(ata) < \
            n * 2.0 ** -24


# --- apps ------------------------------------------------------------------

def test_merge_sort(ctx, ref_ctx):
    """The reference's test_merge_sort, on both runtimes: exact."""
    rng = np.random.default_rng(22)
    chunks = [rng.standard_normal(17).astype(np.float32) for _ in range(5)]
    outs = []
    for c, pool_cls, mod in ((ctx, DTDTaskpool, A), (ref_ctx, RefPool, RA)):
        tp = pool_cls(c, "msort")
        result = mod.merge_sort(tp, chunks)
        _drain(c, tp)
        outs.append(np.asarray(result.data.newest_copy().payload))
    np.testing.assert_array_equal(outs[0], np.sort(np.concatenate(chunks)))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_all2all(ctx):
    """The reference's test_all2all: 4 tiles, 16 tasks, exact sums."""
    N, TS = 4, 8
    Am = TiledMatrix("A2A", 1, N * TS, 1, TS)
    Bm = TiledMatrix("B2A", 1, N * TS, 1, TS)
    Am.fill(lambda m, n: np.full((1, TS), float(n + 1), np.float32))
    Bm.fill(lambda m, n: np.zeros((1, TS), np.float32))
    tp = DTDTaskpool(ctx, "a2a")
    assert A.all2all(tp, Am, Bm) == N * N
    _drain(ctx, tp)
    assert np.array_equal(Bm.to_dense(), np.full((1, N * TS), 10.0))


def test_pingpong(ctx):
    """The reference's test_pingpong: 7 hops land 7 in tile (1, 0)."""
    Am = TiledMatrix("PP", 2 * 4, 4, 4, 4)
    Am.fill(lambda m, n: np.zeros((4, 4), np.float32))
    tp = DTDTaskpool(ctx, "pp")
    hops = 7
    assert A.pingpong(tp, Am, hops) == hops
    _drain(ctx, tp)
    final = Am.data_of(hops % 2, 0).newest_copy()
    assert np.array_equal(np.asarray(final.payload), np.full((4, 4), 7.0))


def test_haar_tree(ctx):
    """The reference's test_haar_tree: the root of 8 leaves is their mean."""
    tp = DTDTaskpool(ctx, "haar")
    leaves = [tp.tile_new(np.full((1,), float(i), np.float32))
              for i in range(8)]
    roots = A.haar_transform(tp, leaves)
    _drain(ctx, tp)
    assert len(roots) == 3
    top = np.asarray(roots[-1].data.newest_copy().payload)
    assert np.allclose(top, np.mean(np.arange(8.0)))


def test_generalized_reduction_non_power_of_two(ctx, ref_ctx):
    """13 tiles (trees of 1 + 4 + 8), exactly 12 pairwise tasks; the sum
    within 1e-5 of numpy's, and bit for bit the reference runtime's (both
    add the same float32 pairs in the same tree order)."""
    vals = np.random.default_rng(77).standard_normal((13, 8)).astype(
        np.float32)
    outs = []
    for c, pool_cls, mod in ((ctx, DTDTaskpool, A), (ref_ctx, RefPool, RA)):
        tp = pool_cls(c, "genred")
        tiles = [tp.tile_new(vals[i]) for i in range(13)]
        n0 = tp.inserted
        root = mod.generalized_reduction(tp, tiles)
        assert tp.inserted - n0 == 12
        _drain(c, tp)
        outs.append(np.asarray(root.data.newest_copy().payload))
    np.testing.assert_allclose(outs[0], vals.sum(axis=0), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(outs[0], outs[1])


def _matmul_red(left, right):
    return left @ right


def test_generalized_reduction_non_commutative_op(ctx):
    """The association order is left to right: a matrix product over 5
    tiles (trees of 1 + 4) is tiles[0] @ ... @ tiles[4], rtol 1e-4."""
    rng = np.random.default_rng(88)
    mats = [rng.standard_normal((4, 4)).astype(np.float32) * 0.5
            for _ in range(5)]
    tp = DTDTaskpool(ctx, "genred-mm")
    tiles = [tp.tile_new(m) for m in mats]
    root = A.generalized_reduction(tp, tiles, op=_matmul_red)
    _drain(ctx, tp)
    out = np.asarray(root.data.newest_copy().payload)
    ref = functools.reduce(lambda a, b: a @ b, mats)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_tile_algorithms_on_the_device_module():
    """``device_cuda_over_cpu``: the getrf and geqrf DAGs and the tensor-
    bodied apps run every task on the CUDA device module; the host-code
    merge sort stays on the CPU chore."""
    mca.set("device_cuda_over_cpu", True)
    mca.set("device_load_balance_allow_cpu", False)
    c = Context(nb_cores=1, device="cpu")
    try:
        dev = next(d for d in c.devices.devices if isinstance(d, CUDADevice))
        a = L.make_dd(64, seed=2)
        n_lu, M = _factor(c, DTDTaskpool, TiledMatrix, L.insert_getrf_tasks,
                          a, 16, "LUd")
        Lf, U = L.unpack_lu(M.to_dense())
        np.testing.assert_allclose(Lf @ U, a, rtol=1e-4, atol=1e-3)
        q = np.random.default_rng(3).standard_normal((64, 64)).astype(
            np.float32)
        n_qr, M = _factor(c, DTDTaskpool, TiledMatrix, Q.insert_geqrf_tasks,
                          q, 16, "QRd")
        R = np.triu(M.to_dense())
        np.testing.assert_allclose(R.T @ R, q.T @ q, rtol=1e-3, atol=1e-3)
        tp = DTDTaskpool(c, "genred-dev")
        tiles = [tp.tile_new(np.full((4,), float(i), np.float32))
                 for i in range(6)]
        root = A.generalized_reduction(tp, tiles)
        ms = A.merge_sort(tp, [np.array([3.0, 1.0]), np.array([2.0])])
        _drain(c, tp)
        assert dev.executed_tasks == n_lu + n_qr + 5
        assert np.array_equal(np.asarray(root.data.newest_copy().payload),
                              np.full((4,), 15.0))
        assert np.asarray(ms.data.newest_copy().payload).tolist() == \
            [1.0, 2.0, 3.0]
    finally:
        c.fini()
        mca.params.unset("device_cuda_over_cpu")
        mca.params.unset("device_load_balance_allow_cpu")


@pytest.mark.parametrize("algo", ["getrf", "geqrf"])
def test_factorization_gates_reject_a_skipped_update(ctx, algo):
    """The gates of ``chip_smoke.py`` on the CPU at N = 2048 in 256^2 tiles:
    a correct DAG passes ||LU - A|| / ||A|| < N 2^-24 (getrf, on the smoke
    run's matrix 2I + (G + 11^T)/sqrt(N)) and ||R^T R - A^T A|| / ||A^T A||
    < N 2^-24 (geqrf, on G), and the same DAG with its first trailing
    update (GEMM, TSMQR) left out lands at least 10x above it. ``-s``
    prints both residuals."""
    import math
    import chip_smoke as CS
    n, ts = 2048, 256
    g = torch.Generator().manual_seed(2)
    a = (torch.randn(n, n, generator=g) + 1.0) / math.sqrt(n)
    a.diagonal().add_(2.0)
    if algo == "geqrf":
        a = torch.randn(n, n, generator=g)
    insert, fault = {"getrf": (L.insert_getrf_tasks, "GEMM"),
                     "geqrf": (Q.insert_geqrf_tasks, "TSMQR")}[algo]
    resids = []
    for skip in (None, (fault, 1)):
        M = TiledMatrix(f"{algo}{skip is None}", n, n, ts, ts)
        M.fill(lambda m, k: a[m * ts:(m + 1) * ts, k * ts:(k + 1) * ts])
        tp = DTDTaskpool(ctx, algo)
        insert(CS.SkipOne(tp, *skip) if skip else tp, M)
        _drain(ctx, tp)
        packed = torch.from_numpy(M.to_dense())
        resids.append(CS.lu_residual(torch, packed, a) if algo == "getrf"
                      else CS.qr_residuals(torch, packed, a, ts)[0])
    gate = n * 2.0 ** -24
    print(f"{algo} N={n}: residual {resids[0]:.3e}, with the first {fault} "
          f"left out {resids[1]:.3e}, gate {gate:.3e}")
    assert resids[0] < gate <= resids[1] / 10
