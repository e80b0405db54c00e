"""The reference's SPMD tests (``tests/test_spmd.py``) on the port: the same
seeded inputs through the JAX functions on the reference's 8-device CPU
mesh and through the port on an 8-rank gloo group over CPU tensors (one
:class:`RankPool` for the file), compared at the reference tests' own
tolerances. The rank bodies are in ``tests/_torch_mesh_jobs.py``."""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

import _torch_mesh_jobs as J
from parsec_tpu.parallel import spmd as JS
from parsec_tpu.ops.potrf import make_spd
from parsec_tpu_torch.parallel import spmd
from parsec_tpu_torch.parallel.multihost import RankPool

#: one job's deadline (a hung collective fails the test well inside the
#: suite's limit)
JOB_S = 120.0


@pytest.fixture(scope="module")
def pool():
    p = RankPool(8, "cpu", timeout=JOB_S)
    yield p
    p.close()


def _first(results):
    return next(r for r in results if r is not None)


def test_best_grid():
    assert spmd.best_grid(8) == (2, 4) == JS.best_grid(8)
    assert spmd.best_grid(4) == (2, 2)
    assert spmd.best_grid(7) == (1, 7)
    assert spmd.best_grid(16) == (4, 4)


def test_make_mesh_shape(pool):
    out = pool.run(J.mesh_shape, 8)
    assert out[0][:2] == ((2, 4), ("p", "q"))
    assert tuple(JS.make_mesh(8).devices.shape) == (2, 4)
    # row-major: rank r sits at (r // 4, r % 4)
    assert [tuple(o[2]) for o in out] == [(r // 4, r % 4) for r in range(8)]
    # a mesh of the first 4 ranks: the others are outside it
    four = pool.run(J.mesh_shape, 4)
    assert four[0][0] == (2, 2) and four[5][2] is None


def _check_gemm(res, A, B, ref, nranks):
    got = _first(res)
    np.testing.assert_allclose(got["C"], A @ B, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["C"], np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    assert got["spec"] == ("p", "q")
    assert sum(r is not None for r in res) == nranks


def test_distributed_gemm_allgather(pool):
    rng = np.random.default_rng(0)
    A = rng.standard_normal((64, 32)).astype(np.float32)
    B = rng.standard_normal((32, 64)).astype(np.float32)
    ref = JS.distributed_gemm_allgather(A, B, JS.make_mesh(8))
    res = pool.run(J.gemm, "allgather", 8, A, B)
    _check_gemm(res, A, B, ref, 8)
    assert _first(res)["local"] == (32, 16)
    assert "all_gather/gloo" in _first(res)["stats"]


def test_distributed_gemm_cannon_square_mesh(pool):
    rng = np.random.default_rng(1)
    A = rng.standard_normal((32, 32)).astype(np.float32)
    B = rng.standard_normal((32, 32)).astype(np.float32)
    ref = JS.distributed_gemm(A, B, JS.make_mesh(4))      # 2x2: Cannon
    res = pool.run(J.gemm, "cannon", 4, A, B)
    _check_gemm(res, A, B, ref, 4)
    # the skews and the T = 2 shifts of each operand rode send/recv
    assert _first(res)["stats"]["send_recv/gloo"]["calls"] == 2 + 2 * 2


def test_distributed_gemm_nonsquare_fallback(pool):
    rng = np.random.default_rng(2)
    A = rng.standard_normal((32, 32)).astype(np.float32)
    B = rng.standard_normal((32, 32)).astype(np.float32)
    ref = JS.distributed_gemm(A, B, JS.make_mesh(8))      # 2x4: all-gather
    res = pool.run(J.gemm, "cannon", 8, A, B)
    _check_gemm(res, A, B, ref, 8)
    assert "send_recv/gloo" not in _first(res)["stats"]


def test_distributed_potrf(pool):
    n = 64
    A = make_spd(n, seed=3)
    ref = np.asarray(JS.distributed_potrf(A, JS.make_mesh(8), block=16))
    L = _first(pool.run(J.potrf, 8, A, 16))
    np.testing.assert_allclose(L @ L.T, A, rtol=1e-3, atol=1e-3)
    assert np.allclose(L, np.tril(L))
    np.testing.assert_allclose(L, ref, rtol=1e-4, atol=1e-5)
    # a block that does not divide n factors the tail in one piece
    L2 = _first(pool.run(J.potrf, 8, A, 24))
    np.testing.assert_allclose(
        L2, np.asarray(JS.distributed_potrf(A, JS.make_mesh(8), block=24)),
        rtol=1e-4, atol=1e-5)


def test_training_step_composite(pool):
    rng = np.random.default_rng(4)
    A = rng.standard_normal((32, 32)).astype(np.float32)
    B = rng.standard_normal((32, 32)).astype(np.float32)
    C = np.zeros((32, 32), np.float32)
    rC2, rL = JS.training_step(A, B, C, JS.make_mesh(8))
    C2, L = _first(pool.run(J.training_step, 8, A, B, C))
    np.testing.assert_allclose(C2, A @ B, rtol=1e-4, atol=1e-4)
    assert not np.isnan(L).any()
    np.testing.assert_allclose(C2, np.asarray(rC2), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(L, np.asarray(rL), rtol=1e-3, atol=1e-3)


# ------------------------------------------------------- mesh data bridge

def _reference_bridge(a, b, n, ts):
    import parsec_tpu as pt
    from parsec_tpu.data.matrix import TwoDimBlockCyclic
    from parsec_tpu.data.mesh_bridge import from_global, to_global
    from parsec_tpu.dsl.dtd import DTDTaskpool, RW
    from parsec_tpu.ops.gemm import insert_gemm_tasks
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("x", "y"))
    ctx = pt.Context(nb_cores=1)
    try:
        A = TwoDimBlockCyclic("mbA", n, n, ts, ts, P=1, Q=1)
        B = TwoDimBlockCyclic("mbB", n, n, ts, ts, P=1, Q=1)
        C = TwoDimBlockCyclic("mbC", n, n, ts, ts, P=1, Q=1)
        A.fill(lambda m, k: a[m*ts:(m+1)*ts, k*ts:(k+1)*ts])
        B.fill(lambda m, k: b[m*ts:(m+1)*ts, k*ts:(k+1)*ts])
        C.fill(lambda m, k: np.zeros((ts, ts), np.float32))
        tp = DTDTaskpool(ctx, "bridge-gemm")
        insert_gemm_tasks(tp, A, B, C)
        tp.wait(timeout=60)
        tp.close()
        ctx.wait(timeout=30)
        g = to_global(C, mesh)
        from_global(C, jax.jit(lambda x: 2.0 * x)(g))
        tp2 = DTDTaskpool(ctx, "bridge-post")
        for m in range(C.mt):
            tp2.insert_task(lambda x: x + 1.0, (tp2.tile_of(C, m, 0), RW))
        tp2.wait(timeout=30)
        tp2.close()
        ctx.wait(timeout=30)
        return np.asarray(C.to_dense())
    finally:
        ctx.fini()


def test_mesh_bridge_roundtrip_and_spmd_handoff(pool):
    """Task-world matrices hand off to a mesh program and back: a DTD GEMM
    writes C on every rank, to_global shards it over the 2x4 mesh, a mesh
    program scales it, from_global makes the result visible to a second
    taskpool."""
    n, ts = 64, 16
    rng = np.random.default_rng(31)
    a = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, n)).astype(np.float32)
    res = pool.run(J.bridge_roundtrip, a, b, n, ts)
    expect = 2.0 * (a @ b)
    expect[:, :ts] += 1.0          # the second pool touched column 0
    ref = _reference_bridge(a, b, n, ts)
    for spec, got in res:
        assert spec == ("x", "y")
        np.testing.assert_allclose(got, expect, rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_mesh_bridge_redistribute(pool):
    """Layout change through the resharding seam: 16x16 tiles -> 8x8
    tiles, values preserved bit for bit; mismatched extents refused."""
    from parsec_tpu.data.matrix import TwoDimBlockCyclic
    from parsec_tpu.data.mesh_bridge import redistribute_mesh
    n = 64
    src_v = np.random.default_rng(33).standard_normal((n, n)).astype(
        np.float32)
    src = TwoDimBlockCyclic("rsrc", n, n, 16, 16, P=1, Q=1)
    dst = TwoDimBlockCyclic("rdst", n, n, 8, 8, P=1, Q=1)
    src.fill(lambda m, k: src_v[m*16:(m+1)*16, k*16:(k+1)*16])
    redistribute_mesh(src, dst, Mesh(np.array(jax.devices()[:8]).reshape(
        2, 4), ("x", "y")))
    for got, refused in pool.run(J.bridge_redistribute, src_v):
        np.testing.assert_array_equal(got, src_v)
        np.testing.assert_array_equal(got, np.asarray(dst.to_dense()))
        assert "extents differ" in refused
