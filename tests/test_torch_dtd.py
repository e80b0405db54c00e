"""The DTD slice through both runtimes.

The same matrices, made with numpy from a seed, go through the reference
runtime and the port (on a CPU context) via ``collection_from_numpy``; the
GEMM uses a k-chain of 20 so that the chain body (the Pallas kernel in the
reference, ``gemm_chain`` in the port) runs. Ordering cases carried over from
the reference's DTD tests run on the port alone.
"""

import numpy as np
import pytest
import torch

from parsec_tpu.core.context import Context as RefContext
from parsec_tpu.data.matrix import TwoDimBlockCyclic as RefMatrix
from parsec_tpu.dsl.dtd import DTDTaskpool as RefPool
from parsec_tpu.ops.gemm import insert_gemm_tasks as ref_insert_gemm
from parsec_tpu.ops.potrf import insert_potrf_tasks as ref_insert_potrf
from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.data.matrix import TiledMatrix, collection_from_numpy
from parsec_tpu_torch.dsl.dtd import DTDTaskpool, READ, RW
from parsec_tpu_torch.ops.gemm import insert_gemm_tasks
from parsec_tpu_torch.ops.potrf import insert_potrf_tasks, make_spd


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


def _ref_collection(name, dense, ts):
    M = RefMatrix(name, dense.shape[0], dense.shape[1], ts, ts, P=1, Q=1)
    M.fill(lambda m, n: dense[m * ts:(m + 1) * ts, n * ts:(n + 1) * ts])
    return M


def _run(ctx, pool_cls, insert, *args, **kw):
    tp = pool_cls(ctx, "x")
    n = insert(tp, *args, **kw)
    tp.wait()
    tp.close()
    ctx.wait()
    return n, tp


@pytest.mark.parametrize("batch_k", [True, False])
def test_gemm_matches_reference_runtime(ctx, ref_ctx, batch_k):
    """A 64x640 by 640x64 GEMM in 32^2 tiles (kt = 20) through both
    runtimes, rtol 1e-4."""
    rng = np.random.default_rng(11)
    a = rng.standard_normal((64, 640)).astype(np.float32)
    b = rng.standard_normal((640, 64)).astype(np.float32)
    c0 = rng.standard_normal((64, 64)).astype(np.float32)
    ref_mats = [_ref_collection(n, d, 32) for n, d in
                (("A", a), ("B", b), ("C", c0))]
    n_ref, _ = _run(ref_ctx, RefPool, ref_insert_gemm, *ref_mats,
                    batch_k=batch_k)
    mats = [collection_from_numpy(n, d, 32, 32) for n, d in
            (("A", a), ("B", b), ("C", c0))]
    n_port, tp = _run(ctx, DTDTaskpool, insert_gemm_tasks, *mats,
                      batch_k=batch_k)
    assert n_port == n_ref == (4 if batch_k else 80)
    assert tp.executed == n_port
    want = ref_mats[2].to_dense()
    np.testing.assert_allclose(mats[2].to_dense(), want, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(want, c0 + a.astype(np.float64) @ b,
                               rtol=1e-4, atol=1e-3)


def test_gemm_chain_body_takes_the_kernel_path(ctx, monkeypatch):
    """kt = 20 > 16: every GEMM_K task stacks its tiles and calls
    gemm_chain once (the routing of the reference's chain body)."""
    from parsec_tpu_torch.ops import gemm as gemm_mod
    calls = []
    real = gemm_mod.gemm_chain

    def spy(c, a, b):
        calls.append(tuple(a.shape))
        return real(c, a, b)

    monkeypatch.setattr(gemm_mod, "gemm_chain", spy)
    rng = np.random.default_rng(2)
    A = collection_from_numpy("A", rng.standard_normal((64, 640)), 32, 32,
                              dtype=torch.float32)
    B = collection_from_numpy("B", rng.standard_normal((640, 64)), 32, 32,
                              dtype=torch.float32)
    C = collection_from_numpy("C", np.zeros((64, 64), np.float32), 32, 32)
    _run(ctx, DTDTaskpool, insert_gemm_tasks, A, B, C, batch_k=True)
    assert calls == [(20, 32, 32)] * 4


def test_potrf_matches_reference_runtime(ctx, ref_ctx):
    """POTRF at 256 in 64^2 tiles: L within atol 1e-4, same task counts."""
    spd = make_spd(256, seed=11)
    P_ref = _ref_collection("P", spd, 64)
    n_ref, tp_ref = _run(ref_ctx, RefPool, ref_insert_potrf, P_ref)
    P = collection_from_numpy("P", spd, 64, 64)
    n_port, tp = _run(ctx, DTDTaskpool, insert_potrf_tasks, P)
    assert n_port == n_ref == 20
    assert tp.executed == tp_ref.executed == n_port
    L, L_ref = np.tril(P.to_dense()), np.tril(P_ref.to_dense())
    np.testing.assert_allclose(L, L_ref, atol=1e-4)
    assert np.abs(L @ L.T - spd).max() < 1e-3


def test_potrf_priorities_order_ready_tasks(ctx):
    """Ready tasks leave the (default lfq) scheduler highest priority first,
    the property POTRF's critical-path priorities rely on."""
    A = TiledMatrix("PR", 4 * 6, 4, 4, 4)
    tp = DTDTaskpool(ctx, "prio")
    order = []

    def body(x, tag):
        order.append(tag)

    prios = [3, 50, 7, 1000, 20, 0]
    for m, p in enumerate(prios):
        tp.insert_task(body, (tp.tile_of(A, m, 0), READ), p, priority=p,
                       jit=False)
    tp.wait(); tp.close(); ctx.wait()
    assert order == sorted(prios, reverse=True)


# --- ordering cases carried over from the reference's tests/test_dtd.py ---

def test_simple_chain_rw(ctx):
    """N sequential increments of one tile: the RAW chain serializes."""
    A = TiledMatrix("A", 8, 8, 8, 8)
    tp = DTDTaskpool(ctx, "chain")
    t = tp.tile_of(A, 0, 0)
    for _ in range(32):
        tp.insert_task(lambda x: x + 1.0, (t, RW))
    tp.wait(); tp.close(); ctx.wait()
    assert np.allclose(A.to_dense(), 32)


def test_war_read_then_write(ctx):
    """Readers of version k all run before the writer of k+1 (WAR)."""
    A = TiledMatrix("A", 4, 4, 4, 4)
    A.fill(lambda m, n: np.full((4, 4), 7.0, np.float32))
    tp = DTDTaskpool(ctx, "war")
    t = tp.tile_of(A, 0, 0)
    seen = []

    def reader(x):
        seen.append(float(x[0, 0]))

    for _ in range(4):
        tp.insert_task(reader, (t, READ), jit=False)
    tp.insert_task(lambda x: x * 0.0, (t, RW))
    tp.wait(); tp.close(); ctx.wait()
    assert seen == [7.0] * 4
    assert np.allclose(A.to_dense(), 0.0)


def test_waw_writes_land_in_insert_order(ctx):
    """Successive writers of one tile run in program order (WAW)."""
    A = TiledMatrix("A", 4, 4, 4, 4)
    tp = DTDTaskpool(ctx, "waw")
    t = tp.tile_of(A, 0, 0)
    for v in range(1, 6):
        tp.insert_task(lambda x, v: x * 0.0 + v, (t, RW), float(v))
    tp.wait(); tp.close(); ctx.wait()
    assert np.allclose(A.to_dense(), 5.0)
    assert t.data.version == 5


def test_reduction_tree(ctx):
    """Pairwise reduction over 8 tiles (ref: dtd_test_allreduce shape)."""
    A = TiledMatrix("A", 32, 4, 4, 4)
    A.fill(lambda m, n: np.full((4, 4), float(m), np.float32))
    tp = DTDTaskpool(ctx, "reduce")
    tiles = [tp.tile_of(A, m, 0) for m in range(8)]
    stride = 1
    while stride < 8:
        for i in range(0, 8, 2 * stride):
            tp.insert_task(lambda d, s: d + s, (tiles[i], RW),
                           (tiles[i + stride], READ))
        stride *= 2
    tp.wait(); tp.close(); ctx.wait()
    assert np.allclose(tiles[0].data.newest_copy().payload.numpy(),
                       sum(range(8)))


def test_value_args_and_new_tile(ctx):
    """By-value params + parsec_dtd_tile_new scratch tiles."""
    tp = DTDTaskpool(ctx, "vals")
    t = tp.tile_new((4, 4))
    tp.insert_task(lambda x, a, b: x + a * b, (t, RW), 3.0, 4.0)
    tp.wait(); tp.close(); ctx.wait()
    assert np.allclose(t.data.newest_copy().payload.numpy(), 12.0)


def test_window_flow_control(ctx):
    """Insertion beyond the window blocks and helps execute
    (ref: parsec_dtd_window_size)."""
    A = TiledMatrix("A", 4, 4, 4, 4)
    tp = DTDTaskpool(ctx, "win")
    tp.window_size, tp.threshold_size = 8, 4
    t = tp.tile_of(A, 0, 0)
    for _ in range(40):
        tp.insert_task(lambda x: x + 1.0, (t, RW))
    assert tp.window_stalls > 0
    tp.wait(); tp.close(); ctx.wait()
    assert np.allclose(A.to_dense(), 40.0)
