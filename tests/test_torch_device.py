"""The port's CUDA device module in its CPU test mode.

``--mca device_cuda_over_cpu 1`` on a ``device="cpu"`` context registers the
device module over CPU tensors with events that complete at once, so the
whole device logic runs here: enqueue and manager drive, version-checked
stage-in, the LRU byte budget with eviction and write-back, reader pins,
the epilog's version bumps, batched dispatch. These mirror the reference's
tests/test_device_async.py.
"""

import numpy as np
import pytest
import torch

from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.data.data import (COHERENCY_INVALID, COHERENCY_OWNED,
                                        COHERENCY_SHARED)
from parsec_tpu_torch.data.matrix import TiledMatrix, collection_from_numpy
from parsec_tpu_torch.device.cuda import CUDADevice
from parsec_tpu_torch.dsl.dtd import DTDTaskpool, READ, RW
from parsec_tpu_torch.ops.gemm import insert_gemm_tasks
from parsec_tpu_torch.ops.potrf import insert_potrf_tasks, make_spd
from parsec_tpu_torch.utils import mca

TILE_BYTES = 16 * 16 * 4


@pytest.fixture()
def dctx():
    mca.set("device_cuda_over_cpu", True)
    mca.set("device_load_balance_allow_cpu", False)
    c = Context(nb_cores=1, device="cpu")
    try:
        yield c
    finally:
        c.fini()
        mca.params.unset("device_cuda_over_cpu")
        mca.params.unset("device_load_balance_allow_cpu")


def _dev(ctx) -> CUDADevice:
    devs = [d for d in ctx.devices.devices if isinstance(d, CUDADevice)]
    assert devs, "device module did not register over the CPU"
    return devs[0]


def _drain(ctx, tp):
    tp.wait(); tp.close(); ctx.wait()


def test_over_cpu_mode_only_when_asked():
    c = Context(nb_cores=1, device="cpu")
    try:
        assert not any(isinstance(d, CUDADevice) for d in c.devices.devices)
    finally:
        c.fini()


def test_async_device_pipeline(dctx):
    dev = _dev(dctx)
    A = TiledMatrix("AD", 32, 32, 16, 16)
    dense = np.random.default_rng(40).standard_normal((32, 32)).astype(np.float32)
    A.fill(lambda m, n: dense[m*16:(m+1)*16, n*16:(n+1)*16])
    tp = DTDTaskpool(dctx, "dev")
    for m in range(2):
        for n in range(2):
            tp.insert_task(lambda x: x * 2.0, (tp.tile_of(A, m, n), RW))
    _drain(dctx, tp)
    np.testing.assert_allclose(A.to_dense(), dense * 2.0, rtol=1e-6)
    assert dev.executed_tasks == 4
    assert dev.transfer_in_bytes == 4 * TILE_BYTES    # staged tiles in
    assert len(dev._lru) == 4                         # resident copies tracked


def test_version_checked_stage_in_skips_second_transfer(dctx):
    """A chain over one tile stages it in once: later tasks find the device
    copy at the newest version."""
    dev = _dev(dctx)
    A = TiledMatrix("AR", 16, 16, 16, 16)
    A.fill(lambda m, n: np.ones((16, 16), np.float32))
    tp = DTDTaskpool(dctx, "resident")
    t = tp.tile_of(A, 0, 0)
    for _ in range(4):
        tp.insert_task(lambda x: x + 1.0, (t, RW))
    _drain(dctx, tp)
    assert dev.transfer_in_bytes == TILE_BYTES
    assert np.allclose(t.data.newest_copy().payload.numpy(), 5.0)


def test_host_write_forces_a_new_stage_in(dctx):
    """A newer host version (a refill) makes the resident copy stale."""
    dev = _dev(dctx)
    A = TiledMatrix("AS", 16, 16, 16, 16)
    A.fill(lambda m, n: np.ones((16, 16), np.float32))
    for val in (2.0, 3.0):
        tp = DTDTaskpool(dctx, "restage")
        tp.insert_task(lambda x: x * 2.0, (tp.tile_of(A, 0, 0), RW))
        _drain(dctx, tp)
        A.fill(lambda m, n: np.full((16, 16), val, np.float32))
    assert dev.transfer_in_bytes == 2 * TILE_BYTES


def test_epilog_bumps_versions(dctx):
    dev = _dev(dctx)
    A = TiledMatrix("AV", 16, 16, 16, 16)
    A.fill(lambda m, n: np.ones((16, 16), np.float32))
    data = A.data_of(0, 0)
    v0 = data.version
    tp = DTDTaskpool(dctx, "ver")
    for _ in range(3):
        tp.insert_task(lambda x: x + 1.0, (tp.tile_of(A, 0, 0), RW))
    _drain(dctx, tp)
    dcopy = data.get_copy(dev.device_index)
    assert data.version == v0 + 3
    assert dcopy.version == data.version
    assert dcopy.coherency_state == COHERENCY_OWNED
    assert data.get_copy(0).version == v0          # host copy is older
    assert data.newest_copy() is dcopy


def test_eviction_under_pressure_writes_owned_copies_back(dctx):
    """A budget of 3 tiles forces LRU eviction; evicted owned copies write
    their newest version back to the host first."""
    dev = _dev(dctx)
    dev.set_budget(3 * TILE_BYTES)
    A = TiledMatrix("AE", 16 * 8, 16, 16, 16)
    A.fill(lambda m, n: np.full((16, 16), float(m), np.float32))
    tp = DTDTaskpool(dctx, "evict")
    for m in range(8):
        tp.insert_task(lambda x: x + 0.5, (tp.tile_of(A, m, 0), RW))
    _drain(dctx, tp)
    for m in range(8):
        assert np.allclose(A.data_of(m, 0).newest_copy().payload.numpy(),
                           m + 0.5)
    assert dev.evictions >= 5
    assert dev._resident_bytes <= dev._budget
    assert dev.transfer_out_bytes >= 5 * TILE_BYTES   # write-backs
    datas = [A.data_of(m, 0) for m in range(8)]
    evicted = [d for d in datas if d.get_copy(dev.device_index)
               .coherency_state == COHERENCY_INVALID]
    assert len(evicted) == 5     # the three last written stay resident
    for d in evicted:            # ... the others carried their version home
        assert d.get_copy(0).version == d.version
        assert d.get_copy(0).coherency_state == COHERENCY_SHARED


def test_pinned_copies_survive_eviction(dctx):
    """A reader pin protects a device copy from the eviction walk
    (ref: the readers guard of device_gpu.c:1210)."""
    dev = _dev(dctx)
    A = TiledMatrix("PIN", 32, 16, 16, 16)
    A.fill(lambda m, n: np.full((16, 16), float(m + 1), np.float32))
    tp = DTDTaskpool(dctx, "pin")
    t0, t1 = tp.tile_of(A, 0, 0), tp.tile_of(A, 1, 0)
    tp.insert_task(lambda x: x * 2.0, (t0, RW))
    tp.insert_task(lambda x: x * 3.0, (t1, RW))
    _drain(dctx, tp)
    c0 = t0.data.get_copy(dev.device_index)
    c1 = t1.data.get_copy(dev.device_index)
    dev.pin_copy(c0)
    try:
        freed = dev.evict_bytes(dev._resident_bytes)   # demand everything
        assert dev.pinned_skips > 0
        assert c0.payload is not None and c0.coherency_state != COHERENCY_INVALID
        assert c1.payload is None
        assert freed == TILE_BYTES
    finally:
        dev.unpin_copy(c0)
    dev.evict_bytes(dev._resident_bytes)
    assert c0.payload is None
    assert np.allclose(t0.data.newest_copy().payload.numpy(), 2.0)


def _acc(a, x):
    return a + x


def test_inflight_pins_balance_and_pressure_correctness(dctx):
    """Budget of ~2 tiles while many live tiles flow through the device:
    evictions happen, every reader pin is released at epilog, and the
    result is right."""
    dev = _dev(dctx)
    dev.set_budget(2 * TILE_BYTES + 64)
    rows = 8
    A = TiledMatrix("PRS", 16 * rows, 16, 16, 16)
    dense = np.stack([np.full((16, 16), float(m), np.float32)
                      for m in range(rows)])
    A.fill(lambda m, n: dense[m])
    tp = DTDTaskpool(dctx, "pressure")
    acc = tp.tile_new(np.zeros((16, 16), np.float32))
    for m in range(rows):
        tp.insert_task(_acc, (acc, RW), (tp.tile_of(A, m, 0), READ))
    _drain(dctx, tp)
    np.testing.assert_allclose(acc.data.newest_copy().payload.numpy(),
                               dense.sum(axis=0), rtol=1e-6)
    assert dev.evictions > 0
    for m in range(rows):
        assert all(c.readers == 0 for c in A.data_of(m, 0).copies.values())
    assert all(c.readers == 0 for c in acc.data.copies.values())


def test_batched_dispatch(dctx):
    """Independent same-class tasks collapse into one dispatch (ref:
    parsec_gpu_task_collect_batch). Holding the manager lock during the
    enqueue models a busy card accumulating work."""
    dev = _dev(dctx)
    A = TiledMatrix("AB", 16 * 8, 16, 16, 16)
    A.fill(lambda m, n: np.full((16, 16), float(m), np.float32))
    tp = DTDTaskpool(dctx, "batch")

    def scale(x):
        return x * 3.0

    for m in range(8):
        tp.insert_task(scale, (tp.tile_of(A, m, 0), RW), batch=True)
    with dev._manager_lock:
        dctx._progress_loop(dctx.streams[0],
                            until=lambda: len(dev._pending) == 8, timeout=10)
    _drain(dctx, tp)
    for m in range(8):
        assert np.allclose(A.data_of(m, 0).newest_copy().payload.numpy(),
                           3.0 * m)
    assert dev.batched_dispatches >= 1
    assert dev.executed_tasks == 8


def test_gemm_and_potrf_run_on_the_device_module(dctx):
    """The slice's DAGs placed on the device module (CPU may not take
    tasks): every task executes there, with correct results."""
    dev = _dev(dctx)
    rng = np.random.default_rng(8)
    a = rng.standard_normal((64, 640)).astype(np.float32)
    b = rng.standard_normal((640, 64)).astype(np.float32)
    A, B = collection_from_numpy("A", a, 32, 32), collection_from_numpy("B", b, 32, 32)
    C = collection_from_numpy("C", np.zeros((64, 64), np.float32), 32, 32)
    tp = DTDTaskpool(dctx, "gemm")
    n = insert_gemm_tasks(tp, A, B, C, batch_k=True)
    _drain(dctx, tp)
    np.testing.assert_allclose(C.to_dense(), a.astype(np.float64) @ b,
                               rtol=1e-4, atol=1e-3)
    spd = make_spd(128, seed=4)
    P = collection_from_numpy("P", spd, 32, 32)
    tp = DTDTaskpool(dctx, "potrf")
    n += insert_potrf_tasks(tp, P)
    _drain(dctx, tp)
    L = np.tril(P.to_dense())
    assert np.abs(L @ L.T - spd).max() < 1e-3
    assert dev.executed_tasks == n
    assert dctx.devices.cpu.executed_tasks == 0


def test_bf16_tiles_through_the_device_module(dctx):
    rng = np.random.default_rng(9)
    a = rng.standard_normal((32, 64)).astype(np.float32)
    b = rng.standard_normal((64, 32)).astype(np.float32)
    A = collection_from_numpy("A", a, 32, 32, dtype=torch.bfloat16)
    B = collection_from_numpy("B", b, 32, 32, dtype=torch.bfloat16)
    C = collection_from_numpy("C", np.zeros((32, 32)), 32, 32,
                              dtype="bfloat16")
    tp = DTDTaskpool(dctx, "bf16")
    insert_gemm_tasks(tp, A, B, C, batch_k=True)
    _drain(dctx, tp)
    assert C.data_of(0, 0).newest_copy().payload.dtype == torch.bfloat16
    ab = A.to_dense().astype(np.float64) @ B.to_dense()
    np.testing.assert_allclose(C.to_dense(), ab, rtol=2e-2, atol=0.25)


def test_data_flush_brings_the_newest_version_home(dctx):
    """parsec_dtd_data_flush_all: after device writes, a flush task lands
    each tile's newest value in its host copy, which becomes the newest."""
    dev = _dev(dctx)
    A = TiledMatrix("AF", 32, 16, 16, 16)
    A.fill(lambda m, n: np.full((16, 16), float(m), np.float32))
    tp = DTDTaskpool(dctx, "flush")
    for m in range(2):
        tp.insert_task(lambda x: x + 10.0, (tp.tile_of(A, m, 0), RW))
    tp.data_flush_all(A)
    _drain(dctx, tp)
    for m in range(2):
        d = A.data_of(m, 0)
        host = d.get_copy(0)
        assert d.newest_copy() is host
        assert host.version == d.version
        assert d.get_copy(dev.device_index).version < d.version
        assert np.allclose(host.payload.numpy(), m + 10.0)


def test_device_module_stress_with_worker_threads():
    """More worker threads than the DAG's width, a short switch interval and
    a 3-tile budget: the manager try-lock, the reader pins and the LRU
    bookkeeping stay consistent (every pin released, every result right)."""
    import sys
    mca.set("device_cuda_over_cpu", True)
    mca.set("device_load_balance_allow_cpu", False)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    ctx = Context(nb_cores=6, device="cpu")
    try:
        dev = _dev(ctx)
        dev.set_budget(3 * TILE_BYTES)
        rows = 12
        A = TiledMatrix("ST", 16 * rows, 16, 16, 16)
        A.fill(lambda m, n: np.full((16, 16), float(m), np.float32))
        tp = DTDTaskpool(ctx, "stress")
        acc = tp.tile_new(np.zeros((16, 16), np.float32))
        for step in range(5):
            for m in range(rows):
                tp.insert_task(lambda x: x + 1.0, (tp.tile_of(A, m, 0), RW))
            for m in range(rows):
                tp.insert_task(_acc, (acc, RW), (tp.tile_of(A, m, 0), READ))
        assert tp.wait(timeout=120)
        tp.close()
        ctx.wait(timeout=60)
        assert tp.executed == tp.inserted == 5 * 2 * rows
        # tile m reads m+1 .. m+5 into acc over the five steps
        want = sum(m + s for m in range(rows) for s in range(1, 6))
        np.testing.assert_allclose(acc.data.newest_copy().payload.numpy(),
                                   want)
        for m in range(rows):
            d = A.data_of(m, 0)
            assert np.allclose(d.newest_copy().payload.numpy(), m + 5.0)
            assert all(c.readers == 0 for c in d.copies.values())
        assert dev.evictions > 0 and dev.executed_tasks == tp.executed
    finally:
        sys.setswitchinterval(old)
        ctx.fini()
        mca.params.unset("device_cuda_over_cpu")
        mca.params.unset("device_load_balance_allow_cpu")
