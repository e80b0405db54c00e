"""The port's device pipeline with the native device lane, in the CPU test
mode (``--mca device_cuda_over_cpu 1``): the reference's
tests/test_device_async.py on the port.

Exercises the interpreted device path — kernel_scheduler enqueue, manager
drive, version-checked stage-in through the C coherency table, LRU
residency with its zone ledger, event polling, epilog write-back, batched
dispatch — and the native device lane (``csrc/ptdev.cpp``): PTG device
pools surfacing onto the lane, the lane's dispatch and retire, the
``CohTable`` policy units, eviction races, and the engine-level ``ptdtd``
wiring (DTD pools stay on the interpreted device module). On the CPU the
lane has no stream and each batch's event is complete at once; the card
tests of the same contract are in tests/test_torch_cuda.py.
"""

import threading
import time

import numpy as np
import pytest

from parsec_tpu_torch import native as native_mod
from parsec_tpu_torch.core import costmodel
from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.data.data import COHERENCY_INVALID, data_from_array
from parsec_tpu_torch.data.matrix import TiledMatrix
from parsec_tpu_torch.device.cuda import CUDADevice
from parsec_tpu_torch.dsl.dtd import DTDTaskpool, READ, RW
from parsec_tpu_torch.utils import mca


@pytest.fixture(autouse=True)
def _fresh_cost_model():
    """The online cost model is process-global by design; every test here
    starts from a cold one (the reference resets its model per test in its
    conftest)."""
    yield
    costmodel.model.reset()


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


def _host(data):
    return np.asarray(data.newest_copy().payload)


def test_async_device_pipeline(dctx):
    dev = _dev(dctx)
    A = TiledMatrix("AD", 32, 32, 16, 16)
    dense = np.random.default_rng(40).standard_normal(
        (32, 32)).astype(np.float32)
    A.fill(lambda m, n: dense[m*16:(m+1)*16, n*16:(n+1)*16])
    tp = DTDTaskpool(dctx, "dev")
    for m in range(2):
        for n in range(2):
            tp.insert_task(lambda x: x * 2.0, (tp.tile_of(A, m, n), RW))
    _drain(dctx, tp)
    # x * 2.0 is exact in f32: tolerance 0
    np.testing.assert_array_equal(A.to_dense(), dense * 2.0)
    assert dev.executed_tasks == 4
    assert dev.transfer_in_bytes > 0          # staged tiles in
    assert len(dev._lru) > 0                  # resident copies tracked
    assert dev.coh_stats()["coh_misses"] == 4  # the table decided each


def test_device_chain_reuses_resident_tiles(dctx):
    """Second pass over the same tiles must not re-stage (version match)."""
    dev = _dev(dctx)
    A = TiledMatrix("AR", 16, 16, 16, 16)
    A.fill(lambda m, n: np.ones((16, 16), np.float32))
    tp = DTDTaskpool(dctx, "resident")
    t = tp.tile_of(A, 0, 0)
    for _ in range(4):
        tp.insert_task(lambda x: x + 1.0, (t, RW))
    _drain(dctx, tp)
    assert dev.transfer_in_bytes == 16 * 16 * 4   # one initial stage-in
    assert np.all(_host(t.data) == 5.0)
    cs = dev.coh_stats()
    assert cs["coh_misses"] == 1 and cs["coh_hits"] == 3


def test_batched_dispatch(dctx):
    """Independent same-class tasks collapse into one dispatch (ref:
    parsec_gpu_task_collect_batch). The CPU test mode completes work at
    once, so the batch window never fills on its own; holding the manager
    lock during enqueue models a busy card accumulating work."""
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
                            until=lambda: len(dev._pending) == 8,
                            timeout=10)
    _drain(dctx, tp)
    for m in range(8):
        assert np.all(_host(A.data_of(m, 0)) == 3.0 * m)
    assert dev.batched_dispatches >= 1


def test_eviction_under_pressure(dctx):
    """A tiny budget forces LRU eviction with write-back; the zone ledger
    (offsets + occupancy stats) tracks every resident tile."""
    dev = _dev(dctx)
    tile_b = 16 * 16 * 4
    dev.set_budget(3 * tile_b, unit=tile_b)    # room for ~3 tiles
    A = TiledMatrix("AE", 16 * 8, 16, 16, 16)
    A.fill(lambda m, n: np.full((16, 16), float(m), np.float32))
    tp = DTDTaskpool(dctx, "evict")
    for m in range(8):
        tp.insert_task(lambda x: x + 0.5, (tp.tile_of(A, m, 0), RW))
    _drain(dctx, tp)
    for m in range(8):
        assert np.all(_host(A.data_of(m, 0)) == m + 0.5)
    assert dev._resident_bytes <= dev._budget + tile_b
    # the zone ledger: one live segment per resident tile, occupancy within
    # budget, eviction churn visible in the high-water mark
    zs = dev.zone_stats()
    assert len(dev._lru_segs) == len(dev._lru)
    assert zs["in_use_bytes"] == len(dev._lru_segs) * tile_b
    assert zs["in_use_bytes"] <= zs["total_bytes"]
    assert zs["hwm_bytes"] >= zs["in_use_bytes"] > 0
    # the table decided the victims and saw the write-backs
    cs = dev.coh_stats()
    assert cs["evictions"] >= 5 and cs["stage_out_bytes"] >= 5 * tile_b


def test_ptg_body_through_device_module(dctx):
    """PTG ``[type=CUDA]`` bodies route through the device lane; PTG
    intermediates ride as tensors without a backing Data."""
    from parsec_tpu_torch.dsl.ptg.compiler import compile_ptg

    src = """
%global KT
%global descC

STEP(k)
  k = 0 .. KT-1
  : descC(0, 0)
  RW C <- (k == 0) ? descC(0, 0) : C STEP(k-1)
       -> (k < KT-1) ? C STEP(k+1) : descC(0, 0)
BODY [type=CUDA]
  C = C + 1.0
END
"""
    dev = _dev(dctx)
    C = TiledMatrix("PDEV", 8, 8, 8, 8)
    C.fill(lambda m, n: np.zeros((8, 8), np.float32))
    prog = compile_ptg(src, "pdev")
    tp = prog.instantiate(dctx, globals={"KT": 5},
                          collections={"descC": C}, name="pdev")
    dctx.add_taskpool(tp)
    dctx.wait(timeout=30)
    np.testing.assert_array_equal(C.to_dense(), np.full((8, 8), 5.0))
    assert dev.executed_tasks >= 5


def test_pinned_copies_survive_eviction(dctx):
    """An inflight task's reader pin protects its device copies from the
    eviction walks (ref: the readers guard of device_gpu.c:1210); pin_copy
    mirrors the pin into the C table, so C's victim selection honors it."""
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
    assert c0 is not None and c1 is not None
    dev.pin_copy(c0)
    try:
        freed = dev.evict_bytes(dev._resident_bytes)   # demand everything
        assert dev.pinned_skips > 0, "eviction walk never saw the pin"
        assert c0.payload is not None, "pinned copy was evicted"
        assert c0.coherency_state != COHERENCY_INVALID
        assert c1.payload is None, "unpinned copy should have been evicted"
        assert freed > 0
    finally:
        dev.unpin_copy(c0)
    dev.evict_bytes(dev._resident_bytes)
    assert c0.payload is None


def _acc(a, x):
    return a + x


def test_inflight_pins_balance_and_pressure_correctness(dctx):
    """Seeded eviction pressure (budget = ~2 tiles) while a DAG with many
    live tiles runs through the device module: every task's reader pins
    are dropped at epilog, evictions DO happen, and the results are
    right."""
    dev = _dev(dctx)
    tile_bytes = 16 * 16 * 4
    dev.set_budget(2 * tile_bytes + 64, unit=1024)
    n_rows = 8
    A = TiledMatrix("PRS", 16 * n_rows, 16, 16, 16)
    dense = np.stack([np.full((16, 16), float(m), np.float32)
                      for m in range(n_rows)])
    A.fill(lambda m, n: dense[m])
    tp = DTDTaskpool(dctx, "pressure")
    acc = tp.tile_new(np.zeros((16, 16), np.float32))
    for m in range(n_rows):
        tp.insert_task(_acc, (acc, RW), (tp.tile_of(A, m, 0), READ))
    _drain(dctx, tp)
    # small integers: the sum is exact, tolerance 0
    np.testing.assert_array_equal(_host(acc.data), dense.sum(axis=0))
    assert dev.evictions > 0, "budget pressure produced no evictions"
    for m in range(n_rows):
        for c in A.data_of(m, 0).copies.values():
            assert c.readers == 0
    for c in acc.data.copies.values():
        assert c.readers == 0


# ---------------------------------------------------------------------------
# the native device lane (ptdev) + the C-side coherency table
# ---------------------------------------------------------------------------

_MIXED_SRC = """
%global NT
%global DEPTH
%global descA
%global descB

DEVSTEP(i, l)
  i = 0 .. NT-1
  l = 0 .. DEPTH-1
  : descA(0, i)
  RW X <- (l == 0) ? descA(0, i) : Y HOSTSTEP(i, l-1)
       -> Y HOSTSTEP(i, l)
BODY [type=CUDA]
  X = X * 2.0 + l
END

HOSTSTEP(i, l)
  i = 0 .. NT-1
  l = 0 .. DEPTH-1
  : descA(0, i)
  RW Y <- X DEVSTEP(i, l)
       -> (l < DEPTH-1) ? X DEVSTEP(i, l+1) : descB(0, i)
BODY
  Y = Y - 0.5 * i
END
"""


def _mixed_replay(a_cols, nt, depth):
    """Exact numpy replay of the mixed CPU+device DAG."""
    out = []
    for i in range(nt):
        x = a_cols[i].astype(np.float64)
        for l in range(depth):
            x = x * 2.0 + l          # DEVSTEP
            x = x - 0.5 * i          # HOSTSTEP
        out.append(x)
    return out


def _run_mixed(ctx, nt, depth, a_cols, tag):
    from parsec_tpu_torch.dsl.ptg.compiler import compile_ptg
    A = TiledMatrix(f"mxA{tag}", 4, 4 * nt, 4, 4)
    A.fill(lambda m, n: a_cols[n])
    B = TiledMatrix(f"mxB{tag}", 4, 4 * nt, 4, 4)
    B.fill(lambda m, n: np.zeros((4, 4), np.float32))
    prog = compile_ptg(_MIXED_SRC, f"mixed-{tag}")
    tp = prog.instantiate(ctx, globals={"NT": nt, "DEPTH": depth},
                          collections={"descA": A, "descB": B},
                          name=f"mixed-{tag}")
    ctx.add_taskpool(tp)
    ctx.wait(timeout=90)
    return tp, A, B


def test_mixed_dag_parity_lane_on_off(dctx):
    """Randomized mixed CPU+device-body DAG parity: the native execution
    and device lanes on vs the full interpreted FSM + interpreted device
    module — identical completion, final payloads (vs an exact numpy
    replay, rtol 1e-4 as the reference; lane vs FSM rtol 1e-5), data
    versions, and coherency invariants."""
    from parsec_tpu_torch.device.native import PTDEV_STATS
    from parsec_tpu_torch.dsl.ptg.compiler import PTEXEC_STATS
    rng = np.random.default_rng(1234)
    for round_ in range(3):
        nt = int(rng.integers(2, 5))
        depth = int(rng.integers(2, 6))
        a_cols = [rng.standard_normal((4, 4)).astype(np.float32)
                  for _ in range(nt)]
        expect = _mixed_replay(a_cols, nt, depth)

        snap = PTEXEC_STATS.snapshot()
        dsnap = PTDEV_STATS.snapshot()
        tp_on, _A_on, B_on = _run_mixed(dctx, nt, depth, a_cols,
                                        f"on{round_}")
        delta = PTEXEC_STATS.delta(snap)
        ddelta = PTDEV_STATS.delta(dsnap)
        assert tp_on._ptexec_state is not None, "lane leg fell back"
        assert delta["pools_fallback"] == 0 and \
            ddelta["pools_fallback"] == 0, (delta, ddelta)
        assert delta["pools_device"] == 1, delta
        assert ddelta["tasks_engaged"] == nt * depth, ddelta

        mca.set("ptg_native_exec", False)
        try:
            tp_off, _A_off, B_off = _run_mixed(dctx, nt, depth, a_cols,
                                               f"off{round_}")
        finally:
            mca.params.unset("ptg_native_exec")
        assert tp_off._ptexec_state is None

        for i in range(nt):
            on = np.asarray(B_on.data_of(0, i).newest_copy().payload,
                            np.float64)
            off = np.asarray(B_off.data_of(0, i).newest_copy().payload,
                             np.float64)
            np.testing.assert_allclose(on, expect[i], rtol=1e-4)
            np.testing.assert_allclose(on, off, rtol=1e-5)
            # both legs land exactly one write-back per descB tile on top
            # of fill()'s version 1; the newest version is carried by a
            # valid copy with a live payload
            d_on = B_on.data_of(0, i)
            d_off = B_off.data_of(0, i)
            assert d_on.version == d_off.version == 2
            for d in (d_on, d_off):
                best = d.newest_copy()
                assert best is not None and best.payload is not None
                assert best.version == d.version


def test_device_lane_engagement_counters(dctx):
    """A device-bodied pool engages the native device lane end to end —
    pools_fallback == 0, every device task dispatched AND retired through
    ptdev (the graph's dev counters match the lane's), and no coherency
    violation in the table."""
    from parsec_tpu_torch.dsl.ptg.compiler import PTEXEC_STATS
    dev = _dev(dctx)
    rng = np.random.default_rng(7)
    a_cols = [rng.standard_normal((4, 4)).astype(np.float32)
              for _ in range(3)]
    snap = PTEXEC_STATS.snapshot()
    tp, A, _B = _run_mixed(dctx, 3, 4, a_cols, "gate")
    delta = PTEXEC_STATS.delta(snap)
    assert delta["pools_fallback"] == 0 and delta["pools_device"] == 1
    lane = dctx._ptdev
    assert lane is not None and lane is not False
    gstats = tp._ptexec_state["graph"].dev_stats()
    assert gstats["dev_tx"] == gstats["dev_done"] == 3 * 4
    assert gstats["dev_bad"] == 0
    ls = lane.clane.stats()
    assert ls["retired"] >= 3 * 4 and ls["cb_errors"] == 0
    assert lane.failed() is None
    # coherency: every staged descA tile's table entry matches the live
    # Data version
    assert dev.coh_stats() is not None
    for i in range(3):
        d = A.data_of(0, i)
        st = dev._ncoh.state(dev.res_key(d))
        if st is not None and st[0] != 0:      # still resident+valid
            assert st[1] == (d.version & 0xFFFFFFFF), \
                f"coherency violation on descA(0,{i}): {st} vs {d.version}"


def test_device_lane_drops_consumed_slots(dctx, monkeypatch):
    """A pool whose tasks all ride the device lane drops a slot's payload
    once every consumer of it retired (the device dispatch takes the
    graph's retired slots): a chain of 8 on one tile ends with at most the
    last two of its 8 slots live, where keeping them all to the end would
    hold one tile a task."""
    from parsec_tpu_torch.dsl.ptg import compiler as C
    seen = []
    finalize = C.PTGTaskpool._ptexec_finalize

    def counting(self, lane):
        slots = lane.get("slots") or []
        seen.append((sum(v is not None for v in slots), len(slots)))
        return finalize(self, lane)
    monkeypatch.setattr(C.PTGTaskpool, "_ptexec_finalize", counting)
    mca.set("region_fusion", False)
    try:
        src = ("%global NT\n%global descA\n"
               "T(k)\n  k = 0 .. NT-1\n"
               "  RW X <- (k == 0) ? descA(0, 0) : X T(k-1)\n"
               "       -> (k < NT-1) ? X T(k+1) : descA(0, 0)\n"
               "BODY [type=CUDA]\n  X = X * 2.0\nEND\n")
        A = TiledMatrix("A", 4, 4, 4, 4, device="cpu")
        A.fill(lambda m, n: np.ones((4, 4), np.float32))
        tp = C.compile_ptg(src, "drop").instantiate(
            dctx, globals={"NT": 8}, collections={"descA": A})
        dctx.add_taskpool(tp)
        dctx.wait(timeout=60)
    finally:
        mca.params.unset("region_fusion")
    assert tp._ptexec_state.get("dev_pool") is not None
    assert seen == [(seen[0][0], 8)] and seen[0][0] <= 2, seen
    np.testing.assert_array_equal(_host(A.data_of(0, 0)),
                                  np.full((4, 4), 256.0, np.float32))


def test_first_per_task_pool_of_a_class_is_cold(dctx):
    """A class's first per-task pool on a lane carries the lane's one-off
    costs and is left out of the cost model; the second pool of the class
    on the same lane is measured (``cuda``, one observation a task)."""
    from parsec_tpu_torch.dsl.ptg import compiler as C
    src = ("%global NT\n%global descA\n"
           "T(k)\n  k = 0 .. NT-1\n"
           "  RW X <- (k == 0) ? descA(0, 0) : X T(k-1)\n"
           "       -> (k < NT-1) ? X T(k+1) : descA(0, 0)\n"
           "BODY [type=CUDA]\n  X = X + 1.0\nEND\n")
    prog = C.compile_ptg(src, "cold")
    m = costmodel.model
    counts = []
    mca.set("region_fusion", False)
    try:
        for _ in range(2):
            A = TiledMatrix("A", 4, 4, 4, 4, device="cpu")
            A.fill(lambda m_, n: np.zeros((4, 4), np.float32))
            tp = prog.instantiate(dctx, globals={"NT": 6},
                                  collections={"descA": A})
            dctx.add_taskpool(tp)
            dctx.wait(timeout=60)
            assert tp._ptexec_state.get("dev_pool") is not None
            counts.append(m.count("cold.T", tp._ptexec_pool_bucket(), "cuda"))
    finally:
        mca.params.unset("region_fusion")
    assert counts == [0, 6]


def test_device_lane_cost_clock_spans_its_pools(dctx):
    """One retire sweep's wall window divides across the task weights that
    every pool of the lane retired in it: two pools retiring together get
    the same share a task, and their shares add up to the window (a clock
    for each pool would bill the whole window to each)."""
    from parsec_tpu_torch.device.native import _PoolState
    lane = dctx._ptdev_lane()
    seen = {}

    def pool(name, w):
        def poll():
            return [0], [((name, 0, "cuda"), w)]

        def observe(retired, per):
            seen[name] = (retired, per)
        return _PoolState(None, poll, observe, None, None)
    lane._pools[901], lane._pools[902] = pool("a", 3), pool("b", 1)
    try:
        lane._clock = t0 = time.perf_counter_ns()
        time.sleep(0.02)
        done = lane._poll()
        window = lane._clock - t0
    finally:
        del lane._pools[901], lane._pools[902]
    assert sorted(done) == [(901, 0), (902, 0)]
    assert seen["a"][1] == seen["b"][1] == pytest.approx(window / 4)
    assert seen["a"][0] == [(("a", 0, "cuda"), 3)]


def test_device_lane_dispatch_error_surfaces(dctx):
    """A body raising on the lane's manager thread must poison the pool and
    surface to the waiter — not hang the drain loops."""
    from parsec_tpu_torch.dsl.ptg.compiler import compile_ptg
    src = ("%global NT\n%global descA\n"
           "T(k)\n  k = 0 .. NT-1\n"
           "  RW X <- (k == 0) ? descA(0, k) : X T(k-1)\n"
           "       -> (k < NT-1) ? X T(k+1) : descA(0, k)\n"
           "BODY [type=CUDA]\n"
           "  X = torch.linalg.cholesky(X) * bad_name\nEND\n")
    A = TiledMatrix("errA", 1, 4, 1, 1)
    A.fill(lambda m, k: np.zeros((1, 1), np.float32))
    prog = compile_ptg(src, "dev-err")
    tp = prog.instantiate(dctx, globals={"NT": 4}, collections={"descA": A})
    dctx.add_taskpool(tp)
    with pytest.raises(BaseException,
                       match="native device lane callback failed"):
        dctx.wait(timeout=30)
    assert dctx._ptdev.failed() is not None
    # the context stays poisoned: the fixture's fini skips the drain and
    # tears down cleanly (the documented error contract)


def test_coh_table_units():
    """CohTable policy units: version-checked stage-in, LRU victim order,
    pin veto, budget shrink, ownership bumps."""
    mod = native_mod.load_ptdev()
    t = mod.CohTable(1000)
    need, v = t.stage_in(1, 400, 0)
    assert need == 1 and v == []
    need, v = t.stage_in(1, 400, 0)          # same version: resident hit
    assert need == 0 and v == []
    need, v = t.stage_in(1, 400, 1)          # version bumped: re-stage
    assert need == 1 and v == []
    need, v = t.stage_in(2, 400, 0)
    assert need == 1 and v == []
    # third tile exceeds the budget: key 1 is the LRU victim
    need, v = t.stage_in(3, 400, 0)
    assert need == 1 and v == [(1, 0)]
    st = t.stats()
    assert st["evictions"] == 1 and st["resident_bytes"] == 800
    # a pinned entry is skipped; the next unpinned one evicts instead
    t.pin(2)
    need, v = t.stage_in(4, 400, 0)
    assert need == 1 and v == [(3, 0)]
    assert t.stats()["pinned_skips"] >= 1
    t.unpin(2)
    # ownership: mark_owned flags the victim as dirty (owned) on eviction
    vs = t.mark_owned(4, 5, 400)
    assert vs == []
    assert t.state(4)[:2] == (mod.COH_OWNED, 5)
    vict = t.set_budget(100)                 # evicts everything resident
    assert (2, 0) in vict                    # clean victim
    assert (4, 1) in vict                    # owned victim reported dirty
    assert t.stats()["resident_bytes"] == 0


def test_eviction_races_reader_atomically(dctx):
    """An OWNED copy evicted under pressure writes back AND downgrades
    atomically with the version check. A reader racing eviction must always
    find the data's newest version on a valid copy with a live payload, and
    a concurrent host write must never be clobbered by a stale
    write-back."""
    dev = _dev(dctx)
    data = data_from_array(np.zeros((16, 16), np.float32), key="race-tile")
    stop = threading.Event()
    errors = []

    def reader():
        last = -1
        while not stop.is_set():
            with data._lock:
                best = None
                for c in data.copies.values():
                    if c.coherency_state != COHERENCY_INVALID:
                        if best is None or c.version > best.version:
                            best = c
                if best is None or best.payload is None:
                    errors.append("newest version lost its payload")
                    break
                if best.version < last or best.version < data.version:
                    errors.append(
                        f"version went backwards: {best.version} < "
                        f"{max(last, data.version)}")
                    break
                last = best.version
        stop.set()

    def host_writer():
        n = 0
        while not stop.is_set() and n < 400:
            host = data.get_copy(0)
            if host is not None and host.payload is not None:
                data.bump_version(0)
            n += 1
            time.sleep(0)
        stop.set()

    rt = threading.Thread(target=reader)
    wt = threading.Thread(target=host_writer)
    rt.start(); wt.start()
    try:
        for _ in range(400):
            if stop.is_set():
                break
            copy = dev.lane_stage_in(data)
            data.bump_version(dev.device_index)      # device owns newest
            dev._lru_touch(dev.res_key(data), copy)
            dev._coh_mark_owned(data, copy)
            dev.evict_bytes(1 << 30)                 # force the write-back
    finally:
        stop.set()
        rt.join(timeout=10); wt.join(timeout=10)
    assert not errors, errors
    best = data.newest_copy()
    assert best is not None and best.payload is not None
    assert best.version == data.version


def test_ptdtd_dev_wiring_engine_level():
    """The ptdtd half of the lane contract, wired and tested at the engine
    level (DTD pools stay on the interpreted device module): ready tasks of
    a device-marked class surface onto a ptdev Lane, the manager dispatches
    them through the pool callbacks, and the GIL-free dev_retire release
    walk completes them — including surfacing their per-task-lane
    successors through drain_ready."""
    dmod = native_mod.load_ptdev()
    emod = native_mod.load_ptdtd()
    eng = emod.Engine()
    tile = eng.tile()
    eng.slot_set(tile, 1.0)
    lane = dmod.Lane()

    def cb(args_list):                 # CPU batch callback (unused here)
        return [(a[0],) for a in args_list]

    cls = eng.register_class(cb, [0], [3], None, -1, 1)   # device=1
    dispatched = []

    def dispatch(pool, ids):
        for tid in ids:
            v = eng.slot_get(tile)
            eng.slot_set(tile, v * 2.0)
            dispatched.append(tid)
        return len(ids)

    def poll():
        out = [(1, tid) for tid in dispatched]
        del dispatched[:]
        return out

    lane.bind_pool(1, eng.dev_retire_capsule(), eng)
    lane.start(dispatch, poll, 100)
    try:
        eng.dev_bind(lane.submit_capsule(), 1)
        # a device-class chain: t0 -> t1 (RAW on the tile), plus a
        # per-task-lane reader that must surface at the end
        n = eng.insert_many([(cls, None, tile, 3), (cls, None, tile, 3)])
        assert n == 2
        tid, _held = eng.insert([tile], [1])   # per-task-lane reader
        eng.activate(tid)
        deadline = time.monotonic() + 10
        surfaced = []
        while time.monotonic() < deadline:
            _nexec, sur = eng.drain_ready(64, 1024)
            surfaced.extend(sur)
            if eng.dev_stats()["dev_done"] == 2 and surfaced:
                break
            time.sleep(0.005)
        ds = eng.dev_stats()
        assert ds["dev_tx"] == 2 and ds["dev_done"] == 2 and \
            ds["dev_bad"] == 0, ds
        assert surfaced == [tid], (surfaced, tid)
        assert eng.slot_get(tile) == 4.0      # both device bodies ran
        ls = lane.stats()
        assert ls["retired"] == 2 and ls["cb_errors"] == 0
    finally:
        lane.stop()
        lane.unbind_pool(1)


def test_device_lane_off_by_mca(dctx):
    """--mca device_native 0 keeps CUDA-bodied pools on the interpreted
    device module (counted ineligible, never fallback)."""
    from parsec_tpu_torch.device.native import PTDEV_STATS
    mca.set("device_native", False)
    try:
        rng = np.random.default_rng(3)
        a_cols = [rng.standard_normal((4, 4)).astype(np.float32)
                  for _ in range(2)]
        snap = PTDEV_STATS.snapshot()
        tp, _A, B = _run_mixed(dctx, 2, 2, a_cols, "mcaoff")
        delta = PTDEV_STATS.delta(snap)
        assert tp._ptexec_state is None
        assert delta["pools_ineligible"] >= 1 and \
            delta["pools_fallback"] == 0
        expect = _mixed_replay(a_cols, 2, 2)
        for i in range(2):
            np.testing.assert_allclose(
                np.asarray(B.data_of(0, i).newest_copy().payload,
                           np.float64), expect[i], rtol=1e-4)
    finally:
        mca.params.unset("device_native")


def test_device_lane_under_budget_pressure(dctx):
    """Under a tight budget, staging tile k+1 of one dispatch batch must not
    evict tile k staged moments earlier — staged copies pin the moment they
    stage. The run stays correct (max abs error against numpy < 1e-2, the
    reference's tolerance), C-decided evictions DO happen, and every pin
    balances back to zero."""
    from parsec_tpu_torch.dsl.ptg.compiler import compile_ptg
    dev = _dev(dctx)
    n, ts = 64, 16
    dev.set_budget(4 * ts * ts * 4, unit=1024)   # room for ~4 tiles
    rng = np.random.default_rng(21)
    a = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, n)).astype(np.float32)
    src = ("%global MT\n%global KT\n%global descA\n%global descB\n"
           "%global descC\n"
           "GEMM(m, n, k)\n  m = 0 .. MT-1\n  n = 0 .. MT-1\n"
           "  k = 0 .. KT-1\n  : descC(m, n)\n"
           "  READ A <- descA(m, k)\n  READ B <- descB(k, n)\n"
           "  RW   C <- (k == 0) ? descC(m, n) : C GEMM(m, n, k-1)\n"
           "       -> (k < KT-1) ? C GEMM(m, n, k+1) : descC(m, n)\n"
           "BODY [type=CUDA]\n"
           "  C = C + torch.matmul(A, B)\n"
           "END\n")
    A = TiledMatrix("pbA", n, n, ts, ts)
    A.fill(lambda m, k: a[m*ts:(m+1)*ts, k*ts:(k+1)*ts])
    B = TiledMatrix("pbB", n, n, ts, ts)
    B.fill(lambda m, k: b[m*ts:(m+1)*ts, k*ts:(k+1)*ts])
    C = TiledMatrix("pbC", n, n, ts, ts)
    C.fill(lambda m, k: np.zeros((ts, ts), np.float32))
    prog = compile_ptg(src, "pb-gemm")
    # per-task staging pressure under test: region fusion stages each
    # fused chain's tiles once per REGION (covered by test_torch_fusion.py)
    mca.set("region_fusion", False)
    try:
        tp = prog.instantiate(dctx,
                              globals={"MT": n // ts, "KT": n // ts},
                              collections={"descA": A, "descB": B,
                                           "descC": C})
        dctx.add_taskpool(tp)
        dctx.wait(timeout=90)
    finally:
        mca.params.unset("region_fusion")
    assert tp._ptexec_state is not None and \
        tp._ptexec_state.get("dev_pool") is not None
    err = float(np.abs(C.to_dense() - a @ b).max())
    assert err < 1e-2, f"tight-budget device-lane GEMM wrong: {err}"
    cs = dev.coh_stats()
    assert cs["evictions"] > 0, cs
    # pins balance: with the pool done, nothing stays pinned
    for M in (A, B, C):
        for m in range(M.mt):
            for nn in range(M.nt):
                st = dev._ncoh.state(dev.res_key(M.data_of(m, nn)))
                assert st is None or st[3] == 0, (m, nn, st)
    assert dctx._ptdev.failed() is None


def test_abandoned_lane_stops_at_exit():
    """A context abandoned with its device lane up (no ``fini()``, the
    manager thread alive at exit): the interpreter exits at once and
    cleanly, with no hang and no crash. (The atexit net stops the manager
    before finalization; CPython 3.12 would also end a thread that asks for
    the GIL during finalization, so the test guards the exit, not the
    net.)"""
    import subprocess
    import sys
    script = (
        "import numpy as np\n"
        "from parsec_tpu_torch.core.context import Context\n"
        "from parsec_tpu_torch.data.matrix import TiledMatrix\n"
        "from parsec_tpu_torch.dsl.ptg.compiler import compile_ptg\n"
        "from parsec_tpu_torch.utils import mca\n"
        "mca.set('device_cuda_over_cpu', True)\n"
        "ctx = Context(nb_cores=2, device='cpu')\n"
        "A = TiledMatrix('A', 1, 4, 1, 1)\n"
        "A.fill(lambda m, k: np.zeros((1, 1), np.float32))\n"
        "src = ('%global NT\\n%global descA\\nT(k)\\n  k = 0 .. NT-1\\n'\n"
        "       '  RW X <- (k == 0) ? descA(0, k) : X T(k-1)\\n'\n"
        "       '       -> (k < NT-1) ? X T(k+1) : descA(0, k)\\n'\n"
        "       'BODY [type=CUDA]\\n  X = X + 1.0\\nEND\\n')\n"
        "tp = compile_ptg(src, 'abandon').instantiate(\n"
        "    ctx, globals={'NT': 4}, collections={'descA': A})\n"
        "ctx.add_taskpool(tp)\n"
        "ctx.wait(timeout=30)\n"
        "assert ctx._ptdev and ctx._ptdev.clane.stats()['retired'] == 1\n"
        "print('abandoned')\n")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=60,
                         cwd=str(__import__("pathlib").Path(__file__)
                                 .resolve().parent.parent))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "abandoned" in out.stdout
