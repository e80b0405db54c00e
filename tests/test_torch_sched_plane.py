"""The port's native multi-pool scheduler plane (``csrc/ptsched.h``,
``core/sched_plane.py``): the plane and DTD cases of the reference's
``tests/test_ptsched.py`` on the port's extensions and CPU contexts.

* raw Plane semantics on the C extension (policies, weighted DRR, hot-queue
  spill, steal-half, admission windows, concurrent register/unregister,
  the queue-wait histogram, the capsule's lifetime);
* DTD integration: weighted drain fairness across pools in the engine,
  multi-pool parity with the plane on and off (and against the
  reference's run), admission backpressure (the blocking insert and the
  ``nowait`` error), and the policy mapping with its counted fallback.
"""

import gc
import random
import threading
import time

import numpy as np
import pytest
import torch

from parsec_tpu_torch import native as native_mod
from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.core.sched_plane import SCHED_STATS
from parsec_tpu_torch.dsl.dtd import (
    AdmissionBackpressure, DTDTaskpool, READ, RW,
)
from parsec_tpu_torch.utils import mca


def _mod():
    return native_mod.load_ptsched()


# ------------------------------------------------------------------ raw plane

def test_plane_fifo_policy_oldest_first():
    ps = _mod()
    pl = ps.Plane(nworkers=1, policy=ps.POLICY_FIFO)
    h = pl.register_pool(ext_id=1, kind=ps.KIND_EXT)
    pl.push(h, list(range(10)))           # worker -1: straight to overflow
    got = [t for _, t in pl.pop(worker=0, kind=ps.KIND_EXT, cap=10)]
    assert got == list(range(10))


def test_plane_wdrr_weights_within_tolerance():
    ps = _mod()
    pl = ps.Plane(nworkers=1, policy=ps.POLICY_WDRR, quantum=64)
    a = pl.register_pool(ext_id=1, kind=ps.KIND_EXT, weight=2)
    b = pl.register_pool(ext_id=2, kind=ps.KIND_EXT, weight=1)
    served = {a: 0, b: 0}
    nxt = {a: 0, b: 0}
    for h in (a, b):                      # sustained backlog, long run
        pl.push(h, list(range(4096)))
        nxt[h] = 4096
    for _ in range(300):
        for p, _t in pl.pop(worker=0, kind=ps.KIND_EXT, cap=64):
            served[p] += 1
        for h in (a, b):
            q = pl.queued(h)
            if q < 2048:
                pl.push(h, list(range(nxt[h], nxt[h] + 4096 - q)))
                nxt[h] += 4096 - q
    ratio = served[a] / max(1, served[b])
    assert abs(ratio - 2.0) / 2.0 < 0.25, (served, ratio)


def test_plane_prio_policy_best_pool_first():
    ps = _mod()
    pl = ps.Plane(nworkers=1, policy=ps.POLICY_PRIO)
    lo = pl.register_pool(ext_id=1, kind=ps.KIND_EXT)
    hi = pl.register_pool(ext_id=2, kind=ps.KIND_EXT)
    pl.push(lo, [0, 1], prios=[1, 2])
    pl.push(hi, [10, 11], prios=[9, 8])
    got = pl.pop(worker=0, kind=ps.KIND_EXT, cap=10)
    # the hi pool's top priority wins; within a pool, priority order
    assert [t for _, t in got[:2]] == [10, 11]
    assert [t for _, t in got[2:]] == [1, 0]


def test_plane_hotq_spill_accounting():
    ps = _mod()
    pl = ps.Plane(nworkers=2)
    h = pl.register_pool(ext_id=1, kind=ps.KIND_EXT)
    n = ps.HOTQ_CAP + 100
    pl.push(h, list(range(n)), worker=0)  # overflows the bounded hot queue
    assert pl.pool_stats(h)["spills"] == 100
    got = set()
    while True:
        batch = pl.pop(worker=0, kind=ps.KIND_EXT, cap=256)
        if not batch:
            break
        got |= {t for _, t in batch}
    assert got == set(range(n))           # nothing lost to the spill


def test_plane_steal_liveness_one_pool_n_workers():
    """1 pool, N workers: a starved worker steals half from the victim's
    cold end, counted per thief."""
    ps = _mod()
    pl = ps.Plane(nworkers=2)
    h = pl.register_pool(ext_id=1, kind=ps.KIND_EXT)
    pl.push(h, list(range(100)), worker=0)   # all in worker 0's hot queue
    got = pl.pop(worker=1, kind=ps.KIND_EXT, cap=8)
    assert got, "starved worker found no stealable work"
    st = pl.stats()
    assert st["steals"] > 0 and st["steal_visits"] > 0
    assert pl.worker_steals(1) == st["steals"]   # counted per thief
    assert pl.worker_steals(0) == 0
    # cold-end contract: the loot comes from the OLDEST pushed items
    assert min(t for _, t in got) == 0


def test_plane_admission_window_signal():
    ps = _mod()
    pl = ps.Plane(nworkers=1)
    h = pl.register_pool(ext_id=1, kind=ps.KIND_EXT, window=8)
    assert not pl.over_window(h)
    pl.admit(h, 8)
    assert not pl.over_window(h)          # at the window, not past it
    pl.admit(h, 1)
    assert pl.over_window(h)
    assert pl.push(h, [0]) is True        # push reports the soft signal
    pl.retired(h, 5)
    assert not pl.over_window(h)
    assert pl.inflight(h) == 4


def test_plane_concurrent_register_unregister_mid_run():
    ps = _mod()
    pl = ps.Plane(nworkers=2)
    stop = threading.Event()
    errs = []

    def churn(seed):
        rng = random.Random(seed)
        try:
            while not stop.is_set():
                h = pl.register_pool(ext_id=seed, kind=ps.KIND_EXT)
                pl.push(h, list(range(rng.randrange(1, 64))),
                        worker=rng.randrange(-1, 2))
                pl.pop(worker=rng.randrange(2), kind=ps.KIND_EXT,
                       cap=rng.randrange(1, 64))
                pl.unregister_pool(h)
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=churn, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    time.sleep(1.0)
    stop.set()
    for t in threads:
        t.join()
    assert not errs
    assert pl.stats()["pools_live"] == 0
    assert pl.stats()["pools_registered"] > 0


def test_plane_queue_wait_histogram():
    """The push->pop wait histogram, sampled 1 in 8 by task id: ids 0..63
    give 8 samples, each at least the 2 ms the items sat queued."""
    ps = _mod()
    pl = ps.Plane(nworkers=1)
    pl.hist_enable()
    h = pl.register_pool(ext_id=1, kind=ps.KIND_EXT)
    pl.push(h, list(range(64)))
    time.sleep(0.002)
    while pl.pop(worker=0, kind=ps.KIND_EXT, cap=16):
        pass
    name, (count, sum_ns, raw) = next(iter(pl.hist_snapshot().items()))
    assert name == "queue_ns" and count == 8
    assert sum_ns >= 8 * 2_000_000
    assert len(raw) > 0


def test_plane_capsule_keeps_plane_alive():
    """The capsule owns a reference to its plane: with the Plane object
    dropped, an engine still binds through the capsule."""
    ps = _mod()
    pl = ps.Plane(nworkers=1)
    cap = pl.plane_capsule()
    del pl
    gc.collect()
    eng = native_mod.load_ptdtd().Engine()
    eng.sched_bind(cap)
    assert eng.sched_bound()
    del eng, cap                          # dropping both releases the plane
    gc.collect()


# -------------------------------------------------------- ptdtd integration

def test_engine_weighted_drain_fairness():
    """2:1 pool weights -> served ratio within 25% over a long drain (both
    pools held backlogged so the weights bind)."""
    pd, ps = native_mod.load_ptdtd(), _mod()
    eng = pd.Engine()
    pl = ps.Plane(nworkers=2, policy=ps.POLICY_WDRR)
    eng.sched_bind(pl.plane_capsule())
    assert eng.sched_bound()
    a = pl.register_pool(ext_id=1, kind=ps.KIND_PTDTD, weight=2)
    b = pl.register_pool(ext_id=2, kind=ps.KIND_PTDTD, weight=1)
    done = {a: 0, b: 0}
    ca = eng.register_class(
        lambda args: done.__setitem__(a, done[a] + len(args)),
        [0], [1], None, a)
    cb = eng.register_class(
        lambda args: done.__setitem__(b, done[b] + len(args)),
        [0], [1], None, b)
    ta, tb = eng.tile(), eng.tile()
    for r in range(120):
        for cls, h, t in ((ca, a, ta), (cb, b, tb)):
            q = pl.queued(h)
            if q < 1024:
                eng.insert_many([(cls, None, t, 1)] * (1024 - q))
        eng.drain_ready(256, 256, r % 2)
    ratio = done[a] / max(1, done[b])
    assert abs(ratio - 2.0) / 2.0 < 0.25, (done, ratio)
    # admission accounting drained back to the live backlog
    assert pl.inflight(a) == pl.queued(a)
    assert pl.inflight(b) == pl.queued(b)


def _bump(x):
    return x + 1.0


def _multi_pool(new_ctx, new_pool, zeros, params, native_plane: bool):
    """400 random inserts into 3 concurrent pools of weights 1-3: the final
    tile values, pool by pool."""
    if not native_plane:
        params.set("sched_native", False)
    try:
        ctx = new_ctx()
        rng = random.Random(42)
        pools = []
        for i in range(3):
            tp = new_pool(ctx, f"par{i}")
            tp.qos_weight = i + 1
            pools.append((tp, [tp.tile_new(zeros()) for _ in range(4)]))
        assert (ctx.sched_plane is not None) == native_plane
        for _ in range(400):
            tp, tiles = pools[rng.randrange(3)]
            tp.insert_task(_bump, (tiles[rng.randrange(4)], RW),
                           jit=False, name="B")
        outs = []
        for tp, tiles in pools:
            tp.wait(timeout=120)
            outs.append([float(np.asarray(t.data.newest_copy().payload)
                               .reshape(-1)[0]) for t in tiles])
            tp.close()
        ctx.wait(timeout=120)
        ctx.fini()
        return outs
    finally:
        params.params.unset("sched_native")


def test_dtd_multi_pool_parity_plane_on_off():
    """Randomized inserts into 3 concurrent pools, plane on vs off:
    identical final tile payloads — and equal to the reference's run of
    the same inserts."""
    import parsec_tpu as ref_pt
    from parsec_tpu.dsl.dtd import DTDTaskpool as RefPool
    from parsec_tpu.utils import mca as ref_mca

    port = [_multi_pool(lambda: Context(nb_cores=2, device="cpu"),
                        DTDTaskpool, lambda: torch.zeros(2, 2), mca, on)
            for on in (True, False)]
    ref = _multi_pool(lambda: ref_pt.Context(nb_cores=2), RefPool,
                      lambda: np.zeros((2, 2), np.float32), ref_mca, True)
    assert port[0] == port[1] == ref


def test_dtd_admission_window_blocks_and_counts():
    """nb_cores=1: nothing drains between flush boundaries, so the window
    (128 < the 256-spec flush) MUST trip and the inserter MUST drain its
    way back under it."""
    ctx = Context(nb_cores=1, device="cpu")
    assert ctx.sched_plane is not None
    before = SCHED_STATS.snapshot()
    tp = DTDTaskpool(ctx, "adm")
    tp.admission_window = 128
    tiles = [tp.tile_new((2, 2)) for _ in range(4)]

    def body(x):               # ONE fn object: inserts ride the batch
        return None            # lane's fast cache (and thus the plane)

    for i in range(4000):
        tp.insert_task(body, (tiles[i % 4], READ), jit=False, name="A")
    tp.wait(timeout=120)
    tp.close()
    ctx.wait(timeout=120)
    delta = SCHED_STATS.delta(before)
    assert delta["admission_stalls"] > 0     # the window bit, blocking
    assert delta["pools_engaged"] >= 1       # ... on an engaged pool
    assert tp.executed == 4000
    ctx.fini()


def test_dtd_admission_nowait_raises():
    ctx = Context(nb_cores=1, device="cpu")
    assert ctx.sched_plane is not None
    tp = DTDTaskpool(ctx, "nowait")
    tp.admission_window = 64
    tile = tp.tile_new((2, 2))

    def body(x):
        return None

    tp.insert_task(body, (tile, READ), jit=False, name="N")
    assert tp._sched_pool is not None
    # force the pool past its window (the deterministic form)
    ctx.sched_plane.plane.admit(tp._sched_pool, 100)
    before = SCHED_STATS.snapshot()
    try:
        with pytest.raises(AdmissionBackpressure):
            tp.insert_task(body, (tile, READ), jit=False,
                           name="N", nowait=True)
        assert SCHED_STATS.delta(before)["admission_rejects"] == 1
        # a nowait caller that backs off and retries after the overrun
        # clears succeeds
        ctx.sched_plane.plane.retired(tp._sched_pool, 100)
        tp.insert_task(body, (tile, READ), jit=False,
                       name="N", nowait=True)
    finally:
        tp.wait(timeout=60)
        tp.close()
        ctx.wait(timeout=60)
        ctx.fini()


# ------------------------------------------------------------ policy routing

def test_native_policy_mapping_and_fallback():
    # ap maps to the native prio flavor
    ctx = Context(nb_cores=1, device="cpu", scheduler="ap")
    assert ctx.sched_plane is not None and ctx.sched_plane.policy == "prio"
    ctx.fini()
    # ip has no native analogue: honest fallback, counted
    before = SCHED_STATS.snapshot()
    ctx = Context(nb_cores=1, device="cpu", scheduler="ip")
    assert ctx.sched_plane is None
    assert SCHED_STATS.delta(before)["policy_fallback"] == 1
    ctx.fini()
    # and the python engine's switch turns the plane off, counted
    mca.set("native_enabled", False)
    try:
        before = SCHED_STATS.snapshot()
        ctx = Context(nb_cores=1, device="cpu")
        assert ctx.sched_plane is None
        assert SCHED_STATS.delta(before)["plane_unavailable"] == 1
        ctx.fini()
    finally:
        mca.params.unset("native_enabled")


def _inc(a):
    return a + 1.0


def test_no_plane_on_a_context_with_a_cuda_device():
    """A context with a CUDA device keeps its DTD pools off the batched
    lane, the plane's only client: it creates no plane, and the decline
    is counted. Shown on the CPU with the CUDA device module over it."""
    mca.set("device_cuda_over_cpu", True)
    try:
        before = SCHED_STATS.snapshot()
        ctx = Context(nb_cores=1, device="cpu")
        try:
            assert ctx.sched_plane is None
            assert SCHED_STATS.delta(before)["card_context"] == 1
            tp = DTDTaskpool(ctx, "card")
            t = tp.tile_new((2, 2), torch.float32)
            t.data.create_copy(0, torch.zeros(2, 2))
            for _ in range(4):
                assert tp.insert_task(_inc, (t, RW), jit=False) is not None
            assert tp._neng is not None and not tp._batch_on
            assert tp._sched_pool is None
            tp.wait()
            tp.close()
            ctx.wait(timeout=30)
            assert float(t.data.newest_copy().payload[0, 0]) == 4.0
        finally:
            ctx.fini()
    finally:
        mca.params.unset("device_cuda_over_cpu")
