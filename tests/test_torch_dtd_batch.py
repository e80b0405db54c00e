"""The port's batched native insert lane: engine insert_many/drain_ready
semantics, the insert_task fast path, three-way lane parity (batched vs
per-task engine vs the Python engine) held against the reference's three
lanes on the same program, engagement counters equal to the reference's,
and concurrent inserters with the batch buffer on. The port of the
reference's ``tests/test_dtd_batch.py`` on CPU contexts.
"""

import sys
import threading

import numpy as np
import pytest
import torch

import parsec_tpu as ref_pt
from parsec_tpu import native as ref_native
from parsec_tpu.dsl.dtd import DTDTaskpool as RefPool
from parsec_tpu.dsl.dtd import PTDTD_STATS as REF_STATS
from parsec_tpu.utils import mca as ref_mca
from parsec_tpu_torch import native as native_mod
from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.dsl.dtd import (
    DTDTaskpool, NOTRACK, PTDTD_STATS, READ, RW,
)
from parsec_tpu_torch.utils import mca


# hoisted bodies: the batch lane engages on REPEAT inserts of one fn
# object — a fresh lambda per loop iteration never batches
def _inc(a):
    return a + 1.0


def _axpy(x, y):
    return y + 2.0 * x


def _scale_by(a, s):
    return a * s


def _observe(a):
    return None


@pytest.fixture()
def ctx():
    c = Context(nb_cores=1, device="cpu")
    yield c
    c.fini()


def _tile(tp, value=0.0, shape=(2, 2)):
    t = tp.tile_new(shape, torch.float32)
    t.data.create_copy(0, torch.full(shape, float(value)))
    return t


def _val(t) -> float:
    return float(t.data.newest_copy().payload.reshape(-1)[0])


# ---------------------------------------------------------------- engagement

def test_batch_lane_engages_and_returns_none(ctx):
    tp = DTDTaskpool(ctx, "bl")
    t = _tile(tp)
    b0 = PTDTD_STATS["tasks_batched"]
    first = tp.insert_task(_inc, (t, RW), jit=False)
    assert first is not None, "first insert of a class takes the per-task path"
    for _ in range(100):
        assert tp.insert_task(_inc, (t, RW), jit=False) is None, \
            "batched inserts are handle-free"
    tp.wait()
    tp.close()
    ctx.wait(timeout=30)
    assert PTDTD_STATS["tasks_batched"] - b0 == 100
    assert _val(t) == 101.0
    assert t.data.version == 101


def test_batch_lane_off_when_disabled(ctx):
    mca.set("dtd_batch_insert", False)
    try:
        tp = DTDTaskpool(ctx, "bloff")
        t = _tile(tp)
        for _ in range(10):
            assert tp.insert_task(_inc, (t, RW), jit=False) is not None
        assert not tp._batch_on and tp._neng is not None
        tp.wait()
        tp.close()
        ctx.wait(timeout=30)
    finally:
        mca.params.unset("dtd_batch_insert")


def test_batch_lane_off_with_an_explicit_scheduler():
    """An explicitly chosen scheduler policy spans every task of a pool,
    which no per-lane ordering can honor: the batched lane stays off."""
    c = Context(nb_cores=1, device="cpu", scheduler="ap")
    try:
        tp = DTDTaskpool(c, "ex")
        t = _tile(tp)
        for _ in range(10):
            assert tp.insert_task(_inc, (t, RW), jit=False) is not None
        assert not tp._batch_on
        tp.wait()
        tp.close()
        c.wait(timeout=30)
        assert _val(t) == 10.0
    finally:
        c.fini()


def test_batch_fallbacks_stay_honest(ctx):
    """Ineligible inserts (priority, NOTRACK, where) ride the per-task
    lane — counted, never silently wrong."""
    tp = DTDTaskpool(ctx, "bf")
    t = _tile(tp)
    p0 = PTDTD_STATS["tasks_per_task"]
    # NOTRACK class: insert-time snapshot — batch-ineligible by design
    for _ in range(5):
        assert tp.insert_task(_observe, (t, READ | NOTRACK),
                              jit=False) is not None
    # prioritized / device-restricted inserts of an otherwise-batchable class
    tp.insert_task(_inc, (t, RW), jit=False)           # registers the class
    assert tp.insert_task(_inc, (t, RW), jit=False, priority=3) is not None
    assert tp.insert_task(_inc, (t, RW), jit=False, where=0x1) is not None
    assert PTDTD_STATS["tasks_per_task"] - p0 >= 8
    tp.wait()
    tp.close()
    ctx.wait(timeout=30)
    assert _val(t) == 3.0


def test_batch_values_args(ctx):
    """By-value args on eager bodies buffer per task through the spec's
    values tuple."""
    tp = DTDTaskpool(ctx, "bv")
    t = _tile(tp, 1.0)
    tp.insert_task(_scale_by, (t, RW), 2.0, jit=False)   # per-task (first)
    for _ in range(6):
        assert tp.insert_task(_scale_by, (t, RW), 2.0, jit=False) is None
    tp.wait()
    tp.close()
    ctx.wait(timeout=30)
    assert _val(t) == 2.0 ** 7


def test_batch_error_surfaces_at_wait(ctx):
    def bad(a):
        raise ValueError("intentional-batch")

    tp = DTDTaskpool(ctx, "be")
    t = _tile(tp)
    for _ in range(10):
        tp.insert_task(bad, (t, RW), jit=False)
    with pytest.raises(ValueError, match="intentional-batch"):
        tp.wait(timeout=10)
    # the context stays poisoned: fini skips the drain and tears down
    tp.close()


def test_mixed_lane_chain_order(ctx):
    """Eligible (batched) and ineligible (fresh-lambda, per-task) inserts
    interleaved on ONE tile serialize in program order: the slow path
    flushes the batch buffer before linking."""
    tp = DTDTaskpool(ctx, "mx")
    t = _tile(tp)
    expected = np.float32(0.0)
    tp.insert_task(_inc, (t, RW), jit=False)
    expected += np.float32(1.0)
    for _ in range(30):
        for _ in range(5):
            tp.insert_task(_inc, (t, RW), jit=False)     # batched
            expected += np.float32(1.0)
        # a fresh lambda never matches the class cache -> per-task lane
        tp.insert_task(lambda a: a * 2.0, (t, RW), jit=False)
        expected *= np.float32(2.0)
    tp.wait()
    tp.close()
    ctx.wait(timeout=60)
    assert _val(t) == float(expected)


def test_batch_recursive_insert_from_body(ctx):
    """A batched body that itself inserts (same hoisted child class) must
    not deadlock or lose tasks."""
    tp = DTDTaskpool(ctx, "rec")
    parent_t, child_t = _tile(tp), _tile(tp)
    n = 50

    def parent(a):
        tp.insert_task(_inc, (child_t, RW), jit=False)
        return a + 1.0

    for _ in range(n):
        tp.insert_task(parent, (parent_t, RW), jit=False)
    assert tp.wait(timeout=60)
    tp.close()
    ctx.wait(timeout=30)
    assert _val(parent_t) == n and _val(child_t) == n


# ------------------------------------------------- engine-level contracts

def test_engine_retire_fires_after_outputs_land():
    """The retire callback runs AFTER the outputs land: every retire must
    already see its batch's outputs in the tile slot."""
    eng = native_mod.load_ptdtd().Engine()
    nid = eng.tile()
    eng.slot_set(nid, 0.0)
    seen = []

    def cb(args_list):
        return [(v + 1.0,) for (v,) in args_list]

    def retire(n):
        seen.append((n, eng.slot_get(nid)))

    cls = eng.register_class(cb, [0], [RW], retire)
    eng.insert_many([(cls, None, nid, RW)] * 5)
    total = 0
    while total < 5:
        n, surfaced = eng.drain_ready(256, 4096)
        assert surfaced == ()
        if n == 0:
            break
        total += n
    assert total == 5
    assert sum(n for n, _ in seen) == 5
    landed = 0.0
    for n, payload in seen:
        landed += n
        assert payload == landed, "retire observed a pre-landing slot"


def test_engine_release_pool_drops_refs():
    eng = native_mod.load_ptdtd().Engine()
    nid = eng.tile()
    payload = torch.ones(2, 2)
    eng.slot_set(nid, payload)
    cls = eng.register_class(lambda args_list: None, [0], [READ])
    rc_held = sys.getrefcount(payload)
    eng.release_pool([nid], [cls])
    assert eng.slot_get(nid) is None
    assert sys.getrefcount(payload) == rc_held - 1


# ------------------------------------------------- pool lifecycle contracts

def test_on_complete_chained_not_clobbered(ctx):
    """A completion hook set BEFORE the lane arms must still fire — and
    see the synced tile.data, not the pre-batch values."""
    tp = DTDTaskpool(ctx, "oc")
    t = _tile(tp)
    fired = []
    tp.on_complete = lambda pool: fired.append(_val(t))
    for _ in range(20):
        tp.insert_task(_inc, (t, RW), jit=False)
    assert tp._batch_on
    tp.wait(timeout=30)
    tp.close()
    ctx.wait(timeout=30)
    assert fired == [20.0]


def test_batch_pool_releases_engine_state(ctx):
    """Final completion hands the engine-side state back: the context's
    open-batch count returns to zero and the pool's slot payloads are
    dropped from the engine."""
    tp = DTDTaskpool(ctx, "rel")
    t = _tile(tp)
    for _ in range(20):
        tp.insert_task(_inc, (t, RW), jit=False)
    assert ctx._dtd_batch_pools == 1
    tp.wait(timeout=30)
    tp.close()
    ctx.wait(timeout=30)
    assert tp._batch_retired
    assert ctx._dtd_batch_pools == 0
    assert tp._neng.slot_get(t.nid) is None
    assert _val(t) == 20.0


def _gather65(*tiles):
    """64 READ tiles into the last (RW): the flow count of the DTD GEMM's
    GEMM_K body at kt = 32 (2 * 32 + 1 = 65)."""
    return tiles[-1] + sum(tiles[:-1])


def test_batch_lane_takes_a_65_flow_body(ctx):
    """The port's engine takes up to 1024 flows a task on every insert path
    (the per-task insert, register_class and insert_many), so repeat
    inserts of a 65-flow body on a CPU context ride the batched lane: the
    first goes per-task and the rest are batched. The reference's engine
    takes at most 64 on each of those paths, so its pool raises on the
    first insert and no lane counter of its can be compared on this DAG:
    shown here on its register_class, the batched lane's entry."""
    tp = DTDTaskpool(ctx, "f65")
    srcs = [_tile(tp, 1.0) for _ in range(64)]
    acc = _tile(tp)
    before = PTDTD_STATS.snapshot()
    flows = [(t, READ) for t in srcs] + [(acc, RW)]
    assert tp.insert_task(_gather65, *flows, jit=False) is not None
    for _ in range(4):
        assert tp.insert_task(_gather65, *flows, jit=False) is None
    tp.wait()
    tp.close()
    ctx.wait(timeout=30)
    d = PTDTD_STATS.delta(before)
    assert d["tasks_batched"] == 4 and d["tasks_native"] == 1
    assert tp._batch_on and _val(acc) == 5 * 64.0
    accs, argmap = [1] * 64 + [3], list(range(65))
    ref_e = ref_native.load_ptdtd().Engine()
    with pytest.raises(ValueError, match="max 64"):
        ref_e.register_class(_gather65, argmap, accs)
    assert native_mod.load_ptdtd().Engine().register_class(
        _gather65, argmap, accs) >= 0


# ------------------------------------------------------------ parity harness

def _random_program(seed, nops=400, ntiles=6):
    """A reproducible random access pattern over shared tiles, exercising
    RAW/WAR/WAW chains, multi-flow bodies, and value args with HOISTED
    fns (so the batch lane engages on the batched run)."""
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(0, 4)), int(rng.integers(0, ntiles)),
             int(rng.integers(0, ntiles))) for _ in range(nops)]


def _run_program(pool_cls, ctx, ops, tensor, ntiles=6):
    tp = pool_cls(ctx, "par")
    tiles = [tp.tile_new((2, 2)) for _ in range(ntiles)]
    for i, t in enumerate(tiles):
        t.data.create_copy(0, tensor(i))
    for kind, a, b in ops:
        if kind == 0:
            tp.insert_task(_inc, (tiles[a], RW), jit=False)
        elif kind == 1:
            tp.insert_task(_observe, (tiles[a], READ), jit=False)
        elif kind == 2 and a != b:
            tp.insert_task(_axpy, (tiles[a], READ), (tiles[b], RW),
                           jit=False)
        else:
            tp.insert_task(_scale_by, (tiles[a], RW), 1.5, jit=False)
    tp.wait(timeout=120)
    tp.close()
    ctx.wait(timeout=60)
    return {"payloads": [np.asarray(t.data.newest_copy().payload,
                                    np.float32).copy() for t in tiles],
            "versions": [t.data.version for t in tiles],
            "wcounts": [t.wcount for t in tiles],
            "survivors": [len(t.readers) for t in tiles],
            "executed": tp.executed, "inserted": tp.inserted,
            "batch_on": tp._batch_on}


def _lanes(params, ctx_of, pool_cls, ops, tensor, stats):
    """The program on each of the three lanes: {lane: (result, counter
    delta)}."""
    out = {}
    for mode in ("batched", "pertask", "python"):
        if mode == "pertask":
            params.set("dtd_batch_insert", False)
        elif mode == "python":
            params.set("native_enabled", False)
        try:
            c = ctx_of()
            try:
                snap = stats.snapshot()
                res = _run_program(pool_cls, c, ops, tensor)
                out[mode] = (res, stats.delta(snap))
            finally:
                c.fini()
        finally:
            params.params.unset("dtd_batch_insert")
            params.params.unset("native_enabled")
    return out


@pytest.mark.parametrize("seed", [7, 41, 1234])
def test_three_way_lane_parity(seed):
    """batched vs per-task engine vs Python engine on one random program,
    in the port and in the reference: within each package identical
    completion counts, tile payloads and versions, and identical
    reader-compaction survivors between the two per-task modes; across the
    packages every lane's payloads within the reference test's tolerance,
    its counts and versions equal, and its PTDTD_STATS deltas equal (the
    port's extra ``tasks_native`` counts every per-task-lane insert)."""
    ops = _random_program(seed)
    port = _lanes(mca, lambda: Context(nb_cores=1, device="cpu"),
                  DTDTaskpool, ops, lambda i: torch.full((2, 2), float(i)),
                  PTDTD_STATS)
    ref = _lanes(ref_mca, lambda: ref_pt.Context(nb_cores=1), RefPool, ops,
                 lambda i: np.full((2, 2), float(i), np.float32), REF_STATS)
    for lanes in (port, ref):
        rb, rp, rpy = (lanes[m][0] for m in ("batched", "pertask", "python"))
        assert rb["batch_on"] and not rp["batch_on"] and not rpy["batch_on"]
        for other in (rp, rpy):
            assert rb["inserted"] == other["inserted"]
            assert rb["executed"] == other["executed"]
            assert rb["versions"] == other["versions"]
            assert rb["wcounts"] == other["wcounts"]
            for pa, pb in zip(rb["payloads"], other["payloads"]):
                np.testing.assert_allclose(pa, pb)
        assert rp["survivors"] == rpy["survivors"]
    for mode in ("batched", "pertask", "python"):
        (p, p_stats), (r, r_stats) = port[mode], ref[mode]
        for key in ("inserted", "executed", "versions", "wcounts",
                    "survivors", "batch_on"):
            assert p[key] == r[key], (mode, key)
        for pa, ra in zip(p["payloads"], r["payloads"]):
            np.testing.assert_allclose(pa, ra)
        assert {k: p_stats[k] for k in r_stats} == r_stats, mode
        # the port's own counter: every per-task-lane insert
        assert p_stats["tasks_native"] == (
            p["inserted"] - p_stats["tasks_batched"]
            if p["batch_on"] or mode == "pertask" else 0), mode


# ------------------------------------------------------- concurrent inserters

def test_concurrent_inserters_batched_shared_tiles():
    """THREE user threads hammer the SAME tiles through the batch buffer:
    every chain stays exact (final sum == total inserts)."""
    c = Context(nb_cores=1, device="cpu")
    try:
        tp = DTDTaskpool(c, "cc")
        shared = [_tile(tp) for _ in range(4)]
        # register the class so every thread takes the fast path
        tp.insert_task(_inc, (shared[0], RW), jit=False)
        per_thread, nthreads = 1500, 3
        barrier = threading.Barrier(nthreads)

        def inserter(tid):
            barrier.wait()
            for i in range(per_thread):
                tp.insert_task(_inc, (shared[(tid + i) % 4], RW), jit=False)

        threads = [threading.Thread(target=inserter, args=(k,))
                   for k in range(nthreads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        tp.wait(timeout=120)
        tp.close()
        c.wait(timeout=60)
        assert sum(_val(t) for t in shared) == nthreads * per_thread + 1
        assert tp.executed == nthreads * per_thread + 1
        assert tp.inserted == tp.local_inserted == nthreads * per_thread + 1
    finally:
        c.fini()


def test_concurrent_inserters_batched_with_live_workers():
    """Concurrent batched inserters racing LIVE worker drains: no task may
    be lost or run twice."""
    c = Context(nb_cores=2, device="cpu")
    try:
        tp = DTDTaskpool(c, "cw")
        assert tp._native_engine() is not None
        c.start()
        tiles = {k: [_tile(tp) for _ in range(4)] for k in range(2)}
        tp.insert_task(_inc, (tiles[0][0], RW), jit=False)
        per_thread = 4000

        def inserter(tid):
            for i in range(per_thread):
                tp.insert_task(_inc, (tiles[tid][i % 4], RW), jit=False)

        threads = [threading.Thread(target=inserter, args=(k,))
                   for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        tp.wait(timeout=180)
        tp.close()
        c.wait(timeout=60)
        total = sum(_val(t) for tl in tiles.values() for t in tl)
        assert total == 2 * per_thread + 1, total
    finally:
        c.fini()


def test_batch_window_pressure():
    """Tiny window: the flush threshold shrinks with it and the inserter
    stalls/drains mid-insertion; counts and results stay exact."""
    mca.set("dtd_window_size", 32)
    mca.set("dtd_threshold_size", 16)
    c = Context(nb_cores=1, device="cpu")
    try:
        tp = DTDTaskpool(c, "wp")
        t = _tile(tp)
        n = 600
        for _ in range(n):
            tp.insert_task(_inc, (t, RW), jit=False)
        assert tp.window_stalls > 0, "window never engaged"
        tp.wait(timeout=60)
        tp.close()
        c.wait(timeout=30)
        assert _val(t) == float(n)
        assert tp.executed == n
    finally:
        mca.params.unset("dtd_window_size")
        mca.params.unset("dtd_threshold_size")
        c.fini()


def test_tile_reseed_between_waits_is_honored(ctx):
    """After a wait() quiescence the HOST copy is authoritative again: a
    user reseeding tile.data is seen by the next round of batched tasks."""
    tp = DTDTaskpool(ctx, "reseed")
    t = _tile(tp)
    for _ in range(10):
        tp.insert_task(_inc, (t, RW), jit=False)
    assert tp.wait(timeout=30)
    assert _val(t) == 10.0
    t.data.get_copy(0).payload = torch.zeros(2, 2)
    for _ in range(10):
        tp.insert_task(_inc, (t, RW), jit=False)
    assert tp.wait(timeout=30)
    tp.close()
    ctx.wait(timeout=30)
    assert _val(t) == 10.0


class _FlushBoom:
    """Engine proxy whose insert_many raises once — the flush-failure
    rollback path (everything else delegates)."""

    def __init__(self, real):
        self._real = real
        self.armed = True

    def __getattr__(self, name):
        return getattr(self._real, name)

    def insert_many(self, specs):
        if self.armed:
            self.armed = False
            raise MemoryError("intentional-flush-boom")
        return self._real.insert_many(specs)


def test_flush_failure_rolls_back_counters(ctx):
    """A failed insert_many links NOTHING, so the pre-counted
    nb_tasks/inserted roll back — or the pool could never quiesce."""
    tp = DTDTaskpool(ctx, "fboom")
    t = _tile(tp)
    tp.insert_task(_inc, (t, RW), jit=False)      # registers the class
    for _ in range(5):
        tp.insert_task(_inc, (t, RW), jit=False)  # buffered
    assert len(tp._bbuf) == 5
    boom = _FlushBoom(tp._neng)
    tp._neng = boom
    with pytest.raises(MemoryError):
        tp._flush_batch()
    tp._neng = boom._real
    assert not boom.armed
    ins_after = tp.inserted
    assert tp.wait(timeout=30)
    tp.close()
    ctx.wait(timeout=30)
    assert tp.inserted == ins_after == 1
    assert tp.nb_tasks == 0
    assert _val(t) == 1.0
