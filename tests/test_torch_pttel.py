"""The port's mesh telemetry plane (``parsec_tpu_torch/comm/pttel.py``) with
the watchdog, the flight recorder and the push-mode reconciler: the
reference's ``tests/test_pttel.py`` on the port's CPU contexts, and
cross-checks through both packages.

Five layers, mirroring how the observability plane is built:

* **tree/fold units** — the pure math of the reduction tree
  (parent/children inverses, depth bound) and :func:`fold_entry` (delta
  telescoping, seq idempotence) plus the sparse histogram bucket merge
  equalling per-rank sums;
* **in-process 8-rank mesh** — real :class:`TelemetryPlane` instances over a
  ThreadsCE fabric, rounds driven deterministically: the O(log P) frame
  contract (<= 1 tx frame per rank per round, <= fanout rx), full-mesh
  convergence at the root, and delta correctness for a marker counter that
  CHANGES between rounds;
* **watchdog** — a real context's scheduler plane: an injected
  never-drained pool is caught within 2x ``watchdog_stall_ms`` with exactly
  one flight record, an idle-but-healthy pool never trips, recovery clears
  the episode and /health;
* **flight recorder** — dump round-trip: the companion ``.pbp`` is readable
  by ``tools/trace_reader`` and the JSON parses with the attributed trigger;
* **reconciler** — push-mode rounds with zero HTTP fetches, partial rounds
  that skip only the missing ranks, and the flat-dict ``_scrape``
  monkeypatch contract;
* **2-OS-rank leg** — the acceptance program
  (:func:`parsec_tpu_torch.serving.harness.pttel_2rank_program`): pushed
  rollup equals the per-rank registry truth, push-mode reconciler with zero
  fetches, forced stall -> one attributed flight record.

Cross-checks: the fold math (:func:`fold_entry`, :func:`mesh_sum`,
:func:`merge_rank_hists`, the tree shape) on seeded scripts with replayed
and out-of-order entries, and an 8-rank ThreadsCE mesh fed the same
per-rank counter and histogram script in both packages, whose rollups must
be equal apart from the wall-clock stamps. The 2-OS-rank job holds the
port's job lock only.
"""

import functools
import glob
import importlib
import json
import math
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest

from parsec_tpu_torch.comm.pttel import (TEL_STATS, TelemetryPlane,
                                         fold_entry, gauge_key,
                                         merge_rank_hists, mesh_sum,
                                         tel_children, tel_depth, tel_parent)
from parsec_tpu_torch.utils import mca


# ------------------------------------------------------------- tree shape

@pytest.mark.parametrize("nb_ranks,fanout", [(2, 2), (8, 2), (8, 4),
                                             (13, 3), (64, 2), (1, 2)])
def test_tree_parent_children_inverse(nb_ranks, fanout):
    assert tel_parent(0, fanout) is None
    seen = set()
    for r in range(nb_ranks):
        kids = tel_children(r, nb_ranks, fanout)
        assert len(kids) <= fanout
        for c in kids:
            assert tel_parent(c, fanout) == r
            assert c not in seen
            seen.add(c)
    # every non-root rank is exactly one rank's child
    assert seen == set(range(1, nb_ranks))
    depth = tel_depth(nb_ranks, fanout)
    if nb_ranks > 1:
        assert depth <= math.ceil(math.log(nb_ranks, fanout)) + 1
        # walking any rank to the root takes <= depth hops
        for r in range(nb_ranks):
            hops, cur = 0, r
            while cur != 0:
                cur = tel_parent(cur, fanout)
                hops += 1
            assert hops <= depth
    else:
        assert depth == 0


# -------------------------------------------------------------- fold math

def test_fold_entry_telescopes_and_dedups():
    store = {}
    assert fold_entry(store, {"r": 3, "seq": 1, "ts": 10.0,
                              "d": {"a": 5, "g": 2.5}})
    # replaying the SAME entry is a no-op (idempotence)
    snap = {r: dict(st["counters"]) for r, st in store.items()}
    assert not fold_entry(store, {"r": 3, "seq": 1, "ts": 10.0,
                                  "d": {"a": 5, "g": 2.5}})
    assert {r: dict(st["counters"]) for r, st in store.items()} == snap
    # a stale seq is dropped even with different content
    assert not fold_entry(store, {"r": 3, "seq": 0, "ts": 9.0,
                                  "d": {"a": 100}})
    assert store[3]["counters"]["a"] == 5
    # telescoping: cumulative == sum of deltas == latest snapshot value
    assert fold_entry(store, {"r": 3, "seq": 2, "ts": 11.0,
                              "d": {"a": -2, "g": 0.5}})
    assert store[3]["counters"]["a"] == 3
    assert store[3]["counters"]["g"] == pytest.approx(3.0)
    assert store[3]["seq"] == 2 and store[3]["ts"] == 11.0


def test_mesh_sum_excludes_gauges():
    assert gauge_key("sched.hist.queue_ns.p99_us")
    assert not gauge_key("sched.hist.queue_ns.count")
    assert gauge_key("comm.clock_offset_ns")
    assert not gauge_key("ptfab.served.tv")
    store = {}
    fold_entry(store, {"r": 0, "seq": 1, "ts": 1.0,
                       "d": {"ptfab.served.tv": 10,
                             "x.hist.lat.p99_us": 400.0}})
    fold_entry(store, {"r": 1, "seq": 1, "ts": 1.0,
                       "d": {"ptfab.served.tv": 7,
                             "x.hist.lat.p99_us": 900.0}})
    total = mesh_sum(store)
    assert total["ptfab.served.tv"] == 17
    assert "x.hist.lat.p99_us" not in total     # summed p99s lie
    # but the gauge stays visible in the per-rank columns
    assert store[1]["counters"]["x.hist.lat.p99_us"] == 900.0


def test_merge_rank_hists_equals_per_rank_sums():
    h0 = {"dtd.task_ns": [4, 1000, [[3, 2], [5, 2]]]}
    h1 = {"dtd.task_ns": [3, 700, [[3, 1], [9, 2]]],
          "sched.queue_ns": [1, 50, [[0, 1]]]}
    merged = merge_rank_hists([h0, h1])
    count, sum_ns, buckets = merged["dtd.task_ns"]
    assert count == 7 and sum_ns == 1700
    assert buckets == [[3, 3], [5, 2], [9, 2]]
    assert sum(c for _, c in buckets) == count
    assert merged["sched.queue_ns"] == [1, 50, [[0, 1]]]


# ------------------------------------------- in-process 8-rank mesh (tree)

def _mesh(nb_ranks, fanout, pkg="parsec_tpu_torch", order=None):
    """Real TelemetryPlanes (of ``pkg``) over the in-process thread
    fabric, with per-rank frame counting wrapped around send_am. ``order``
    is the order the planes are built in (the newest is the process's
    ``current_plane``)."""
    engine = importlib.import_module(f"{pkg}.comm.engine")
    threads = importlib.import_module(f"{pkg}.comm.threads")
    pttel = importlib.import_module(f"{pkg}.comm.pttel")
    pmca = importlib.import_module(f"{pkg}.utils.mca")
    tag = engine.TAG_PTTEL
    fabric = threads.ThreadFabric(nb_ranks)
    pmca.set("tel_interval_ms", 10_000)   # never self-fires; rounds manual
    pmca.set("tel_fanout", fanout)
    planes, tx = [None] * nb_ranks, [0] * nb_ranks
    for r in (order if order is not None else range(nb_ranks)):
        ce = threads.ThreadsCE(fabric, r)
        orig = ce.send_am

        def counted(tag_, dst, header, payload=None, _o=orig, _r=r):
            if tag_ == tag:
                tx[_r] += 1
            return _o(tag_, dst, header, payload)

        ce.send_am = counted
        plane = pttel.TelemetryPlane(SimpleNamespace(ce=ce))
        ce.tag_register(tag,
                        lambda _ce, src, hdr, _p, pl=plane:
                        pl.on_frame(src, hdr))
        planes[r] = plane
    return planes, tx


def _unset_tel(pkg="parsec_tpu_torch"):
    pmca = importlib.import_module(f"{pkg}.utils.mca")
    for name in ("tel_interval_ms", "tel_fanout"):
        pmca.params.unset(name)


def _sweep(planes):
    """One mesh round, leaves-first with progress between ranks, so a
    leaf's entry reaches the root within tree-depth sweeps (and in ONE
    sweep at this deterministic ordering)."""
    for p in sorted(planes, key=lambda p: -p.my_rank):
        p.round()
        for q in planes:
            q.ce.progress()


def test_eight_rank_mesh_converges_with_log_frames():
    from parsec_tpu_torch.utils.counters import counters
    nb, fanout = 8, 2
    before = TEL_STATS.snapshot()
    counters.set("pttel_test.marker", 5)
    planes, tx = _mesh(nb, fanout)
    try:
        _sweep(planes)
        root = planes[0]
        # the deterministic leaves-first ordering converges in ONE sweep
        assert sorted(root.rollup()["ranks"]) == list(range(nb))
        # delta correctness under CHANGE: the marker moves between
        # rounds; the telescoped cumulative must equal the latest value,
        # not the sum of snapshots
        counters.set("pttel_test.marker", 12)
        _sweep(planes)
        _sweep(planes)
        roll = root.rollup()
        for r in range(nb):
            assert roll["ranks"][r]["counters"]["pttel_test.marker"] == 12
        assert roll["rollup"]["pttel_test.marker"] == 12 * nb
        assert roll["depth"] == tel_depth(nb, fanout) == 3
        for r in range(nb):
            assert 0 <= roll["ranks"][r]["staleness_s"] < 60
        # O(log P) frame shape: every rank sent AT MOST one frame per
        # round (the root none), mesh-wide (P-1) frames per round
        rounds = 3
        assert tx[0] == 0
        for r in range(1, nb):
            assert 1 <= tx[r] <= rounds
        assert sum(tx) == (nb - 1) * rounds
        d = TEL_STATS.delta(before)
        assert d["frames_tx"] == sum(tx)
        assert d["frames_rx"] == sum(tx)     # every frame delivered once
        assert d["tx_errors"] == 0
    finally:
        _unset_tel()


def test_wire_frame_replay_is_idempotent():
    """A duplicated TAG_PTTEL frame (transport retry) must not
    double-count: replay the exact frame the leaf sent."""
    from parsec_tpu_torch.comm.engine import TAG_PTTEL
    planes, _tx = _mesh(2, 2)
    try:
        captured = []
        leaf, root = planes[1], planes[0]
        orig = leaf.ce.send_am

        def capture(tag, dst, header, payload=None):
            if tag == TAG_PTTEL:
                captured.append((dst, header))
            return orig(tag, dst, header, payload)

        leaf.ce.send_am = capture
        leaf.round()
        root.ce.progress()
        assert captured
        cum = dict(root._store[1]["counters"])
        drops = TEL_STATS["late_drops"]
        root.on_frame(1, captured[-1][1])      # replay verbatim
        assert dict(root._store[1]["counters"]) == cum
        assert TEL_STATS["late_drops"] > drops
    finally:
        _unset_tel()


# --------------------------------------------------------------- watchdog

@pytest.fixture
def plane_ctx():
    from parsec_tpu_torch.core.context import Context
    ctx = Context(nb_cores=1, device="cpu")
    assert ctx.sched_plane is not None
    yield ctx
    ctx.fini()


def test_watchdog_idle_pool_never_trips(plane_ctx):
    from parsec_tpu_torch.core.watchdog import WATCHDOG_STATS, StallWatchdog
    sp = plane_ctx.sched_plane
    h = sp.register_pool("idle-pool", sp.KIND_EXT, weight=1, window=0)
    assert h >= 0
    wd = StallWatchdog(plane_ctx, stall_ms=40)
    before = WATCHDOG_STATS.snapshot()
    try:
        for _ in range(6):                 # well past the threshold
            wd.tick()
            time.sleep(0.02)
        d = WATCHDOG_STATS.delta(before)
        assert d["pool_stalls"] == 0 and d["comm_stalls"] == 0 \
            and d["device_stalls"] == 0
        assert wd.active_stalls() == []
    finally:
        wd.stop()
        sp.unregister_pool(h)


def test_watchdog_catches_injected_stall_and_recovers(plane_ctx, tmp_path):
    from parsec_tpu_torch.core.watchdog import (WATCHDOG_STATS,
                                                StallWatchdog, health_report)
    from parsec_tpu_torch.tools import flight
    mca.set("flight_dir", str(tmp_path))
    flight.reset()
    sp = plane_ctx.sched_plane
    h = sp.register_pool("stuck-pool", sp.KIND_EXT, weight=1, window=0)
    assert h >= 0
    sp.admit(h, 3)                        # held work that never drains
    stall_ms = 60
    wd = StallWatchdog(plane_ctx, stall_ms=stall_ms)
    before = WATCHDOG_STATS.snapshot()
    t0 = time.monotonic()
    try:
        detected = None
        while time.monotonic() - t0 < 2 * stall_ms / 1e3 + 0.5:
            wd.tick()
            if WATCHDOG_STATS["pool_stalls"] > before["pool_stalls"]:
                detected = (time.monotonic() - t0) * 1e3
                break
            time.sleep(stall_ms / 1e3 / 8)
        assert detected is not None, "stall never detected"
        assert detected <= 2 * stall_ms + 500   # 2x bound (+ tick slack)
        stalls = wd.active_stalls()
        assert any(s["lane"] == "pool:stuck-pool" for s in stalls)
        hr = health_report()
        assert hr is not None and hr["degraded"]
        # exactly ONE attributed flight record, however long it persists
        for _ in range(4):
            wd.tick()
            time.sleep(stall_ms / 1e3 / 4)
        records = glob.glob(str(tmp_path / "flight-r*-*.json"))
        assert len(records) == 1, records
        body = json.loads(open(records[0]).read())
        assert body["trigger"] == "watchdog_stall"
        assert body["detail"]["lane"] == "pool:stuck-pool"
        # recovery: progress resumes -> episode clears, /health restores
        sp.retired(h, 3)
        wd.tick()
        d = WATCHDOG_STATS.delta(before)
        assert d["pool_stalls"] == 1 and d["clears"] >= 1
        assert wd.active_stalls() == []
        assert not health_report()["degraded"]
    finally:
        wd.stop()
        sp.unregister_pool(h)
        mca.set("flight_dir", "")


def test_watchdog_attributes_a_local_context_to_the_mesh_rank(plane_ctx):
    """A single-rank local context in a mesh process (the serving-tier
    shape) takes the process's distributed rank from the telemetry plane:
    its flight records are ``flight-r<rank>-*``."""
    from parsec_tpu_torch.comm import pttel
    from parsec_tpu_torch.core.watchdog import StallWatchdog
    planes, _tx = _mesh(3, 2, order=(0, 1, 2))   # rank 2's plane is newest
    try:
        assert pttel.current_plane() is planes[2]
        wd = StallWatchdog(plane_ctx, stall_ms=40)
        wd.stop()
        assert plane_ctx.my_rank == 0 and wd.rank == 2
    finally:
        _unset_tel()


# --------------------------------------------------------- flight recorder

def test_flight_dump_round_trips(tmp_path):
    from parsec_tpu_torch.tools import flight
    from parsec_tpu_torch.tools.trace_reader import read_pbp
    from parsec_tpu_torch.utils.trace import EVENT_FLAG_POINT, Profiling
    flight.reset()
    prof = Profiling()
    kb, ke = prof.add_dictionary_keyword("unit::work")
    st = prof.stream("worker-0")
    for i in range(5):
        st.trace(kb, i, 1, 0)
        st.trace(ke, i, 1, 0)
    st.trace(kb, 99, 1, EVENT_FLAG_POINT)
    ctx = SimpleNamespace(profiling=prof, my_rank=3, comm=None,
                          _ntrace=None)
    path = flight.record("unit_test", {"why": "round-trip"},
                         key="unit", ctx=ctx, dir=str(tmp_path))
    assert path is not None and os.path.exists(path)
    body = json.loads(open(path).read())
    assert body["trigger"] == "unit_test" and body["rank"] == 3
    assert body["detail"] == {"why": "round-trip"}
    assert isinstance(body["counters"], dict)
    assert body["events"] == 11
    # companion .pbp reads back through the standard trace reader with
    # the dictionary numbering intact
    trace = read_pbp(os.path.join(str(tmp_path), body["trace"]))
    assert [d["name"] for d in trace.dictionary] == ["unit::work"]
    assert trace.streams[0]["name"] == "worker-0"
    assert len(trace.streams[0]["events"]) == 11
    # same key never dumps twice; a fresh key does (bounded count)
    assert flight.record("unit_test", {}, key="unit", ctx=ctx,
                         dir=str(tmp_path)) is None
    assert flight.record("other", {}, key="other", ctx=ctx,
                         dir=str(tmp_path)) is not None
    flight.reset()


def test_flight_unarmed_is_counted_noop(tmp_path):
    from parsec_tpu_torch.tools import flight
    flight.reset()
    before = flight.FLIGHT_STATS.snapshot()
    assert mca.get("flight_dir", "") == ""
    assert flight.record("x", {}) is None
    d = flight.FLIGHT_STATS.delta(before)
    assert d["triggers"] == 1 and d["suppressed"] == 1 and d["dumps"] == 0


# -------------------------------------------------------------- reconciler

class _StubFab:
    nb_ranks = 2
    my_rank = 0
    rde = None
    _dead: set = set()

    def __init__(self):
        self.weights = {}

    def set_weight(self, t, w):
        self.weights[t] = w


def _mk_rec(**kw):
    from parsec_tpu_torch.serving.reconcile import ShareReconciler
    kw.setdefault("tel", None)
    return ShareReconciler(_StubFab(), [], {"a": 1.0, "b": 1.0}, **kw)


def test_reconcile_partial_round_skips_missing_rank():
    from parsec_tpu_torch.serving.reconcile import RECONCILE_STATS
    rec = _mk_rec()
    feeds = [({0: {"a": 0, "b": 0}, 1: {"a": 0, "b": 0}}, set()),
             ({0: {"a": 64, "b": 16}}, {1}),             # rank 1 dark
             ({0: {"a": 128, "b": 32}, 1: {"a": 80, "b": 80}}, set())]
    rec._scrape = lambda: feeds.pop(0)
    before = RECONCILE_STATS.snapshot()
    assert rec.step() is None          # first round only seeds _last
    err = rec.step()                   # partial: reconciled over rank 0
    assert err is not None and err > 0
    assert rec._last[1] == {"a": 0, "b": 0}    # kept, not dropped
    err2 = rec.step()                  # rank 1 back: delta spans the gap
    assert err2 is not None
    d = RECONCILE_STATS.delta(before)
    assert d["partial_rounds"] == 1 and d["missing_ranks"] == 1
    assert rec.rounds == 2


def test_reconcile_push_mode_zero_http_fetches():
    from parsec_tpu_torch.serving.reconcile import RECONCILE_STATS
    served = {"n": 0}

    class _FakeTel:
        interval_s = 0.01

        def rollup(self):
            served["n"] += 64
            now = time.time()
            return {"ranks": {
                r: {"seq": served["n"], "ts": now, "staleness_s": 0.0,
                    "counters": {"ptfab.served.a": served["n"],
                                 "ptfab.served.b": served["n"]}}
                for r in range(2)}}

    rec = _mk_rec(tel=_FakeTel())
    before = RECONCILE_STATS.snapshot()
    rec.step()
    assert rec.step() is not None
    d = RECONCILE_STATS.delta(before)
    assert d["push_rounds"] == 2 and d["http_fetches"] == 0 \
        and d["scrape_rounds"] == 0
    assert rec.last_mode == "push"
    assert rec.converged_round is not None     # equal shares, weights 1:1


def test_reconcile_push_stale_rank_counts_missing():
    from parsec_tpu_torch.serving.reconcile import RECONCILE_STATS

    class _StaleTel:
        interval_s = 0.01

        def rollup(self):
            now = time.time()
            return {"ranks": {
                0: {"seq": 1, "ts": now, "staleness_s": 0.0,
                    "counters": {"ptfab.served.a": 100,
                                 "ptfab.served.b": 100}},
                1: {"seq": 1, "ts": now - 99, "staleness_s": 99.0,
                    "counters": {"ptfab.served.a": 5,
                                 "ptfab.served.b": 5}}}}

    rec = _mk_rec(tel=_StaleTel())
    before = RECONCILE_STATS.snapshot()
    got = rec._scrape()
    assert got is not None
    per_rank, missing = got
    assert 0 in per_rank and missing == {1}
    assert RECONCILE_STATS.delta(before)["push_rounds"] == 1


def test_reconcile_legacy_flat_scrape_still_works():
    """A flat {tenant: total} _scrape keeps driving step() unchanged."""
    rec = _mk_rec()
    feeds = [{"a": 0, "b": 0}, {"a": 90, "b": 30}]
    rec._scrape = lambda: feeds.pop(0)
    assert rec.step() is None
    err = rec.step()
    assert err is not None and err > 0
    assert rec.rounds == 1
    assert rec.fabric.weights          # nudges applied locally


# ------------------------------------------------ /mesh and live_view mesh

def test_mesh_endpoint_and_live_view_poll_the_rollup():
    """/mesh serves rank 0's rollup (the newest plane of the process); a
    live view in mesh mode reads every rank's series and the mesh sums from
    that one endpoint, with each rank's staleness in its stats."""
    from parsec_tpu_torch.tools.live_view import LiveCounterView
    from parsec_tpu_torch.tools.metrics_server import MetricsServer, fetch
    from parsec_tpu_torch.utils.counters import counters
    counters.set("pttel_test.mesh_marker", 7)
    planes, _tx = _mesh(4, 2, order=(3, 2, 1, 0))   # rank 0 newest
    srv = MetricsServer(port=0).start()
    try:
        _sweep(planes)
        _sweep(planes)
        body = fetch(srv.endpoint, path="/mesh")
        assert body["my_rank"] == 0 and body["nb_ranks"] == 4
        assert sorted(int(r) for r in body["ranks"]) == [0, 1, 2, 3]
        assert body["rollup"]["pttel_test.mesh_marker"] == 28
        view = LiveCounterView(mesh_endpoint=srv.endpoint, interval_s=0.01)
        view.sample()
        assert view.series["mesh.pttel_test.mesh_marker"][-1] == 28
        for r in range(4):
            assert view.series[f"r{r}.pttel_test.mesh_marker"][-1] == 7
        st = view.stats()
        assert st["plane_down"] == 0 and st["poll_errors"] == 0
        assert sorted(st["mesh_staleness"]) == [0, 1, 2, 3]
    finally:
        srv.stop()
        _unset_tel()


def test_mesh_endpoint_without_a_plane_says_why(monkeypatch):
    from parsec_tpu_torch.comm import pttel
    from parsec_tpu_torch.tools.live_view import LiveCounterView
    from parsec_tpu_torch.tools.metrics_server import MetricsServer, fetch
    monkeypatch.setattr(pttel, "_current", None)    # no plane in process
    assert pttel.current_plane() is None
    srv = MetricsServer(port=0).start()
    try:
        body = fetch(srv.endpoint, path="/mesh")
        assert body["mesh"] is None and "tel_interval_ms" in body["reason"]
        view = LiveCounterView(mesh_endpoint=srv.endpoint)
        view.sample()
        assert view.stats()["plane_down"] == 1
    finally:
        srv.stop()


def test_remote_dep_parks_frames_until_the_plane_attaches():
    """TAG_PTTEL frames that arrive before a plane attaches park in a box
    of 256 (``pttel.parked``; past the bound ``late_drops``) and replay at
    ``tel_attach``; an engine built with ``tel_interval_ms`` > 0 builds
    and starts its plane and stops it at ``fini``."""
    from parsec_tpu_torch.comm.engine import TAG_PTTEL
    from parsec_tpu_torch.comm.remote_dep import RemoteDepEngine
    from parsec_tpu_torch.comm.threads import ThreadFabric, ThreadsCE
    from parsec_tpu_torch.core.context import Context
    fabric = ThreadFabric(2)
    ce0, ce1 = ThreadsCE(fabric, 0), ThreadsCE(fabric, 1)
    ctx = Context(nb_cores=1, device="cpu", my_rank=0, nb_ranks=2)
    eng = RemoteDepEngine(ctx, ce0)
    try:
        assert eng.telemetry is None
        before = TEL_STATS.snapshot()
        frame = {"k": "fold", "e": [{"r": 1, "seq": 1, "ts": time.time(),
                                     "d": {"x.parked": 3}, "h": {}}]}
        for i in range(258):
            e = dict(frame["e"][0], seq=i + 1)
            ce1.send_am(TAG_PTTEL, 0, {"k": "fold", "e": [e]}, None)
        while ce0.progress():
            pass
        d = TEL_STATS.delta(before)
        assert d["parked"] == 256 and d["late_drops"] == 2
        mca.set("tel_interval_ms", 10_000)
        plane = TelemetryPlane(eng)
        eng.tel_attach(plane)
        # the 256 parked frames replayed in order: seq 1..256 folded
        assert plane.seq_of(1) == 256
        assert plane._store[1]["counters"]["x.parked"] == 3 * 256
    finally:
        _unset_tel()
        ctx.comm = None
        ctx.fini()
    # an armed engine builds, starts and stops its own plane
    fabric = ThreadFabric(1)
    mca.set("tel_interval_ms", 10_000)
    try:
        ctx = Context(nb_cores=1, device="cpu", my_rank=0, nb_ranks=1)
        eng = RemoteDepEngine(ctx, ThreadsCE(fabric, 0))
        assert isinstance(eng.telemetry, TelemetryPlane)
        eng.enable()
        assert eng.telemetry._thread is not None
        rounds = TEL_STATS["rounds"]
        eng.fini()
        assert eng.telemetry._thread is None
        assert TEL_STATS["rounds"] == rounds + 1     # the final flush
    finally:
        _unset_tel()
        ctx.comm = None
        ctx.fini()


# ------------------------------------------------------------ 2-OS-rank leg

def test_two_rank_pttel_push_and_stall(tmp_path):
    """The acceptance leg: real processes, real wire. The pushed rollup
    at rank 0 must equal each rank's own registry truth for every
    ptfab.served.* counter; the push-mode reconciler must issue ZERO
    HTTP fetches; the forced stall on rank 1 must produce exactly one
    attributed flight record while rank 0's watchdog stays clean."""
    from parsec_tpu_torch.comm.tcp import run_distributed_procs
    from parsec_tpu_torch.serving.harness import pttel_2rank_program
    res = run_distributed_procs(
        2, functools.partial(pttel_2rank_program, stall=True,
                             flight_dir=str(tmp_path)), timeout=300)
    for r in res:
        assert r.get("telemetry"), r.get("reason")
    r0, r1 = res
    # --- pushed rollup == per-rank truth, within one settled round ---
    assert sorted(r0["ranks_seen"]) == [0, 1]
    for rank, r in enumerate(res):
        assert r["served_local"], "no served counters registered"
        assert r0["per_rank_served"][rank] == r["served_local"], \
            (rank, r0["per_rank_served"][rank], r["served_local"])
    for k in r0["per_rank_served"][0]:
        assert r0["rollup_served"][k] == sum(
            r0["per_rank_served"][r].get(k, 0) for r in (0, 1))
    assert all(s < 30 for s in r0["staleness_s"].values())
    # --- O(log P) wire shape + clean frames --------------------------
    assert r1["tel_stats"]["frames_tx"] > 0       # leaf pushed
    assert r0["tel_stats"]["frames_rx"] > 0       # root folded
    assert r0["tel_stats"]["frames_tx"] == 0      # the root sends none
    for r in res:
        assert r["tel_stats"]["rounds"] > 0
        assert r["tel_stats"]["tx_errors"] == 0
        assert r["frame_errors"] == 0
    # --- push-mode reconciler: zero per-round HTTP fetches -----------
    assert r0["reconcile_mode"] == "push"
    assert r0["reconcile"]["push_rounds"] > 0
    assert r0["reconcile"]["http_fetches"] == 0
    # --- forced stall: one attributed record, clean elsewhere --------
    assert r0["watchdog_armed"] and r1["watchdog_armed"]
    st = r1["stall"]
    assert st["watchdog"]["pool_stalls"] == 1, st
    assert st["detected_ms"] <= 2 * 500, st       # 2x watchdog_stall_ms
    assert st["flight_records"] == 1, st
    assert r0["watchdog_stats"]["pool_stalls"] == 0
    assert r0["watchdog_stats"]["device_stalls"] == 0
    records = glob.glob(str(tmp_path / "flight-r1-*.json"))
    assert len(records) == 1
    body = json.loads(open(records[0]).read())
    assert body["trigger"] == "watchdog_stall"
    assert body["detail"]["lane"] == "pool:stall-inject"
    # --- chip_smoke's phase 14 (e) gate holds on the same run ----------
    import chip_smoke
    assert chip_smoke.telemetry_gate(res, [body])


# ------------------------------------------------ cross-checks: reference

def _entry_script(seed, nb_ranks=5, n=60):
    """Wire entries for ``nb_ranks`` origins with replays and out-of-order
    seqs: each origin's seqs 1..k are shuffled locally and some entries
    are sent twice."""
    rng = np.random.default_rng(seed)
    keys = ["a.x", "a.y", "b.hist.lat.p99_us", "b.hist.lat.count",
            "comm.clock_offset_ns", "c.z"]
    entries = []
    for r in range(nb_ranks):
        k = int(rng.integers(3, n // nb_ranks + 3))
        seqs = list(range(1, k + 1))
        for i in range(0, k - 1, 3):            # local reordering
            if rng.random() < 0.5:
                seqs[i], seqs[i + 1] = seqs[i + 1], seqs[i]
        for s in seqs:
            d = {}
            for key in keys:
                if rng.random() < 0.6:
                    d[key] = (float(rng.normal(0, 100))
                              if ".hist." in key and "count" not in key
                              else int(rng.integers(-5, 50)))
            h = {}
            if rng.random() < 0.7:
                buckets = sorted({int(i) for i in
                                  rng.integers(0, 64, size=4)})
                cells = [[i, int(rng.integers(1, 9))] for i in buckets]
                h["dtd.task_ns"] = [sum(c for _, c in cells),
                                    int(rng.integers(0, 10 ** 6)), cells]
            e = {"r": r, "seq": s, "ts": float(s), "d": d, "h": h}
            entries.append(e)
            if rng.random() < 0.25:
                entries.append(dict(e))             # a replayed entry
    order = rng.permutation(len(entries))           # interleave origins
    by_rank = {}
    out = []
    for i in order:                                 # keep per-origin order
        by_rank.setdefault(entries[i]["r"], []).append(i)
    cursor = {r: iter(sorted(v)) for r, v in by_rank.items()}
    for i in order:
        out.append(entries[next(cursor[entries[i]["r"]])])
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fold_math_equals_reference(seed):
    """fold_entry (return values and stores), mesh_sum, merge_rank_hists
    and the tree shape give the reference's results exactly, on seeded
    scripts with replayed and out-of-order seqs."""
    from parsec_tpu.comm import pttel as R
    script = _entry_script(seed)
    ours, theirs = {}, {}
    applied = [(fold_entry(ours, dict(e)), R.fold_entry(theirs, dict(e)))
               for e in script]
    assert [a for a, _ in applied] == [b for _, b in applied]
    assert any(not a for a, _ in applied) and any(a for a, _ in applied)
    assert ours == theirs
    assert mesh_sum(ours) == R.mesh_sum(theirs)
    hists = [st["hists"] for st in ours.values()]
    assert merge_rank_hists(hists) == R.merge_rank_hists(
        [st["hists"] for st in theirs.values()])
    for key in {k for st in ours.values() for k in st["counters"]}:
        assert gauge_key(key) == R.gauge_key(key)
    for nb in (1, 2, 3, 7, 8, 13, 64, 100):
        for fanout in (1, 2, 3, 4, 8):
            assert tel_depth(nb, fanout) == R.tel_depth(nb, fanout)
            for r in range(nb):
                assert tel_parent(r, fanout) == R.tel_parent(r, fanout)
                assert tel_children(r, nb, fanout) == \
                    R.tel_children(r, nb, fanout)


def _scripted_rollup(pkg, counter_script, hist_script, nb, fanout, sweeps):
    """An nb-rank mesh of ``pkg``'s planes whose snapshots replay the
    script (rank r's i-th round reads ``counter_script[r][i]`` and
    ``hist_script[r][i]``); the root's rollup after ``sweeps`` sweeps, and
    the TEL_STATS deltas."""
    pttel = importlib.import_module(f"{pkg}.comm.pttel")
    before = pttel.TEL_STATS.snapshot()
    planes, tx = _mesh(nb, fanout, pkg=pkg)
    try:
        for r, plane in enumerate(planes):
            cs, hs = iter(counter_script[r]), iter(hist_script[r])
            plane._snapshot_counters = lambda cs=cs: dict(next(cs))
            plane._snapshot_hists = lambda hs=hs: dict(next(hs))
        for _ in range(sweeps):
            _sweep(planes)
        roll = planes[0].rollup()
    finally:
        _unset_tel(pkg)
    return roll, pttel.TEL_STATS.delta(before), tx


def test_eight_rank_rollup_equals_reference():
    """The same per-rank counter and histogram script through an 8-rank
    ThreadsCE mesh of each package: the root's rollup is the same apart
    from the wall-clock stamps (``ts``, ``staleness_s``); ``rounds``, a
    process-wide count, is compared as its change, with the frame counts."""
    nb, fanout, sweeps = 8, 2, 3
    rng = np.random.default_rng(8)
    counter_script, hist_script = [], []
    for r in range(nb):
        cum = {"x.served": 0, "x.bytes": 0}
        rows, hrows = [], []
        for i in range(sweeps):
            cum["x.served"] += int(rng.integers(0, 40))
            cum["x.bytes"] += int(rng.integers(0, 1 << 20))
            row = dict(cum)
            row["x.hist.lat.p99_us"] = float(rng.uniform(1, 900))
            row["comm.clock_offset_ns"] = int(rng.integers(-5000, 5000))
            if i != 1:                     # a gauge that comes and goes
                row["x.level"] = int(rng.integers(0, 10))
            rows.append(row)
            cells = [[int(b), int(rng.integers(1, 5))]
                     for b in sorted(set(rng.integers(0, 40, size=3)))]
            hrows.append({"ptexec.exec_ns": [sum(c for _, c in cells),
                                             int(rng.integers(0, 10 ** 7)),
                                             cells]})
        counter_script.append(rows)
        hist_script.append(hrows)
    ours, d_ours, tx_ours = _scripted_rollup(
        "parsec_tpu_torch", counter_script, hist_script, nb, fanout, sweeps)
    theirs, d_theirs, tx_theirs = _scripted_rollup(
        "parsec_tpu", counter_script, hist_script, nb, fanout, sweeps)

    def strip(roll):
        out = {k: v for k, v in roll.items() if k != "rounds"}
        out["ranks"] = {r: {k: v for k, v in ent.items()
                            if k not in ("ts", "staleness_s")}
                        for r, ent in roll["ranks"].items()}
        return out
    assert strip(ours) == strip(theirs)
    assert sorted(ours["ranks"]) == list(range(nb))
    # the telescoped cumulative is each rank's last snapshot
    for r in range(nb):
        assert ours["ranks"][r]["counters"]["x.served"] == \
            counter_script[r][-1]["x.served"]
    assert ours["rollup"]["x.served"] == sum(
        counter_script[r][-1]["x.served"] for r in range(nb))
    assert "x.hist.lat.p99_us" not in ours["rollup"]
    assert tx_ours == tx_theirs
    for key in ("rounds", "frames_tx", "frames_rx", "folds",
                "late_drops", "tx_errors"):
        assert d_ours[key] == d_theirs[key], key


def test_pttel_counter_names_match_reference():
    """install_native_counters exports the same pttel.* and reconcile.*
    names in both packages."""
    from parsec_tpu.utils import counters as RC
    from parsec_tpu_torch.utils import counters as PC
    RC.install_native_counters()
    PC.install_native_counters()

    def names(reg):
        return {n for n in reg.snapshot()
                if n.startswith(("pttel.", "reconcile."))}
    assert names(PC.counters) == names(RC.counters)
    assert len(names(PC.counters)) == 13


# ------------------------------------------- the card leg and chip_smoke

def test_card_serving_leg_with_the_plane_rehearses_on_the_cpu():
    """``card_serving_2rank_program(tel_interval_ms=25)`` with the CUDA
    device module over the CPU: every request served and bit for bit the
    plain chain, rank 0's settled rollup of the served and routed-insert
    counters equal to each rank's own nonzero values, the reconciler's
    rounds read from it with no HTTP fetch; with the plane down no rank
    builds one. ``chip_smoke.py``'s phase 14 (f) gate holds on both runs."""
    import chip_smoke
    from parsec_tpu_torch.comm.tcp import run_distributed_procs
    from parsec_tpu_torch.serving.harness import card_serving_2rank_program
    kw = dict(requests=12, window=4, ts=64, device="cpu")
    server, client = run_distributed_procs(
        2, functools.partial(card_serving_2rank_program, tel_interval_ms=25,
                             **kw), timeout=240)
    assert server["telemetry"] and client["telemetry"]
    assert server["served"] == 12 and server["tiles_equal_plain"]
    assert server["card_context"]
    assert server["per_rank_served"] == {0: server["served_local"],
                                         1: client["served_local"]}
    assert server["served_local"] == {"ptfab.remote_inserts_rx": 12}
    assert client["served_local"] == {"ptfab.remote_inserts_tx": 12}
    assert server["rollup_served"] == {"ptfab.remote_inserts_rx": 12,
                                       "ptfab.remote_inserts_tx": 12}
    assert server["reconcile_mode"] == "push"
    assert server["reconcile"]["push_rounds"] == 4
    assert server["reconcile"]["http_fetches"] == 0
    assert chip_smoke.telemetry_card_gate(server, client, 25, 12, "cpu")
    server, client = run_distributed_procs(
        2, functools.partial(card_serving_2rank_program, **kw), timeout=240)
    assert not server["telemetry"] and not client["telemetry"]
    assert server["served"] == 12 and "served_local" not in server
    assert chip_smoke.telemetry_card_gate(server, client, 0, 12, "cpu")


def test_chip_smoke_telemetry_and_entry_phases_rehearse_on_the_cpu(
        monkeypatch):
    """Phase 15 of ``chip_smoke.py`` with every gate that does not need the
    card: ``--devices --cpu``, ``--help-mca``, and the EP row on one CPU
    rank context at a cut task count (the 2-rank row is
    ``test_ep_scaling_rates_on_cpu_ranks``). Phase 14 (e)'s and (f)'s gates,
    :func:`chip_smoke.telemetry_gate` and
    :func:`chip_smoke.telemetry_card_gate`, are held on the runs of
    ``test_two_rank_pttel_push_and_stall`` and
    ``test_card_serving_leg_with_the_plane_rehearses_on_the_cpu``, so that
    no 2-OS-rank program runs twice."""
    import chip_smoke as CS
    monkeypatch.setattr(CS, "EP_PROCS", (1,))
    monkeypatch.setattr(CS, "EP_NTASKS", 2000)
    monkeypatch.setattr(CS, "EP_TURNS", ("cuda",))
    entry = CS.entry_points("cpu", device="cpu")
    assert sorted(entry["ep"]) == [1] and entry["ep"][1] > 0
    assert [d for d, _, _ in entry["ep_turns"]] == ["cpu"]
