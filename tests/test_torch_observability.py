"""The port's observability plane on one rank (``parsec_tpu_torch/utils/
hist.py``, ``utils/counters.py``, ``utils/info.py``, ``tools/
metrics_server.py``, ``tools/live_view.py``, ``tools/flight.py``,
``core/watchdog.py`` and the trace merge of ``tools/trace_reader.py``): the
reference's single-rank tests of ``tests/test_observability.py``, the
watchdog and flight tests of ``tests/test_pttel.py``, the info tests of
``tests/test_futures_info.py`` and the counter tests of ``tests/test_aux.py``
on the port, on the CPU, plus cross-checks through both packages: the
histogram bucket math and percentile summaries on the same samples, the
constants of the port's ``pthist.h``, and the counter names
``install_native_counters`` registers.
"""

import glob
import json
import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from parsec_tpu_torch import native as native_mod
from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.dsl.dtd import DTDTaskpool, RW
from parsec_tpu_torch.utils import hist as H
from parsec_tpu_torch.utils import mca
from parsec_tpu_torch.utils.info import InfoBag, InfoRegistry

_ptexec = native_mod.load_ptexec()
_ptdtd = native_mod.load_ptdtd()


def _ctx(nb_cores=1):
    return Context(nb_cores=nb_cores, device="cpu")


# ------------------------------------------------------- bucket math units

def test_hist_constants_match_native():
    assert _ptexec.HIST_BUCKETS == H.NBUCKETS
    assert _ptexec.HIST_SUB_BITS == H.SUB_BITS
    assert _ptdtd.HIST_BUCKETS == H.NBUCKETS


def test_hist_constants_match_the_port_header():
    """The port's ``csrc/pthist.h`` declares the constants the Python
    mirror uses."""
    import pathlib
    import re
    src = (pathlib.Path(H.__file__).resolve().parent.parent / "csrc"
           / "pthist.h").read_text()
    sub = int(re.search(r"constexpr int SUB_BITS = (\d+);", src).group(1))
    assert sub == H.SUB_BITS
    assert "constexpr int NBUCKETS = (64 - SUB_BITS + 1) * SUBS;" in src
    assert (64 - sub + 1) * (1 << sub) == H.NBUCKETS == 496


def test_bucket_boundaries():
    """Every value lands in a bucket whose [lo, lo+width) contains it;
    indices are monotone in the value; small values are exact."""
    last = -1
    for v in [0, 1, 2, 7, 8, 9, 15, 16, 17, 31, 32, 100, 1000, 4095, 4096,
              10**6, 10**9, 2**40, 2**62]:
        i = H.bucket_index(v)
        assert i >= last, (v, i, last)
        last = i
        lo = H.bucket_lo(i)
        assert lo <= v < lo + H.bucket_width(i), (v, i, lo)
    for v in range(H.SUBS):
        assert H.bucket_index(v) == v and H.bucket_lo(v) == v
    # continuity: each bucket's end is the next bucket's start
    for i in range(H.NBUCKETS - 1):
        assert H.bucket_lo(i) + H.bucket_width(i) == H.bucket_lo(i + 1), i
    # negative values clamp, never raise
    assert H.bucket_index(-5) == 0


def test_bucket_index_matches_native_recording():
    """Bucketize known values through a real Graph hist: a 1-task graph's
    exec_ns sample must land in SOME bucket and the Python decode must
    see exactly the counts the C side bumped."""
    g = _ptexec.Graph([0], [0, 0], [])
    g.hist_enable()
    g.run(None, 1, 0)
    snap = g.hist_snapshot()
    count, sum_ns, raw = snap["exec_ns"]
    buckets = H.decode_buckets(raw)
    assert count == 1 and sum(buckets) == 1
    i = buckets.index(1)
    assert H.bucket_lo(i) <= max(sum_ns, 0) < H.bucket_lo(i) + \
        H.bucket_width(i) or sum_ns < H.SUBS


def test_percentile_summarization_vs_numpy():
    """p50/p99/p999 from the bucketized distribution stay within one
    bucket width (~12.5% relative) of numpy's exact percentiles."""
    rng = np.random.default_rng(7)
    vals = (rng.lognormal(mean=8.0, sigma=1.2, size=20000)).astype(np.int64)
    buckets = [0] * H.NBUCKETS
    for v in vals:
        buckets[H.bucket_index(int(v))] += 1
    for q in (0.5, 0.99, 0.999):
        exact = float(np.quantile(vals, q))
        est = H.percentile(buckets, q)
        assert abs(est - exact) <= 0.15 * exact + 1, (q, est, exact)
    s = H.summarize(buckets, len(vals), int(vals.sum()))
    assert s["count"] == len(vals)
    assert abs(s["mean_us"] * 1e3 - vals.mean()) < 1.0
    # empty histogram degrades to zeros, never raises
    z = H.summarize([0] * H.NBUCKETS, 0, 0)
    assert z["p99_us"] == 0.0 and z["count"] == 0


@pytest.mark.parametrize("seed", [3, 11])
def test_hist_math_equals_reference(seed):
    """Bucket boundaries, bucket indices and percentile summaries equal the
    reference's ``utils/hist.py`` on the same samples."""
    from parsec_tpu.utils import hist as RH
    assert (RH.SUB_BITS, RH.SUBS, RH.NBUCKETS) == (H.SUB_BITS, H.SUBS,
                                                   H.NBUCKETS)
    assert [H.bucket_lo(i) for i in range(H.NBUCKETS)] == \
        [RH.bucket_lo(i) for i in range(RH.NBUCKETS)]
    assert [H.bucket_mid(i) for i in range(H.NBUCKETS)] == \
        [RH.bucket_mid(i) for i in range(RH.NBUCKETS)]
    rng = np.random.default_rng(seed)
    vals = np.concatenate([
        rng.integers(-4, 64, 500),
        rng.lognormal(10.0, 2.0, 3000).astype(np.int64)])
    assert [H.bucket_index(int(v)) for v in vals] == \
        [RH.bucket_index(int(v)) for v in vals]
    buckets = [0] * H.NBUCKETS
    for v in vals:
        buckets[H.bucket_index(int(v))] += 1
    total = int(np.clip(vals, 0, None).sum())
    assert H.summarize(buckets, len(vals), total) == \
        RH.summarize(buckets, len(vals), total)
    for q in (0.25, 0.5, 0.9, 0.99, 0.999, 1.0):
        assert H.percentile(buckets, q) == RH.percentile(buckets, q)
    raw = np.asarray(buckets, np.uint64).astype("<u8").tobytes()
    assert H.decode_buckets(raw) == RH.decode_buckets(raw) == buckets


def test_graph_hist_concurrent_bumps_sum_exactly():
    """Two workers draining one graph: exec counts sum to exactly n and
    the sampled ready-wait counts exactly the 1-in-8 ids (no lost or
    double bumps from the relaxed atomics)."""
    n = 4096
    # NT independent 2-chains: plenty of parallel work for 2 threads
    goals = [0 if i < n // 2 else 1 for i in range(n)]
    succ_off, succs = [], []
    for i in range(n):
        succ_off.append(len(succs))
        if i < n // 2:
            succs.append(n // 2 + i)
    succ_off.append(len(succs))
    g = _ptexec.Graph(goals, succ_off, succs)
    g.hist_enable()
    errs = []

    def worker():
        try:
            while not g.done():
                g.run(None, 64, 512)
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    ts = [threading.Thread(target=worker) for _ in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not errs and g.done()
    snap = g.hist_snapshot()
    count, _, raw = snap["exec_ns"]
    assert count == n
    assert sum(H.decode_buckets(raw)) == n
    rcount, _, rraw = snap["ready_wait_ns"]
    expect = len([i for i in range(n) if i % 8 == 0])
    assert rcount == expect, (rcount, expect)
    assert sum(H.decode_buckets(rraw)) == expect


def test_dtd_engine_hist_counts():
    eng = _ptdtd.Engine()
    eng.hist_enable()
    t0 = eng.tile()
    cls = eng.register_class(lambda args: None, [0], [1])   # READ-only
    eng.insert_many([(cls, None, t0, 1)] * 64)
    nexec, _ = eng.drain_ready(16, 4096)
    assert nexec == 64
    snap = eng.hist_snapshot()
    assert snap["exec_ns"][0] == 64
    assert snap["ready_wait_ns"][0] == 64
    assert sum(H.decode_buckets(snap["exec_ns"][2])) == 64


def test_dtd_engine_per_task_lane_hist_and_ring():
    """The port's engine records its per-task lane too: one ready ->
    complete latency a task (``pt_ready_to_done_ns``), one link interval and one completion point a
    task in the ring."""
    eng = _ptdtd.Engine()
    eng.hist_enable()
    eng.trace_enable(1, 1024)
    t0 = eng.tile()
    ids = []
    for _ in range(8):                     # a RW chain on one tile
        tid, _held = eng.insert([t0], [3])
        ids.append((tid, eng.activate(tid)))
    assert [left for _t, left in ids] == [0] + [1] * 7
    for tid, _left in ids:
        eng.complete(tid)
    snap = eng.hist_snapshot()
    assert snap["pt_ready_to_done_ns"][0] == 8
    assert sum(H.decode_buckets(snap["pt_ready_to_done_ns"][2])) == 8
    # exec_ns keeps the reference's meaning: the batch lane's alone
    assert snap["exec_ns"][0] == 0
    assert snap["ready_wait_ns"][0] == 0
    (ring, blob), = eng.trace_drain()
    import struct
    ev = list(struct.iter_unpack("<qqII", blob))
    keys = [k for _t, _i, k, _f in ev]
    assert keys.count(_ptdtd.EV_PT_LINK) == 16     # START + END per insert
    assert [i for _t, i, k, _f in ev if k == _ptdtd.EV_PT_DONE] == \
        [tid for tid, _l in ids]
    assert eng.trace_dropped() == 0


def test_hist_registry_accumulates_across_detach():
    reg = H.NativeHistograms()
    g = _ptexec.Graph([0] * 8, [0] * 9, [])
    assert reg.attach("ptexec", g)
    assert reg.attach("ptexec", g)          # idempotent
    g.run(None, 8, 0)
    live = reg.snapshot()["ptexec.exec_ns"]["count"]
    assert live == 8
    reg.detach(g)
    del g
    after = reg.snapshot()["ptexec.exec_ns"]
    assert after["count"] == 8              # folded, not lost
    s = reg.summaries()
    assert s["ptexec.exec_ns"]["count"] == 8
    reg.reset()
    assert reg.snapshot() == {}


# ------------------------------------------------------- metrics endpoint

def _chain_prog():
    from parsec_tpu_torch.dsl.ptg.compiler import compile_ptg
    return compile_ptg(
        "%global NT\n%global DEPTH\n"
        "T(i, l)\n  i = 0 .. NT-1\n  l = 0 .. DEPTH-1\n"
        "  CTL S <- (l > 0) ? S T(i, l-1)\n"
        "        -> (l < DEPTH-1) ? S T(i, l+1)\nBODY\n  pass\nEND\n",
        "obs-test-chain")


def test_metrics_server_serves_and_shuts_down_tcp():
    from parsec_tpu_torch.tools.metrics_server import MetricsServer, fetch
    from parsec_tpu_torch.utils.counters import counters

    srv = MetricsServer(rank=0, nb_ranks=1, port=0).start()
    counters.register("test.obs_served")
    counters.add("test.obs_served", 7)
    counters.register("test.obs_nan", sampler=lambda: float("nan"))
    h = fetch(srv.endpoint, "/health")
    assert h["ok"] and h["rank"] == 0 and h["pid"] == os.getpid()
    m = fetch(srv.endpoint, "/metrics")
    assert m["counters"]["test.obs_served"] == 7
    # strict RFC-8259 body: a NaN sampler serializes as null, never the
    # bare `NaN` token (curl | jq / JSON.parse must parse the scrape)
    assert m["counters"]["test.obs_nan"] is None
    assert "percentiles" in m and "ts" in m
    raw = fetch(srv.endpoint, "/histograms")
    assert "histograms" in raw
    with pytest.raises(RuntimeError):
        fetch(srv.endpoint, "/nope")
    srv.stop()
    # clean teardown: socket closed, no listener left behind
    with pytest.raises((OSError, RuntimeError)):
        fetch(srv.endpoint, "/health", timeout=0.5)
    assert srv._thread is None


def test_metrics_server_uds(tmp_path):
    from parsec_tpu_torch.tools.metrics_server import MetricsServer, fetch

    path = str(tmp_path / "metrics.sock")
    srv = MetricsServer(rank=3, nb_ranks=4, uds=path).start()
    assert srv.endpoint == f"unix:{path}.r3"
    m = fetch(srv.endpoint)
    assert m["rank"] == 3 and m["nb_ranks"] == 4
    srv.stop()
    assert not os.path.exists(f"{path}.r3")   # inode unlinked


def test_metrics_endpoint_from_context_lifecycle():
    """--mca metrics_port wires the endpoint into Context init/fini and
    implies histograms: a lane run is scrapeable with live percentiles,
    and fini tears the endpoint down (no leak across contexts)."""
    import socket as _socket

    from parsec_tpu_torch.tools.metrics_server import fetch

    s = _socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    mca.set("metrics_port", port)
    try:
        ctx = _ctx()
        assert ctx.metrics is not None and ctx._hist_on
        tp = _chain_prog().instantiate(
            ctx, globals={"NT": 16, "DEPTH": 8}, collections={})
        ctx.add_taskpool(tp)
        ctx.wait(timeout=60)
        m = fetch(ctx.metrics.endpoint)
        assert m["counters"]["ptexec.pools_engaged"] >= 1
        assert m["percentiles"]["ptexec.exec_ns"]["count"] >= 128
        assert m["counters"]["ptexec.hist.exec_ns.count"] >= 128
        ep = ctx.metrics.endpoint
        ctx.fini()
        assert ctx.metrics is None
        with pytest.raises((OSError, RuntimeError)):
            fetch(ep, "/health", timeout=0.5)
    finally:
        mca.params.unset("metrics_port")


def test_metrics_serve_every_lane_family_equal_to_the_stats():
    """/metrics carries the ptdtd.*, ptexec.*, ptdev.*, sched.* and
    costmodel.* counters, each equal to its stats snapshot."""
    from parsec_tpu_torch.core.costmodel import COSTMODEL_STATS
    from parsec_tpu_torch.core.sched_plane import SCHED_STATS
    from parsec_tpu_torch.device.native import PTDEV_STATS
    from parsec_tpu_torch.dsl.dtd import PTDTD_STATS
    from parsec_tpu_torch.dsl.ptg.compiler import PTEXEC_STATS
    from parsec_tpu_torch.tools.metrics_server import MetricsServer, fetch

    ctx = _ctx()
    tp = _chain_prog().instantiate(ctx, globals={"NT": 4, "DEPTH": 4},
                                   collections={})
    ctx.add_taskpool(tp)
    ctx.wait(timeout=60)
    dtp = DTDTaskpool(ctx, "metrics-dtd")
    t = dtp.tile_new((2, 2), torch.float32)
    for _ in range(4):
        dtp.insert_task(lambda x: x + 1.0, (t, RW))
    dtp.wait()
    dtp.close()
    ctx.wait()
    srv = MetricsServer(port=0).start()
    try:
        c = fetch(srv.endpoint)["counters"]
    finally:
        srv.stop()
        ctx.fini()
    for stats, prefix in ((PTEXEC_STATS, "ptexec"), (PTDTD_STATS, "ptdtd"),
                          (PTDEV_STATS, "ptdev"), (SCHED_STATS, "sched"),
                          (COSTMODEL_STATS, "costmodel")):
        for k, v in stats.snapshot().items():
            assert c[f"{prefix}.{k}"] == v, (prefix, k)
    for k in ("ptdev.submitted", "ptdev.resident_bytes", "sched.steals",
              "sched.py.queued", "trace.events_dropped",
              "ptexec.slots_retired"):
        assert k in c, k


_DEV_SRC = """
%global NT
%global DEPTH
%global descA

STEP(i, l)
  i = 0 .. NT-1
  l = 0 .. DEPTH-1
  : descA(0, i)
  RW X <- (l == 0) ? descA(0, i) : X STEP(i, l-1)
       -> (l < DEPTH-1) ? X STEP(i, l+1) : descA(0, i)
BODY [type=CUDA]
  X = X * 2.0 + l
END
"""


def test_device_lane_ring_and_histogram(tmp_path):
    """A [type=CUDA] PTG pool on the native device lane (the CUDA device
    module over CPU tensors): the lane's ring lands one retire point per
    dispatched task and dispatch intervals that cover them, its retire_ns
    histogram counts every task, and /metrics' ptdev.* equal the lane's
    stats."""
    from parsec_tpu_torch.core import costmodel
    from parsec_tpu_torch.dsl.ptg.compiler import compile_ptg
    from parsec_tpu_torch.data.matrix import TiledMatrix
    from parsec_tpu_torch.tools.metrics_server import MetricsServer, fetch
    from parsec_tpu_torch.tools.trace_reader import read_pbp, to_dataframe
    from parsec_tpu_torch.utils.trace import Profiling

    nt, depth = 3, 4
    rng = np.random.default_rng(5)
    cols = [rng.standard_normal((4, 4)).astype(np.float32)
            for _ in range(nt)]
    mca.set("device_cuda_over_cpu", True)
    mca.set("device_load_balance_allow_cpu", False)
    mca.set("hist_enabled", True)
    mca.set("region_fusion", 0)
    try:
        ctx = _ctx()
        ctx.profiling = Profiling()
        A = TiledMatrix("devA", 4, 4 * nt, 4, 4)
        A.fill(lambda m, n: cols[n])
        tp = compile_ptg(_DEV_SRC, "devtrace").instantiate(
            ctx, globals={"NT": nt, "DEPTH": depth},
            collections={"descA": A})
        ctx.add_taskpool(tp)
        ctx.wait(timeout=90)
        lane = ctx._ptdev
        assert lane and tp._ptexec_state["dev_pool"] is not None
        srv = MetricsServer(port=0).start()
        try:
            c = fetch(srv.endpoint)["counters"]
        finally:
            srv.stop()
        ls = lane.clane.stats()
        for k in ("dispatched", "retired", "submitted"):
            assert c[f"ptdev.{k}"] == ls[k]
        assert H.histograms.snapshot()["ptdev.retire_ns"]["count"] >= \
            nt * depth
        ctx.fini()
    finally:
        for k in ("device_cuda_over_cpu", "device_load_balance_allow_cpu",
                  "hist_enabled", "region_fusion"):
            mca.params.unset(k)
        costmodel.model.reset()
    assert ls["dispatched"] == ls["retired"] == nt * depth
    trace = read_pbp(ctx.profiling.dump(str(tmp_path / "dev.pbp")))
    df = to_dataframe(trace)
    assert len(df[df["name"] == "ptdev::retire"]) == nt * depth
    disp = df[df["name"] == "ptdev::dispatch"]
    assert len(disp) == ls["dispatch_batches"]
    # a dispatch interval's id is its batch size: they sum to dispatched
    assert int(disp["event_id"].sum()) == ls["dispatched"]
    assert ctx._ntrace.dropped() == 0
    want = [c.astype(np.float64) for c in cols]
    for l in range(depth):
        want = [w * 2.0 + l for w in want]
    np.testing.assert_allclose(A.to_dense(), np.concatenate(want, axis=1),
                               rtol=1e-6)


# ------------------------------------------------------------- live_view

def test_live_view_decimates_instead_of_dropping():
    from parsec_tpu_torch.tools.live_view import LiveCounterView
    from parsec_tpu_torch.utils.counters import CounterRegistry

    reg = CounterRegistry()
    reg.register("x")
    view = LiveCounterView(registry=reg, max_samples=16)
    for i in range(100):
        reg.set("x", i)
        view.sample()
    st = view.stats()
    assert st["samples"] <= 16
    assert st["samples_dropped"] > 0 and st["decimations"] >= 1
    # the series still spans the WHOLE run: first and latest values kept
    xs = view.series["x"]
    assert xs[-1] == 99.0 and xs[0] <= 10.0
    assert len(xs) == len(view.times)


def test_live_view_cross_process_endpoints():
    from parsec_tpu_torch.tools.live_view import LiveCounterView
    from parsec_tpu_torch.tools.metrics_server import MetricsServer
    from parsec_tpu_torch.utils.counters import counters

    srv = MetricsServer(rank=0, nb_ranks=1, port=0).start()
    try:
        counters.register("test.lv_remote")
        counters.add("test.lv_remote", 5)
        view = LiveCounterView(endpoints=[srv.endpoint])
        view.sample()
        assert view.series["test.lv_remote"][-1] == 5.0
        # a dead endpoint counts an error but does not break sampling
        bad = LiveCounterView(endpoints=["http://127.0.0.1:1"])
        bad.sample()
        assert bad.poll_errors == 1 and len(bad.times) == 1
    finally:
        srv.stop()


# -------------------------------------------------- merge (synthetic unit)

def _mk_rank_trace(tmp_path, rank, offset_ns, events):
    """A synthetic per-rank trace: meta::clock + ptcomm frame points."""
    from parsec_tpu_torch.utils.trace import EVENT_FLAG_POINT, Profiling

    prof = Profiling()
    start, _ = prof.add_dictionary_keyword(
        "meta::clock",
        info_desc="rank{i};peer{i};offset_ns{q};rtt_ns{q};ok{i}")
    s = prof.stream(f"clock(rank {rank})")
    s.events.append((start, 0, 0, 1000.0, EVENT_FLAG_POINT,
                     prof.pack_info("meta::clock", rank=rank, peer=0,
                                    offset_ns=offset_ns, rtt_ns=50_000,
                                    ok=1)))
    tx, _ = prof.add_dictionary_keyword("ptcomm::frame_tx")
    rx, _ = prof.add_dictionary_keyword("ptcomm::frame_rx")
    comm = prof.stream("ptcomm-w0")
    for kind, peer, seq, t in events:
        key = tx if kind == "tx" else rx
        comm.events.append((key, (peer << 40) | seq, 0, t,
                            EVENT_FLAG_POINT, b""))
    path = str(tmp_path / f"rank{rank}.pbp")
    prof.dump(path)
    return path


def test_merge_traces_rebases_and_pairs(tmp_path):
    from parsec_tpu_torch.tools import trace_reader as tr

    # rank 1's clock runs 1 ms BEHIND rank 0 (offset = -1e6 ns): its raw
    # rx stamps land BEFORE the matching tx; the rebase must fix it
    off = -1_000_000
    p0 = _mk_rank_trace(tmp_path, 0, 0, [
        ("tx", 1, 1, 10.000), ("tx", 1, 2, 10.010), ("rx", 1, 1, 10.020)])
    p1 = _mk_rank_trace(tmp_path, 1, off, [
        ("rx", 0, 1, 10.0005 + off * 1e-9),
        ("rx", 0, 2, 10.0105 + off * 1e-9),
        ("tx", 0, 1, 10.0150 + off * 1e-9)])
    merged = tr.merge_traces([p0, p1])
    meta0 = tr.clock_meta(tr.read_pbp(p0))
    assert meta0["rank"] == 0 and meta0["offset_ns"] == 0
    names = [s["name"] for s in merged.streams]
    assert "r0:ptcomm-w0" in names and "r1:ptcomm-w0" in names
    flows = tr.act_flows(merged)
    assert not flows["unmatched_tx"] and not flows["unmatched_rx"]
    assert len(flows["pairs"]) == 3
    for src, dst, seq, t_tx, t_rx in flows["pairs"]:
        assert t_rx > t_tx, (src, dst, seq, t_tx, t_rx)  # clock-aligned
    # an UNREBASED merge shows the skew (sanity that rebase does work)
    rawm = tr.merge_traces([p0, p1], rebase=False)
    raw_pairs = tr.act_flows(rawm)["pairs"]
    assert any(t_rx < t_tx for _, _, _, t_tx, t_rx in raw_pairs)
    # chrome export round-trips with flow records attached
    ctf = tr.to_chrome_trace(merged)
    ctf["traceEvents"].extend(tr.flow_chrome_events(merged))
    blob = json.loads(json.dumps(ctf))
    assert len([e for e in blob["traceEvents"]
                if e.get("ph") in ("s", "f")]) == 6


def test_merge_unmatched_reported(tmp_path):
    from parsec_tpu_torch.tools import trace_reader as tr

    p0 = _mk_rank_trace(tmp_path, 0, 0, [("tx", 1, 1, 1.0),
                                         ("tx", 1, 2, 2.0)])
    p1 = _mk_rank_trace(tmp_path, 1, 0, [("rx", 0, 1, 1.5)])
    flows = tr.act_flows(tr.merge_traces([p0, p1]))
    assert len(flows["pairs"]) == 1
    assert flows["unmatched_tx"] == [(0, 1, 2)]
    assert not flows["unmatched_rx"]


def test_merge_cli(tmp_path):
    from parsec_tpu_torch.tools import trace_reader as tr

    p0 = _mk_rank_trace(tmp_path, 0, 0, [("tx", 1, 1, 1.0)])
    p1 = _mk_rank_trace(tmp_path, 1, 0, [("rx", 0, 1, 1.5)])
    out = str(tmp_path / "merged.json")
    assert tr.main(["--merge", out, p0, p1]) == 0
    blob = json.load(open(out))
    assert any(e.get("ph") == "s" for e in blob["traceEvents"])
    # an unmatched merge exits nonzero (the ci gate contract)
    p2 = _mk_rank_trace(tmp_path, 0, 0, [("tx", 1, 9, 1.0)])
    assert tr.main(["--merge", out, p2, p1]) == 1


def test_incomplete_clock_stamp_does_not_latch(tmp_path):
    """An ok=0 stamp (dump raced the ladder) must not block the real
    estimate from landing later, and clock_meta prefers the ok=1 record
    over any earlier incomplete one."""
    from parsec_tpu_torch.comm.remote_dep import RemoteDepEngine
    from parsec_tpu_torch.comm.threads import ThreadFabric, ThreadsCE
    from parsec_tpu_torch.tools import trace_reader as tr
    from parsec_tpu_torch.utils.trace import Profiling

    fabric = ThreadFabric(2)
    ce = ThreadsCE(fabric, 1)          # rank 1: no trivial-done shortcut
    ctx = Context(nb_cores=1, device="cpu", my_rank=1, nb_ranks=2)
    ctx.profiling = Profiling()
    eng = RemoteDepEngine(ctx, ce)
    assert not eng._clk_done
    eng.stamp_clock_meta()             # incomplete: ok=0, must not latch
    assert not getattr(ctx.profiling, "_clk_stamped", False)
    with eng._clk_lock:                # ladder completes later
        eng._clk_offset_ns, eng._clk_rtt_ns = 1234, 99
        eng._clk_done = True
    eng.stamp_clock_meta()
    assert ctx.profiling._clk_stamped
    eng.stamp_clock_meta()             # latched: no third record
    path = str(tmp_path / "latch.pbp")
    ctx.profiling.dump(path)
    trace = tr.read_pbp(path)
    meta = tr.clock_meta(trace)
    assert meta["ok"] == 1 and meta["offset_ns"] == 1234
    # re-stamps reuse ONE stream — no duplicate clock(rank N) rows
    assert len([s for s in trace.streams
                if s["name"].startswith("clock(")]) == 1
    ctx.comm = None                    # the fake engine has no real peers
    ctx.fini()


# --------------------------------------------------- 2-OS-rank end-to-end

def _obs_program(rank, ce, trace_dir=None):
    """Traced+histogrammed cross-rank chain (CPU contexts): returns the
    clock estimate, the per-rank trace path, and the rank-0 lane-aware
    counter rollup."""
    from parsec_tpu_torch.comm.remote_dep import RemoteDepEngine
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
    from parsec_tpu_torch.dsl.ptg.compiler import compile_ptg
    from parsec_tpu_torch.utils.trace import Profiling

    nt, depth = 4, 8
    mca.set("hist_enabled", True)
    ctx = Context(nb_cores=1, device="cpu", my_rank=rank,
                  nb_ranks=ce.nb_ranks)
    ctx.profiling = Profiling()
    eng = RemoteDepEngine(ctx, ce)
    A = TwoDimBlockCyclic("descA", depth, nt, 1, 1, P=2, Q=1,
                          nodes=2, myrank=rank)
    src = ("%global NT\n%global DEPTH\n%global descA\n"
           "T(i, l)\n  i = 0 .. NT-1\n  l = 0 .. DEPTH-1\n"
           "  : descA(l, i)\n"
           "  CTL S <- (l > 0) ? S T(i, l-1)\n"
           "        -> (l < DEPTH-1) ? S T(i, l+1)\nBODY\n  pass\nEND\n")
    prog = compile_ptg(src, "obs-test-2rank")
    ce.sync()
    tp = prog.instantiate(ctx, globals={"NT": nt, "DEPTH": depth},
                          collections={"descA": A}, name="obs-test-2rank")
    ctx.add_taskpool(tp)
    ctx.wait(timeout=300)
    ce.sync()
    clock_ok = eng.clock_sync_wait(timeout=30.0)
    ce.sync()
    table = eng.aggregate_counters(timeout=30.0)
    engaged = tp._ptexec_state is not None and \
        tp._ptexec_state.get("pool_id") is not None
    stats = ctx.comm.native.comm.stats() if ctx.comm.native else None
    ce.sync()
    ctx.fini()
    pbp = os.path.join(trace_dir, f"rank{rank}.pbp")
    ctx.profiling.dump(pbp)
    ce.fini()
    return {"rank": rank, "engaged": engaged, "clock_ok": clock_ok,
            "offset_ns": eng._clk_offset_ns, "rtt_ns": eng._clk_rtt_ns,
            "trace": pbp, "table": table,
            "frames_tx": stats["act_frames_tx"] if stats else 0}


def test_two_rank_clock_merge_and_aggregation(tmp_path):
    """The acceptance shape: same-host 2-rank run -> bounded clock
    offset, merged clock-aligned timeline with every activation frame
    paired and causally ordered, and a lane-aware fini rollup carrying
    nonzero ptcomm wire counters."""
    import functools

    from parsec_tpu_torch.comm.tcp import run_distributed_procs
    from parsec_tpu_torch.tools import trace_reader as tr

    res = run_distributed_procs(
        2, functools.partial(_obs_program, trace_dir=str(tmp_path)),
        timeout=300)
    for r in res:
        assert r["engaged"], r
        assert r["clock_ok"], r
        # same host, same CLOCK_MONOTONIC: the estimate must be tiny;
        # its error bound is min-RTT/2, so allow generous slack for a
        # loaded container
        assert abs(r["offset_ns"]) < 50_000_000, r["offset_ns"]
        assert r["rtt_ns"] >= 0
    # lane-aware aggregation: rank 0 merged both ranks incl. the native
    # wire counters the interpreted path never saw
    table = res[0]["table"]
    assert res[1]["table"] is None
    assert table["sum"].get("ptcomm.acts_tx", 0) > 0, \
        sorted(k for k in table["sum"] if k.startswith("ptcomm"))
    assert table["sum"].get("ptcomm.frame_errors", -1) == 0
    assert table["sum"].get("ptexec.hist.exec_ns.count", 0) > 0
    # merged timeline: all frames pair, rebased send precedes ingest
    merged = tr.merge_traces([r["trace"] for r in res])
    metas = [tr.clock_meta(tr.read_pbp(r["trace"])) for r in res]
    assert {int(m["rank"]) for m in metas} == {0, 1}
    flows = tr.act_flows(merged)
    assert not flows["unmatched_tx"], flows["unmatched_tx"][:5]
    assert not flows["unmatched_rx"], flows["unmatched_rx"][:5]
    assert len(flows["pairs"]) == sum(r["frames_tx"] for r in res)
    assert len(flows["pairs"]) > 0
    for src, dst, seq, t_tx, t_rx in flows["pairs"]:
        assert t_rx >= t_tx - 1e-3, (src, dst, seq, t_tx, t_rx)


# ------------------------------------------------------------- watchdog

@pytest.fixture()
def plane_ctx():
    ctx = _ctx()
    assert ctx.sched_plane is not None
    yield ctx
    ctx.fini()


def test_watchdog_idle_pool_never_trips(plane_ctx):
    from parsec_tpu_torch.core.watchdog import WATCHDOG_STATS, StallWatchdog
    sp = plane_ctx.sched_plane
    h = sp.register_pool("idle-pool", sp.mod.KIND_EXT, weight=1, window=0)
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


def test_watchdog_p99_breach_skips_backlog_histograms(monkeypatch):
    """A p99 past the factor times its baseline dumps once; the per-task
    lane's ready -> complete histogram, which grows with the DAG's width,
    never does."""
    from parsec_tpu_torch.core.watchdog import WATCHDOG_STATS, StallWatchdog
    from parsec_tpu_torch.utils import hist as H
    ctx = _ctx()
    wd = StallWatchdog(ctx, stall_ms=40)
    fired = []
    monkeypatch.setattr(wd, "_flight", lambda why, info: fired.append(why))
    names = ("ptexec.exec_ns", "ptdtd.pt_ready_to_done_ns")
    before = WATCHDOG_STATS.snapshot()
    try:
        for count, p99 in ((100, 10.0), (200, 10.0), (300, 1000.0)):
            monkeypatch.setattr(H.histograms, "summaries", lambda c=count,
                                p=p99: {n: {"count": c, "p99_us": p}
                                        for n in names})
            wd._tick_p99()
    finally:
        wd.stop()
        ctx.fini()
    assert fired == ["p99_breach:ptexec.exec_ns"]
    assert WATCHDOG_STATS.delta(before)["p99_breaches"] == 1
    assert H.BACKLOG_BOUND <= {f"ptdtd.{n}" for n in H.HIST_NAMES["ptdtd"]}


def test_watchdog_catches_injected_stall_and_recovers(plane_ctx, tmp_path):
    from parsec_tpu_torch.core.watchdog import (WATCHDOG_STATS, StallWatchdog,
                                                health_report)
    from parsec_tpu_torch.tools import flight
    mca.set("flight_dir", str(tmp_path))
    flight.reset()
    sp = plane_ctx.sched_plane
    h = sp.register_pool("stuck-pool", sp.mod.KIND_EXT, weight=1, window=0)
    assert h >= 0
    sp.plane.admit(h, 3)                  # held work that never drains
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
        sp.plane.retired(h, 3)
        wd.tick()
        d = WATCHDOG_STATS.delta(before)
        assert d["pool_stalls"] == 1 and d["clears"] >= 1
        assert wd.active_stalls() == []
        assert not health_report()["degraded"]
    finally:
        wd.stop()
        sp.unregister_pool(h)
        mca.set("flight_dir", "")


def test_watchdog_armed_by_mca_and_degrades_health():
    """--mca watchdog_stall_ms arms a watchdog at Context creation; the
    metrics endpoint's /health carries its report; fini stops both."""
    from parsec_tpu_torch.tools.metrics_server import MetricsServer, fetch
    mca.set("watchdog_stall_ms", 5000)
    try:
        ctx = _ctx()
        assert ctx.watchdog is not None and ctx.watchdog._thread is not None
        srv = MetricsServer(port=0).start()
        try:
            h = fetch(srv.endpoint, "/health")
        finally:
            srv.stop()
        assert h["ok"] and h["watchdog"]["degraded"] is False
        wd = ctx.watchdog
        ctx.fini()
        assert ctx.watchdog is None and wd._thread is None
    finally:
        mca.params.unset("watchdog_stall_ms")


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


# ------------------------------------------------------------- counters

def test_counters():
    from parsec_tpu_torch.utils import counters as C
    ctx = _ctx()
    C.install_scheduler_counters(ctx)
    before = C.counters.read(C.TASKS_RETIRED)
    tp = DTDTaskpool(ctx, "cnt")
    t = tp.tile_new((2, 2), torch.float32)
    for _ in range(5):
        tp.insert_task(lambda x: x + 1.0, (t, RW))
    tp.wait()
    tp.close()
    ctx.wait()
    ctx.fini()
    assert C.counters.read(C.TASKS_RETIRED) - before == 5
    assert C.counters.read(C.PENDING_TASKS) == \
        C.counters.read(C.TASKS_ENABLED) - C.counters.read(C.TASKS_RETIRED)


def test_native_counter_names_match_reference():
    """install_native_counters registers the same counter names in both
    packages for the lanes and modules both have. The differences are
    exactly the port's counters of its own (the per-task lane's task count
    and its ready -> complete latency, the device lane's retire latency)."""
    import parsec_tpu.core.context as rc
    from parsec_tpu.utils import counters as RC
    from parsec_tpu_torch.utils import counters as PC
    ctxs = (rc.Context(nb_cores=1), _ctx())     # sched.py.* of each
    RC.install_native_counters()
    PC.install_native_counters()
    shared = ("ptexec.", "ptdtd.", "ptdev.", "sched.", "costmodel.",
              "capture.", "watchdog.", "flight.", "trace.")

    def names(reg):
        return {n for n in reg.snapshot() if n.startswith(shared)}
    ref, port = names(RC.counters), names(PC.counters)
    for c in ctxs:
        c.fini()
    assert port - ref == {"ptdtd.tasks_native"} | {
        f"{h}.{st}" for h in ("ptdev.hist.retire_ns",
                              "ptdtd.hist.pt_ready_to_done_ns")
        for st in ("count", "p50_us", "p99_us", "p999_us")}
    assert ref - port == set()
    assert len(port & ref) > 100


# ------------------------------------------------------------- info

def test_info_registry():
    reg = InfoRegistry()
    a = reg.register("dsl.cache")
    b = reg.register("tool.state")
    assert reg.register("dsl.cache") == a   # idempotent
    assert a != b
    bag = InfoBag()
    bag.set(b, {"x": 1})
    assert bag.get(b) == {"x": 1}
    assert bag.get(a, "none") == "none"


def test_info_registry_idempotent_ids_and_lookup():
    reg = InfoRegistry()
    a = reg.register("sched::spray")
    b = reg.register("device::load")
    assert a != b
    assert reg.register("sched::spray") == a     # idempotent
    assert reg.lookup("device::load") == b
    assert reg.lookup("missing") is None
    reg.unregister("sched::spray")
    assert reg.lookup("sched::spray") is None


def test_info_bag_sparse_slots():
    reg = InfoRegistry()
    bag = InfoBag()
    hi = reg.register("x")
    for _ in range(7):                 # ids grow; bag must autosize
        hi = reg.register(f"slot{hi}")
    bag.set(hi, "v")
    assert bag.get(hi) == "v"
    assert bag.get(0, default="d") == "d"        # unset low slot
    assert bag.get(hi + 100, default="d") == "d"  # beyond storage
    bag.set(0, 11)
    assert bag.get(0) == 11


def test_info_registry_threaded_registration_unique_ids():
    reg = InfoRegistry()
    ids = {}
    lock = threading.Lock()

    def worker(w):
        for i in range(50):
            iid = reg.register(f"name{i}")
            with lock:
                ids.setdefault(f"name{i}", set()).add(iid)

    ts = [threading.Thread(target=worker, args=(w,)) for w in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=10)
    # every name got exactly one id, and ids are distinct across names
    assert all(len(v) == 1 for v in ids.values())
    all_ids = [next(iter(v)) for v in ids.values()]
    assert len(set(all_ids)) == len(all_ids)


def test_device_profiling_stream():
    """Per-device profiling streams (ref: per-GPU-stream profiling): the
    CUDA device module over CPU tensors (the test mode)."""
    from parsec_tpu_torch.utils.trace import Profiling
    mca.set("device_cuda_over_cpu", True)
    mca.set("device_load_balance_allow_cpu", False)
    try:
        ctx = _ctx()
        ctx.profiling = Profiling()
        tp = DTDTaskpool(ctx, "devprof")
        t = tp.tile_new((4, 4), torch.float32)
        for _ in range(3):
            tp.insert_task(lambda x: x + 1.0, (t, RW))
        tp.wait()
        tp.close()
        ctx.wait()
        ctx.fini()
        st = ctx.profiling.stats()
        assert st["streams"] >= 1 and st["events"] >= 6  # 3 begin + 3 end
    finally:
        mca.params.unset("device_cuda_over_cpu")
        mca.params.unset("device_load_balance_allow_cpu")
