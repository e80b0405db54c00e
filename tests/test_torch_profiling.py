"""The port's tracer and its tools (``parsec_tpu_torch/utils/trace.py``,
``trace_ptf2.py``, ``native_trace.py``, ``grapher.py``, ``perf_event.py``,
``core/pins_modules.py``, ``tools/trace_reader.py``, ``tools/mem_view.py``,
``tools/live_view.py``): the reference's single-rank
``tests/test_profiling.py`` on the port, on the CPU, plus cross-checks that
run one program through both packages — each package's PBP file and PTF2
archive read by the other's reader, the executed DAG's DOT, the PTG→DTD
replay and the PINS modules' reports.
"""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.core.pins_modules import (ALPerf, IteratorsChecker,
                                                PrintSteals, TaskProfiler,
                                                ptg_to_dtd_replay)
from parsec_tpu_torch.data.matrix import TiledMatrix
from parsec_tpu_torch.dsl.dtd import DTDTaskpool, RW
from parsec_tpu_torch.dsl.ptg.compiler import compile_ptg
from parsec_tpu_torch.tools.trace_reader import (read_pbp, to_chrome_trace,
                                                 to_dataframe)
from parsec_tpu_torch.utils import mca
from parsec_tpu_torch.utils.grapher import DotGrapher
from parsec_tpu_torch.utils.trace import Profiling


def _ctx(nb_cores=1):
    return Context(nb_cores=nb_cores, device="cpu")


@pytest.fixture()
def ctx():
    c = _ctx()
    yield c
    c.fini()


def _run_chain(ctx, n=8):
    tp = DTDTaskpool(ctx, "profchain")
    t = tp.tile_new((4, 4), torch.float32)
    for _ in range(n):
        tp.insert_task(lambda x: x + 1.0, (t, RW))
    tp.wait()
    tp.close()
    ctx.wait()
    return t


def test_trace_roundtrip(ctx, tmp_path):
    prof = Profiling()
    tprof = TaskProfiler(prof)
    tprof.enable(ctx)
    _run_chain(ctx, 8)
    path = str(tmp_path / "t.pbp")
    prof.dump(path)
    trace = read_pbp(path)
    assert trace.dictionary[0]["name"] in ("<lambda>", "dtd_task")
    df = to_dataframe(trace)
    # 8 exec intervals with matched begin/end and positive durations
    assert len(df) == 8
    assert (df["duration"] > 0).all()
    assert len(set(df["taskpool_id"])) == 1
    ctf = to_chrome_trace(trace)
    assert len([e for e in ctf["traceEvents"] if e["ph"] == "X"]) == 8


def test_trace_cli(ctx, tmp_path, capsys):
    prof = Profiling()
    TaskProfiler(prof).enable(ctx)
    _run_chain(ctx, 4)
    path = str(tmp_path / "t.pbp")
    prof.dump(path)
    from parsec_tpu_torch.tools import trace_reader
    ctf = str(tmp_path / "t.json")
    assert trace_reader.main([path, "--ctf", ctf]) == 0
    data = json.load(open(ctf))
    assert any(e.get("ph") == "X" for e in data["traceEvents"])


def test_alperf_and_steals(ctx):
    al = ALPerf()
    al.enable(ctx)
    ps = PrintSteals()
    ps.enable(ctx)
    _run_chain(ctx, 16)
    rep = al.report()
    assert al.counts["executed"] == 16
    assert al.counts["completed"] == 16
    assert rep["executed"] > 0
    assert sum(v["selects"] for v in ps.report().values()) >= 1


_RW_CHAIN = """
%global NT
%global A
T(k)
  k = 0 .. NT-1
  : A(0, 0)
  RW X <- (k == 0) ? A(0, 0) : X T(k-1)
     -> (k < NT-1) ? X T(k+1) : A(0, 0)
BODY
  X = X + 1.0
END
"""


def test_iterators_checker_clean_ptg(ctx):
    """A well-formed PTG program produces zero violations."""
    chk = IteratorsChecker()
    chk.enable(ctx)
    A = TiledMatrix("A", 4, 4, 4, 4)
    A.fill(lambda m, n: torch.zeros((4, 4)))
    tp = compile_ptg(_RW_CHAIN, "chk").instantiate(
        ctx, globals={"NT": 6}, collections={"A": A})
    ctx.add_taskpool(tp)
    ctx.wait()
    assert chk.violations == []


def test_dot_grapher(ctx):
    g = DotGrapher()
    g.enable(ctx)
    _run_chain(ctx, 4)
    dot = g.to_dot()
    assert dot.startswith("digraph")
    assert dot.count("->") == 3  # chain of 4 has 3 edges


def test_ptg_to_dtd_replay(ctx):
    """Cross-DSL harness: the PTG chain replayed through DTD gives the same
    result (ref: pins/ptg_to_dtd)."""
    NT = 5
    A = TiledMatrix("A", 4, 4, 4, 4)
    A.fill(lambda m, n: torch.zeros((4, 4)))
    prog = compile_ptg(_RW_CHAIN, "replay")
    ptp = prog.instantiate(ctx, globals={"NT": NT}, collections={"A": A})
    # replay WITHOUT running the PTG version
    dtp = ptg_to_dtd_replay(ptp, ctx)
    dtp.wait()
    dtp.close()
    ctx.wait()
    assert dtp.executed >= NT
    # the chain's memory out-dep wrote home: A(0,0) saw NT increments
    np.testing.assert_allclose(
        A.data_of(0, 0).newest_copy().payload.numpy(), float(NT))


def _comm_trace_gemm(tmp_path, name, N, TS, a, b, backend=None):
    """A distributed DTD GEMM on two in-process ranks (CPU contexts), each
    with its own tracer; returns each rank's dumped trace path."""
    from parsec_tpu_torch.comm.remote_dep import RemoteDepEngine
    from parsec_tpu_torch.comm.threads import ThreadsCE, run_distributed
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
    from parsec_tpu_torch.ops.gemm import insert_gemm_tasks

    def program(rank, fabric):
        ctx = Context(nb_cores=1, device="cpu", my_rank=rank, nb_ranks=2)
        ctx.profiling = Profiling()
        RemoteDepEngine(ctx, ThreadsCE(fabric, rank))
        kw = dict(nodes=2, myrank=rank, P=2, Q=1)
        A = TwoDimBlockCyclic(f"{name}A", N, N, TS, TS, **kw)
        B = TwoDimBlockCyclic(f"{name}B", N, N, TS, TS, **kw)
        C = TwoDimBlockCyclic(f"{name}C", N, N, TS, TS, **kw)
        A.fill(lambda m, n: a[m*TS:(m+1)*TS, n*TS:(n+1)*TS])
        B.fill(lambda m, n: b[m*TS:(m+1)*TS, n*TS:(n+1)*TS])
        C.fill(lambda m, n: np.zeros((TS, TS), np.float32))
        tp = DTDTaskpool(ctx, name)
        insert_gemm_tasks(tp, A, B, C)
        tp.wait(timeout=60)
        tp.close()
        ctx.wait(timeout=30)
        ctx.fini()
        if backend is None:
            path = str(tmp_path / f"rank{rank}.pbp")
            ctx.profiling.dump(path)
            return path
        return ctx.profiling.dump(str(tmp_path / f"r{rank}"),
                                  backend=backend)

    return run_distributed(2, program, timeout=120)


def test_comm_trace_2rank_check_comms(tmp_path):
    """Distributed run with per-rank tracers: the comm machinery writes
    typed activate/get/put events with src/dst/bytes to its own stream, and
    the cross-rank validator proves wire symmetry (the check-comms.py role,
    ref: remote_dep_mpi.c:1286-1302, tests/profiling/check-comms.py)."""
    from parsec_tpu_torch.tools.trace_reader import check_comms, comm_events

    N, TS = 64, 16
    rng = np.random.default_rng(4)
    a = rng.standard_normal((N, N)).astype(np.float32)
    b = rng.standard_normal((N, N)).astype(np.float32)
    # small eager limit so large tiles exercise the rendezvous (get/put) leg
    mca.set("comm_eager_limit", 512)
    try:
        paths = _comm_trace_gemm(tmp_path, "commtrace", N, TS, a, b)
    finally:
        mca.params.unset("comm_eager_limit")

    evs0 = comm_events(read_pbp(paths[0]))
    assert evs0, "rank 0 recorded no comm events"
    kinds = {e["kind"] for e in evs0}
    assert "activate_snd" in kinds and "activate_rcv" in kinds
    # 16x16 f32 tiles (1KiB) exceed the 512B eager limit -> rendezvous legs
    assert "put_rcv" in kinds or "put_snd" in kinds, kinds
    summary = check_comms(paths)
    assert summary["errors"] == [], summary
    assert summary["counts"]["activate_snd"] > 0
    assert summary["counts"]["put_snd"] > 0          # rendezvous exercised
    assert summary["counts"]["activate_snd"] == \
        summary["counts"]["activate_rcv"]

    # the CLI entry point (the reference's standalone checker script)
    from parsec_tpu_torch.tools import trace_reader
    assert trace_reader.main(["--check-comms", *paths]) == 0


def test_check_comms_reads_otf2_archives(tmp_path):
    """check-comms is format-agnostic: rank traces written as PTF2 archives
    (the port's name for the reference's OTF2-class backend) validate the
    same as PBP files."""
    from parsec_tpu_torch.tools.trace_reader import check_comms

    N, TS = 32, 16
    rng = np.random.default_rng(1)
    a = rng.standard_normal((N, N)).astype(np.float32)
    b = rng.standard_normal((N, N)).astype(np.float32)
    paths = _comm_trace_gemm(tmp_path, "otf2comm", N, TS, a, b,
                             backend="ptf2")
    assert all(os.path.isdir(p) and p.endswith(".ptf2") for p in paths)
    summary = check_comms(paths)
    assert summary["errors"] == [], summary
    assert summary["counts"]["activate_snd"] > 0


def test_otf2_archive_roundtrip(ctx, tmp_path):
    """The second trace backend (profiling_otf2.c role): same tracer state
    written as a PTF2 archive (anchor + global defs + per-location event
    files, varint/delta encoded) reads back IDENTICAL to the PBP file
    through the shared analysis pipeline."""
    from parsec_tpu_torch.tools.trace_reader import read_trace

    prof = Profiling()
    TaskProfiler(prof).enable(ctx)
    _run_chain(ctx, 8)

    pbp = prof.dump(str(tmp_path / "t.pbp"))
    arch = prof.dump(str(tmp_path / "t"), backend="otf2")
    assert os.path.isdir(arch) and arch.endswith(".ptf2")
    assert os.path.exists(os.path.join(arch, "anchor.json"))
    assert os.path.exists(os.path.join(arch, "global.defs"))
    assert any(f.startswith("loc_") for f in os.listdir(arch))

    a = read_pbp(pbp)
    b = read_trace(arch)
    assert [d["name"] for d in a.dictionary] == [d["name"] for d in b.dictionary]
    assert [s["name"] for s in a.streams] == [s["name"] for s in b.streams]
    dfa, dfb = to_dataframe(a), to_dataframe(b)
    assert len(dfa) == len(dfb) == 8
    # timestamps survive the ns-tick delta encoding to <1us
    assert (abs(dfa["duration"] - dfb["duration"]) < 1e-6).all()
    assert list(dfa["name"]) == list(dfb["name"])
    ctf = to_chrome_trace(b)
    assert len([e for e in ctf["traceEvents"] if e["ph"] == "X"]) == 8


def test_otf2_backend_via_mca(ctx, tmp_path):
    """--mca profile_backend otf2 flips the default dump format."""
    prof = Profiling()
    TaskProfiler(prof).enable(ctx)
    _run_chain(ctx, 4)
    mca.set("profile_backend", "otf2")
    try:
        out = prof.dump(str(tmp_path / "m"))
    finally:
        mca.params.unset("profile_backend")
    assert os.path.isdir(out)
    with pytest.raises(ValueError):
        prof.dump(str(tmp_path / "x"), backend="hdf5")


def test_dag_svg_render(ctx, tmp_path):
    """The dbp-dot2png role without graphviz: the executed DAG renders to a
    self-contained SVG with layered nodes and dependency arrows."""
    g = DotGrapher()
    g.enable(ctx)
    _run_chain(ctx, 4)
    svg = g.to_svg()
    assert svg.startswith("<svg") and svg.endswith("</svg>")
    assert svg.count("<rect") == 4          # 4 chained tasks
    assert svg.count("<line") == 3          # 3 dependency edges
    p = g.dump_svg(str(tmp_path / "dag.svg"))
    assert open(p).read() == svg


def test_animated_gantt_svg(ctx, tmp_path):
    """The trace-animation role (tools/profiling/animation.c): a
    self-drawing Gantt SVG with SMIL timing, from either trace format."""
    from parsec_tpu_torch.tools import trace_reader
    from parsec_tpu_torch.tools.trace_reader import read_trace, to_animated_svg

    prof = Profiling()
    TaskProfiler(prof).enable(ctx)
    _run_chain(ctx, 6)
    path = prof.dump(str(tmp_path / "anim.pbp"))
    svg = to_animated_svg(read_trace(path))
    assert svg.count("<rect") == 6
    assert svg.count("<set attributeName=") == 6       # SMIL playback
    out = str(tmp_path / "anim.svg")
    assert trace_reader.main([path, "--svg", out]) == 0
    assert open(out).read().startswith("<svg")


def test_live_counter_view(ctx, tmp_path):
    """The aggregator_visu GUI role: background counter sampling during a
    run + a rendered time-series image (headless matplotlib)."""
    from parsec_tpu_torch.tools.live_view import LiveCounterView
    from parsec_tpu_torch.utils.counters import install_scheduler_counters

    install_scheduler_counters(ctx)
    view = LiveCounterView(interval_s=0.01)
    view.start()
    _run_chain(ctx, 32)
    view.stop()
    assert len(view.times) >= 2
    active = view.active_series()
    assert any("sched" in n or "task" in n for n in active), active
    out = view.render(str(tmp_path / "counters.png"))
    assert os.path.getsize(out) > 1000


# ------------------------------------------------- memory-over-time (dbp2mem)

def test_device_memory_events_and_mem_view(tmp_path):
    """The dbp2mem pipeline (tools/profiling/dbp2mem.c role): a DAG under a
    tight device budget emits ::mem residency POINT events; mem_view renders
    timeline/summary/CSV/SVG, with evictions visible as negative deltas.
    The CUDA device module runs over CPU tensors (the test mode)."""
    from parsec_tpu_torch.device.cuda import CUDADevice
    from parsec_tpu_torch.tools import mem_view

    mca.set("device_cuda_over_cpu", True)
    mca.set("device_load_balance_allow_cpu", False)
    ctx = _ctx()
    try:
        ctx.profiling = Profiling()
        devs = [d for d in ctx.devices.devices if isinstance(d, CUDADevice)]
        assert devs, "device module did not register over the host device"
        dev = devs[0]
        ts = 16
        tile_b = ts * ts * 4
        dev.set_budget(3 * tile_b, unit=tile_b)      # room for ~3 tiles

        A = TiledMatrix("Amem", 8 * ts, ts, ts, ts)
        rng = np.random.default_rng(77)
        A.fill(lambda m, n: rng.standard_normal((ts, ts)).astype(np.float32))
        tp = DTDTaskpool(ctx, "memtrace")
        for m in range(8):                            # 8 tiles > 3-tile budget
            tp.insert_task(lambda x: x * 2.0, (tp.tile_of(A, m, 0), RW))
        tp.wait(timeout=60)
        tp.close()
        ctx.wait(timeout=30)
        assert dev.evictions > 0                      # pressure exercised
        resident = dev._resident_bytes
        path = ctx.profiling.dump(str(tmp_path / "mem.pbp"))
    finally:
        ctx.fini()
        mca.params.unset("device_cuda_over_cpu")
        mca.params.unset("device_load_balance_allow_cpu")

    trace = read_pbp(path)
    rows = mem_view.memory_timeline(trace)
    assert rows, "no ::mem events in the trace"
    assert all(r["t"] >= 0 for r in rows)
    assert any(r["delta"] > 0 for r in rows)          # stage-ins
    assert any(r["delta"] < 0 for r in rows)          # evictions
    # residency is the post-change occupancy: replaying deltas reproduces it
    run = {}
    for r in rows:
        run[r["stream"]] = run.get(r["stream"], 0) + r["delta"]
        assert run[r["stream"]] == r["resident"], r
    # the last event is the module's residency when the DAG ended
    assert rows[-1]["resident"] == resident
    # residency never exceeds budget + one in-flight tile
    assert max(r["resident"] for r in rows) <= 4 * (16 * 16 * 4)

    summ = mem_view.summarize(trace)
    s = next(iter(summ.values()))
    assert s["peak"] > 0 and s["allocated"] > s["freed"] - 1

    csv = mem_view.to_csv(trace)
    assert csv.splitlines()[0] == "t_seconds,stream,resident_bytes,delta_bytes"
    assert len(csv.splitlines()) == len(rows) + 1
    svg = mem_view.to_svg(trace)
    assert svg.startswith("<svg") and "polyline" in svg

    # CLI writes both artifacts
    out_csv, out_svg = str(tmp_path / "m.csv"), str(tmp_path / "m.svg")
    assert mem_view.main([path, "--csv", out_csv, "--svg", out_svg]) == 0
    assert os.path.getsize(out_csv) > 0 and os.path.getsize(out_svg) > 0


def test_device_exec_spans_pair_per_task(tmp_path):
    """The CUDA device module's exec stream: one START at launch and one
    END at the completion epilog per task, END after START (the test mode's
    events complete at once)."""
    from parsec_tpu_torch.tools.trace_reader import _intervals

    mca.set("device_cuda_over_cpu", True)
    mca.set("device_load_balance_allow_cpu", False)
    ctx = _ctx()
    try:
        ctx.profiling = Profiling()
        A = TiledMatrix("Aexec", 64, 16, 16, 16)
        A.fill(lambda m, n: np.ones((16, 16), np.float32))
        tp = DTDTaskpool(ctx, "exectrace")

        def dbl(x):
            return x * 2.0
        for m in range(4):
            for _ in range(3):
                tp.insert_task(dbl, (tp.tile_of(A, m, 0), RW))
        tp.wait(timeout=60)
        tp.close()
        ctx.wait(timeout=30)
        path = ctx.profiling.dump(str(tmp_path / "exec.pbp"))
    finally:
        ctx.fini()
        mca.params.unset("device_cuda_over_cpu")
        mca.params.unset("device_load_balance_allow_cpu")
    trace = read_pbp(path)
    key = next(d["key"] for d in trace.dictionary
               if d["name"] == "cuda-over-cpu::exec")
    spans = [(t_s, t_e) for _si, sname, base, _e, _tp, t_s, t_e, _i
             in _intervals(trace) if base == key]
    assert len(spans) == 12
    assert all(t_e >= t_s for t_s, t_e in spans)
    ev = [e for s in trace.streams for e in s["events"] if e[0] >> 1 == key]
    assert len(ev) == 24
    # one id a span: DTD tasks of a class share their key, and spans in
    # flight together on the card must not pair across tasks
    assert len({e[1] for e in ev}) == 12
    np.testing.assert_array_equal(A.to_dense(), np.full((64, 16), 8.0))


def test_tracers_attached_in_turn_each_dump_their_own(tmp_path):
    """Two tracers attached in turn on one context, with an untraced run
    between them: each dump holds the device module's exec spans and the
    lanes' ring events of its own runs and nothing of the others' (the
    device stream and the trace bridge follow ``ctx.profiling``), and the
    DTD engine, which outlives pools, stops recording while tracing is
    off."""
    from parsec_tpu_torch.dsl.dtd import PTDTD_STATS
    from parsec_tpu_torch.tools.trace_reader import _intervals

    mca.set("device_cuda_over_cpu", True)
    mca.set("device_load_balance_allow_cpu", False)
    ctx = _ctx()
    A = TiledMatrix("Aturns", 64, 16, 16, 16)
    A.fill(lambda m, n: np.ones((16, 16), np.float32))
    profs = [Profiling(), Profiling()]
    ring = {}

    def run(prof, name):
        ctx.profiling = prof
        snap = PTDTD_STATS.snapshot()
        tp = DTDTaskpool(ctx, name)
        for m in range(4):
            for _ in range(3):
                tp.insert_task(lambda x: x * 2.0, (tp.tile_of(A, m, 0), RW))
        tp.wait(timeout=60)
        tp.close()
        ctx.wait(timeout=30)
        _run_ptg_chain(ctx, nt=4, depth=4, name=f"{name}chain")
        assert PTDTD_STATS.delta(snap)["tasks_native"] == 12
        ring[name] = ctx._dtd_neng.trace_drain() if prof is None else None

    try:
        run(profs[0], "first")
        run(None, "off")
        run(profs[1], "second")
        paths = [p.dump(str(tmp_path / f"turn{i}.pbp"))
                 for i, p in enumerate(profs)]
    finally:
        ctx.fini()
        mca.params.unset("device_cuda_over_cpu")
        mca.params.unset("device_load_balance_allow_cpu")
    assert ring["off"] == []          # the engine recorded nothing while off
    for path in paths:
        trace = read_pbp(path)
        names = {d["key"]: d["name"] for d in trace.dictionary}
        spans = {}
        for _si, _sn, base, _e, _tp, t_s, t_e, _i in _intervals(trace):
            spans.setdefault(names[base], []).append(t_e - t_s)
        assert len(spans["cuda-over-cpu::exec"]) == 12
        assert all(d >= 0 for d in spans["cuda-over-cpu::exec"])
        assert len(spans["ptexec::task"]) == 4 * 4
        assert len(spans["ptdtd::link"]) == 12
        raw = {}
        for s in trace.streams:
            for e in s["events"]:
                raw[names[e[0] >> 1]] = raw.get(names[e[0] >> 1], 0) + 1
        assert raw["cuda-over-cpu::exec"] == 24
        assert raw["ptdtd::task"] == 12
    np.testing.assert_array_equal(A.to_dense(), np.full((64, 16), 512.0))


def test_mem_view_reads_ptf2_archive(ctx, tmp_path):
    """mem_view consumes the OTF2-class backend identically to PBP."""
    from parsec_tpu_torch.tools import mem_view
    from parsec_tpu_torch.tools.trace_reader import read_trace
    from parsec_tpu_torch.utils.trace import EVENT_FLAG_POINT

    prof = Profiling()
    key, _ = prof.add_dictionary_keyword("dev0::mem",
                                         info_desc="resident{q};delta{q}")
    s = prof.stream("dev0")
    run = 0
    for i, d in enumerate([1024, 2048, -1024, 512]):
        run += d
        s.trace(key, i, 0, EVENT_FLAG_POINT,
                prof.pack_info("dev0::mem", resident=run, delta=d))

    pbp = prof.dump(str(tmp_path / "m.pbp"))
    arch = prof.dump(str(tmp_path / "m"), backend="otf2")
    rows_pbp = mem_view.memory_timeline(read_trace(pbp))
    rows_otf = mem_view.memory_timeline(read_trace(arch))
    assert [(r["resident"], r["delta"]) for r in rows_pbp] == \
        [(r["resident"], r["delta"]) for r in rows_otf] == \
        [(1024, 1024), (3072, 2048), (2048, -1024), (2560, 512)]
    assert mem_view.summarize(read_trace(arch))["dev0"]["peak"] == 3072


def test_ptf2_is_the_backend_name_and_otf2_warns(ctx, tmp_path):
    """The second backend is named for what it is (a private
    OTF2-architecture format): 'ptf2' selects it; 'otf2' still works as a
    deprecated alias."""
    prof = Profiling()
    TaskProfiler(prof).enable(ctx)
    _run_chain(ctx, 3)
    arch = prof.dump(str(tmp_path / "p"), backend="ptf2")
    assert arch.endswith(".ptf2")
    assert os.path.isdir(arch)
    arch2 = prof.dump(str(tmp_path / "q"), backend="otf2")   # alias
    assert os.path.isdir(arch2)


def test_hw_counters_pins_module(ctx):
    """The PAPI-role PINS module: samples per-class PMU deltas where
    perf_event works, enables as a NO-OP where it does not (both paths are
    the contract)."""
    from parsec_tpu_torch.core.pins_modules import HWCounters
    from parsec_tpu_torch.utils import perf_event

    hw = HWCounters()
    hw.enable(ctx)
    try:
        _run_chain(ctx, 8)
        if perf_event.available():
            rep = hw.report()
            assert hw.tasks_sampled >= 8
            cls = next(iter(rep.values()))
            assert cls.get("cycles", 0) > 0
        else:
            assert hw.tasks_sampled == 0       # clean no-op
    finally:
        hw.disable(ctx)


def test_perf_event_attr_layout():
    """The hand-packed perf_event_attr must be exactly
    PERF_ATTR_SIZE_VER7 bytes with the flags word at offset 40, and the
    same bytes as the reference's."""
    import struct

    from parsec_tpu.utils import perf_event as ref_pe
    from parsec_tpu_torch.utils import perf_event as pe
    raw = pe._attr_bytes(pe.EVENTS["cycles"])
    assert len(raw) == 128
    t, size = struct.unpack_from("II", raw, 0)
    assert t == 0 and size == 128
    (flags,) = struct.unpack_from("Q", raw, 40)
    assert flags & 0x1          # disabled at open
    assert flags & (1 << 5)     # exclude_kernel
    for name, ev in pe.EVENTS.items():
        assert pe._attr_bytes(ev) == ref_pe._attr_bytes(ref_pe.EVENTS[name])


# ------------------------------------------------- native in-lane tracing
# The observer-effect contract: profiled runs stay on the native lanes and
# the lanes trace THEMSELVES (per-worker ring buffers drained into the PBP
# streams, utils/native_trace.py) — the recorded machine is the production
# machine. --mca pins_paranoid 1 opts back into the per-task Python FSM.

_CHAIN_SRC = (
    "%global NT\n%global DEPTH\n"
    "T(i, l)\n  i = 0 .. NT-1\n  l = 0 .. DEPTH-1\n"
    "  CTL S <- (l > 0) ? S T(i, l-1)\n"
    "        -> (l < DEPTH-1) ? S T(i, l+1)\nBODY\n  pass\nEND\n")


def _run_ptg_chain(ctx, nt=16, depth=8, name="ntrace", mod=None):
    if mod is None:
        prog = compile_ptg(_CHAIN_SRC, name)
    else:
        prog = mod.compile_ptg(_CHAIN_SRC, name)
    tp = prog.instantiate(ctx, globals={"NT": nt, "DEPTH": depth},
                          collections={})
    ctx.add_taskpool(tp)
    ctx.wait(timeout=60)
    return tp


def test_native_lane_trace_chain(tmp_path):
    """A profiled chain run stays on the native lane and yields a PBP
    trace with per-worker native streams: paired START/END task
    intervals, monotonic per-stream timestamps, zero drops, and a valid
    chrome://tracing conversion."""
    from parsec_tpu_torch.dsl.ptg.compiler import PTEXEC_STATS
    ctx = _ctx()
    ctx.profiling = Profiling()
    snap = PTEXEC_STATS.snapshot()
    tp = _run_ptg_chain(ctx)
    delta = PTEXEC_STATS.delta(snap)
    ctx.fini()
    assert tp._ptexec_state is not None, \
        "profiling ejected the pool from the native lane (observer effect)"
    assert delta["pools_engaged"] == 1 and delta["pools_fallback"] == 0
    path = ctx.profiling.dump(str(tmp_path / "native.pbp"))
    trace = read_pbp(path)
    assert any(s["name"].startswith("ptexec-w") for s in trace.streams)
    assert "ptexec::task" in {d["name"] for d in trace.dictionary}
    for s in trace.streams:           # ring hand-off preserves time order
        ts = [e[3] for e in s["events"]]
        assert ts == sorted(ts)
    df = to_dataframe(trace)
    tasks = df[df["name"] == "ptexec::task"]
    assert len(tasks) == 16 * 8       # every lane task: one paired interval
    assert (tasks["duration"] >= 0).all()
    ctf = to_chrome_trace(trace)
    assert len([e for e in ctf["traceEvents"] if e["ph"] == "X"]) == 16 * 8
    meta = {e["args"]["name"] for e in ctf["traceEvents"] if e["ph"] == "M"}
    assert any(n.startswith("ptexec-w") for n in meta)
    assert ctx._ntrace.dropped() == 0


def test_profiling_keeps_native_engagement():
    """Regression for the observer effect: engagement counters of a
    profiled run match an unprofiled run of the same pool shape."""
    from parsec_tpu_torch.dsl.ptg.compiler import PTEXEC_STATS
    ctx = _ctx()
    base = PTEXEC_STATS.snapshot()
    _run_ptg_chain(ctx, name="plain")
    plain = PTEXEC_STATS.delta(base)
    ctx.fini()
    ctx2 = _ctx()
    ctx2.profiling = Profiling()
    base2 = PTEXEC_STATS.snapshot()
    _run_ptg_chain(ctx2, name="profiled")
    profiled = PTEXEC_STATS.delta(base2)
    ctx2.fini()
    assert profiled == plain, (plain, profiled)


def test_native_trace_ring_overflow():
    """Ring overflow drops events (bumping the drop counter) instead of
    blocking the lane: the run completes, the drop count is visible, and
    the drained event count stays within capacity."""
    mca.set("trace_ring_capacity", 32)
    mca.set("trace_rings", 1)
    try:
        ctx = _ctx()
        ctx.profiling = Profiling()
        tp = _run_ptg_chain(ctx, nt=64, depth=16, name="overflow")
        ctx.fini()
        assert tp._ptexec_state is not None
        assert tp._ptexec_state["graph"].done()      # lane unharmed
        assert ctx._ntrace.dropped() > 0
        st = ctx.profiling.stats()
        # 2 events per task would be 2048; a 32-slot ring cannot hold them
        assert st["events"] < 2 * 64 * 16
    finally:
        mca.params.unset("trace_ring_capacity")
        mca.params.unset("trace_rings")


def test_pins_paranoid_restores_python_fsm():
    """--mca pins_paranoid 1 is the full-fidelity escape hatch: an
    instrumented pool leaves the native lane (pools_ineligible, not
    fallback) and every task pays the per-task PINS cycle again."""
    from parsec_tpu_torch.dsl.ptg.compiler import PTEXEC_STATS
    mca.set("pins_paranoid", True)
    try:
        ctx = _ctx()
        al = ALPerf()
        al.enable(ctx)
        assert ctx.pins.paranoid
        snap = PTEXEC_STATS.snapshot()
        tp = _run_ptg_chain(ctx, nt=4, depth=4, name="paranoid")
        delta = PTEXEC_STATS.delta(snap)
        ctx.fini()
        assert tp._ptexec_state is None
        assert delta["pools_engaged"] == 0
        assert delta["pools_ineligible"] == 1
        assert al.counts["executed"] == 4 * 4     # per-task events are back
    finally:
        mca.params.unset("pins_paranoid")


def test_dtd_batched_lane_traced(tmp_path):
    """The DTD engine traces its insert->link->exec cycle: link and
    per-(class, batch) exec intervals plus one completion point per task,
    while engagement matches an unprofiled run. Unlike the reference's
    engine, the port's records its per-task lane too (the card's lane):
    the first insert of the body class rides it, so the points count it."""
    from parsec_tpu_torch.dsl.dtd import PTDTD_STATS

    def inc(a):
        return a + 1.0

    ctx = _ctx()
    ctx.profiling = Profiling()
    snap = PTDTD_STATS.snapshot()
    tp = DTDTaskpool(ctx, "dtdtrace")
    tiles = [tp.tile_new((2, 2), torch.float32) for _ in range(4)]
    for t in tiles:
        t.data.create_copy(0, torch.zeros((2, 2)))
    for i in range(256):
        tp.insert_task(inc, (tiles[i % 4], RW), jit=False)
    tp.wait(timeout=60)
    tp.close()
    ctx.wait(timeout=30)
    delta = PTDTD_STATS.delta(snap)
    ctx.fini()
    assert delta["pools_batch"] == 1, delta      # profiling kept the lane
    assert delta["tasks_batched"] >= 250, delta
    per_task = delta["tasks_native"]
    assert delta["tasks_batched"] + per_task == 256, delta
    for t in tiles:
        assert float(t.data.newest_copy().payload[0, 0]) == 64.0
    path = ctx.profiling.dump(str(tmp_path / "dtd.pbp"))
    trace = read_pbp(path)
    kw = {d["name"] for d in trace.dictionary}
    assert {"ptdtd::link", "ptdtd::exec", "ptdtd::task"} <= kw
    by_key = {d["key"]: d["name"] for d in trace.dictionary}
    points = [e for s in trace.streams for e in s["events"]
              if by_key[e[0] >> 1] == "ptdtd::task"]
    assert len(points) == 256
    df = to_dataframe(trace)
    assert (df[df["name"] == "ptdtd::exec"]["duration"] > 0).all()
    # POINT events surface downstream too: zero-duration dataframe rows
    # and chrome instant ('i') events, not just raw stream records
    pts = df[df["name"] == "ptdtd::task"]
    assert len(pts) == 256
    assert (pts["duration"] == 0).all()
    ctf = to_chrome_trace(trace)
    assert len([e for e in ctf["traceEvents"]
                if e["ph"] == "i" and e["name"] == "ptdtd::task"]) == 256
    assert ctx._ntrace.dropped() == 0


def test_dtd_per_task_lane_traced(tmp_path):
    """The per-task lane (the one GEMM and POTRF inserts take on the card)
    records one link interval and one completion point per task, and its
    latency histogram counts every task; landed + dropped equals what it
    recorded."""
    from parsec_tpu_torch.dsl.dtd import AFFINITY, PTDTD_STATS
    from parsec_tpu_torch.utils.hist import histograms

    mca.set("hist_enabled", True)
    try:
        ctx = _ctx()
        ctx.profiling = Profiling()
        snap = PTDTD_STATS.snapshot()
        h0 = histograms.snapshot().get("ptdtd.pt_ready_to_done_ns",
                                       {}).get("count", 0)
        tp = DTDTaskpool(ctx, "pertask")
        tiles = [tp.tile_new((2, 2), torch.float32) for _ in range(3)]
        for t in tiles:
            t.data.create_copy(0, torch.zeros((2, 2)))

        def inc(a):
            return a + 1.0
        for i in range(30):
            tp.insert_task(inc, (tiles[i % 3], RW | AFFINITY), jit=False)
        tp.wait(timeout=60)
        tp.close()
        ctx.wait(timeout=30)
        delta = PTDTD_STATS.delta(snap)
        h = histograms.snapshot()["ptdtd.pt_ready_to_done_ns"]["count"] - h0
        ctx.fini()
    finally:
        mca.params.unset("hist_enabled")
    assert delta["tasks_native"] == 30 and delta["tasks_batched"] == 0
    assert h == 30
    path = ctx.profiling.dump(str(tmp_path / "pt.pbp"))
    df = to_dataframe(read_pbp(path))
    assert len(df[df["name"] == "ptdtd::link"]) == 30
    assert len(df[df["name"] == "ptdtd::task"]) == 30
    assert ctx._ntrace.events_landed + ctx._ntrace.dropped() == 3 * 30
    for t in tiles:
        assert float(t.data.newest_copy().payload[0, 0]) == 10.0


def test_native_drain_fires_coarse_pins_markers():
    """Each drain that lands events fires SCHEDULE_BEGIN/END batch
    markers so pins_modules consumers observe lane activity without
    per-task callbacks."""
    from parsec_tpu_torch.core import pins as P
    from parsec_tpu_torch.utils.native_trace import NativeDrainMarker
    ctx = _ctx()
    ctx.profiling = Profiling()
    seen = []
    ctx.pins.register(P.SCHEDULE_END,
                      lambda s, t, e: seen.append(t)
                      if isinstance(t, NativeDrainMarker) else None)
    _run_ptg_chain(ctx, name="markers")
    ctx.fini()
    markers = [m for m in seen if m.lane == "ptexec"]
    assert markers and sum(m.n_events for m in markers) == 2 * 16 * 8


def test_lane_stats_helpers():
    """PTEXEC_STATS/PTDTD_STATS carry snapshot()/reset()/delta() so gates
    stop hand-poking dict keys."""
    from parsec_tpu_torch.dsl.dtd import PTDTD_STATS
    from parsec_tpu_torch.dsl.ptg.compiler import PTEXEC_STATS
    from parsec_tpu_torch.utils.counters import LaneStats
    s = LaneStats(a=0, b=0)
    s["a"] += 3
    snap = s.snapshot()
    s["b"] += 2
    assert s.delta(snap) == {"a": 0, "b": 2}
    s.reset()
    assert s == {"a": 0, "b": 0}
    for stats in (PTEXEC_STATS, PTDTD_STATS):
        assert stats.delta(stats.snapshot()) == {k: 0 for k in stats}


def test_native_counters_registry(tmp_path):
    """install_native_counters exposes the lanes under canonical names
    (ptexec.*, ptdtd.*, trace.*) for live_view / the SDE-style export."""
    from parsec_tpu_torch.dsl.dtd import PTDTD_STATS
    from parsec_tpu_torch.dsl.ptg.compiler import PTEXEC_STATS
    from parsec_tpu_torch.utils.counters import (counters,
                                                 install_native_counters)
    install_native_counters()
    install_native_counters()       # idempotent
    snap = counters.snapshot()
    assert snap["ptexec.pools_engaged"] == PTEXEC_STATS["pools_engaged"]
    assert snap["ptdtd.tasks_batched"] == PTDTD_STATS["tasks_batched"]
    assert snap["trace.events_dropped"] >= 0
    ctx = _ctx()
    ctx.profiling = Profiling()
    before = counters.read("ptexec.pools_engaged")
    _run_ptg_chain(ctx, nt=4, depth=4, name="cntreg")
    ctx.fini()
    assert counters.read("ptexec.pools_engaged") == before + 1
    assert counters.read("trace.events_native") > 0


def test_mca_profile_enabled_auto_dump(tmp_path):
    """--mca profile_enabled 1 attaches a tracer at Context creation and
    dumps to --mca profile_filename at fini (the reference's parsec_fini
    dbp write) — with the native lanes traced like an explicit attach."""
    path = str(tmp_path / "auto.pbp")
    mca.set("profile_enabled", True)
    mca.set("profile_filename", path)
    try:
        ctx = _ctx()
        assert ctx.profiling is not None
        tp = _run_ptg_chain(ctx, nt=4, depth=4, name="mcaauto")
        ctx.fini()
    finally:
        mca.params.unset("profile_enabled")
        mca.params.unset("profile_filename")
    assert tp._ptexec_state is not None
    trace = read_pbp(path)
    assert any(s["name"].startswith("ptexec-w") for s in trace.streams)
    assert len(to_dataframe(trace)
               .query("name == 'ptexec::task'")) == 4 * 4


def test_pins_only_keeps_lane_and_fires_markers():
    """PINS instrumentation with NO tracer attached keeps pools on the
    native lane and runs the bridge marker-only: consumers see coarse,
    balanced drain markers instead of a silently idle machine."""
    from parsec_tpu_torch.dsl.ptg.compiler import PTEXEC_STATS
    ctx = _ctx()
    al = ALPerf()
    al.enable(ctx)                       # pins.enabled, ctx.profiling None
    snap = PTEXEC_STATS.snapshot()
    tp = _run_ptg_chain(ctx, nt=8, depth=4, name="pinsonly")
    delta = PTEXEC_STATS.delta(snap)
    ctx.fini()
    assert tp._ptexec_state is not None, "PINS alone ejected the pool"
    assert delta["pools_engaged"] == 1 and delta["pools_ineligible"] == 0
    assert ctx._ntrace is not None and ctx._ntrace.prof is None
    assert ctx._ntrace.events_landed == 0          # marker-only: no landing
    assert al.counts["scheduled"] >= 1, "pins consumers saw an idle machine"
    # SCHEDULE_END and COMPLETE_EXEC_END fire 1:1 per drain — balanced
    assert al.counts["scheduled"] == al.counts["completed"]


def test_drain_markers_keep_scheduler_counters_balanced():
    """NativeDrainMarker must not drift the canonical enabled/retired
    counters: every marker SCHEDULE_END has a matching COMPLETE_EXEC_END,
    so scheduler.pending_tasks returns to its pre-run value."""
    from parsec_tpu_torch.utils.counters import (
        TASKS_ENABLED, TASKS_RETIRED, counters, install_scheduler_counters)
    ctx = _ctx()
    install_scheduler_counters(ctx)
    ctx.profiling = Profiling()
    before = counters.read(TASKS_ENABLED) - counters.read(TASKS_RETIRED)
    _run_ptg_chain(ctx, nt=8, depth=4, name="balance")
    ctx.fini()
    after = counters.read(TASKS_ENABLED) - counters.read(TASKS_RETIRED)
    assert counters.read(TASKS_ENABLED) > 0        # markers did land
    assert after == before, "drain markers drifted pending_tasks"


def test_trace_accounting_complete_under_ring_contention():
    """Landed + dropped covers every event the lanes tried to record,
    even when concurrent engine calls outnumber the rings (the
    all-rings-claimed case counts into the drop side, never vanishes)."""
    mca.set("trace_rings", 1)            # force worker contention
    try:
        ctx = _ctx(nb_cores=2)
        ctx.profiling = Profiling()
        tp = _run_ptg_chain(ctx, nt=64, depth=8, name="contend")
        ctx.fini()
        assert tp._ptexec_state is not None
        # 2 ring events (START/END) per task, no dispatch (CTL bodies):
        # whatever was not landed must be accounted as dropped
        total = ctx._ntrace.events_landed + ctx._ntrace.dropped()
        assert total == 2 * 64 * 8, total
    finally:
        mca.params.unset("trace_rings")


def test_detach_releases_lane_objects_keeps_drop_count():
    """detach() must not pin finished graphs (ring storage is freed with
    the graph) while cumulative drop accounting stays visible."""
    mca.set("trace_ring_capacity", 32)
    mca.set("trace_rings", 1)
    try:
        ctx = _ctx()
        ctx.profiling = Profiling()
        _run_ptg_chain(ctx, nt=64, depth=16, name="detach")
        ctx.fini()
        assert ctx._ntrace._targets == []          # nothing left attached
        assert ctx._ntrace.dropped() > 0           # snapshot survived detach
    finally:
        mca.params.unset("trace_ring_capacity")
        mca.params.unset("trace_rings")


def test_fused_region_trace_marks(tmp_path):
    """A fused PTG data pool brackets each region body in ptexec::region
    intervals (the compiler's trace_mark calls)."""
    mca.set("region_fusion", 1)
    try:
        ctx = _ctx()
        ctx.profiling = Profiling()
        A = TiledMatrix("A", 4, 4, 4, 4)
        A.fill(lambda m, n: torch.zeros((4, 4)))
        tp = compile_ptg(_RW_CHAIN, "fusedmarks").instantiate(
            ctx, globals={"NT": 8}, collections={"A": A})
        ctx.add_taskpool(tp)
        ctx.wait(timeout=60)
        regions = tp._ptexec_state["graph"].region_stats()
        ctx.fini()
    finally:
        mca.params.unset("region_fusion")
    assert float(A.data_of(0, 0).newest_copy().payload[0, 0]) == 8.0
    trace = read_pbp(ctx.profiling.dump(str(tmp_path / "r.pbp")))
    df = to_dataframe(trace)
    assert len(df[df["name"] == "ptexec::region"]) >= 1, regions


# ----------------------------------------- cross-checks through both packages

def _ref():
    import parsec_tpu.core.context as rc
    import parsec_tpu.dsl.ptg.compiler as rp
    import parsec_tpu.utils.trace as rt
    return rc, rp, rt


def _traced_chain(which, backend, path, nt=6, depth=4):
    """The PTG chain on the native lane under a tracer in one package,
    dumped with ``backend``; returns the written path."""
    if which == "ref":
        rc, rp, rt = _ref()
        ctx = rc.Context(nb_cores=1)
        ctx.profiling = rt.Profiling()
        _run_ptg_chain(ctx, nt, depth, name="xchain", mod=rp)
    else:
        import parsec_tpu_torch.dsl.ptg.compiler as pp
        ctx = _ctx()
        ctx.profiling = Profiling()
        _run_ptg_chain(ctx, nt, depth, name="xchain", mod=pp)
    ctx.fini()
    return ctx.profiling.dump(path, backend=backend)


def _interval_counts(mod, trace):
    counts = {}
    for _si, _sn, base, *_rest in mod._intervals(trace):
        name = trace.dictionary[base]["name"]
        counts[name] = counts.get(name, 0) + 1
    return counts


@pytest.mark.parametrize("backend", ["pbp", "ptf2"])
def test_traces_read_across_packages(tmp_path, backend):
    """Each package's trace (PBP file or PTF2 archive) of the same PTG
    chain is read by the other package's reader: equal dictionaries
    (keywords and info descriptions) and equal matched-interval counts per
    keyword, whichever reader reads it."""
    import parsec_tpu.tools.trace_reader as ref_reader
    import parsec_tpu_torch.tools.trace_reader as port_reader
    paths = {w: _traced_chain(w, backend, str(tmp_path / f"{w}.pbp"))
             for w in ("ref", "port")}
    seen = []
    for w, path in paths.items():
        for reader in (ref_reader, port_reader):
            tr = reader.read_trace(path)
            seen.append((
                [(d["name"], d["info_desc"]) for d in tr.dictionary],
                _interval_counts(reader, tr)))
    assert all(s == seen[0] for s in seen), seen
    assert seen[0][1]["ptexec::task"] == 6 * 4


@contextlib.contextmanager
def _both_mca(name, value):
    """Set one MCA parameter in both packages' registries for a block."""
    import parsec_tpu.utils.mca as rmca
    mca.set(name, value)
    rmca.set(name, value)
    try:
        yield
    finally:
        mca.params.unset(name)
        rmca.params.unset(name)


def _per_package():
    """(context factory, compiler module, matrix module, package) of the
    reference and of the port."""
    import parsec_tpu.data.matrix as rm
    import parsec_tpu_torch.data.matrix as pm
    import parsec_tpu_torch.dsl.ptg.compiler as pp
    rc, rp, _rt = _ref()
    return ((lambda: rc.Context(nb_cores=1), rp, rm, "parsec_tpu"),
            (_ctx, pp, pm, "parsec_tpu_torch"))


def test_dot_grapher_same_dot_in_both_packages():
    """DotGrapher records the same executed DAG of one PTG program in both
    packages (per-task PINS events: pins_paranoid): identical DOT text."""
    import importlib
    out = []
    for ctx_f, comp, _mm, pkg in _per_package():
        grapher = importlib.import_module(f"{pkg}.utils.grapher").DotGrapher
        with _both_mca("pins_paranoid", True):
            ctx = ctx_f()
            g = grapher()
            g.enable(ctx)
            _run_ptg_chain(ctx, 3, 4, name="dotx", mod=comp)
            ctx.fini()
        out.append(g.to_dot(name="dag"))
    assert out[0] == out[1]
    assert out[0].count("->") == 3 * 3


def test_ptg_to_dtd_replay_bit_exact_across_packages():
    """The replay of one PTG program (a data chain with random inputs made
    from a seed) gives bit-identical tiles in both packages, and equal to
    the PTG execution itself."""
    src = """
%global NT
%global A
%global B
T(k)
  k = 0 .. NT-1
  : A(0, 0)
  RW X <- (k == 0) ? A(0, 0) : X T(k-1)
     -> (k < NT-1) ? X T(k+1) : A(0, 0)
  READ Y <- B(0, 0)
BODY
  X = X * 0.5 + Y * 1.25
END
"""
    import parsec_tpu.data.matrix as rm
    rc, rp, _rt = _ref()
    rng = np.random.default_rng(1010)
    a0 = rng.standard_normal((8, 8)).astype(np.float32)
    b0 = rng.standard_normal((8, 8)).astype(np.float32)

    def run(ctx, mod_c, mod_m, replay):
        A = mod_m.TiledMatrix("A", 8, 8, 8, 8)
        B = mod_m.TiledMatrix("B", 8, 8, 8, 8)
        A.fill(lambda m, n: a0.copy())
        B.fill(lambda m, n: b0.copy())
        ptp = mod_c.compile_ptg(src, "rx").instantiate(
            ctx, globals={"NT": 5}, collections={"A": A, "B": B})
        if replay is None:
            ctx.add_taskpool(ptp)
        else:
            dtp = replay(ptp, ctx)
            dtp.wait()
            dtp.close()
        ctx.wait()
        ctx.fini()
        return np.asarray(A.to_dense(), np.float32)

    from parsec_tpu.core.pins_modules import ptg_to_dtd_replay as ref_replay
    import parsec_tpu_torch.dsl.ptg.compiler as pp
    import parsec_tpu_torch.data.matrix as pm
    ref = run(rc.Context(nb_cores=1), rp, rm, ref_replay)
    port = run(_ctx(), pp, pm, ptg_to_dtd_replay)
    port_ptg = run(_ctx(), pp, pm, None)
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(port, port_ptg)


def test_pins_module_reports_match_reference():
    """IteratorsChecker and ALPerf see the same counts for one PTG program
    (per-task PINS events: pins_paranoid) in both packages."""
    import importlib
    out = []
    for ctx_f, comp, mm, pkg in _per_package():
        pm = importlib.import_module(f"{pkg}.core.pins_modules")
        with _both_mca("pins_paranoid", True):
            ctx = ctx_f()
            al, chk = pm.ALPerf(), pm.IteratorsChecker()
            al.enable(ctx)
            chk.enable(ctx)
            A = mm.TiledMatrix("A", 4, 4, 4, 4)
            A.fill(lambda m, n: np.zeros((4, 4), np.float32))
            tp = comp.compile_ptg(_RW_CHAIN, "pinsx").instantiate(
                ctx, globals={"NT": 7}, collections={"A": A})
            ctx.add_taskpool(tp)
            ctx.wait()
            ctx.fini()
        out.append((dict(al.counts), list(chk.violations)))
    assert out[0] == out[1], out
    assert out[0][0]["executed"] == 7 and out[0][1] == []
