"""PINS instrumentation modules.

Re-design of the reference's module set (parsec/mca/pins/*):

* :class:`TaskProfiler` — feeds the profiling trace from task lifecycle
  events (ref: pins/task_profiler).
* :class:`PrintSteals` — per-stream steal accounting (ref: pins/print_steals;
  "distance" > 0 on select means the task came from another stream's queue).
* :class:`IteratorsChecker` — walks every executed task's successor
  descriptors and validates them against the dependency engine — the
  runtime "race detector" for DSL-generated dataflow
  (ref: pins/iterators_checker).
* :class:`ALPerf` — accumulated-lifecycle performance counters
  (ref: pins/alperf): tasks scheduled/executed/completed per second.
* :class:`PTGToDTD` — replays a PTG taskpool through the DTD frontend, the
  cross-DSL test harness (ref: pins/ptg_to_dtd) — see
  :func:`ptg_to_dtd_replay`.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional

from ..utils import output
from . import pins as P
from .task import Task


class PinsModule:
    name = "base"

    def enable(self, context) -> None:
        self.context = context
        self._register(context.pins)

    def disable(self, context) -> None:
        self._unregister(context.pins)

    def _register(self, pins) -> None:
        raise NotImplementedError

    def _unregister(self, pins) -> None:
        pass


class TaskProfiler(PinsModule):
    """Emit exec/schedule/complete events into the profiling trace."""

    name = "task_profiler"

    def __init__(self, profiling) -> None:
        self.prof = profiling
        self.keys: Dict[str, tuple] = {}
        self._streams: Dict[int, Any] = {}
        self._lock = threading.Lock()

    def _stream_for(self, stream) -> Any:
        sid = getattr(stream, "th_id", -1)
        s = self._streams.get(sid)
        if s is None:
            with self._lock:
                s = self._streams.get(sid)
                if s is None:
                    s = self.prof.stream(f"es{sid}")
                    self._streams[sid] = s
        return s

    def _key(self, task: Task, end: bool) -> int:
        name = task.task_class.name
        ks = self.keys.get(name)
        if ks is None:
            ks = self.prof.add_dictionary_keyword(name, info_desc="prio{i}")
            self.keys[name] = ks
        return ks[1] if end else ks[0]

    def _register(self, pins) -> None:
        pins.register(P.EXEC_BEGIN, self._exec_begin)
        pins.register(P.EXEC_END, self._exec_end)
        pins.register(P.COMPLETE_EXEC_END, self._complete)

    def _unregister(self, pins) -> None:
        pins.unregister(P.EXEC_BEGIN, self._exec_begin)
        pins.unregister(P.EXEC_END, self._exec_end)
        pins.unregister(P.COMPLETE_EXEC_END, self._complete)

    def _eid(self, task: Task) -> int:
        return hash(task.key) & 0x7FFFFFFF

    def _exec_begin(self, stream, task, extra) -> None:
        from ..utils.trace import EVENT_FLAG_START
        key = self._key(task, False)   # registers the keyword on first use
        info = self.prof.pack_info(task.task_class.name, prio=task.priority)
        self._stream_for(stream).trace(key, self._eid(task),
                                       task.taskpool.taskpool_id,
                                       EVENT_FLAG_START, info)

    def _exec_end(self, stream, task, extra) -> None:
        from ..utils.trace import EVENT_FLAG_END
        self._stream_for(stream).trace(self._key(task, True), self._eid(task),
                                       task.taskpool.taskpool_id,
                                       EVENT_FLAG_END)

    def _complete(self, stream, task, extra) -> None:
        pass


class PrintSteals(PinsModule):
    """Count work steals per stream (ref: pins/print_steals)."""

    name = "print_steals"

    def __init__(self) -> None:
        self.steals: Dict[int, int] = defaultdict(int)
        self.selects: Dict[int, int] = defaultdict(int)

    def _register(self, pins) -> None:
        pins.register(P.SELECT_END, self._select_end)

    def _unregister(self, pins) -> None:
        pins.unregister(P.SELECT_END, self._select_end)

    def _select_end(self, stream, task, extra) -> None:
        if task is None:
            return
        self.selects[stream.th_id] += 1

    def report(self) -> Dict[int, Dict[str, int]]:
        return {tid: {"selects": n, "steals": self.steals[tid]}
                for tid, n in self.selects.items()}


class IteratorsChecker(PinsModule):
    """Validate DSL-generated successor descriptors at runtime.

    For every completed task, re-walks its out-deps and checks each
    successor's locals are inside the peer's declared ranges and that the
    dep targets an existing flow — catching miscompiled dataflow the way the
    reference's iterators_checker does.
    """

    name = "iterators_checker"

    def __init__(self) -> None:
        self.violations: List[str] = []

    def _register(self, pins) -> None:
        pins.register(P.COMPLETE_EXEC_BEGIN, self._check)

    def _unregister(self, pins) -> None:
        pins.unregister(P.COMPLETE_EXEC_BEGIN, self._check)

    def _check(self, stream, task: Task, extra) -> None:
        tc = task.task_class
        for flow in tc.flows:
            for dep in flow.deps_out:
                if dep.task_class is None:
                    continue
                if dep.cond is not None and not dep.cond(task.locals):
                    continue
                try:
                    targets = dep.target_locals(task.locals) if dep.target_locals \
                        else [task.locals]
                except Exception as e:  # noqa: BLE001
                    self.violations.append(
                        f"{task!r}.{flow.name}: target_locals raised {e!r}")
                    continue
                if isinstance(targets, dict):
                    targets = [targets]
                peer = dep.task_class
                for tl in targets:
                    if dep.flow_index >= len(peer.flows):
                        self.violations.append(
                            f"{task!r}.{flow.name}: dep to missing flow "
                            f"#{dep.flow_index} of {peer.name}")
                    ranges = getattr(peer, "_ptg_ranges", None)
                    if ranges:
                        env = dict(getattr(task.taskpool, "env_base", {}))
                        for param, lo, hi, _st in ranges:
                            env.update(tl)
                            v = tl.get(param)
                            if v is None:
                                continue
                            if not (int(lo(env)) <= v <= int(hi(env))):
                                self.violations.append(
                                    f"{task!r}.{flow.name} -> {peer.name}{tl}: "
                                    f"{param}={v} outside range")


class ALPerf(PinsModule):
    """Accumulated lifecycle rates (ref: pins/alperf)."""

    name = "alperf"

    def __init__(self) -> None:
        self.t0 = time.perf_counter()
        self.counts: Dict[str, int] = defaultdict(int)

    def _register(self, pins) -> None:
        pins.register(P.SCHEDULE_END, lambda s, t, e: self._bump("scheduled", t))
        pins.register(P.EXEC_END, lambda s, t, e: self._bump("executed", t))
        pins.register(P.COMPLETE_EXEC_END, lambda s, t, e: self._bump("completed", t))

    def _bump(self, what: str, t) -> None:
        n = len(t) if isinstance(t, list) else 1
        self.counts[what] += n

    def report(self) -> Dict[str, float]:
        dt = max(time.perf_counter() - self.t0, 1e-9)
        r = {k: v / dt for k, v in self.counts.items()}
        r["elapsed_s"] = dt
        return r


class HWCounters(PinsModule):
    """Hardware PMU counters around task execution (the PAPI role, ref:
    parsec/mca/pins/papi/ — mod_papi.c samples counters at EXEC begin/end
    through libpapi; here raw perf_event_open, utils/perf_event.py).

    Accumulates per-task-class deltas (cycles, instructions, ...); a host
    where perf_event is unavailable (seccomp, paranoid level, no PMU)
    yields a module that enables as a NO-OP — same shape as the reference
    only building pins/papi when libpapi exists."""

    name = "hw_counters"

    def __init__(self, events=("cycles", "instructions")) -> None:
        from ..utils import perf_event
        self._pe = perf_event
        self.events = tuple(events)
        self.active = perf_event.available()
        self._hw = None
        self._pending: Dict[int, Dict[str, int]] = {}
        self.per_class: Dict[str, Dict[str, int]] = defaultdict(
            lambda: defaultdict(int))
        self.tasks_sampled = 0

    def _register(self, pins) -> None:
        if not self.active:
            output.debug_verbose(
                1, "pins", "hw_counters: perf_event unavailable; no-op")
            return
        self._hw = self._pe.HWCounterSet(self.events)
        self._hw.start()
        pins.register(P.EXEC_BEGIN, self._on_begin)
        pins.register(P.EXEC_END, self._on_end)

    def _unregister(self, pins) -> None:
        if not self.active:
            return
        pins.unregister(P.EXEC_BEGIN, self._on_begin)
        pins.unregister(P.EXEC_END, self._on_end)
        if self._hw is not None:
            self._hw.close()
            self._hw = None

    def _on_begin(self, stream, task, extra) -> None:
        self._pending[id(task)] = self._hw.read()

    def _on_end(self, stream, task, extra) -> None:
        t0 = self._pending.pop(id(task), None)
        if t0 is None:
            return
        t1 = self._hw.read()
        acc = self.per_class[task.task_class.name]
        for k in self.events:
            acc[k] += t1[k] - t0[k]
        self.tasks_sampled += 1

    def report(self) -> Dict[str, Dict[str, int]]:
        return {cls: dict(v) for cls, v in self.per_class.items()}


def ptg_to_dtd_replay(ptg_taskpool, ctx, name: Optional[str] = None,
                      capture: bool = False):
    """Replay a PTG taskpool's task space through the DTD frontend.

    The cross-DSL harness (ref: pins/ptg_to_dtd): enumerate the PTG task
    space, and for each task insert a DTD task touching the same memory
    endpoints with the same access modes. Dataflow through repos becomes
    dataflow through tiles; results must match the PTG execution.
    Returns the DTD taskpool (caller waits/closes).

    Anonymous task→task flows ride per-flow scratch tiles keyed by the
    PRODUCER (class, key, flow); memory out-deps copy home (the replay
    analogue of PTG's complete-execution write-back).

    With ``capture=True`` the replay lands in a captured pool
    (dsl/capture.py): a PTG program — a static task space by definition —
    runs as one captured DAG (one CUDA graph on the card). PTG bodies are
    pure tensor functions, so the replay wrappers capture through.
    """
    from ..dsl.dtd import DTDTaskpool, READ, RW, WRITE
    from ..dsl.ptg.compiler import PTGTaskpool
    assert isinstance(ptg_taskpool, PTGTaskpool)
    tp = DTDTaskpool(ctx, name or f"{ptg_taskpool.name}-dtd", capture=capture)
    spec = ptg_taskpool.program.spec

    scratch: Dict[Any, Any] = {}

    def scratch_tile(cls_name: str, key: tuple, flow: str):
        k = (cls_name, key, flow)
        t = scratch.get(k)
        if t is None:
            t = tp.tile_new((1,))
            scratch[k] = t
        return t

    for tc, loc in ptg_taskpool._enumerate():
        tcs = tc._ptg_spec
        env = ptg_taskpool._env(loc)
        args = []
        accesses = []
        for fi, fs in enumerate(tcs.flows):
            if fs.access == "CTL":
                continue
            acc = {"READ": READ, "WRITE": WRITE, "RW": RW}[fs.access]
            ep = tc._ptg_active_in(tc._ptg_in_specs[fi], env)
            if ep is not None and ep["kind"] == "memory":
                dc = ptg_taskpool.collections[ep["name"]]
                tile = tp.tile_of(dc, *[ex.values(env)[0] for ex in ep["exprs"]])
            elif ep is not None and ep["kind"] == "task":
                pkey = tuple(ex.values(env)[0] for ex in ep["exprs"])
                tile = scratch_tile(ep["name"], pkey, ep["flow"])
            else:
                tile = scratch_tile(tcs.name, tuple(loc.values()), fs.name)
            # writes also publish into this task's own scratch/memory targets
            args.append((tile, acc))
            accesses.append(acc)
        params = [loc[p] for p in tcs.params]
        # reuse the PTG-compiled body through a DTD-shaped wrapper
        fn = _dtd_wrapper_for(ptg_taskpool, tcs, tc)
        tp.insert_task(fn, *args, *params, name=f"{tcs.name}-replay",
                       jit=capture)
        # route written outputs onward: memory out-deps write home like PTG;
        # task out-deps land in the successor's scratch tile
        _route_outputs(ptg_taskpool, tp, tc, tcs, loc, env, args, scratch_tile)
    return tp


def _dtd_wrapper_for(ptp, tcs, tc):
    data_flows = [f for f in tcs.flows if f.access != "CTL"]
    chore_fn = tc._ptg_body_fn

    def wrapper(*vals):
        nflows = len(data_flows)
        tiles = vals[:nflows]
        params = vals[nflows:]
        outs = chore_fn(*params, *tiles)
        return outs
    wrapper.__name__ = f"{tcs.name}_replay"
    return wrapper


def _replay_copy(d_, s_):
    return s_


def _route_outputs(ptp, tp, tc, tcs, loc, env, args, scratch_tile) -> None:
    """After the replayed task, publish its written flows where successor
    replays will read them. Scratch tiles are keyed by the PRODUCER
    (class, key, flow) — the key a consumer's input endpoint names
    ("C GEMM(m,n,k-1)" reads scratch(GEMM, (m,n,k-1), C)) — and memory
    out-deps copy home, the replay analogue of PTG's complete-execution
    write-back."""
    import itertools

    from ..dsl.dtd import READ, RW
    from ..dsl.ptg.compiler import _index_expr
    flow_tiles = {}
    di = 0
    for fs in tcs.flows:
        if fs.access == "CTL":
            continue
        flow_tiles[fs.name] = args[di][0]
        di += 1
    jit_copy = getattr(tp, "_capture", None) is not None
    for fs in tcs.flows:
        if fs.access not in ("WRITE", "RW"):
            continue
        src = flow_tiles[fs.name]
        has_task_out = False
        for d in fs.deps:
            if d.direction != "out":
                continue
            for ep, neg in ((d.endpoint, False), (d.else_endpoint, True)):
                if ep is None:
                    continue
                if d.guard is not None:
                    v = bool(eval(compile(d.guard, "<g>", "eval"), dict(env)))  # noqa: S307
                    if neg:
                        v = not v
                    if not v:
                        continue
                if ep.kind == "task":
                    has_task_out = True
                elif ep.kind == "memory":
                    exprs = [_index_expr(e) for e in ep.index_exprs]
                    for combo in itertools.product(
                            *[ex.values(env) for ex in exprs]):
                        dc = ptp.collections[ep.name]
                        dst = tp.tile_of(dc, *combo)
                        if dst is not src:
                            tp.insert_task(_replay_copy, (dst, RW),
                                           (src, READ), name="replay-copy",
                                           jit=jit_copy)
        if has_task_out:
            # one producer-keyed publication serves every consumer
            dst = scratch_tile(tcs.name, tuple(loc.values()), fs.name)
            if dst is not src:
                tp.insert_task(_replay_copy, (dst, RW), (src, READ),
                               name="replay-copy", jit=jit_copy)
