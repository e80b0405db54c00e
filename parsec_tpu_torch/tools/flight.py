"""Per-rank flight recorder: a bounded black box for post-mortems.

A killed or wedged rank must leave evidence instead of silence. On
trigger — peer death (a comm lane's
``broken_peers``), pool error, a watchdog stall, or a p99 breach vs the
EWMA baseline (all fired by :mod:`parsec_tpu_torch.core.watchdog`), or any
caller of :func:`record` — the recorder dumps an attributed snapshot of

* the native trace rings' recent events (drained through the context's
  trace bridge and re-emitted as a standalone ``.pbp`` companion file,
  readable by ``tools/trace_reader`` like any trace),
* the unified counter registry and the latency-histogram summaries,
* the comm lane's last frame counters (``out_pending``, ``bytes_*``,
  ``frame_errors``, ``broken_peers``) once a context has a comm lane,

into ``--mca flight_dir`` as ``flight-r<rank>-<n>-<trigger>.json`` (+
``.pbp`` when events exist). BOUNDED black box: at most ``--mca
flight_max_dumps`` dumps per process, at most ``--mca
flight_max_events`` events per stream in the companion trace, and a
repeated trigger key (the same stall persisting across watchdog ticks)
is suppressed after its first dump — a forced stall produces exactly
one flight record.

Everything is best-effort and off the hot path: a failed snapshot
section degrades to its error string in the dump, never an exception
out of the trigger site.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Optional

from ..utils import mca, output
from ..utils.counters import LaneStats

mca.register("flight_dir", "",
             "Arm the flight recorder: attributed post-mortem dumps "
             "(counters JSON + recent-events .pbp) land here on trigger "
             "(watchdog stall, peer death, pool error, p99 breach). "
             "Empty = disabled", type=str)
mca.register("flight_max_events", 2048,
             "Per-stream event cap in a flight dump's companion .pbp "
             "(the bounded black box)", type=int)
mca.register("flight_max_dumps", 4,
             "Max flight dumps per process — a flapping trigger must "
             "not fill the disk", type=int)

#: exported as ``flight.*`` by install_native_counters
FLIGHT_STATS = LaneStats(
    triggers=0,      # record() calls (armed or not)
    dumps=0,         # dumps actually written
    suppressed=0,    # repeated-key / over-cap / unarmed triggers
    errors=0,        # dump attempts that failed
)

_mu = threading.Lock()
_seen: set = set()        # trigger keys already dumped (dedup)
_dump_no = 0


def _json_safe(v):
    from .metrics_server import _json_safe as js
    return js(v)


def _section(fn):
    """Run one snapshot section; a failure becomes its error string."""
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 — the dump must still land
        return {"error": repr(e)}


def _comm_brief(ctx) -> Dict[str, Any]:
    rde = getattr(ctx, "comm", None)
    native = getattr(rde, "native", None)
    if native is None:
        return {}
    s = native.comm.stats()
    return {k: s.get(k, 0) for k in
            ("out_pending", "bytes_tx", "bytes_rx", "acts_tx", "acts_rx",
             "frame_errors", "broken_peers", "early_parked",
             "dropped_sends")}


def _snapshot_trace(ctx, path: str, max_events: int) -> int:
    """Re-emit the tail of the attached tracer's streams as a
    standalone .pbp (same dictionary, last ``max_events`` events per
    stream) after a blocking ring drain — the recent-events black box.
    Returns the event count written (0 = no companion file)."""
    prof = getattr(ctx, "profiling", None) if ctx is not None else None
    if prof is None:
        return 0
    ntrace = getattr(ctx, "_ntrace", None)
    if ntrace is not None:
        try:
            ntrace.drain_all(wait=True)   # land straggler ring events
        except Exception:  # noqa: BLE001 — dump what already landed
            pass
    from ..utils.trace import Profiling
    snap = Profiling()
    with prof._lock:
        snap.t0 = prof.t0
        entries = sorted(prof._dict.values(), key=lambda e: e.key)
        streams = [(s.name, list(s.events[-max_events:]))
                   for s in prof._streams]
    # keys are assigned sequentially, so re-adding in key order
    # reproduces the same key space the copied events reference
    for e in entries:
        snap.add_dictionary_keyword(e.name, e.attr, e.info_desc)
    n = 0
    for name, events in streams:
        if not events:
            continue
        st = snap.stream(name)
        st.events.extend(events)
        n += len(events)
    if n == 0:
        return 0
    snap.dump(path, backend="pbp")
    return n


def record(trigger: str, detail: Optional[Dict[str, Any]] = None, *,
           key: Optional[str] = None, ctx=None,
           dir: Optional[str] = None) -> Optional[str]:
    """Dump one attributed flight record; returns the JSON path or None
    (unarmed / suppressed / failed — counted either way).

    ``key`` dedups: the same key never dumps twice in one process (the
    watchdog passes ``watchdog_stall:<lane>`` so a persisting stall
    produces exactly one record). ``ctx`` (optional) supplies the trace
    bridge, tracer and comm lane for the events/comm sections.
    """
    global _dump_no
    FLIGHT_STATS["triggers"] += 1
    out_dir = dir if dir is not None else mca.get("flight_dir", "")
    if not out_dir:
        FLIGHT_STATS["suppressed"] += 1
        return None
    with _mu:
        k = key or trigger
        if k in _seen or _dump_no >= max(1, mca.get("flight_max_dumps", 4)):
            FLIGHT_STATS["suppressed"] += 1
            return None
        _seen.add(k)
        _dump_no += 1
        n = _dump_no
    rank = getattr(ctx, "my_rank", 0) if ctx is not None else 0
    if not rank:       # a rank-0-shaped local ctx: trust the trigger's
        rank = (detail or {}).get("rank", 0) or 0   # own attribution
    base = os.path.join(out_dir, f"flight-r{rank}-{n}-{trigger}")
    try:
        os.makedirs(out_dir, exist_ok=True)
        from ..utils.counters import counters, install_native_counters
        from ..utils.hist import histograms
        _section(install_native_counters)
        from ..core.watchdog import WATCHDOG_STATS
        pbp_path = base + ".pbp"
        nevents = _section(lambda: _snapshot_trace(
            ctx, pbp_path, max(1, mca.get("flight_max_events", 2048))))
        body = {
            "trigger": trigger,
            "key": key or trigger,
            "detail": detail or {},
            "ts": time.time(),
            "rank": rank,
            "pid": os.getpid(),
            "counters": _section(counters.snapshot),
            "percentiles": _section(lambda: histograms.summaries(ttl=0.0)),
            "comm": _section(lambda: _comm_brief(ctx)),
            "watchdog": _section(WATCHDOG_STATS.snapshot),
            "events": nevents if isinstance(nevents, int) else 0,
            "trace": os.path.basename(pbp_path)
            if isinstance(nevents, int) and nevents else None,
        }
        path = base + ".json"
        with open(path, "w") as f:
            json.dump(_json_safe(body), f, indent=1)
        FLIGHT_STATS["dumps"] += 1
        output.warning(f"flight record dumped: {path} "
                       f"(trigger={trigger}, {body['events']} events)")
        return path
    except Exception as e:  # noqa: BLE001 — the black box must not throw
        FLIGHT_STATS["errors"] += 1
        output.debug_verbose(1, "flight", f"dump failed: {e}")
        return None


def reset() -> None:
    """Drop the dedup set + dump counter (test isolation only)."""
    global _dump_no
    with _mu:
        _seen.clear()
        _dump_no = 0
