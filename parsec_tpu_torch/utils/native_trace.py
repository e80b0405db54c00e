"""Bridge: native in-lane event rings → the PBP profiling trace.

The observability half of the native execution lanes (the role the
reference's profiling.c per-ES buffers play for its generated-C hot
path): ``csrc/ptexec.cpp``, ``ptdtd.cpp`` and ``ptdev.cpp`` record
``(key, id, flags, monotonic-ns)`` events into per-worker lock-free ring
buffers while the FSM walks with the GIL dropped (``ptrace_ring.h``).
This module drains those rings and lands the events into the existing
:mod:`parsec_tpu_torch.utils.trace` machinery:

* native event keys register in the process PBP **dictionary**
  (``ptexec::task``, ``ptexec::dispatch``, ``ptdtd::link``,
  ``ptdtd::exec``, ``ptdtd::task``) — begin/end pairs share a key with
  the low bit distinguishing START/END exactly like every other keyword;
* each (lane, ring) pair becomes a per-worker **profiling stream**
  (``ptexec-w0`` …), so :mod:`parsec_tpu_torch.tools.trace_reader` (summary,
  CSV, chrome://tracing/Perfetto JSON) and the PTF2 backend consume
  native-lane runs unchanged;
* each drain that landed events fires coarse ``SCHEDULE_BEGIN/END``
  PINS batch markers (a :class:`NativeDrainMarker`, NOT per-task events)
  so existing ``pins_modules`` consumers observe lane activity that fires
  no PINS events of its own (:data:`PINS_VISIBLE` is left out) — exact
  per-task counts live in the counter registry
  (``utils/counters.install_native_counters``), not in the markers;
* ring **drop counters** (overflow never blocks the lane) surface
  through :func:`total_dropped` / the ``trace.events_dropped`` counter.

Timestamp calibration: the rings record ``steady_clock`` ns while the
PBP streams use ``time.perf_counter()`` seconds; the offset is sampled
once per attach (on Linux both read CLOCK_MONOTONIC, so it is ~0, but
the bridge does not rely on that).
"""

from __future__ import annotations

import struct
import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

from . import mca

mca.register("trace_ring_capacity", 1 << 16,
             "Events per in-lane trace ring (csrc/ptrace_ring.h); "
             "overflow drops events and bumps trace.events_dropped "
             "instead of blocking the lane", type=int)
mca.register("trace_rings", 16,
             "Per-engine worker ring count for in-lane tracing (one ring "
             "is claimed per concurrent engine call)", type=int)

#: the ring event record (ptrace_ring.h Event): t_ns, id, key, flags
_EVENT_FMT = "<qqII"
EVENT_SIZE = struct.calcsize(_EVENT_FMT)

# native key -> PBP keyword name per lane kind (must mirror the EV_*
# constants exported by the extension modules)
NATIVE_KEYWORDS: Dict[str, Dict[int, str]] = {
    "ptexec": {1: "ptexec::task", 2: "ptexec::dispatch",
               # fused-region body intervals: merged Perfetto timelines
               # separate regions from per-task seams
               3: "ptexec::region"},
    # keys 4/5 are the per-task lane's link interval and completion point:
    # the same keywords, keys of their own so the drain markers skip them
    "ptdtd": {1: "ptdtd::link", 2: "ptdtd::exec", 3: "ptdtd::task",
              4: "ptdtd::link", 5: "ptdtd::task"},
    # the device lane's manager-thread events (csrc/ptdev.cpp): dispatch
    # batches as intervals, per-task retirements as points — device
    # occupancy/overlap in the same Perfetto view as the engines
    # (`ptdev-w*` streams; one ring, the manager is a single thread)
    "ptdev": {1: "ptdev::dispatch", 2: "ptdev::retire"},
    # the comm lane's EV_COMM_* points (csrc/ptcomm.cpp): one per-rank
    # progress-thread stream, so compute/comm overlap is measurable in the
    # same Perfetto view as the execution lanes; frame_tx/frame_rx carry
    # the flow identity (peer << 40) | seq of one activation frame
    "ptcomm": {1: "ptcomm::act_tx", 2: "ptcomm::act_rx",
               3: "ptcomm::data_tx", 4: "ptcomm::data_rx",
               5: "ptcomm::rdv_get", 6: "ptcomm::rdv_rep",
               7: "ptcomm::frame_tx", 8: "ptcomm::frame_rx",
               9: "ptfab::cred_tx", 10: "ptfab::cred_rx"},
}

#: (kind, native key) of events whose tasks fire the per-task PINS events
#: themselves (the DTD per-task lane): the coarse drain markers leave them
#: out, or PINS consumers would count those tasks twice
PINS_VISIBLE = frozenset({("ptdtd", 4), ("ptdtd", 5)})

#: live bridges, for the process-wide drop/landed samplers
_bridges: "weakref.WeakSet[NativeTraceBridge]" = weakref.WeakSet()


def total_dropped() -> int:
    """Events lost to ring overflow across every live bridge (the
    ``trace.events_dropped`` counter sampler)."""
    return sum(b.dropped() for b in list(_bridges))


def total_landed() -> int:
    """Events landed into profiling streams across every live bridge."""
    return sum(b.events_landed for b in list(_bridges))


class NativeDrainMarker:
    """The coarse PINS payload fired once per drain (a batch marker, not
    a task): ``lane`` names the engine kind, ``n_events`` counts what the
    drain landed. Fired through SCHEDULE_BEGIN/END *and* COMPLETE_EXEC_END
    so payload-agnostic consumers (``install_scheduler_counters``, ALPerf)
    see one balanced enabled/retired tick per drain — canonical gauges
    like ``scheduler.pending_tasks`` cannot drift from markers alone."""

    __slots__ = ("lane", "n_events")

    def __init__(self, lane: str, n_events: int) -> None:
        self.lane = lane
        self.n_events = n_events

    def __repr__(self) -> str:  # pragma: no cover
        return f"<native-drain {self.lane}: {self.n_events} events>"


class _Target:
    __slots__ = ("kind", "obj", "tpid", "offset", "dropped0")

    def __init__(self, kind: str, obj: Any, tpid: int, offset: float) -> None:
        self.kind = kind
        self.obj = obj          # strong ref; detach() drops it
        self.tpid = tpid
        self.offset = offset    # perf_counter seconds - monotonic_ns * 1e-9
        # the object's cumulative drop count when this attach began: a
        # long-lived lane detached and attached again (tracing switched
        # off and on) must not count its earlier drops twice
        self.dropped0 = obj.trace_dropped()

    def dropped(self) -> int:
        return self.obj.trace_dropped() - self.dropped0


class NativeTraceBridge:
    """Owns the ring lifecycle for one context's native engines:
    enable at attach → record in-lane → drain (starvation hook +
    quiescence points) → land into the PBP dictionary/streams.

    ``profiling`` may be None (PINS-only instrumentation, no tracer
    attached): the lanes still stay engaged and the bridge runs in
    marker-only mode — rings are drained and counted but discarded, and
    the coarse :class:`NativeDrainMarker` PINS events are the whole
    signal (``--mca pins_paranoid 1`` buys back per-task fidelity)."""

    def __init__(self, profiling, pins=None) -> None:
        self.prof = profiling
        self.pins = pins
        self._targets: List[_Target] = []
        self._dropped_detached = 0   # keep detached lanes' drop accounting
        self._streams: Dict[Tuple[str, int], Any] = {}
        self._keys: Dict[Tuple[str, int], Tuple[int, int]] = {}
        self._cache_prof = profiling      # the tracer the caches belong to
        self.events_landed = 0
        # drains run from EVERY worker stream's hot loop (context drain
        # hooks) plus quiescence points: one lock serializes the
        # stream/keyword caches, target list edits, and the landing
        # appends (two unserialized drains could mint duplicate
        # `ptexec-w0` streams, splitting START/END pairs across them)
        self._mu = threading.Lock()
        _bridges.add(self)

    # ------------------------------------------------------------ lifecycle
    def attach(self, kind: str, obj: Any, tpid: int = 0) -> bool:
        """Arm ``obj``'s in-lane rings and start landing its events.
        Idempotent per object; returns False when the object predates
        in-lane tracing (older extension build)."""
        if not hasattr(obj, "trace_enable"):
            return False
        with self._mu:
            for t in self._targets:
                if t.obj is obj:
                    return True
            obj.trace_enable(mca.get("trace_rings", 16),
                             mca.get("trace_ring_capacity", 1 << 16))
            # clock calibration: sample both clocks back to back
            offset = time.perf_counter() - obj.monotonic_ns() * 1e-9
            self._targets.append(_Target(kind, obj, tpid, offset))
        return True

    def detach(self, obj: Any) -> None:
        """Final-drain ``obj`` and stop holding it (a finished pool's
        graph — and its ring storage — must not be pinned by the tracer).
        Its cumulative drop count is snapshotted into the bridge so it
        stays visible through :meth:`dropped`."""
        fired = []
        with self._mu:
            for t in list(self._targets):
                if t.obj is obj:
                    fired.append((t.kind, self._drain_target(t)))
                    self._targets.remove(t)
                    try:
                        self._dropped_detached += t.dropped()
                    except Exception:  # noqa: BLE001 — accounting only
                        pass
        self._fire_markers(fired)

    def rebind(self, profiling) -> None:
        """Land every target's pending events into the current tracer,
        then land what follows into ``profiling`` (None: marker-only). The
        stream and keyword caches belong to the last tracer that landed
        events: a tracer switched off and on again keeps its streams."""
        self.drain_all(wait=True)
        with self._mu:
            self.prof = profiling
            if profiling is not None and profiling is not self._cache_prof:
                self._streams.clear()
                self._keys.clear()
                self._cache_prof = profiling

    # --------------------------------------------------------------- drain
    def drain_all(self, wait: bool = False) -> int:
        """Land every target's pending ring events; returns the event
        count. Registered as a context drain hook, so it runs at progress
        -loop start and whenever a stream starves — plus explicitly at
        pool quiescence (compiler/dtd retire paths) and fini, which pass
        ``wait=True`` so the final drain cannot be skipped."""
        # non-blocking from the hot loops: when another worker is already
        # mid-drain the events are in good hands — skip, don't stall
        if not self._mu.acquire(blocking=wait):
            return 0
        try:
            fired = [(t.kind, self._drain_target(t)) for t in self._targets]
        finally:
            self._mu.release()
        self._fire_markers(fired)
        return sum(n for _, (n, _m) in fired)

    def dropped(self) -> int:
        with self._mu:
            return self._dropped_detached + sum(t.dropped()
                                                for t in self._targets)

    # ------------------------------------------------------------ internals
    def _key_for(self, kind: str, key: int) -> Optional[Tuple[int, int]]:
        ks = self._keys.get((kind, key))
        if ks is None:
            name = NATIVE_KEYWORDS.get(kind, {}).get(key)
            if name is None:
                return None       # unknown key: a newer engine — skip
            ks = self.prof.add_dictionary_keyword(name)
            self._keys[(kind, key)] = ks
        return ks

    def _stream_for(self, kind: str, ring: int):
        s = self._streams.get((kind, ring))
        if s is None:
            s = self.prof.stream(f"{kind}-w{ring}")
            self._streams[(kind, ring)] = s
        return s

    def _drain_target(self, t: _Target) -> Tuple[int, int]:
        """Drain one target: (events consumed, events the drain markers
        count — those not in :data:`PINS_VISIBLE`)."""
        try:
            pending = t.obj.trace_drain()
        except Exception:  # noqa: BLE001 — tracing must never kill the lane
            return 0, 0
        if not pending:
            return 0, 0
        n = 0
        seen = 0
        if self.prof is None:
            # marker-only mode (PINS without a tracer): consume and count
            # the rings so drop accounting stays live, land nothing
            for _ring, blob in pending:
                for _t, _e, key, _f in struct.iter_unpack(_EVENT_FMT, blob):
                    n += 1
                    seen += (t.kind, key) in PINS_VISIBLE
        else:
            # taskpool-tagged event ids: two pools' task #k must not pair
            # against each other in one per-worker stream
            eid_base = t.tpid << 40
            for ring, blob in pending:
                stream = self._stream_for(t.kind, ring)
                append = stream.events.append
                for t_ns, eid, key, flags in struct.iter_unpack(_EVENT_FMT,
                                                                blob):
                    ks = self._key_for(t.kind, key)
                    if ks is None:
                        continue
                    pbp_key = ks[1] if flags == 0x2 else ks[0]
                    append((pbp_key, eid_base + eid, t.tpid,
                            t_ns * 1e-9 + t.offset, flags, b""))
                    n += 1
                    seen += (t.kind, key) in PINS_VISIBLE
            self.events_landed += n
        return n, n - seen

    def _fire_markers(self, fired: List[Tuple[str, int]]) -> None:
        """Coarse per-drain batch markers for pins_modules consumers —
        fired OUTSIDE the bridge lock (a callback may read back
        :meth:`dropped`). SCHEDULE-shaped, with one matching COMPLETE
        tick so the canonical enabled/retired counters stay balanced;
        per-task fidelity needs --mca pins_paranoid 1."""
        if self.pins is None or not self.pins.enabled:
            return
        from ..core import pins as P
        for kind, (_n, n) in fired:
            if not n:
                continue
            marker = NativeDrainMarker(kind, n)
            self.pins.fire(P.SCHEDULE_BEGIN, None, marker)
            self.pins.fire(P.SCHEDULE_END, None, marker)
            self.pins.fire(P.COMPLETE_EXEC_END, None, marker)
