"""Properties dictionary + software-defined counter export.

Re-design of parsec/dictionary.c (live properties registry) and
parsec/papi_sde.c (PAPI software-defined events exposing runtime counters —
pending tasks, tasks enabled, tasks retired; scheduling.c:330-337,491).
Counters register once and are sampled on read; an aggregation hook serves
the live-visualization role of tools/aggregator_visu.

The lanes' engagement counters (``PTDTD_STATS``, ``SCHED_STATS``, the
program cache's) are :class:`Counters`: a plain dict underneath, so the hot
paths keep their ``stats[key] += 1`` shape, with the lifecycle helpers
tests and gates read them through. :func:`install_native_counters` exports
every one of them into the process registry under canonical names.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Union

Sampler = Callable[[], Union[int, float]]

# canonical counter names (ref: PAPI_SDE parsec::SCHEDULER::PENDING_TASKS etc.)
PENDING_TASKS = "scheduler.pending_tasks"
TASKS_ENABLED = "scheduler.tasks_enabled"
TASKS_RETIRED = "scheduler.tasks_retired"


class Counters(dict):
    """A dict of named counters with ``snapshot``/``delta``/``reset``."""

    def snapshot(self) -> Dict[str, int]:
        """A point-in-time copy (compare with :meth:`delta`)."""
        return dict(self)

    def delta(self, snap: Dict[str, int]) -> Dict[str, int]:
        """Per-key change since a :meth:`snapshot`."""
        return {k: v - snap.get(k, 0) for k, v in self.items()}

    def reset(self) -> None:
        """Zero every counter."""
        for k in self:
            self[k] = 0


#: the engagement-counter dict of the native lanes (``PTEXEC_STATS``): the
#: reference's name for the same helper
LaneStats = Counters


class CounterRegistry:
    """Process-wide named counters: either atomic accumulators or samplers."""

    def __init__(self) -> None:
        self._acc: Dict[str, float] = {}
        self._samplers: Dict[str, Sampler] = {}
        self._lock = threading.Lock()

    def register(self, name: str, sampler: Optional[Sampler] = None) -> None:
        with self._lock:
            if sampler is not None:
                self._samplers[name] = sampler
            else:
                self._acc.setdefault(name, 0)

    def add(self, name: str, v: Union[int, float] = 1) -> None:
        with self._lock:
            self._acc[name] = self._acc.get(name, 0) + v

    def set(self, name: str, v: Union[int, float]) -> None:
        with self._lock:
            self._acc[name] = v

    def read(self, name: str) -> Union[int, float]:
        s = self._samplers.get(name)
        if s is not None:
            return s()
        with self._lock:
            return self._acc.get(name, 0)

    def snapshot(self, skip: Optional[Callable[[str], bool]] = None
                 ) -> Dict[str, Union[int, float]]:
        """All counters at once (the aggregator_visu export). ``skip``
        filters keys BEFORE their samplers run — a sweeper that doesn't
        want a family of derived gauges (``*.hist.*``) must not pay for
        computing them."""
        out: Dict[str, Union[int, float]] = {}
        with self._lock:
            out.update(self._acc)
            samplers = dict(self._samplers)
        if skip is not None:
            for name in [n for n in out if skip(n)]:
                del out[name]
        for name, s in samplers.items():
            if skip is not None and skip(name):
                continue
            try:
                out[name] = s()
            except Exception:  # noqa: BLE001 - sampling must never break
                out[name] = float("nan")
        return out


counters = CounterRegistry()

# canonical native-lane counter names (the SDE-style export of the lane
# engagement/tracing state; see install_native_counters)
PTEXEC_POOLS_ENGAGED = "ptexec.pools_engaged"
PTDTD_TASKS_BATCHED = "ptdtd.tasks_batched"
TRACE_EVENTS_DROPPED = "trace.events_dropped"
TRACE_EVENTS_NATIVE = "trace.events_native"
PTEXEC_SLOTS_RETIRED = "ptexec.slots_retired"


def install_native_counters() -> None:
    """Register the native lanes' engagement stats, their C-side counters,
    the lane-side datarepo retire counter, and the in-lane trace
    drop/landed counters as samplers under canonical names (``ptexec.*``,
    ``ptdtd.*``, ``ptcomm.*``, ``ptdev.*``, ``ptfab.*``, ``sched.*``,
    ``capture.*``, ``costmodel.*``, ``pttel.*``, ``watchdog.*``,
    ``flight.*``, ``reconcile.*``, ``trace.*``) so
    :mod:`parsec_tpu_torch.tools.live_view`, ``/metrics`` and the
    SDE-style snapshot export see the lanes. Idempotent."""
    from ..comm import native as _cnative         # lazy: avoid import cycles
    from ..comm import pttel as _tel
    from ..core import costmodel as _cm
    from ..core import sched_plane as _sp
    from ..core import watchdog as _wd
    from ..device import native as _dnative
    from ..dsl import dtd as _dtd
    from ..dsl import fusion as _fus
    from ..dsl.ptg import compiler as _ptg
    from ..serving import fabric as _fab
    from ..serving import reconcile as _rec
    from ..tools import flight as _fl
    from . import native_trace as _nt
    from .hist import install_hist_counters

    def _sampler(stats, key):
        return lambda: stats[key]

    for stats, prefix in ((_ptg.PTEXEC_STATS, "ptexec"),
                          (_dtd.PTDTD_STATS, "ptdtd"),
                          (_cnative.PTCOMM_STATS, "ptcomm"),
                          (_dnative.PTDEV_STATS, "ptdev"),
                          (_fab.FAB_STATS, "ptfab"),
                          (_sp.SCHED_STATS, "sched"),
                          # the program cache: capture.cache_{hits,misses,
                          # evictions} — the warm-pool contract on /metrics
                          (_fus.CAPTURE_CACHE_STATS, "capture"),
                          # the online cost model: costmodel.{keys,folds,
                          # decisions,placements_diverged,...}
                          (_cm.COSTMODEL_STATS, "costmodel"),
                          # the mesh telemetry plane: pttel.{rounds,
                          # frames_tx,frames_rx,folds,...} — the O(log P)
                          # frame contract on /metrics
                          (_tel.TEL_STATS, "pttel"),
                          # the lane stall watchdog + flight recorder
                          (_wd.WATCHDOG_STATS, "watchdog"),
                          (_fl.FLIGHT_STATS, "flight"),
                          # the serving fabric's share reconciler
                          (_rec.RECONCILE_STATS, "reconcile")):
        for key in stats:
            counters.register(f"{prefix}.{key}", sampler=_sampler(stats, key))
    # the comm lane's C-side wire counters (summed across live lanes)
    for key in _cnative.COMM_COUNTER_KEYS:
        counters.register(f"ptcomm.{key}",
                          sampler=_cnative.comm_counter_sampler(key))
    # the device lane's C-side counters: dispatch/retire/overlap splits
    # from the Lane, residency/eviction/stage-in from the CohTable
    for key in _dnative.DEV_COUNTER_KEYS:
        counters.register(f"ptdev.{key}",
                          sampler=_dnative.dev_counter_sampler(key))
    for key in _dnative.COH_COUNTER_KEYS:
        counters.register(f"ptdev.{key}",
                          sampler=_dnative.coh_counter_sampler(key))
    # the scheduler plane's C-side counters (summed across live planes):
    # steals, spills, served, queued
    for key in _sp.PLANE_COUNTER_KEYS:
        counters.register(f"sched.{key}",
                          sampler=_sp.plane_counter_sampler(key))
    # the serving fabric's wire counters (credit grants/spends/reclaims
    # summed across live fabrics); ptfab.served.<tenant> registers per
    # served tenant (ServingFabric.serve)
    for name, ckey in _fab.FAB_WIRE_KEYS.items():
        counters.register(f"ptfab.{name}",
                          sampler=_fab.fab_wire_sampler(ckey))
    counters.register(TRACE_EVENTS_DROPPED, sampler=_nt.total_dropped)
    counters.register(TRACE_EVENTS_NATIVE, sampler=_nt.total_landed)
    counters.register(PTEXEC_SLOTS_RETIRED)   # accumulator: lane finalize adds
    # latency percentiles (<kind>.hist.<name>.p99_us etc.)
    install_hist_counters()


def install_scheduler_counters(context) -> None:
    """Wire the canonical scheduler counters onto a context via PINS."""
    from ..core import pins as P

    counters.register(TASKS_ENABLED)
    counters.register(TASKS_RETIRED)
    counters.register(PENDING_TASKS, sampler=lambda: (
        counters.read(TASKS_ENABLED) - counters.read(TASKS_RETIRED)))

    def on_sched(stream, tasks, extra) -> None:
        counters.add(TASKS_ENABLED, len(tasks) if isinstance(tasks, list) else 1)

    def on_complete(stream, task, extra) -> None:
        counters.add(TASKS_RETIRED, 1)

    context.pins.register(P.SCHEDULE_END, on_sched)
    context.pins.register(P.COMPLETE_EXEC_END, on_complete)
