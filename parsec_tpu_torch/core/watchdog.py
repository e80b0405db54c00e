"""Lane stall watchdog: the machine explains its own stalls.

Lane deadlocks and pin races are otherwise diagnosed by hand with
faulthandler dumps. This module makes that class of failure
self-detecting: a low-frequency monitor thread (armed by ``--mca
watchdog_stall_ms``, one tick every stall_ms/4) reads *existing*
per-lane progress counters — no new hot-path instrumentation — and
latches a stall when a lane holds work but its progress counter stops
moving for the threshold:

* **pool**: a scheduler-plane pool with ``queued + inflight > 0`` whose
  ``served`` count hasn't moved (``pool_stats`` per handle, attributed
  by pool name);
* **device**: a device lane with ``ptdev.inflight > 0`` and no retires
  (the registry's C-side samplers);
* **comm**: a comm lane (``ctx.comm.native``, once a context has one)
  whose sendq (``out_pending``) holds frames but neither ``bytes_tx`` nor
  ``acts_tx`` advances — a non-draining queue, not a busy one.

Each stall episode counts ONCE (``watchdog.{pool,comm,device}_stalls``),
degrades ``/health`` (``ok: false`` + the attributed stall list, via
:func:`health_report` — the metrics endpoint consults it per probe),
and fires exactly one attributed flight-record dump
(:mod:`parsec_tpu_torch.tools.flight`); progress resuming clears the episode
(``watchdog.clears``) and restores ``/health``. The same tick also
watches for the flight recorder's other triggers: new ``broken_peers``
(peer death), a poisoned context (pool error), and a p99 breach vs an
EWMA baseline on the native latency histograms.

An idle-but-healthy pool (queued == 0) can never trip a rule — every
rule requires held work — which is the zero-false-positive contract
the tests assert.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Any, Dict, List, Optional

from ..utils import mca, output
from ..utils.counters import LaneStats

mca.register("watchdog_stall_ms", 0,
             "Arm the lane stall watchdog: a pool/device/comm lane "
             "holding work whose progress counter does not move for "
             "this many ms counts watchdog.*_stalls, degrades /health "
             "and dumps a flight record. 0 = disabled", type=int)
mca.register("watchdog_p99_factor", 8.0,
             "Flight-record trigger: a histogram p99 exceeding this "
             "multiple of its EWMA baseline (with fresh samples in the "
             "window) dumps a post-mortem. <= 0 disables the breach "
             "trigger", type=float)

#: exported as ``watchdog.*`` by install_native_counters
WATCHDOG_STATS = LaneStats(
    ticks=0,
    pool_stalls=0,     # episodes, not ticks: one per continuous stall
    device_stalls=0,
    comm_stalls=0,
    clears=0,          # episodes that ended (progress resumed)
    degraded=0,        # gauge: lanes currently stalled (0 = healthy)
    peer_deaths=0,     # broken_peers transitions observed
    p99_breaches=0,    # EWMA-baseline p99 trips
    flight_dumps=0,    # dumps this module triggered
)

#: live watchdogs (weak): /health aggregates over them per probe
_live: "weakref.WeakSet[StallWatchdog]" = weakref.WeakSet()
_live_lock = threading.Lock()


def health_report() -> Optional[Dict[str, Any]]:
    """The /health degradation hook: None when no watchdog is armed,
    else ``{"degraded": bool, "stalls": [attributed...]}`` over every
    live watchdog in this process."""
    with _live_lock:
        dogs = list(_live)
    if not dogs:
        return None
    stalls: List[Dict[str, Any]] = []
    for d in dogs:
        stalls.extend(d.active_stalls())
    return {"degraded": bool(stalls), "stalls": stalls,
            "stall_ms": max(d.stall_ms for d in dogs)}


class _LaneWatch:
    """Progress tracker for one watched lane: holds the last progress
    value, when it last moved, and whether a stall episode is latched."""

    __slots__ = ("key", "kind", "progress", "since", "stalled")

    def __init__(self, key: str, kind: str) -> None:
        self.key = key
        self.kind = kind            # "pool" | "device" | "comm"
        self.progress: Optional[float] = None
        self.since = time.monotonic()
        self.stalled = False


class StallWatchdog:
    """One context's monitor thread. ``ctx`` is held weakly — a watchdog
    must never pin a finalized context alive."""

    def __init__(self, ctx, stall_ms: Optional[int] = None) -> None:
        self._ctx = weakref.ref(ctx)
        self.stall_ms = int(stall_ms if stall_ms is not None
                            else mca.get("watchdog_stall_ms", 0))
        self.rank = getattr(ctx, "my_rank", 0)
        if not self.rank:
            # a single-rank LOCAL context (the serving-tier shape) still
            # lives in a mesh process: attribute dumps to the process's
            # distributed rank when the telemetry plane knows it
            try:
                from ..comm.pttel import current_plane
                tel = current_plane()
                if tel is not None:
                    self.rank = tel.my_rank
            except Exception:  # noqa: BLE001 — attribution, not function
                pass
        self.interval_s = max(0.005, self.stall_ms / 1e3 / 4)
        self._watch: Dict[str, _LaneWatch] = {}
        self._mu = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._peers_broken = 0
        self._pool_error_fired = False
        self._p99_ewma: Dict[str, float] = {}
        self._p99_count: Dict[str, float] = {}
        self._p99_fired: set = set()
        try:
            from ..utils.counters import install_native_counters
            install_native_counters()
        except Exception:  # noqa: BLE001 — watch whatever is available
            pass
        with _live_lock:
            _live.add(self)

    # -------------------------------------------------------------- probes
    def active_stalls(self) -> List[Dict[str, Any]]:
        with self._mu:
            return [{"kind": w.kind, "lane": w.key,
                     "stalled_s": round(time.monotonic() - w.since, 3)}
                    for w in self._watch.values() if w.stalled]

    # --------------------------------------------------------------- rules
    def _observe(self, key: str, kind: str, held: float,
                 progress: float) -> None:
        """One lane observation: ``held`` > 0 means the lane owns work;
        ``progress`` is its monotone completion counter. A lane that
        holds work without progress past the threshold latches a stall
        episode; movement (or an emptied lane) clears it."""
        now = time.monotonic()
        with self._mu:
            w = self._watch.get(key)
            if w is None:
                w = self._watch[key] = _LaneWatch(key, kind)
        moved = w.progress is None or progress != w.progress
        w.progress = progress
        if moved or held <= 0:
            w.since = now
            if w.stalled:
                w.stalled = False
                WATCHDOG_STATS["clears"] += 1
                WATCHDOG_STATS["degraded"] = len(self.active_stalls())
                output.debug_verbose(1, "watchdog",
                                     f"{kind} lane {key} recovered")
            return
        if w.stalled or (now - w.since) * 1e3 < self.stall_ms:
            return
        w.stalled = True
        WATCHDOG_STATS[f"{kind}_stalls"] += 1
        WATCHDOG_STATS["degraded"] = len(self.active_stalls())
        detail = {"kind": kind, "lane": key, "held": held,
                  "progress": progress,
                  "stall_ms": round((now - w.since) * 1e3, 1),
                  "threshold_ms": self.stall_ms, "rank": self.rank}
        output.warning(f"watchdog: {kind} lane {key!r} stalled "
                       f"({held:g} held, no progress for "
                       f"{detail['stall_ms']:.0f}ms)")
        self._flight(f"watchdog_stall:{key}", detail)

    def _tick_pools(self, ctx) -> None:
        sp = getattr(ctx, "sched_plane", None)
        if sp is None:
            return
        with sp._lock:
            handles = dict(sp._pools)
        for h, name in handles.items():
            try:
                ps = sp.pool_stats(h)
            except Exception:  # noqa: BLE001 — freed slot mid-iteration
                continue
            if not ps.get("live"):
                continue
            self._observe(f"pool:{name}", "pool",
                          held=ps.get("queued", 0) + ps.get("inflight", 0),
                          progress=ps.get("served", 0))

    def _tick_device(self, ctx) -> None:
        lane = getattr(ctx, "_ptdev", None)
        if not lane:
            return
        try:
            s = lane.stats_cached(ttl=min(0.05, self.interval_s / 2))
        except Exception:  # noqa: BLE001 — lane mid-teardown
            return
        self._observe("ptdev", "device", held=s.get("inflight", 0),
                      progress=s.get("retired", 0))

    def _tick_comm(self, ctx) -> None:
        rde = getattr(ctx, "comm", None)
        native = getattr(rde, "native", None)
        if native is None:
            return
        try:
            s = native.comm.stats()
        except Exception:  # noqa: BLE001 — lane mid-teardown
            return
        self._observe("ptcomm", "comm", held=s.get("out_pending", 0),
                      progress=s.get("bytes_tx", 0) + s.get("acts_tx", 0))
        broken = s.get("broken_peers", 0)
        if broken > self._peers_broken:
            WATCHDOG_STATS["peer_deaths"] += broken - self._peers_broken
            self._flight(f"peer_death:{broken}",
                         {"broken_peers": broken, "rank": self.rank,
                          "comm": {k: s.get(k, 0) for k in
                                   ("out_pending", "frame_errors",
                                    "bytes_tx", "bytes_rx")}})
            self._peers_broken = broken

    def _tick_error(self, ctx) -> None:
        err = getattr(ctx, "_error", None)
        if err is not None and not self._pool_error_fired:
            self._pool_error_fired = True
            self._flight("pool_error",
                         {"error": repr(err), "rank": self.rank})

    def _tick_p99(self) -> None:
        """p99-vs-EWMA breach: per histogram, track an EWMA of p99 and a
        sample count; a p99 past ``watchdog_p99_factor`` x baseline with
        fresh samples in the window dumps once per histogram. Histograms
        that measure a backlog (``hist.BACKLOG_BOUND``) are left out."""
        factor = mca.get("watchdog_p99_factor", 8.0)
        if factor <= 0:
            return
        try:
            from ..utils.hist import BACKLOG_BOUND, histograms
            sums = histograms.summaries()
        except Exception:  # noqa: BLE001 — advisory
            return
        for name, s in sums.items():
            if name in BACKLOG_BOUND:
                continue
            p99, count = s.get("p99_us", 0.0), s.get("count", 0)
            fresh = count - self._p99_count.get(name, 0)
            self._p99_count[name] = count
            base = self._p99_ewma.get(name)
            if base is None or count < 64:
                if p99 > 0:
                    self._p99_ewma[name] = p99
                continue
            if fresh > 0 and p99 > factor * base \
                    and name not in self._p99_fired:
                self._p99_fired.add(name)
                WATCHDOG_STATS["p99_breaches"] += 1
                self._flight(f"p99_breach:{name}",
                             {"hist": name, "p99_us": p99,
                              "baseline_us": round(base, 1),
                              "factor": factor, "rank": self.rank})
            # slow EWMA: the baseline must not chase the breach
            self._p99_ewma[name] = 0.9 * base + 0.1 * p99

    def _flight(self, key: str, detail: Dict[str, Any]) -> None:
        try:
            from ..tools.flight import record
            if record(key.split(":", 1)[0], detail, key=key,
                      ctx=self._ctx()) is not None:
                WATCHDOG_STATS["flight_dumps"] += 1
        except Exception as e:  # noqa: BLE001 — the dump is best-effort
            output.debug_verbose(1, "watchdog", f"flight dump failed: {e}")

    # ----------------------------------------------------------- lifecycle
    def tick(self) -> None:
        """One monitoring pass (also callable directly from tests)."""
        ctx = self._ctx()
        if ctx is None:
            return
        WATCHDOG_STATS["ticks"] += 1
        self._tick_pools(ctx)
        self._tick_device(ctx)
        self._tick_comm(ctx)
        self._tick_error(ctx)
        self._tick_p99()

    def start(self) -> "StallWatchdog":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="parsec-watchdog")
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 — monitoring is advisory
                output.debug_verbose(1, "watchdog", f"tick failed: {e}")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        with self._mu:
            live = sum(1 for w in self._watch.values() if w.stalled)
            self._watch.clear()
        if live:
            WATCHDOG_STATS["clears"] += live
        with _live_lock:
            _live.discard(self)
        WATCHDOG_STATS["degraded"] = 0 if not _live else \
            sum(len(d.active_stalls()) for d in _live)
