"""Native device lane (ptdev): the Python half of the device plane in C.

``csrc/ptdev.cpp`` owns the device hot path — a per-device manager thread
draining a lock-free MPSC pending queue that the execution engines feed
STRAIGHT from their GIL-free release sweeps (``ptdev_iface.h``), taking the
GIL only to issue the asynchronous CUDA launches and to poll the completion
events (``torch.cuda.Event.query``, the cudaEventQuery of
device_gpu.c:2593), then landing completions back into the engines through
the GIL-free ``retire()`` entry. This module is everything around it:

* **lifecycle** — one :class:`NativeDeviceLane` per (context, device),
  created lazily the first time a CUDA-bodied pool prepares for the native
  execution lane and torn down at ``Context.fini`` (before the device
  modules and before torch's CUDA teardown);
* **streams** — the lane issues every launch on a CUDA stream of its own,
  entered explicitly (``torch.cuda.device`` and ``torch.cuda.stream``) around
  each dispatch: torch's current device and stream are per thread, and the
  manager is a thread of its own. The orderings across streams:

  - a pool's first dispatch waits on an event recorded on the stream that
    was current on the thread that added the pool, so what the caller
    queued before (filling a tile on the default stream) is complete before
    a lane body reads it. Work queued there later is not waited for;
  - stage-ins are issued on the device module's stream, the one push
    stream of the card, and a batch that read a memory input orders the
    lane stream after it (:meth:`after_push`): the module registers a staged
    copy at its version before the transfer lands, and the module's own
    readers of a copy the lane staged are behind that transfer on its
    stream;
  - each batch ends with ONE event recorded on the lane stream. A task
    retires only once its batch's event has completed, so any consumer that
    starts after retire — on any stream, or on the host — reads finished
    data;
  - a tensor the lane allocated and wrote back into a tile is marked used
    on the default stream and on the device module's stream
    (:meth:`hand_off`, ``Tensor.record_stream``), so when it is freed the
    caching allocator does not give its block to a later lane allocation
    before the readers those streams had queued have run;
* **pool routing** — the manager calls ONE ``dispatch(pool, ids)`` /
  ``poll()`` pair; this module routes them to the per-pool closures the PTG
  compiler builds (input gather from the lane's slot array,
  version-checked stage-in through the C coherency table, the body
  launches, write-backs at completion);
* **counters** — ``PTDEV_STATS`` engagement accounting, so a silent
  fall-back to the interpreted device module is a test failure, and the
  C-side lane and coherency counters as ``ptdev.*`` samplers of the
  counter registry (:func:`dev_counter_sampler`,
  :func:`coh_counter_sampler`);
* **tracing** — the lane's in-lane ring (``EV_DEV_*``) lands as
  ``ptdev-w*`` profiling streams through the context's trace bridge.

The lane is the FAST path, not the only path: ``device/cuda.py``'s
kernel_scheduler stays the interpreted route for DTD pools and any pool
the execution lane declines — but its residency/eviction POLICY also
lives in the C coherency table (``CohTable``) when the lane's module is
on, so both paths share one view of what is resident at which version.
On a CPU context in test mode (``--mca device_cuda_over_cpu 1``) the lane
has no stream and a completed event stands in for each batch's.
"""

from __future__ import annotations

import atexit
import contextlib
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .. import native as _native
from ..core.task import DEV_CUDA
from ..utils import mca, output
from ..utils.counters import LaneStats
from .cuda import _DONE

mca.register("device_native", True,
             "Drive CUDA-bodied native-lane pools through the native "
             "device lane (csrc/ptdev.cpp): per-device async dispatch "
             "queues, event-based retirement into the engines, C-side "
             "coherency/zone accounting. 0 keeps the interpreted device "
             "module (counted ineligible)", type=bool)
mca.register("device_native_poll_us", 100,
             "Manager-thread completion poll cadence while device work "
             "is in flight (microseconds)", type=int)

#: lane engagement accounting: ``pools_engaged``/``tasks_engaged`` prove
#: the lane carried device bodies; ``pools_ineligible`` counts by-design
#: declines (``--mca device_native 0``); ``pools_fallback`` counts eligible
#: pools that still declined — the silent-regression signal the card run
#: asserts is zero
PTDEV_STATS = LaneStats(lanes_up=0, pools_engaged=0, tasks_engaged=0,
                        pools_fallback=0, pools_ineligible=0)

#: live lanes, for the exit net below and the ``ptdev.*`` samplers
_lanes: "weakref.WeakSet[NativeDeviceLane]" = weakref.WeakSet()


def _stop_abandoned_lanes() -> None:
    """atexit net: a lane whose context never fini'd must stop its manager
    thread BEFORE interpreter teardown — a C thread blocked in
    PyGILState_Ensure during finalization would hang the exit join."""
    for lane in list(_lanes):
        try:
            lane.clane.stop()
        except Exception:  # noqa: BLE001 — already down
            pass


atexit.register(_stop_abandoned_lanes)

#: C-side counters exported into the counter registry (ptdev.<name>): the
#: lane half comes from Lane.stats(), the coherency half from the bound
#: device's CohTable.stats()
DEV_COUNTER_KEYS = ("submitted", "dispatched", "retired",
                    "dispatch_batches", "overlap_hits", "late_submits",
                    "late_retires", "cb_errors", "inflight")
COH_COUNTER_KEYS = ("evictions", "pinned_skips", "coh_hits", "coh_misses",
                    "stage_in_bytes", "stage_out_bytes", "resident_bytes")


def dev_counter_sampler(key: str):
    """Sampler summing one C-side counter across every live lane (TTL-
    cached snapshot: one stats() call per lane per registry sweep)."""
    def sample():
        total = 0
        for lane in list(_lanes):
            try:
                total += lane.stats_cached()[key]
            except Exception:  # noqa: BLE001 - a torn-down lane samples 0
                pass
        return total
    return sample


def coh_counter_sampler(key: str):
    """Sampler summing one coherency-table counter across every device
    table attached to a live lane's device."""
    def sample():
        total = 0
        for lane in list(_lanes):
            try:
                st = lane.coh_stats_cached()
                if st is not None:
                    total += st[key]
            except Exception:  # noqa: BLE001
                pass
        return total
    return sample


def make_coh_table(budget: int):
    """A C-side coherency/residency table, or None when ``--mca
    device_native 0`` or ``--mca native_enabled 0`` (the Python LRU is the
    policy then). A failed build of the module raises."""
    if not mca.get("device_native", True):
        return None
    mod = _native.load_ptdev()
    return None if mod is None else mod.CohTable(int(budget))


class _PoolState:
    """One bound pool's dispatch/poll/observe closures (built by the
    compiler), the event its first dispatch waits on and its dispatched,
    not yet retired tasks."""

    __slots__ = ("dispatch", "poll", "observe", "engine", "start",
                 "outstanding")

    def __init__(self, dispatch: Callable, poll: Callable,
                 observe: Optional[Callable], engine, start) -> None:
        self.dispatch = dispatch
        self.poll = poll
        self.observe = observe
        self.engine = engine
        self.start = start
        self.outstanding = 0


class NativeDeviceLane:
    """One (context, device) native device lane: the C ``Lane`` object, the
    lane's CUDA stream, pool routing and lifecycle."""

    @staticmethod
    def available(ctx) -> Optional[str]:
        """None when the lane can engage, else the reason it cannot."""
        if not mca.get("device_native", True):
            return "disabled by --mca device_native 0"
        if not ctx.devices.by_type(DEV_CUDA):
            return "no CUDA device registered"
        if _native.load_ptdev() is None:
            return "native modules off (--mca native_enabled 0)"
        return None

    @classmethod
    def maybe_create(cls, ctx) -> Optional["NativeDeviceLane"]:
        reason = cls.available(ctx)
        if reason is not None:
            output.debug_verbose(2, "ptdev",
                                 f"device lane not engaged: {reason}")
            return None
        return cls(ctx, ctx.devices.by_type(DEV_CUDA)[0])

    def __init__(self, ctx, device) -> None:
        self.ctx = ctx
        self.device = device          # the CUDADevice whose card we drive
        tdev = device.torch_device
        self.on_card = tdev.type == "cuda"
        #: the stream every lane launch is issued on (None: test mode)
        self.stream = torch.cuda.Stream(tdev) if self.on_card else None
        #: the streams that read what the lane writes back (hand_off)
        self._consumers = (torch.cuda.default_stream(tdev),
                           device.stream) if self.on_card else ()
        #: cost-model keys of the classes some pool has dispatched task by
        #: task on this lane (the first such pool of a class is cold and
        #: left unobserved); the manager thread alone touches it
        self.warm_keys: set = set()
        #: the cost clock: the last retire sweep, or the moment the lane
        #: went from idle to busy (see _poll)
        self._clock = 0
        self.clane = _native.load_ptdev().Lane()
        self._pools: Dict[int, _PoolState] = {}
        self._next_pool = 1
        self._stats_cache: Tuple[float, Optional[dict]] = (0.0, None)
        self._coh_cache: Tuple[float, Optional[dict]] = (0.0, None)
        self.clane.start(self._dispatch, self._poll,
                         mca.get("device_native_poll_us", 100))
        self._up = True
        PTDEV_STATS["lanes_up"] += 1
        _lanes.add(self)
        # in-lane ring events (EV_DEV_*) land as `ptdev-w*` profiling
        # streams through the same bridge as the execution lanes
        ctx._ntrace_attach("ptdev", self.clane)
        ctx._hist_attach("ptdev", self.clane)
        output.debug_verbose(1, "ptdev",
                             f"native device lane up on {device.name}")

    # --------------------------------------------------------- pool routing
    def bind_pool(self, engine, dispatch: Callable, poll: Callable,
                  observe: Optional[Callable] = None) -> int:
        """Route a pool's device tasks: ``engine`` provides the GIL-free
        retire entry (dev_retire_capsule); ``dispatch(ids)`` issues the
        async device work; ``poll()`` returns the completed tids whose
        outputs have landed and their (cost key, task weight) pairs;
        ``observe(pairs, per)`` takes the pool's share of a retire sweep's
        window. Returns the lane-local pool id to pass to the engine's
        ``dev_bind``."""
        pid = self._next_pool
        self._next_pool += 1
        start = None
        if self.stream is not None:
            # what the binding thread queued before this pool (a tile filled
            # on its current stream) precedes the pool's first launch
            start = torch.cuda.Event()
            start.record(torch.cuda.current_stream(self.device.torch_device))
        self.clane.bind_pool(pid, engine.dev_retire_capsule(), engine)
        self._pools[pid] = _PoolState(dispatch, poll, observe, engine,
                                      start)
        return pid

    def unbind_pool(self, pool_id: int) -> None:
        self._pools.pop(pool_id, None)
        try:
            self.clane.unbind_pool(pool_id)
        except Exception:  # noqa: BLE001 — teardown races are benign
            pass

    def submit_capsule(self):
        return self.clane.submit_capsule()

    def failed(self) -> Optional[str]:
        """The message of the callback exception that poisoned the lane,
        or None. Drain loops surface it as the pool's error."""
        return self.clane.failed()

    def batch_event(self):
        """The completion event of the dispatch batch just issued: one
        ``torch.cuda.Event`` recorded on the lane stream (a completed
        stand-in without a stream)."""
        if self.stream is None:
            return _DONE
        ev = torch.cuda.Event()
        ev.record(self.stream)
        return ev

    def after_push(self) -> None:
        """Order the lane stream after the device module's stream, where
        the batch's stage-ins were issued (called between a batch's push
        and exec phases when it read a memory input)."""
        if self.stream is not None:
            self.stream.wait_stream(self.device.stream)

    def hand_off(self, t) -> None:
        """``t``, allocated on the lane stream, leaves the lane (a tile's
        write-back): mark it used on the streams that read tiles, so the
        caching allocator does not reuse its block before their queued
        readers have run."""
        if self._consumers and isinstance(t, torch.Tensor) and t.is_cuda:
            for s in self._consumers:
                t.record_stream(s)

    def _on_stream(self, st: _PoolState):
        """Enter the lane's device and stream on the calling (manager)
        thread; a pool's first dispatch waits on its start event."""
        if self.stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.device.torch_device))
        stack.enter_context(torch.cuda.stream(self.stream))
        if st.start is not None:
            self.stream.wait_event(st.start)
            st.start = None
        return stack

    # ------------------------------------------------ manager-thread hooks
    # Both run ON the manager thread with the GIL held; self._pools is only
    # mutated under the GIL (bind/unbind), so plain dict ops are safe. A
    # pool unbound between submit and dispatch just drops its ids here (the
    # C side counts unrouted retires as late_retires).
    def _dispatch(self, pool: int, ids: List[int]) -> int:
        st = self._pools.get(pool)
        if st is None:
            return 0
        if not any(p.outstanding for p in self._pools.values()):
            # idle -> busy: restart the cost clock, so idle gaps between
            # batches never land in any task's cost
            self._clock = time.perf_counter_ns()
        with self._on_stream(st):
            n = st.dispatch(ids)
        st.outstanding += n
        return n

    def _poll(self):
        done, swept = [], []
        for pid, st in list(self._pools.items()):
            tids, retired = st.poll()
            st.outstanding -= len(tids)
            for tid in tids:
                done.append((pid, tid))
            if retired:
                swept.append((st, retired))
        if swept:
            # batch amortization across the LANE, the semantics of the C
            # lane's exec bump: the wall window since the last sweep (or
            # the idle -> busy mark) divides across every task weight this
            # sweep retired, whichever pool it belongs to. A clock per pool
            # would bill the same window to each of several pools running
            # together, and a pool's dispatch -> retire spans overlap under
            # pipelining, so summing them would bill it several times over
            now = time.perf_counter_ns()
            total = sum(w for _st, r in swept for _k, w in r)
            per = (now - self._clock) / max(total, 1)
            for st, retired in swept:
                if st.observe is not None:
                    st.observe(retired, per)
            self._clock = now
        return done

    # ------------------------------------------------------------ counters
    def stats_cached(self, ttl: float = 0.05) -> Dict[str, Any]:
        now = time.monotonic()
        stamp, snap = self._stats_cache
        if snap is None or now - stamp > ttl:
            snap = self.clane.stats()
            self._stats_cache = (now, snap)
        return snap

    def coh_stats_cached(self, ttl: float = 0.05) -> Optional[Dict[str, Any]]:
        tbl = getattr(self.device, "_ncoh", None)
        if tbl is None:
            return None
        now = time.monotonic()
        stamp, snap = self._coh_cache
        if snap is None or now - stamp > ttl:
            snap = tbl.stats()
            self._coh_cache = (now, snap)
        return snap

    # ------------------------------------------------------------ teardown
    def fini(self) -> None:
        if not self._up:
            return
        self._up = False
        # bounded wait for in-flight dispatches to retire: stopping with
        # work on the card would strand the owning graphs undone. A
        # poisoned lane or one with no bound pools left can never drain
        # what remains (an unbound pool's completions are uncollectable by
        # design) — break at once instead of stalling every error-path
        # teardown for the full deadline
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if self.clane.failed() is not None or not self._pools:
                break
            s = self.clane.stats()
            if s["inflight"] == 0 and s["submitted"] == s["dispatched"] \
                    + s["late_submits"]:
                break
            time.sleep(1e-3)
        # land the lane's last ring events and fold its buckets before the
        # manager stops
        self.ctx._ntrace_detach(self.clane)
        self.ctx._hist_detach(self.clane)
        self.clane.stop()
        _lanes.discard(self)        # the samplers sum live lanes only
        for pid in list(self._pools):
            self.unbind_pool(pid)
        if self.stream is not None:
            self.stream.synchronize()
        output.debug_verbose(1, "ptdev",
                             f"native device lane down on "
                             f"{self.device.name}: {self.clane.stats()}")
