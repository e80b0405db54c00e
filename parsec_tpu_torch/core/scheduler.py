"""Pluggable ready-queue scheduling modules.

Re-design of parsec/mca/sched (module interface: parsec/mca/sched/sched.h:210-335).
A scheduler module provides ``install / flow_init / schedule / select / remove``;
``schedule`` receives a *distance* hint conveying steal/locality distance exactly
as in the reference. The module is selected at runtime through the MCA parameter
``sched`` (ref: parsec_set_scheduler, parsec/scheduling.c:249-275).

Module set mirrors the reference's (parsec/mca/sched/*):

=========  =====================================================================
``lfq``    local flat queues + hierarchical bounded buffers + work stealing
           (default, priority 20; ref: sched_lfq_component.c:73)
``gd``     single global dequeue (sched_gd)
``ltq``    local tree queues (approximated: local heaps, subtree-biased steal)
``lhq``    local hierarchical queues
``ap``     absolute priority: one global priority heap (sched_ap)
``pbq``    priority-based local queues + steal (sched_pbq)
``ip``     inverse priority (sched_ip)
``ll``     local LIFO + steal (sched_ll)
``llp``    local LIFO with priorities (sched_llp)
``rnd``    random global queue (sched_rnd)
``spq``    shared priority queue (sched_spq)
=========  =====================================================================

On the GPU the scheduler's job is mostly *dispatch ordering*: bodies are issued
asynchronously to the device stream, so queue policy governs pipeline depth and
data locality (which tiles stay resident in device memory), not CPU load
balance.
"""

from __future__ import annotations

import bisect
import operator
import heapq
import itertools
import random
import sys
import threading
import weakref
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

from ..utils import mca, output
from .task import Task

mca.register("sched", "lfq", "Scheduler module (lfq|gd|ltq|lhq|ap|pbq|ip|ll|llp|rnd|spq)")


class SchedulerModule:
    """Module interface (ref: parsec/mca/sched/sched.h:210-335)."""

    name = "base"
    priority = 0  # component selection priority, highest wins

    #: native arbitration flavor of this policy on the scheduler plane
    #: (csrc/ptsched.h): "wdrr" | "fifo" | "prio" | "rndsteal", or None
    #: when the policy has no native analogue — the plane then declines
    #: (counted in SCHED_STATS["policy_fallback"]) and every engine keeps
    #: its private ready structure, so ``--mca sched <name>`` selects
    #: ordering uniformly across the interpreted and native paths
    native_policy: Optional[str] = None

    def install(self, context) -> None:
        self.context = context
        self._register_py_counters()

    def stats_global(self) -> Dict[str, int]:
        """Module-WIDE queue depths (not per-stream): the ``sched.py.*``
        registry export, so interpreted and native runs publish the same
        shape of scheduler observability (``sched.queued`` vs
        ``sched.py.queued``)."""
        return {}

    def _register_py_counters(self) -> None:
        """Route this module through the counter registry as
        ``sched.py.*`` (weakly bound: a finished context's module must not
        be pinned by the process-wide registry; the latest installed
        module wins the name, matching the one-live-context norm)."""
        from ..utils.counters import counters
        ref = weakref.ref(self)

        def _mk(key):
            def sample():
                m = ref()
                if m is None:
                    return 0
                try:
                    return m.stats_global().get(key, 0)
                except Exception:  # noqa: BLE001 — sampling never breaks
                    return 0
            return sample

        for key in ("queued", "local_len", "system_len"):
            counters.register(f"sched.py.{key}", sampler=_mk(key))

    def flow_init(self, stream) -> None:
        """Per-execution-stream initialization (ref: flow_init + barrier)."""

    def schedule(self, stream, tasks: Iterable[Task], distance: int = 0) -> None:
        raise NotImplementedError

    def select(self, stream) -> Tuple[Optional[Task], int]:
        """Return (task, distance-it-came-from) or (None, 0)."""
        raise NotImplementedError

    def select_burst(self, stream, n: int) -> List[Task]:
        """Pop up to ``n`` tasks in policy order. Default: loop select().
        Queue-backed modules override with a single-lock bulk pop — the
        per-call overhead an interpreted hot loop cannot amortize one task
        at a time."""
        out = []
        for _ in range(n):
            t, _d = self.select(stream)
            if t is None:
                break
            out.append(t)
        return out

    def stats(self, stream) -> Dict[str, int]:
        return {}

    def has_local_work(self, stream) -> bool:
        """Cheap peek: does this stream see queued tasks without popping?
        The native execution lane (core/context.py:_ptexec_drain) sizes
        its bursts by this — a live lane must interleave with, not starve,
        taskpools riding the ordinary queues. False negatives only cost
        one long burst; the default is safe for modules without queues."""
        return False

    def remove(self, context) -> None:
        pass


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

class _LockedDeque:
    """Thread-safe dequeue with NO explicit lock: every operation is a
    single collections.deque call, which CPython guarantees atomic under
    the GIL (append/extend/popleft/pop). Emptiness is handled by catching
    IndexError instead of check-then-act — the name is kept for its role
    (the reference's parsec_dequeue, which does lock). On free-threaded
    interpreters the module swaps in :class:`_ExplicitLockedDeque` below."""

    __slots__ = ("dq",)

    def __init__(self) -> None:
        self.dq: deque = deque()

    def push_front(self, items) -> None:
        self.dq.extendleft(reversed(items))

    def push_back(self, items) -> None:
        self.dq.extend(items)

    def pop_front(self):
        try:
            return self.dq.popleft()
        except IndexError:
            return None

    def pop_back(self):
        try:
            return self.dq.pop()
        except IndexError:
            return None

    def __len__(self) -> int:
        return len(self.dq)


class _ExplicitLockedDeque:
    """Lock-based deque with the same surface as :class:`_LockedDeque`, for
    free-threaded CPython (PEP 703, 3.13t+) where the GIL atomicity the
    no-lock variant relies on is gone."""

    __slots__ = ("dq", "lock")

    def __init__(self) -> None:
        self.dq: deque = deque()
        self.lock = threading.Lock()

    def push_front(self, items) -> None:
        with self.lock:
            self.dq.extendleft(reversed(items))

    def push_back(self, items) -> None:
        with self.lock:
            self.dq.extend(items)

    def pop_front(self):
        with self.lock:
            try:
                return self.dq.popleft()
            except IndexError:
                return None

    def pop_back(self):
        with self.lock:
            try:
                return self.dq.pop()
            except IndexError:
                return None

    def __len__(self) -> int:
        return len(self.dq)


# checked once at import — the interpreter cannot change GIL mode mid-process
if not getattr(sys, "_is_gil_enabled", lambda: True)():  # pragma: no cover
    _LockedDeque = _ExplicitLockedDeque  # noqa: F811


class _LockedHeap:
    """Priority heap; highest priority pops first (ties FIFO)."""

    __slots__ = ("heap", "lock", "_ctr")

    def __init__(self) -> None:
        self.heap: List = []
        self.lock = threading.Lock()
        self._ctr = itertools.count()

    def push(self, task: Task, sign: int = -1, tie_lifo: bool = False) -> None:
        with self.lock:
            # counter drawn under the lock: acquisition order == insertion
            # order, so the FIFO/LIFO tiebreak among equal priorities holds
            ctr = next(self._ctr)
            heapq.heappush(self.heap,
                           (sign * task.priority,
                            -ctr if tie_lifo else ctr, task))

    def pop(self) -> Optional[Task]:
        with self.lock:
            if not self.heap:
                return None
            return heapq.heappop(self.heap)[2]

    def __len__(self) -> int:
        return len(self.heap)


_PRIO_KEY = operator.attrgetter("priority")


class _HBBuffer:
    """Hierarchical bounded buffer (redesign of parsec/hbbuffer.c:1-278):
    fixed capacity; overflow spills through ``parent_push`` (another buffer
    or the system dequeue); ``pop_best`` removes the highest-priority
    element, ``pop_any`` the coldest (steal end).

    Ordering is LAZY: pushes only mark the buffer dirty and the sort runs
    at the next pop — bulk producers (the DTD ready batch) would otherwise
    pay a full re-sort per push. Timsort makes the all-equal-priority case
    (the common one) a single O(n) scan."""

    __slots__ = ("cap", "items", "lock", "parent_push", "_dirty")

    def __init__(self, cap: int, parent_push) -> None:
        self.cap = max(1, cap)
        self.items: List[Task] = []     # ascending priority; best at the end
        self.lock = threading.Lock()
        self.parent_push = parent_push
        self._dirty = False

    def _ensure_sorted(self) -> None:   # call with self.lock held
        if self._dirty:
            self.items.sort(key=_PRIO_KEY)
            self._dirty = False

    def push(self, tasks: List[Task]) -> None:
        """Fill to capacity, spill the rest upward (hbbuffer_push_all)."""
        with self.lock:
            room = self.cap - len(self.items)
            take, spill = tasks[:room], tasks[room:]
            if take:
                self.items.extend(take)
                self._dirty = True
        if spill:
            self.parent_push(spill)

    def push_by_priority(self, tasks: List[Task]) -> None:
        """Merge then spill the LOWEST-priority overflow upward
        (hbbuffer_push_all_by_priority): hot tasks stay local."""
        with self.lock:
            self.items.extend(tasks)
            self.items.sort(key=_PRIO_KEY)
            self._dirty = False
            nspill = len(self.items) - self.cap
            spill, self.items = (self.items[:nspill], self.items[nspill:]) \
                if nspill > 0 else ([], self.items)
        if spill:
            self.parent_push(spill)

    def pop_best(self) -> Optional[Task]:
        with self.lock:
            if not self.items:
                return None
            self._ensure_sorted()
            return self.items.pop()

    def pop_best_burst(self, n: int) -> List[Task]:
        """Up to ``n`` highest-priority items, one lock."""
        with self.lock:
            items = self.items
            k = min(n, len(items))
            if not k:
                return []
            self._ensure_sorted()
            batch = items[-k:]
            del items[-k:]
        batch.reverse()          # best first
        return batch

    def pop_any(self) -> Optional[Task]:
        with self.lock:
            if not self.items:
                return None
            self._ensure_sorted()
            return self.items.pop(0)

    def __len__(self) -> int:
        return len(self.items)


class _LocalQueuesBase(SchedulerModule):
    """Shared plumbing for the local-queues family: per-stream structures,
    a shared system dequeue, and the distance-ordered steal walk
    (ref: parsec/mca/sched/sched_local_queues_utils.h)."""

    def install(self, context) -> None:
        super().install(context)
        self._queues: Dict[int, object] = {}
        self._order: List[int] = []
        self._system = _LockedDeque()
        self._init_lock = threading.Lock()
        self._steal_cache: Dict[int, List[int]] = {}

    def _system_push(self, tasks: List[Task]) -> None:
        self._system.push_back(tasks)

    def _local(self, stream):
        return self._queues[stream.th_id]

    def _steal_order(self, stream) -> List[int]:
        """Victims by increasing topological distance: ring order, same
        virtual process (NUMA-ish group) first — the hwloc-distance walk of
        flow_*_init (sched_lfq_module.c / sched.h:210-335). Computed once
        per stream (the stream set is fixed after Context init) — this
        runs on every idle-spin select()."""
        me = stream.th_id
        cached = self._steal_cache.get(me)
        if cached is not None and len(cached) == len(self._order) - 1:
            return cached
        n = len(self._order)
        if n <= 1:
            return []
        start = self._order.index(me) if me in self._order else 0
        order = [self._order[(start + d) % n] for d in range(1, n)]
        my_vp = getattr(stream, "vp_id", 0)
        # sort victims by (same-VP first, NUMA core distance, ring order —
        # the stable sort preserves ring position as the final tiebreak):
        # the hwloc-distance steal walk of the reference's flow_init
        vmap = getattr(self.context, "vpmap", None)
        if vmap is not None:
            from .vpmap import core_distance_fn
            dist = core_distance_fn()
            my_core = vmap.core_of(me)
            order.sort(key=lambda tid: (
                0 if self.context.streams[tid].vp_id == my_vp else 1,
                dist(my_core, vmap.core_of(tid))))
        else:
            order.sort(key=lambda tid: 0 if
                       self.context.streams[tid].vp_id == my_vp else 1)
        self._steal_cache[me] = order
        return order

    def stats(self, stream):
        return {"local_len": len(self._local(stream)),
                "system_len": len(self._system)}

    def stats_global(self):
        local = sum(len(q) for q in self._queues.values())
        system = len(self._system)
        return {"queued": local + system, "local_len": local,
                "system_len": system}

    def has_local_work(self, stream) -> bool:
        return bool(len(self._local(stream)) or len(self._system))


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class SchedLFQ(_LocalQueuesBase):
    """Local flat queues (default): per-stream bounded buffer (cap 4·ncores)
    spilling straight to the shared system dequeue; distance-ordered steal
    (ref: parsec/mca/sched/lfq/sched_lfq_module.c:73, hbbuffer.c)."""
    name = "lfq"
    native_policy = "wdrr"
    priority = 20

    def flow_init(self, stream) -> None:
        # bounded per-stream buffers exist to keep work stealable: with ONE
        # stream there is nobody to steal, so spilling to the system deque
        # (and walking the empty steal order on every select) is pure cost
        # — the local buffer absorbs everything
        ns = len(self.context.streams)
        cap = 4 * ns if ns > 1 else (1 << 30)
        with self._init_lock:
            self._queues[stream.th_id] = _HBBuffer(cap, self._system_push)
            self._order.append(stream.th_id)

    def schedule(self, stream, tasks, distance: int = 0) -> None:
        tasks = list(tasks)
        if not tasks:
            return
        if distance == 0:
            self._local(stream).push(tasks)
        else:                       # pushed away from the hot end
            self._system.push_back(tasks)

    def select(self, stream):
        t = self._local(stream).pop_best()
        if t is not None:
            return t, 0
        for d, tid in enumerate(self._steal_order(stream), start=1):
            t = self._queues[tid].pop_any()
            if t is not None:
                return t, d
        return self._system.pop_front(), len(self._order)

    def select_burst(self, stream, n: int):
        batch = self._local(stream).pop_best_burst(n)
        if batch:
            return batch
        return super().select_burst(stream, n)   # steal/system path


class SchedPBQ(_LocalQueuesBase):
    """Priority-based local bounded queues: like lfq but the buffer keeps
    priority order on every push and spills its LOWEST-priority tasks to
    the system queue — hot work never leaves the owning stream
    (ref: sched_pbq, hbbuffer_push_all_by_priority)."""
    name = "pbq"
    native_policy = "prio"

    flow_init = SchedLFQ.flow_init

    def schedule(self, stream, tasks, distance: int = 0) -> None:
        tasks = list(tasks)
        if not tasks:
            return
        if distance == 0:
            self._local(stream).push_by_priority(tasks)
        else:
            self._system.push_back(tasks)

    select = SchedLFQ.select


class SchedLHQ(_LocalQueuesBase):
    """Local hierarchical queues: stream buffer -> shared per-VP buffer ->
    system dequeue; overflow climbs the hierarchy level by level and select
    walks it back down before crossing to other VPs
    (ref: sched_lhq_module.c, nested hbbuffers per hwloc level)."""
    name = "lhq"
    native_policy = "wdrr"

    def install(self, context) -> None:
        super().install(context)
        self._vp_queues: Dict[int, _HBBuffer] = {}

    def flow_init(self, stream) -> None:
        vp = getattr(stream, "vp_id", 0)
        with self._init_lock:
            vq = self._vp_queues.get(vp)
            if vq is None:
                nvp_cores = max(1, sum(
                    1 for s in self.context.streams if s.vp_id == vp))
                vq = _HBBuffer(max(96 // nvp_cores, nvp_cores),
                               self._system_push)
                self._vp_queues[vp] = vq
            self._queues[stream.th_id] = _HBBuffer(
                4 * max(1, len(self.context.streams)), vq.push)
            self._order.append(stream.th_id)

    def schedule(self, stream, tasks, distance: int = 0) -> None:
        tasks = list(tasks)
        if not tasks:
            return
        if distance == 0:
            self._local(stream).push(tasks)
        elif distance == 1:
            self._vp_queues[getattr(stream, "vp_id", 0)].push(tasks)
        else:
            self._system.push_back(tasks)

    def select(self, stream):
        t = self._local(stream).pop_best()
        if t is not None:
            return t, 0
        my_vp = getattr(stream, "vp_id", 0)
        t = self._vp_queues[my_vp].pop_best()
        if t is not None:
            return t, 1
        d = 1
        for tid in self._steal_order(stream):
            if self.context.streams[tid].vp_id == my_vp:
                d += 1
                t = self._queues[tid].pop_any()
                if t is not None:
                    return t, d
        for vp, vq in self._vp_queues.items():
            if vp != my_vp:
                d += 1
                t = vq.pop_any()
                if t is not None:
                    return t, d
        for tid in self._steal_order(stream):
            if self.context.streams[tid].vp_id != my_vp:
                d += 1
                t = self._queues[tid].pop_any()
                if t is not None:
                    return t, d
        return self._system.pop_front(), d + 1

    def stats(self, stream):
        s = super().stats(stream)
        s["vp_len"] = len(self._vp_queues.get(getattr(stream, "vp_id", 0), ()))
        return s


class _TaskHeap:
    """A group of related ready tasks as one schedulable unit, ordered by
    priority (redesign of parsec_heap_t, parsec/maxheap.c:1-385)."""

    __slots__ = ("heap", "_ctr")

    def __init__(self, tasks: List[Task]) -> None:
        self._ctr = itertools.count()
        self.heap = [(-t.priority, next(self._ctr), t) for t in tasks]
        heapq.heapify(self.heap)

    @property
    def top_priority(self) -> int:
        return -self.heap[0][0] if self.heap else -(1 << 62)

    def pop(self) -> Optional[Task]:
        return heapq.heappop(self.heap)[2] if self.heap else None

    def split(self) -> Optional["_TaskHeap"]:
        """Give away about half the tasks (heap_split_and_steal): the thief
        walks off with a subtree, keeping sibling groups together."""
        if len(self.heap) < 2:
            return None
        self.heap.sort()
        mine, theirs = self.heap[::2], self.heap[1::2]
        self.heap = mine
        heapq.heapify(self.heap)
        other = _TaskHeap([])
        other.heap = theirs
        heapq.heapify(other.heap)
        return other

    def __len__(self) -> int:
        return len(self.heap)


class SchedLTQ(_LocalQueuesBase):
    """Local tree queues: every schedule() call becomes ONE heap of tasks;
    streams pop the top of their best heap and keep the rest; a steal takes
    the victim's best heap and SPLITS it, carrying half home — related
    tasks migrate together (ref: sched_ltq_module.c + maxheap.c)."""
    name = "ltq"
    native_policy = "prio"

    def flow_init(self, stream) -> None:
        with self._init_lock:
            self._queues[stream.th_id] = _LockedHeapList()
            self._order.append(stream.th_id)

    def schedule(self, stream, tasks, distance: int = 0) -> None:
        tasks = list(tasks)
        if not tasks:
            return
        self._local(stream).add(_TaskHeap(tasks))

    def select(self, stream):
        own: _LockedHeapList = self._local(stream)
        t = own.pop_task()
        if t is not None:
            return t, 0
        for d, tid in enumerate(self._steal_order(stream), start=1):
            victim: _LockedHeapList = self._queues[tid]
            stolen = victim.steal_half()
            if stolen is not None:
                t = stolen.pop()
                if len(stolen):
                    own.add(stolen)
                if t is not None:
                    return t, d
        return None, 0

    def stats(self, stream):
        q = self._local(stream)
        return {"local_heaps": len(q.heaps),
                "local_len": sum(len(h) for h in q.heaps)}


class _LockedHeapList:
    """Per-stream list of _TaskHeaps (the hbbuffer-of-heaps of ltq)."""

    __slots__ = ("heaps", "lock")

    def __init__(self) -> None:
        self.heaps: List[_TaskHeap] = []
        self.lock = threading.Lock()

    def add(self, h: _TaskHeap) -> None:
        with self.lock:
            self.heaps.append(h)

    def pop_task(self) -> Optional[Task]:
        with self.lock:
            if not self.heaps:
                return None
            best = max(range(len(self.heaps)),
                       key=lambda i: self.heaps[i].top_priority)
            h = self.heaps[best]
            t = h.pop()
            if not len(h):
                self.heaps.pop(best)
            return t

    def steal_half(self) -> Optional[_TaskHeap]:
        with self.lock:
            if not self.heaps:
                return None
            best = max(range(len(self.heaps)),
                       key=lambda i: self.heaps[i].top_priority)
            h = self.heaps[best]
            half = h.split()
            if half is not None:
                return half
            return self.heaps.pop(best)   # singleton: take it whole

    def __len__(self) -> int:
        return len(self.heaps)


class SchedLL(_LocalQueuesBase):
    """Local LIFO: push and pop the same end (depth-first), steal the other
    (ref: sched_ll)."""
    name = "ll"
    native_policy = "fifo"

    def flow_init(self, stream) -> None:
        with self._init_lock:
            self._queues[stream.th_id] = _LockedDeque()
            self._order.append(stream.th_id)

    def schedule(self, stream, tasks, distance: int = 0) -> None:
        tasks = list(tasks)
        if tasks:
            self._local(stream).push_front(tasks)

    def select(self, stream):
        t = self._local(stream).pop_front()
        if t is not None:
            return t, 0
        for d, tid in enumerate(self._steal_order(stream), start=1):
            t = self._queues[tid].pop_back()
            if t is not None:
                return t, d
        return None, 0


class SchedLLP(_LocalQueuesBase):
    """Local LIFO with priorities: an UNBOUNDED per-stream list kept in
    priority order (LIFO among equals — latest insert at the head of its
    priority class); no system queue; thieves take from the cold end
    (ref: sched_llp, parsec_lifo_with_prio)."""
    name = "llp"
    native_policy = "prio"

    def flow_init(self, stream) -> None:
        with self._init_lock:
            self._queues[stream.th_id] = _PrioLIFO()
            self._order.append(stream.th_id)

    def schedule(self, stream, tasks, distance: int = 0) -> None:
        tasks = list(tasks)
        if tasks:
            self._local(stream).push(tasks)

    def select(self, stream):
        t = self._local(stream).pop_head()
        if t is not None:
            return t, 0
        for d, tid in enumerate(self._steal_order(stream), start=1):
            t = self._queues[tid].pop_tail()
            if t is not None:
                return t, d
        return None, 0


class _PrioLIFO:
    """Priority-ordered LIFO (redesign of parsec_lifo_with_prio): head =
    highest priority, newest first within a priority class."""

    __slots__ = ("items", "lock")

    def __init__(self) -> None:
        self.items: List[Task] = []   # descending priority
        self.lock = threading.Lock()

    def push(self, tasks: List[Task]) -> None:
        with self.lock:
            keys = [-t.priority for t in self.items]
            for t in tasks:
                i = bisect.bisect_left(keys, -t.priority)
                self.items.insert(i, t)
                keys.insert(i, -t.priority)

    def pop_head(self) -> Optional[Task]:
        with self.lock:
            return self.items.pop(0) if self.items else None

    def pop_tail(self) -> Optional[Task]:
        with self.lock:
            return self.items.pop() if self.items else None

    def __len__(self) -> int:
        return len(self.items)


class _GlobalBase(SchedulerModule):
    def install(self, context) -> None:
        super().install(context)
        self._q = _LockedDeque()

    def flow_init(self, stream) -> None:
        pass

    def stats_global(self):
        return {"queued": len(self._q)}

    def has_local_work(self, stream) -> bool:
        return len(self._q) > 0


class SchedGD(_GlobalBase):
    """Global dequeue (ref: sched_gd)."""
    name = "gd"
    native_policy = "fifo"

    def schedule(self, stream, tasks, distance: int = 0) -> None:
        tasks = list(tasks)
        if not tasks:
            return
        if distance == 0:
            self._q.push_front(tasks)
        else:
            self._q.push_back(tasks)

    def select(self, stream):
        return self._q.pop_front(), 0


class SchedRND(_GlobalBase):
    """Random order global queue (ref: sched_rnd)."""
    name = "rnd"
    native_policy = "rndsteal"

    def install(self, context) -> None:
        super().install(context)
        self._rng = random.Random(0xC0FFEE)
        # random-position inserts are compound ops; _LockedDeque itself is
        # lock-free (single GIL-atomic calls), so this module keeps its own
        self._rnd_lock = threading.Lock()

    def schedule(self, stream, tasks, distance: int = 0) -> None:
        tasks = list(tasks)
        with self._rnd_lock:
            for t in tasks:
                if self._q.dq and self._rng.random() < 0.5:
                    self._q.dq.insert(self._rng.randrange(len(self._q.dq) + 1), t)
                else:
                    self._q.dq.append(t)

    def select(self, stream):
        return self._q.pop_front(), 0


class _GlobalHeapBase(SchedulerModule):
    sign = -1           # -1: highest priority first
    tie_lifo = False    # FIFO among equal priorities

    def install(self, context) -> None:
        super().install(context)
        self._heap = _LockedHeap()

    def flow_init(self, stream) -> None:
        pass

    def stats_global(self):
        return {"queued": len(self._heap)}

    def has_local_work(self, stream) -> bool:
        return len(self._heap) > 0

    def schedule(self, stream, tasks, distance: int = 0) -> None:
        for t in tasks:
            self._heap.push(t, self.sign, self.tie_lifo)

    def select(self, stream):
        return self._heap.pop(), 0


class SchedAP(_GlobalHeapBase):
    """Absolute priority (ref: sched_ap): depth-first (LIFO) among equal
    priorities — the freshest ready task continues the critical path."""
    name = "ap"
    native_policy = "prio"
    tie_lifo = True


class SchedSPQ(_GlobalHeapBase):
    """Shared priority queue (ref: sched_spq)."""
    name = "spq"
    native_policy = "prio"


class SchedIP(_GlobalHeapBase):
    """Inverse priority (ref: sched_ip): lowest priority first."""
    name = "ip"
    native_policy = None   # inverse priority has no native flavor
    sign = 1


_modules = {
    cls.name: cls
    for cls in (SchedLFQ, SchedGD, SchedLTQ, SchedLHQ, SchedAP, SchedPBQ,
                SchedIP, SchedLL, SchedLLP, SchedRND, SchedSPQ)
}


def create(name: Optional[str] = None) -> SchedulerModule:
    """MCA-style component selection (ref: parsec_set_scheduler, scheduling.c:249)."""
    name = name or mca.get("sched", "lfq")
    if name not in _modules:
        output.fatal(f"unknown scheduler module {name!r} (have: {sorted(_modules)})")
    return _modules[name]()


def available() -> List[str]:
    return sorted(_modules)
