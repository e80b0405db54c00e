"""Runtime context, execution streams, and the scheduling state machine.

Re-design of parsec/parsec.c (parsec_init, :405) + parsec/scheduling.c:

* :class:`ExecutionStream` — one per worker thread (ref:
  parsec_execution_stream_t, parsec/include/parsec/execution_stream.h:36-76).
* :class:`Context` — process-wide state (ref: parsec_context_t,
  execution_stream.h:117-174), with ``add_taskpool / start / wait / test``
  mirroring parsec/runtime.h:174-388.
* The per-thread hot loop re-creates ``__parsec_context_wait``
  (scheduling.c:727, hot loop :789-818) including exponential backoff.
* ``_task_progress`` re-creates ``__parsec_task_progress`` (scheduling.c:507)
  and ``__parsec_execute`` (scheduling.c:126): prepare_input → best-device
  selection → chore evaluate/hook → return-code dispatch
  (DONE/AGAIN/ASYNC/NEXT/DISABLE, scheduling.c:518-566).

GPU-first shape: CUDA chores enqueue their kernels on the device module's
stream and return ``HOOK_ASYNC``; the progress loop polls the device modules
(the analogue of the reference's GPU manager thread, device_gpu.c:3376+), so a
single host thread can keep the card busy.

The context runs on the card unless the caller asks for the CPU
(``Context(device="cpu")``, as the tests do); asking for CUDA on a machine
without it raises.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from ..utils import mca, output
from . import pins as pins_mod
from . import scheduler as sched_mod
from . import termdet as termdet_mod
from .task import (
    HOOK_AGAIN, HOOK_ASYNC, HOOK_DISABLE, HOOK_DONE, HOOK_ERROR, HOOK_NEXT,
    Task, Taskpool,
    TASK_STATUS_COMPLETE, TASK_STATUS_HOOK, TASK_STATUS_PREPARE_INPUT,
)

mca.register("runtime_nb_cores", 0, "Worker threads (0 = autodetect)", type=int)
mca.register("runtime_backoff_max_us", 1000, "Max starvation backoff (µs)", type=int)
mca.register("runtime_gc_defer", True,
             "Stretch Python cyclic-GC thresholds while taskpools are in "
             "flight (the mempool discipline of the reference: no "
             "allocator churn in the hot path). Task/tile graphs are "
             "cyclic and mostly LIVE mid-DAG, so frequent young-gen scans "
             "only promote them and full collections walk the whole heap",
             type=bool)
mca.register("debug_paranoid", 0,
             "Assertion tier (ref: PARSEC_DEBUG_PARANOID): >0 adds runtime "
             "invariant checks in the scheduling hot path (not-ready or "
             "completed tasks entering the queues, double completion)",
             type=int)


# process-wide refcount for the GC-stretch window (several contexts can
# live in one process; gc thresholds are global)
_gc_defer_lock = threading.Lock()
_gc_defer_count = 0
_gc_saved_thresholds = None
_GC_STRETCHED = (50_000, 20, 20)    # vs the (700, 10, 10) default


def _gc_defer_acquire() -> None:
    global _gc_defer_count, _gc_saved_thresholds
    import gc
    with _gc_defer_lock:
        _gc_defer_count += 1
        if _gc_defer_count == 1:
            _gc_saved_thresholds = gc.get_threshold()
            gc.set_threshold(*_GC_STRETCHED)


def _gc_defer_release() -> None:
    global _gc_defer_count, _gc_saved_thresholds
    import gc
    with _gc_defer_lock:
        if _gc_defer_count == 0:
            return
        _gc_defer_count -= 1
        if _gc_defer_count == 0 and _gc_saved_thresholds is not None:
            gc.set_threshold(*_gc_saved_thresholds)
            _gc_saved_thresholds = None


class ExecutionStream:
    """One worker's view of the runtime (ref: execution_stream.h:36-76)."""

    __slots__ = ("th_id", "vp_id", "context", "next_task", "nb_selects",
                 "nb_executed")

    def __init__(self, th_id: int, context: "Context", vp_id: int = 0) -> None:
        self.th_id = th_id
        self.vp_id = vp_id
        self.context = context
        self.next_task: Optional[Task] = None   # es->next_task locality slot
        self.nb_selects = 0
        self.nb_executed = 0

    @property
    def is_master(self) -> bool:
        return self.th_id == 0  # ref: PARSEC_THREAD_IS_MASTER


class Context:
    """Process-wide runtime (ref: parsec_context_t + parsec_init parsec.c:405).

    ``device`` is the accelerator the context drives: ``"cuda"`` (the
    default, the current card), ``"cuda:<i>"``, or ``"cpu"`` for a context
    with no accelerator (every body runs on the CPU device; the tests use
    it). A CUDA request on a machine without CUDA raises."""

    def __init__(
        self,
        nb_cores: Optional[int] = None,
        scheduler: Optional[str] = None,
        argv: Optional[List[str]] = None,
        device: Any = "cuda",
    ) -> None:
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"Context(device={str(device)!r}) needs CUDA, but "
                f"torch.cuda.is_available() is False; pass device='cpu' "
                f"to run without a card")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {str(device)!r}")
        if argv:
            mca.parse_cmdline(argv)
        if nb_cores is None:
            nb_cores = mca.get("runtime_nb_cores", 0) or (os.cpu_count() or 1)
        self.nb_cores = max(1, nb_cores)
        self.pins = pins_mod.PinsManager()
        self.paranoid = mca.get("debug_paranoid", 0)
        from .vpmap import VPMap
        self.vpmap = VPMap(nb_threads=self.nb_cores)
        self.streams: List[ExecutionStream] = [
            ExecutionStream(i, self, vp_id=self.vpmap.thread_to_vp(i))
            for i in range(self.nb_cores)
        ]
        self.sched = sched_mod.create(scheduler)
        self.sched.install(self)
        for s in self.streams:
            self.sched.flow_init(s)
        # device registry (lazy import to avoid cycles)
        from ..device.device import DeviceRegistry
        self.devices = DeviceRegistry(self)
        self._taskpools: Dict[int, Taskpool] = {}
        self._active = 0
        self._cv = threading.Condition()
        self._started = False
        self._finalized = False
        self._workers: List[threading.Thread] = []
        self._work_event = threading.Event()
        self._error: Optional[BaseException] = None
        self._prio_seen = False   # any nonzero-priority task ever scheduled
        # per-thread stream binding
        self._tls = threading.local()
        self._tls.stream = self.streams[0]
        #: serializes progress loops on the MASTER stream: every
        #: non-worker thread (wait()/wait_taskpool()/fini drain/DTD
        #: window stall) drives streams[0], and two concurrent drivers race
        #: on streams[0].next_task (the read-then-clear hand-off can execute
        #: a task twice or drop it). REENTRANT: nested loops on one thread
        #: (wait inside a drain) are legal
        self._master_loop_lock = threading.RLock()
        # schedule() only needs to wake anyone when parked workers exist;
        # single-core runs skip the Event syscall
        self._need_wake = self.nb_cores > 1
        self._gc_held = False
        output.debug_verbose(2, "runtime",
                             f"context up: {self.nb_cores} streams, "
                             f"sched={self.sched.name}, device={self.device}")

    # ------------------------------------------------------------------ setup
    def add_taskpool(self, tp: Taskpool) -> None:
        """parsec_context_add_taskpool (ref: scheduling.c:865-923)."""
        if self._finalized:
            output.fatal("context already finalized")
        tp.context = self
        if tp.termdet is None:
            termdet_mod.LocalTermdet().monitor_taskpool(tp)  # ref: scheduling.c:879-884
        with self._cv:
            self._taskpools[tp.taskpool_id] = tp
            self._active += 1
            first = self._active == 1
        if first and mca.get("runtime_gc_defer", True):
            # the hold + finalizer transition under _cv: racing a
            # concurrent quiesce-release outside the lock could detach the
            # WRONG finalizer and lose the crash-safety net
            with self._cv:
                if not self._gc_held:
                    self._gc_held = True
                    _gc_defer_acquire()
                    # crash-safety: a context abandoned without fini() must
                    # not leave process-wide GC thresholds stretched forever
                    import weakref
                    self._gc_finalizer = weakref.finalize(
                        self, _gc_defer_release)
        # taskpool keeps one pending action for the enqueue itself
        tp.addto_nb_pending_actions(1)
        if tp.on_enqueue is not None:
            tp.on_enqueue(tp)
        if tp.startup_hook is not None:
            startup = tp.startup_hook(self.streams[0], tp)
            if startup:
                self.schedule(startup, self.streams[0])
        tp.termdet.taskpool_ready(tp)
        tp.addto_nb_pending_actions(-1)
        self._work_event.set()

    def _taskpool_completed(self, tp: Taskpool) -> None:
        with self._cv:
            if tp.taskpool_id in self._taskpools:
                del self._taskpools[tp.taskpool_id]
                self._active -= 1
            quiesced = self._active == 0
            self._cv.notify_all()
        if quiesced:
            self._release_gc_hold()

    def _release_gc_hold(self) -> None:
        with self._cv:
            if not self._gc_held:
                return
            self._gc_held = False
            fin = getattr(self, "_gc_finalizer", None)
            self._gc_finalizer = None
            if fin is not None:
                fin.detach()     # normal release: the safety net must not
        _gc_defer_release()      # double-decrement the process refcount

    # ------------------------------------------------------------------ start/wait
    def start(self) -> None:
        """parsec_context_start (ref: scheduling.c:968): spawn workers."""
        if self._started:
            return
        self._started = True
        for s in self.streams[1:]:
            t = threading.Thread(target=self._worker_main, args=(s,),
                                 name=f"parsec-worker-{s.th_id}", daemon=True)
            self._workers.append(t)
            t.start()

    def test(self) -> bool:
        """parsec_context_test: True when no active taskpool remains."""
        with self._cv:
            return self._active == 0

    def wait(self, timeout: Optional[float] = None) -> int:
        """parsec_context_wait (ref: scheduling.c:994): master joins the hot loop."""
        self.start()
        self._progress_loop(self.streams[0],
                            until=lambda: self._active == 0,
                            timeout=timeout)
        return 0

    def wait_taskpool(self, tp: Taskpool, timeout: Optional[float] = None) -> bool:
        """parsec_taskpool_wait (ref: scheduling.c:1028)."""
        self.start()
        self._progress_loop(self.streams[0],
                            until=lambda: tp.completed,
                            timeout=timeout)
        return tp.completed

    def fini(self, timeout: Optional[float] = None) -> None:
        """parsec_fini: drain and join workers; report statistics. After a
        body error the context is poisoned: fini skips the drain and tears
        down cleanly instead of re-raising."""
        if self._finalized:
            return
        if self._error is None:
            self.wait(timeout=timeout)
        self._finalized = True
        for s in self.streams:
            if s.nb_executed:
                output.debug_verbose(1, "stats",
                                     f"es{s.th_id} (vp{s.vp_id}): "
                                     f"{s.nb_executed} tasks, "
                                     f"{s.nb_selects} selects")
        for name, st in self.devices.statistics().items():
            if st["executed_tasks"]:
                output.debug_verbose(1, "stats", f"device {name}: {st}")
        self._work_event.set()
        for t in self._workers:
            t.join(timeout=5.0)
        self.devices.fini()
        self._release_gc_hold()  # error paths can finalize w/ pools active

    # ------------------------------------------------------------------ scheduling
    def schedule(self, tasks, stream: Optional[ExecutionStream] = None,
                 distance: int = 0) -> None:
        """__parsec_schedule (ref: scheduling.c:287)."""
        if isinstance(tasks, Task):
            tasks = [tasks]
        tasks = list(tasks)
        if not tasks:
            return
        if self.paranoid:
            # PARANOID tier 1+ (ref: PARSEC_DEBUG_PARANOID build flavor):
            # a task entering the ready queues must actually be ready, and
            # must not already be completed
            for t in tasks:
                unmet = getattr(t, "deps_remaining", 0)
                if unmet > 0:
                    output.fatal(f"PARANOID: {t!r} scheduled with "
                                 f"{unmet} unmet dependencies")
                if t.status == TASK_STATUS_COMPLETE:
                    output.fatal(f"PARANOID: completed task {t!r} "
                                 f"re-scheduled")
        if not self._prio_seen:
            # burst selection is only policy-sound while every live task
            # has equal priority: the first prioritized task flips the hot
            # loop to task-at-a-time selects so releases preempt promptly
            for t in tasks:
                if t.priority:
                    self._prio_seen = True
                    break
        stream = stream or self._current_stream()
        if self.pins.enabled:
            self.pins.fire(pins_mod.SCHEDULE_BEGIN, stream, tasks)
            self.sched.schedule(stream, tasks, distance)
            self.pins.fire(pins_mod.SCHEDULE_END, stream, tasks)
        else:
            self.sched.schedule(stream, tasks, distance)
        if self._need_wake:
            self._work_event.set()

    def _current_stream(self) -> ExecutionStream:
        # threadlocal binding (workers bind in _worker_main); unknown
        # threads (user code) act as the master stream
        return getattr(self._tls, "stream", None) or self.streams[0]

    # ------------------------------------------------------------------ hot loop
    def _worker_main(self, stream: ExecutionStream) -> None:
        self._tls.stream = stream
        if mca.get("runtime_bind_threads", False):
            from .vpmap import bind_current_thread
            bind_current_thread(self.vpmap.core_of(stream.th_id))
        while not self._finalized:
            self._progress_loop(stream, until=lambda: self._active == 0)
            # park until new work shows up
            self._work_event.wait(timeout=0.05)
            self._work_event.clear()

    def in_progress_loop(self) -> bool:
        """True when the CALLING thread is inside a progress loop — i.e. a
        task body may be on its call stack. Flow-control blocking (the DTD
        window stall) consults this: blocking mid-body can deadlock the
        pool. THREAD-local on purpose — all user threads share the master
        stream object."""
        return getattr(self._tls, "loop_depth", 0) > 0

    def _progress_loop(self, stream: ExecutionStream, until, timeout=None) -> None:
        """The hot loop (ref: __parsec_context_wait scheduling.c:789-818).

        Master-stream loops are serialized (one driving thread at a time,
        see ``_master_loop_lock``). A contender must NOT block on the
        lock unconditionally — the holder's exit condition may require
        the contender to make progress elsewhere — so contenders poll their
        OWN ``until`` (and the error flag, and their deadline) between short
        acquire attempts; the holder is draining the same work anyway."""
        tls = self._tls
        depth = getattr(tls, "loop_depth", 0)
        tls.loop_depth = depth + 1
        try:
            if stream.th_id != 0:
                self._progress_loop_inner(stream, until, timeout)
                return
            deadline = None if timeout is None \
                else time.monotonic() + timeout
            while True:
                if until():
                    return
                if self._error is not None:
                    raise self._error
                if deadline is not None:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        return
                    slice_ = min(0.02, left)
                else:
                    slice_ = 0.02
                if self._master_loop_lock.acquire(timeout=slice_):
                    try:
                        self._progress_loop_inner(
                            stream, until,
                            None if deadline is None
                            else max(0.0, deadline - time.monotonic()))
                    finally:
                        self._master_loop_lock.release()
                    return
        finally:
            tls.loop_depth = depth

    def _progress_loop_inner(self, stream: ExecutionStream, until,
                             timeout=None) -> None:
        misses = 0
        deadline = None if timeout is None else time.monotonic() + timeout
        backoff_max = mca.get("runtime_backoff_max_us", 1000) / 1e6
        while not until():
            if self._error is not None:
                if stream.is_master:
                    raise self._error
                return  # workers park quietly; the master surfaces the error
            # poll device modules (our analogue of the GPU manager thread)
            did_something = bool(self.devices.progress(stream))
            task = stream.next_task
            stream.next_task = None
            distance = 0
            if task is None:
                if self.pins.enabled:
                    self.pins.fire(pins_mod.SELECT_BEGIN, stream, None)
                    task, distance = self.sched.select(stream)
                    self.pins.fire(pins_mod.SELECT_END, stream, task)
                else:
                    task, distance = self.sched.select(stream)
                stream.nb_selects += 1
            if task is not None:
                misses = 0
                # drain a burst before re-checking the loop conditions: the
                # per-iteration overhead (until, error, device polls) is
                # pure cost for fine-grain tasks, and the scheduler pops the
                # whole burst under ONE lock (select_burst). Bursts skip the
                # SELECT pins events, so instrumentation keeps the
                # task-at-a-time shape
                budget = 1 if self.pins.enabled else 32
                use_burst = not (self.pins.enabled or self._prio_seen)
                batch: List[Task] = []
                bi = 0
                try:
                    while True:
                        self._task_progress(stream, task, distance)
                        budget -= 1
                        task = stream.next_task
                        if task is not None:
                            if budget <= 0:
                                # outer loop consumes next_task; un-run
                                # burst tasks go back to the queues
                                if bi < len(batch):
                                    self.sched.schedule(stream, batch[bi:], 0)
                                break
                            stream.next_task = None
                            distance = 0
                            continue
                        if bi < len(batch):
                            task = batch[bi]
                            bi += 1
                            distance = 0
                            continue
                        if budget <= 0:
                            break
                        if use_burst:
                            batch = self.sched.select_burst(stream, budget)
                            stream.nb_selects += 1
                            bi = 0
                            if not batch:
                                break
                            task = batch[0]
                            bi = 1
                        else:
                            # prioritized workload: task-at-a-time selects
                            # keep just-released high-priority work first
                            task, distance = self.sched.select(stream)
                            stream.nb_selects += 1
                            if task is None:
                                break
                            continue
                        distance = 0
                except BaseException as e:  # noqa: BLE001 - re-raised below
                    # a failing body must surface to every waiter, not die
                    # silently with one worker thread (ref: hook errors are
                    # fatal, scheduling.c:541-548)
                    if self._error is None:
                        self._error = e
                    if bi < len(batch):     # un-run burst tasks stay queued
                        self.sched.schedule(stream, batch[bi:], 0)
                    self._work_event.set()
                    if stream.is_master:
                        raise
                    return
                did_something = True
            if not did_something:
                misses += 1
                if deadline is not None and time.monotonic() > deadline:
                    return
                # exponential backoff while starving (ref: scheduling.c:801-804)
                time.sleep(min(backoff_max, 1e-6 * (1 << min(misses, 10))))

    # ------------------------------------------------------------------ task FSM
    def _task_progress(self, stream: ExecutionStream, task: Task,
                       distance: int = 0) -> int:
        """__parsec_task_progress (ref: scheduling.c:507)."""
        tc = task.task_class
        if task.status < TASK_STATUS_PREPARE_INPUT:
            task.status = TASK_STATUS_PREPARE_INPUT
            if tc.prepare_input is not None:
                pins_on = self.pins.enabled
                if pins_on:
                    self.pins.fire(pins_mod.PREPARE_INPUT_BEGIN, stream, task)
                rc = tc.prepare_input(stream, task)
                if pins_on:
                    self.pins.fire(pins_mod.PREPARE_INPUT_END, stream, task)
                if rc == HOOK_AGAIN:
                    self.schedule([task], stream, distance)
                    return rc
        return self._execute(stream, task)

    def _execute(self, stream: ExecutionStream, task: Task) -> int:
        """__parsec_execute (ref: scheduling.c:126)."""
        tc = task.task_class
        task.status = TASK_STATUS_HOOK
        device = self.devices.select_best_device(task)  # ref: device.c:100
        task.selected_device = device
        for chore in tc.incarnations:
            if not (chore.device_type & task.chore_mask):
                continue
            if device is not None and not (chore.device_type & device.type):
                continue
            if chore.evaluate is not None:
                ev = chore.evaluate(stream, task)
                if ev == HOOK_NEXT:
                    continue
                if ev == HOOK_DISABLE:
                    task.chore_mask &= ~chore.device_type
                    continue
            task.selected_chore = chore
            pins_on = self.pins.enabled
            if pins_on:
                self.pins.fire(pins_mod.EXEC_BEGIN, stream, task)
            rc = chore.hook(stream, task)
            stream.nb_executed += 1
            # return-code dispatch (ref: scheduling.c:518-566)
            if rc == HOOK_DONE:
                if pins_on:
                    self.pins.fire(pins_mod.EXEC_END, stream, task)
                if device is not None:
                    device.executed_tasks += 1  # async devices count in epilog
                self.complete_task_execution(stream, task)
                return rc
            if rc == HOOK_ASYNC:
                # completion arrives via complete_task_execution from a
                # device; the EXEC interval closes here (it measures host
                # dispatch)
                if pins_on:
                    self.pins.fire(pins_mod.EXEC_END, stream, task)
                return rc
            if rc == HOOK_AGAIN:
                if pins_on:
                    self.pins.fire(pins_mod.EXEC_END, stream, task)
                self.schedule([task], stream, distance=1)  # __parsec_reschedule :445
                return rc
            if rc == HOOK_NEXT:
                continue
            if rc == HOOK_DISABLE:
                task.chore_mask &= ~chore.device_type
                continue
            if rc == HOOK_ERROR:
                output.fatal(f"task {task!r} hook failed")  # ref: scheduling.c:541-548
        output.fatal(f"no runnable chore for task {task!r} "
                     f"(chore_mask={task.chore_mask:#x})")
        return HOOK_ERROR

    def complete_task_execution(self, stream: ExecutionStream, task: Task) -> None:
        """__parsec_complete_execution (ref: scheduling.c:469)."""
        tc = task.task_class
        if self.paranoid and task.status == TASK_STATUS_COMPLETE:
            output.fatal(f"PARANOID: {task!r} completed twice")
        task.status = TASK_STATUS_COMPLETE
        pins_on = self.pins.enabled
        if pins_on:
            self.pins.fire(pins_mod.COMPLETE_EXEC_BEGIN, stream, task)
        if tc.prepare_output is not None:
            tc.prepare_output(stream, task)
        if tc.complete_execution is not None:
            tc.complete_execution(stream, task)
        if pins_on:
            self.pins.fire(pins_mod.RELEASE_DEPS_BEGIN, stream, task)
        if tc.release_deps is not None:
            tc.release_deps(stream, task)
        if pins_on:
            self.pins.fire(pins_mod.RELEASE_DEPS_END, stream, task)
            self.pins.fire(pins_mod.COMPLETE_EXEC_END, stream, task)
        if task.on_complete is not None:
            task.on_complete(task)
        task.taskpool.addto_nb_tasks(-1)
        if tc.release_task is not None:
            tc.release_task(stream, task)
