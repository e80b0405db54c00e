"""Core task model: taskpool / task-class / task.

Re-design of PaRSEC's task model (reference:
parsec/parsec_internal.h:117-563). The triple is preserved:

* :class:`Taskpool`   — one DAG-in-progress (parsec_taskpool_t, :117-163)
* :class:`TaskClass`  — the static description of one task type: flows, deps,
  chores/incarnations per device type, key function (parsec_task_class_t, :411-459)
* :class:`Task`       — one runtime instance with locals, data slots, status
  (parsec_task_t, :551-563)

Device incarnations ("chores", __parsec_chore_t :398-404) carry an optional
``evaluate`` and the ``hook``; hook return codes drive the scheduling state
machine exactly as in the reference (scheduling.c:518-566): DONE, AGAIN, ASYNC,
NEXT, DISABLE, ERROR.

Unlike the reference's C, task bodies here are Python callables over torch
tensors; on the GPU they enqueue kernels on the device module's CUDA stream
and return at once, so ASYNC-style completion is the *normal* mode for CUDA
chores.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..utils import mca

# ---------------------------------------------------------------------------
# Hook return codes (ref: parsec/parsec_internal.h PARSEC_HOOK_RETURN_*)
# ---------------------------------------------------------------------------
HOOK_DONE = 0       # body finished synchronously
HOOK_AGAIN = 1      # reschedule on the same device (e.g. OOM, retry later)
HOOK_ASYNC = 2      # completion will be signalled asynchronously
HOOK_NEXT = 3       # try the next chore/incarnation
HOOK_DISABLE = 4    # disable this chore for this task class henceforth
HOOK_ERROR = -1

# Task status codes (ref: parsec_internal.h:510-515)
TASK_STATUS_NONE = 0
TASK_STATUS_PREPARE_INPUT = 1
TASK_STATUS_EVAL = 2
TASK_STATUS_HOOK = 3
TASK_STATUS_PREPARE_OUTPUT = 4
TASK_STATUS_COMPLETE = 5

# Flow access modes (ref: parsec/parsec_internal.h PARSEC_FLOW_ACCESS_*)
FLOW_ACCESS_NONE = 0x0
FLOW_ACCESS_READ = 0x1
FLOW_ACCESS_WRITE = 0x2
FLOW_ACCESS_RW = FLOW_ACCESS_READ | FLOW_ACCESS_WRITE
FLOW_ACCESS_CTL = 0x4   # pure control dependency, no data

# Device type bitmask (ref: parsec/mca/device/device.h:63-77)
DEV_NONE = 0x0
DEV_CPU = 0x1
DEV_RECURSIVE = 0x2
DEV_CUDA = 0x4         # PARSEC_DEV_CUDA (same bit as the TPU device type)
DEV_ALL = 0xFF

MAX_PARAM_COUNT = 32   # ref: MAX_PARAM_COUNT in parsec_internal.h


@dataclass
class Chore:
    """One device incarnation of a task class (ref: __parsec_chore_t :398-404)."""
    device_type: int
    hook: Callable[..., int]
    evaluate: Optional[Callable[..., int]] = None
    dyld: Optional[str] = None  # name for find_incarnation-style lookup


@dataclass
class Dep:
    """One dataflow edge endpoint (ref: parsec/parsec_internal.h dep_t).

    ``cond`` is a predicate over the *source* task's locals; ``target_locals``
    maps source locals -> an iterable of successor locals assignments (a single
    dep may fan out, e.g. broadcast edges in JDF).
    """
    task_class: "TaskClass"          # the peer task class
    flow_index: int                  # peer flow index
    dep_index: int = 0               # bit in the dependency mask
    cond: Optional[Callable[[Dict[str, int]], bool]] = None
    target_locals: Optional[Callable[[Dict[str, int]], Sequence[Dict[str, int]]]] = None
    datatype: Any = None             # arena/datatype for remote transfers
    #: memory endpoint (JDF "A(k)"): locals -> Data in a collection; used when
    #: ``task_class is None``
    data_ref: Optional[Callable[[Dict[str, int]], Any]] = None


@dataclass
class Flow:
    """A named data flow of a task class (ref: parsec_flow_t)."""
    name: str
    access: int = FLOW_ACCESS_RW
    flow_index: int = 0
    deps_in: List[Dep] = field(default_factory=list)    # where the data comes from
    deps_out: List[Dep] = field(default_factory=list)   # who consumes it


@dataclass(slots=True)
class TaskData:
    """Per-flow data slot of a task (ref: parsec_data_pair_t)."""
    data_in: Any = None          # DataCopy consumed
    data_out: Any = None         # DataCopy produced
    source_repo_entry: Any = None
    repo_entry: Any = None


class TaskClass:
    """Static description of one task type (ref: parsec_task_class_t :411-459)."""

    def __init__(
        self,
        name: str,
        nb_flows: int = 0,
        nb_locals: int = 0,
        task_class_id: int = 0,
        dependencies_goal: int = 0,
        flags: int = 0,
        properties: Optional[Dict[str, Any]] = None,
    ) -> None:
        self.name = name
        self.task_class_id = task_class_id
        self.nb_flows = nb_flows
        self.nb_locals = nb_locals
        self.flags = flags
        self.flows: List[Flow] = []
        self.incarnations: List[Chore] = []
        #: bitmask of input dep bits that must be satisfied (mask mode), or the
        #: count of input deps (counter mode).  Ref: dependencies_goal.
        self.dependencies_goal = dependencies_goal
        self.count_mode = False  # True -> counter-based deps (hash deps)
        #: optional per-task goal (conditioned deps): locals -> goal value.
        #: Plays the role of the generated code pre-marking inactive dep bits
        #: (ref: startup-task marking, parsec/parsec.c:1730).
        self.dependencies_goal_fn: Optional[Callable[[Dict[str, int]], int]] = None
        self.properties: Dict[str, Any] = properties or {}
        # Overridable behaviors (generated by DSLs in the reference):
        self.make_key: Callable[["Taskpool", Dict[str, int]], Any] = \
            lambda tp, locals_: tuple(sorted(locals_.items()))
        self.prepare_input: Optional[Callable[[Any, "Task"], int]] = None
        self.prepare_output: Optional[Callable[[Any, "Task"], int]] = None
        self.complete_execution: Optional[Callable[[Any, "Task"], int]] = None
        self.release_task: Optional[Callable[[Any, "Task"], None]] = None
        self.iterate_successors: Optional[Callable[..., None]] = None
        self.iterate_predecessors: Optional[Callable[..., None]] = None
        self.release_deps: Optional[Callable[..., int]] = None
        self.data_affinity: Optional[Callable[["Task"], Any]] = None
        self.time_estimate: Optional[Callable[["Task", Any], float]] = None
        # (registry weakref, epoch, {mask: device tuple}) — owned by
        # DeviceRegistry.select_best_device; lives/dies with this class
        self._dev_sel_cache = None
        #: True: Task.__init__ leaves .data as None and prepare_input
        #: allocates the slots on first need (DTD sets this — its fused
        #: lane retires most tasks without touching them)
        self.lazy_data = False

    def add_flow(self, flow: Flow) -> Flow:
        flow.flow_index = len(self.flows)
        self.flows.append(flow)
        self.nb_flows = len(self.flows)
        return flow

    def add_chore(self, chore: Chore) -> Chore:
        self.incarnations.append(chore)
        return chore

    def __repr__(self) -> str:  # pragma: no cover
        return f"<TaskClass {self.name}#{self.task_class_id}>"


#: shared locals for task instances that carry none (DTD tasks identify by
#: insertion index, not named parameters) — never mutate this dict
_EMPTY_LOCALS: Dict[str, int] = {}


class Task:
    """One runtime task instance (ref: parsec_task_t :551-563)."""

    __slots__ = (
        "taskpool", "task_class", "locals", "priority", "chore_mask",
        "status", "data", "repo_entry", "_sched_next", "selected_device",
        "selected_chore", "on_complete", "prof_info",
    )

    def __init__(
        self,
        taskpool: "Taskpool",
        task_class: TaskClass,
        locals_: Optional[Dict[str, int]] = None,
        priority: int = 0,
    ) -> None:
        self.taskpool = taskpool
        self.task_class = task_class
        self.locals: Dict[str, int] = \
            locals_ if locals_ is not None else _EMPTY_LOCALS
        self.priority = priority
        self.chore_mask = DEV_ALL
        self.status = TASK_STATUS_NONE
        # lazy_data classes defer slot allocation to prepare_input: the DTD
        # fused lane retires most tasks without ever touching the slots
        self.data: List[TaskData] = None if task_class.lazy_data else \
            [TaskData() for _ in range(task_class.nb_flows)]
        self.repo_entry = None
        self.selected_device = None
        self.selected_chore: Optional[Chore] = None
        self.on_complete: Optional[Callable[["Task"], None]] = None
        self.prof_info: Any = None
        self._sched_next = None  # intrusive ring link used by schedulers

    @property
    def key(self) -> Any:
        return self.task_class.make_key(self.taskpool, self.locals)

    def __repr__(self) -> str:  # pragma: no cover
        loc = ",".join(f"{k}={v}" for k, v in self.locals.items())
        return f"{self.task_class.name}({loc})"


class Taskpool:
    """One DAG being executed (ref: parsec_taskpool_t :117-163).

    ``nb_tasks`` counts locally-known unexecuted tasks; ``nb_pending_actions``
    counts outstanding runtime actions (communications, async device work,
    in-flight completions). The termination-detection module watches both, as
    in the reference (parsec/mca/termdet/termdet.h:99-314).
    """

    _ids = itertools.count(1)
    UNDETERMINED_NB_TASKS = (1 << 30)  # ref: PARSEC_UNDETERMINED_NB_TASKS

    def __init__(self, name: str = "taskpool", nb_task_classes: int = 0) -> None:
        self.taskpool_id = next(Taskpool._ids)
        self.name = name
        self.task_classes: List[TaskClass] = []
        self.context = None                  # set by Context.add_taskpool
        self.termdet = None                  # termination-detection monitor
        self.on_enqueue: Optional[Callable[["Taskpool"], None]] = None
        self.on_complete: Optional[Callable[["Taskpool"], None]] = None
        self.startup_hook: Optional[Callable[[Any, "Taskpool"], List[Task]]] = None
        self.priority = 0
        self.devices_index_mask = DEV_ALL
        self._lock = threading.Lock()
        self._nb_tasks = 0
        self._nb_pending_actions = 0
        self._completed_event = threading.Event()
        # dependency-tracking state: task_class_id -> table (dict or native)
        self._deps: List[Any] = []
        self._deps_locks: List[threading.Lock] = []
        # per-task-class data repos, installed by the DSL
        self.repos: List[Any] = []

    # -- task class registration ------------------------------------------------
    def add_task_class(self, tc: TaskClass) -> TaskClass:
        tc.task_class_id = len(self.task_classes)
        self.task_classes.append(tc)
        self._deps.append(None)   # backend chosen on first update_deps
        self._deps_locks.append(threading.Lock())
        self.repos.append(None)
        return tc

    # -- termination accounting (ref: termdet.h taskpool_addto_* ) --------------
    @property
    def nb_tasks(self) -> int:
        return self._nb_tasks

    @property
    def nb_pending_actions(self) -> int:
        return self._nb_pending_actions

    def set_nb_tasks(self, v: int) -> None:
        with self._lock:
            self._nb_tasks = v
        self._check_complete()

    def addto_nb_tasks(self, d: int) -> int:
        with self._lock:
            self._nb_tasks += d
            v = self._nb_tasks
        if v == 0:
            self._check_complete()
        return v

    def addto_nb_pending_actions(self, d: int) -> int:
        with self._lock:
            self._nb_pending_actions += d
            v = self._nb_pending_actions
        if v == 0:
            self._check_complete()
        return v

    def _check_complete(self) -> None:
        if self.termdet is not None:
            self.termdet.taskpool_state_changed(self)

    def _declare_complete(self) -> None:
        """Called by the termdet module exactly once."""
        if self.on_complete is not None:
            self.on_complete(self)
        self._completed_event.set()
        if self.context is not None:
            self.context._taskpool_completed(self)

    @property
    def completed(self) -> bool:
        return self._completed_event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """parsec_taskpool_wait (ref: scheduling.c:1028)."""
        if self.context is not None:
            return self.context.wait_taskpool(self, timeout)
        return self._completed_event.wait(timeout)

    # -- generic dependency tracking (ref: parsec_default_find_deps /
    #    parsec_hash_find_deps, parsec_internal.h:361-366 and
    #    parsec_update_deps_with_mask, parsec.c:1657) ---------------------------
    def update_deps(self, tc: TaskClass, key: Any, contribution: int,
                    goal: Optional[int] = None) -> bool:
        """Record one satisfied input dep of task ``key`` of class ``tc``.

        In mask mode ``contribution`` is the dep bit; in counter mode it is 1.
        Returns True when the task just became ready (goal reached).
        """
        if goal is None:
            goal = tc.dependencies_goal
        table = self._deps[tc.task_class_id]
        if table is None:
            table = self._pick_dep_backend(tc, key)
        if not isinstance(table, dict):
            # the native dependency table (csrc/ptcore.cpp, native.py)
            return table.update(key, contribution, goal, tc.count_mode)
        with self._deps_locks[tc.task_class_id]:
            cur = table.get(key, 0)
            if tc.count_mode:
                cur += contribution
            else:
                cur |= contribution
            if cur == goal:
                # retire the entry: the task is launched exactly once
                table.pop(key, None)
                return True
            table[key] = cur
            return False

    def _pick_dep_backend(self, tc: TaskClass, key: Any):
        """Create the class's dependency table on first use, by key shape:
        the native table (csrc/ptcore.cpp) takes int-tuple keys, the
        DSL-generated common case; other keys (a user ``make_key_fn``'s)
        and ``--mca native_enabled 0`` take a dict. A failed build of the
        native core raises."""
        with self._deps_locks[tc.task_class_id]:
            table = self._deps[tc.task_class_id]
            if table is not None:
                return table
            from .. import native
            if mca.get("native_enabled", True) and \
                    native.NativeDepTable.key_ok(key):
                table = native.NativeDepTable()
            else:
                table = {}
            self._deps[tc.task_class_id] = table
            return table

    def task_rank_of(self, tc: TaskClass, locals_: Dict[str, int]) -> int:
        """Owner-computes rank of a task instance. One rank until the
        distributed half of the port lands: a PTG class's affinity still
        answers (it names rank 0 on a one-rank collection)."""
        rank_of = getattr(tc, "_ptg_rank_of", None)
        if rank_of is not None:
            return rank_of(locals_)
        return 0

    def dep_state(self, tc: TaskClass, key: Any) -> int:
        table = self._deps[tc.task_class_id]
        if table is None:
            return 0
        if not isinstance(table, dict):
            return table.get(key)
        return table.get(key, 0)
