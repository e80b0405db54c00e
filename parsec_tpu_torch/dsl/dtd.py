"""DTD: dynamic task discovery — the insert-task frontend.

Re-design of parsec/interfaces/dtd (insert_function.c, insert_function.h,
insert_function_internal.h). The user inserts tasks against *tiles*; the
runtime builds the DAG on the fly from each tile's access chain and executes
tasks as their dependencies retire:

* :class:`DTDTile` — ref: parsec_dtd_tile_t (insert_function_internal.h:174-196)
  with ``last_writer`` / reader lists driving RAW/WAR/WAW chaining
  (WAR strategy per overlap_strategies.c: a writer waits on all readers since
  the previous write; readers wait on the last writer).
* :class:`DTDTaskpool` — ref: parsec_dtd_taskpool_new (insert_function.c:1513);
  task classes are auto-created per body function + parameter profile
  (the reference's function_h_table); flow-control **window/threshold**
  (insert_function.h:149-157): the inserter blocks past the window and helps
  execute until the executed count catches up.
* ``insert_task`` — ref: parsec_dtd_insert_task (insert_function.c:3617) →
  create/initialize (:2801), param linking (:2896), schedule-if-ready (:2963).

Bodies are *functional* — ``fn(*args) -> outputs`` returns fresh tensors for
its WRITE flows instead of mutating in place. The same body runs as the CPU
chore (on host tensors) or the CUDA chore (on device tensors, its kernels
enqueued on the device module's stream), which makes version-tracked copies
natural (every write is a new buffer).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..core.context import Context
from ..core.task import (
    Chore, DEV_CPU, DEV_CUDA, Flow, FLOW_ACCESS_READ, FLOW_ACCESS_RW,
    FLOW_ACCESS_WRITE, HOOK_DONE, Task, TaskClass, TaskData, Taskpool,
)
from ..data.collection import DataCollection
from ..data.data import COHERENCY_OWNED, Data, DataCopy, data_from_array
from ..data.matrix import torch_dtype
from ..device.cuda import CUDADevice, CUDATask
from ..utils import mca, output
from .fusion import Counters

# access flags for insert_task args (ref: PARSEC_INPUT/OUTPUT/INOUT | AFFINITY)
READ = FLOW_ACCESS_READ
WRITE = FLOW_ACCESS_WRITE
RW = FLOW_ACCESS_RW
AFFINITY = 0x100          # ref: PARSEC_AFFINITY bit on a dtd param
NOTRACK = 0x200           # ref: PARSEC_DONT_TRACK (dtd_test_flag_dont_track.c):
                          # the tile's VALUE flows to the body, but the access
                          # creates no RAW/WAR/WAW edges — ordering w.r.t.
                          # tracked accesses of the same tile is the caller's
                          # problem.

mca.register("dtd_window_size", 2048,
             "Max in-flight inserted-but-not-executed tasks", type=int)
mca.register("dtd_threshold_size", 1024,
             "Catch-up target once the window is hit", type=int)

#: process-wide DTD counters: capture windows deferred to the scheduler,
#: and the fused regions (and their tasks) those windows inserted
DTD_STATS = Counters(capture_windows_deferred=0, capture_regions_fused=0,
                     capture_tasks_fused=0)


def _flush_body(arr):
    """data_flush task body: bring the newest version home to the host."""
    return arr.cpu()


class DTDTile:
    """Ref: parsec_dtd_tile_t (insert_function_internal.h:174-196)."""

    __slots__ = ("data", "key", "dc", "lock", "last_writer", "readers",
                 "compact_at")

    def __init__(self, data: Data, key: Any,
                 dc: Optional[DataCollection]) -> None:
        self.data = data
        self.key = key
        self.dc = dc
        self.lock = threading.Lock()
        self.last_writer: Optional["DTDTask"] = None
        self.readers: List["DTDTask"] = []
        self.compact_at = 32      # next reader-list compaction watermark

    def __repr__(self) -> str:  # pragma: no cover
        return f"<DTDTile {self.key}>"


class DTDTask(Task):
    """Task with runtime-discovered deps (ref: parsec_dtd_task_t)."""

    __slots__ = ("deps_remaining", "successors", "completed", "lock",
                 "arg_spec", "tiles", "pending_inputs", "ident")

    def __init__(self, taskpool, task_class, priority=0) -> None:
        super().__init__(taskpool, task_class, None, priority)
        self.ident = 0          # insertion index (repr/debug identity)
        # starts at 1: the insertion-in-progress guard (dropped at the end of
        # insert_task, mirroring the count-then-activate protocol of
        # parsec_dtd_schedule_task_if_ready, insert_function.c:2963)
        self.deps_remaining = 1
        self.completed = False
        self.successors: List[DTDTask] = []
        self.lock = threading.Lock()
        self.arg_spec: List[Tuple[str, Any]] = []  # ('flow', i) | ('value', v)
        self.tiles: List[Optional[DTDTile]] = []
        #: flow_index -> payload snapshotted at insert (NOTRACK flows).
        #: Lazily allocated: a per-task dict is churn on the insert hot path
        self.pending_inputs: Optional[Dict[int, Any]] = None

    def dep_satisfied(self) -> bool:
        with self.lock:
            self.deps_remaining -= 1
            return self.deps_remaining == 0

    def __repr__(self) -> str:  # pragma: no cover
        return f"{self.task_class.name}(#{self.ident})"


class DTDTaskClass(TaskClass):
    """Auto-created per (body fn, param profile)
    (ref: function_h_table, insert_function_internal.h:206-224)."""

    def __init__(self, name: str, fn: Callable, flow_accesses: Tuple[int, ...],
                 nb_values: int, jit_ok: bool = True,
                 batchable: bool = False) -> None:
        super().__init__(name, nb_flows=len(flow_accesses))
        self.fn = fn
        self.count_mode = True
        self.lazy_data = True     # slots allocated at prepare_input
        self.flow_accesses = flow_accesses
        #: False for side-effectful bodies (callbacks, host I/O): they run
        #: on the CPU device only
        self.jit_ok = jit_ok
        #: True: compatible queued device tasks collapse into one dispatch
        #: (ref: dtd GPU batching flag on task-class chores)
        self.batchable = batchable
        for i, acc in enumerate(flow_accesses):
            self.add_flow(Flow(f"f{i}", acc))


def _on_host(payload):
    """A tensor payload on the host (the CPU chore's inputs)."""
    if isinstance(payload, torch.Tensor) and payload.device.type != "cpu":
        return payload.cpu()
    return payload


def _as_outputs(outs) -> List[Any]:
    """A body's result as a list of tensors, one per WRITE flow."""
    if outs is None:
        return []
    if not isinstance(outs, (tuple, list)):
        outs = (outs,)
    return [o if isinstance(o, torch.Tensor) else torch.as_tensor(o)
            for o in outs]


class DTDTaskpool(Taskpool):
    """Ref: parsec_dtd_taskpool_new (insert_function.c:1513).

    ``capture`` (``True``/``"auto"``, ``"inline"`` or ``"scan"``) records
    the inserts instead of scheduling them and runs each wait()-delimited
    window as one program (:mod:`parsec_tpu_torch.dsl.capture`): a CUDA
    graph on a card context, an eager replay on a CPU one."""

    def __init__(self, context: Context, name: str = "dtd",
                 capture: Any = False) -> None:
        # per-context sequence number per base name, so two live pools
        # never share a name
        seqs = getattr(context, "_dtd_name_seq", None)
        if seqs is None:
            seqs = context._dtd_name_seq = {}
        seq = seqs.get(name, 0)
        seqs[name] = seq + 1
        if seq:
            name = f"{name}#{seq}"
        super().__init__(name)
        self.ctx = context
        self._classes: Dict[Any, DTDTaskClass] = {}
        self._tiles: Dict[Any, DTDTile] = {}
        self._tiles_lock = threading.Lock()
        self.window_size = mca.get("dtd_window_size", 2048)
        self.threshold_size = mca.get("dtd_threshold_size", 1024)
        #: serializes the WHOLE insert path: concurrent user-thread inserts
        #: are an advertised contract (the inserted/local_inserted RMWs and
        #: the tile chains must stay exact). REENTRANT on purpose: a
        #: window-stalled inserter executes tasks inline, and a body may
        #: itself insert (recursive task insertion). NOT held across the
        #: window stall (see _window_stall); _stall_lock elects the one user
        #: thread that drives the master stream's drain loop
        self._insert_lock = threading.RLock()
        self._stall_lock = threading.Lock()
        self.inserted = 0
        self.local_inserted = 0   # tasks this process executes
        self.window_stalls = 0    # inserter blocked on the task window
        self._executed = 0
        self._exec_lock = threading.Lock()
        self._open = False
        self._touched_tiles: List[DTDTile] = []
        self._new_tile_count = 0
        self._last_class = None   # (fn, accs, nvals, jit, batch, tc)
        #: True while the CURRENT insert window is deferred to the
        #: scheduler (a non-capturable insert poisoned it); wait() resets
        #: it so the next window captures again (per-window auto-defer)
        self._capture_deferred = False
        # whole-DAG capture mode (dsl/capture.py): record inserts, execute
        # the pool as ONE program at wait()
        self._capture = None
        if capture:
            if getattr(context, "nb_ranks", 1) > 1:
                output.fatal("graph capture is single-rank "
                             "(a captured pool never leaves the card)")
            from .capture import GraphCapture
            self._capture = GraphCapture(self, mode=capture)
        # hold the "user may still insert" action BEFORE attaching, so the
        # termdet can never observe transiently-zero counters at enqueue time
        self.addto_nb_pending_actions(1)
        self._open = True
        context.add_taskpool(self)

    # ------------------------------------------------------------- tiles
    def tile_of(self, dc: DataCollection, *indices) -> DTDTile:
        """PARSEC_DTD_TILE_OF (ref: parsec_dtd_tile_of, insert_function.c:1403)."""
        key = (dc.name, dc.data_key(*indices))
        with self._tiles_lock:
            t = self._tiles.get(key)
            if t is None:
                data = dc.data_of(*indices)
                t = DTDTile(data, key, dc)
                self._tiles[key] = t
                self._touched_tiles.append(t)
            return t

    def tile_new(self, array_or_shape, dtype=torch.float32,
                 key: Any = None) -> DTDTile:
        """parsec_dtd_tile_new (ref: insert_function.h:239): a taskpool-lifetime
        scratch tile not backed by any collection."""
        if hasattr(array_or_shape, "shape"):
            arr = torch.as_tensor(array_or_shape)
        else:
            arr = torch.zeros(array_or_shape, dtype=torch_dtype(dtype))
        data = data_from_array(arr)
        self._new_tile_count += 1
        t = DTDTile(data, ("new", self.name, self._new_tile_count), None)
        with self._tiles_lock:
            self._tiles[t.key] = t
            self._touched_tiles.append(t)
        return t

    # ------------------------------------------------------------- classes
    def _class_of(self, fn: Callable, flow_accesses: Tuple[int, ...],
                  nb_values: int, name: Optional[str],
                  jit_ok: bool = True, batchable: bool = False) -> DTDTaskClass:
        key = (fn, flow_accesses, nb_values, jit_ok, batchable)
        tc = self._classes.get(key)
        if tc is None:
            tc = DTDTaskClass(name or getattr(fn, "__name__", "dtd_task"),
                              fn, flow_accesses, nb_values, jit_ok=jit_ok,
                              batchable=batchable)
            tc.prepare_input = self._prepare_input
            tc.release_deps = self._release_deps
            tc.complete_execution = self._complete_execution
            # the CUDA chore only exists where a CUDA device does — on
            # CPU-only contexts every task would walk (and fail) it first.
            # Side-effectful bodies (jit=False) never get one: they would
            # ride the whole async device pipeline only to run host code
            if jit_ok and any(d.type & DEV_CUDA
                              for d in self.ctx.devices.devices):
                tc.add_chore(Chore(DEV_CUDA, self._cuda_hook))
            tc.add_chore(Chore(DEV_CPU, self._cpu_hook))
            self.add_task_class(tc)
            self._classes[key] = tc
        return tc

    # ------------------------------------------------------------- insert
    def _window_stall(self) -> None:
        """Window flow control (ref: insert_function.h:149-157).

        Runs OUTSIDE the insert lock — a stalling inserter must never
        block another thread's (in particular a worker-thread body's)
        insert, or a mid-body recursive insert would deadlock the pool.
        Flow control NEVER blocks inside a task body (a thread currently
        driving a progress loop): the unfinished task's successors may be
        the only drainable work. Top-level user threads elect ONE drainer
        via a try-lock — the loser waits for the window to drain instead
        of racing the winner on streams[0].next_task."""
        if self.local_inserted - self.executed <= self.window_size:
            return
        if self.ctx.in_progress_loop():
            return              # mid-body insert: never block flow control
        self.window_stalls += 1
        self.ctx.start()
        while self.local_inserted - self.executed > self.window_size:
            if self.ctx._error is not None:
                return
            if self._stall_lock.acquire(blocking=False):
                try:
                    target = self.local_inserted - self.threshold_size
                    self.ctx._progress_loop(
                        self.ctx.streams[0],
                        until=lambda: self.executed >= target)
                finally:
                    self._stall_lock.release()
                return
            time.sleep(50e-6)   # another user thread is draining

    def insert_task(self, fn: Callable, *args, priority: int = 0,
                    name: Optional[str] = None,
                    jit: bool = True, batch: bool = False) -> Optional[DTDTask]:
        """parsec_dtd_insert_task (ref: insert_function.c:3617); None for
        an insert that a captured pool recorded.

        ``args``: ``(tile, access)`` tuples become data flows; anything else
        is a by-value parameter. ``access`` may carry the NOTRACK bit to pass
        the tile's value without dependency tracking (ref PARSEC_DONT_TRACK),
        and the AFFINITY bit, which names the owner-computes tile of a
        distributed run (accepted here; placement is single-process).

        ``jit=True`` (the default) declares the body a pure tensor function
        that may run as the CUDA chore; ``jit=False`` keeps a side-effectful
        body on the CPU device. ``batch=True`` lets the device module
        collapse compatible ready tasks into one dispatch.

        Thread-safe: concurrent user threads may insert into one pool — the
        whole linking path runs under the taskpool insert lock; window flow
        control runs AFTER the lock drops.
        """
        with self._insert_lock:
            task = self._insert_task_locked(fn, args, priority, name,
                                            jit, batch)
        self._window_stall()
        return task

    def _insert_task_locked(self, fn: Callable, args, priority: int,
                            name: Optional[str],
                            jit: bool, batch: bool) -> Optional[DTDTask]:
        if not self._open:
            output.fatal("insert_task on a closed DTD taskpool")
        if self._capture is not None and not self._capture_deferred:
            from .capture import CaptureDeferred
            try:
                self._capture.record(fn, args, jit=jit, name=name or "",
                                     priority=priority)
                self.inserted += 1
                return None
            except CaptureDeferred as e:
                # per-window auto-defer: this wait()-delimited window holds
                # a non-capturable insert — replay the recorded prefix
                # through the scheduler in program order and run the REST
                # of the window there too; capture re-arms at the next
                # window
                output.debug_verbose(1, "capture",
                                     f"{self.name}: window deferred to "
                                     f"the scheduler ({e})")
                self._capture_deferred = True
                DTD_STATS["capture_windows_deferred"] += 1
                n_rec = len(self._capture.ops)
                # capturable RUNS of the deferred window collapse into one
                # fused super-task insert each
                replays = self._capture.take_ops(
                    fuse=bool(mca.get("region_fusion", True)))
                self.inserted -= n_rec          # re-counted by the replay
                for rfn, rargs, rprio, rname in replays:
                    nf = getattr(rfn, "_ptdtd_fused", 0)
                    if nf:
                        DTD_STATS["capture_regions_fused"] += 1
                        DTD_STATS["capture_tasks_fused"] += nf
                    self._insert_task_locked(rfn, rargs, rprio,
                                             rname or None, True, False)
                # fall through: THIS task inserts normally below
        flow_accesses: List[int] = []
        arg_spec: List[Tuple[str, Any]] = []
        tiles: List[DTDTile] = []
        for a in args:
            if isinstance(a, tuple) and len(a) == 2 and isinstance(a[0], DTDTile):
                tile, acc = a
                acc &= ~AFFINITY
                arg_spec.append(("flow", len(flow_accesses)))
                flow_accesses.append(acc)
                tiles.append(tile)
            elif isinstance(a, DTDTile):
                arg_spec.append(("flow", len(flow_accesses)))
                flow_accesses.append(RW)
                tiles.append(a)
            else:
                arg_spec.append(("value", a))
        # one-entry class cache: the dominant pattern is a loop inserting
        # the same body with the same flow shape (the reference's task
        # class reuse), so the 5-tuple dict key is usually redundant
        lc = self._last_class
        if lc is not None and lc[0] is fn and lc[1] == flow_accesses \
                and lc[2] == len(arg_spec) and lc[3] == jit and lc[4] == batch:
            tc = lc[5]
        else:
            tc = self._class_of(fn, tuple(flow_accesses), len(arg_spec),
                                name, jit_ok=jit, batchable=batch)
            self._last_class = (fn, list(flow_accesses), len(arg_spec),
                                jit, batch, tc)
        task = DTDTask(self, tc, priority)
        task.arg_spec = arg_spec
        task.tiles = tiles
        task.ident = self.inserted
        self.inserted += 1
        # link against each tile's chain (ref: parsec_dtd_set_params_of_task
        # insert_function.c:2896; WAR via overlap_strategies.c)
        for fi, (tile, acc) in enumerate(zip(tiles, flow_accesses)):
            self._link_tile(task, tile, acc, fi)
        self.addto_nb_tasks(1)
        self.local_inserted += 1
        if task.dep_satisfied():
            # ref: parsec_dtd_schedule_task_if_ready (insert_function.c:2963)
            self.ctx.schedule([task])
        return task     # window stall runs after the insert lock drops

    def _link_tile(self, task: DTDTask, tile: DTDTile, acc: int,
                   flow_index: int) -> None:
        if acc & NOTRACK:
            # untracked access: no chaining and no version bump — and the
            # VALUE is snapshotted NOW (ref: insert_function.c:3038 captures
            # tile->data_copy at insert time): an untracked flow has no
            # ordering edges, so resolving newest_copy at execution would let
            # the body observe a tracked write that landed after this insert
            copy = tile.data.newest_copy()
            if copy is not None:
                if task.pending_inputs is None:
                    task.pending_inputs = {}
                task.pending_inputs[flow_index] = copy.payload
            return
        preds: List[DTDTask] = []
        with tile.lock:
            if acc & READ or not (acc & WRITE):
                # RAW: predecessor is the last writer
                if tile.last_writer is not None:
                    preds.append(tile.last_writer)
                readers = tile.readers
                if len(readers) >= tile.compact_at:
                    # amortized compaction: completed readers are
                    # already-satisfied WAR predecessors — pruning them
                    # keeps long read-chains from growing unboundedly
                    # between writes. The watermark doubles past the
                    # survivors so a burst of never-retiring readers costs
                    # O(n log n) total, not a full rescan per insert
                    live = [r for r in readers if not r.completed]
                    live.append(task)
                    tile.readers = live
                    tile.compact_at = max(32, 2 * len(live))
                else:
                    readers.append(task)
            if acc & WRITE:
                # WAR: wait on readers since the previous write; WAW on the
                # last writer
                preds.extend(tile.readers)
                if tile.last_writer is not None and \
                        tile.last_writer not in preds:
                    preds.append(tile.last_writer)
                tile.last_writer = task
                tile.readers = []
                tile.compact_at = 32
        seen = set()
        for p in preds:
            if id(p) in seen or p is task:
                continue
            seen.add(id(p))
            with p.lock:
                if not p.completed:
                    p.successors.append(task)
                    with task.lock:
                        task.deps_remaining += 1

    # ------------------------------------------------------------- hooks
    def _prepare_input(self, stream, task: DTDTask) -> int:
        if task.data is None:     # lazy_data: first touch allocates
            task.data = [TaskData()
                         for _ in range(task.task_class.nb_flows)]
        pending = task.pending_inputs
        for i, tile in enumerate(task.tiles):
            pend = pending.pop(i, None) if pending else None
            if pend is not None:
                # value snapshotted at insert: an unattached copy carries
                # the right Data for write-back without perturbing
                # newest_copy resolution
                task.data[i].data_in = DataCopy(tile.data, 0, pend)
                continue
            copy = tile.data.newest_copy()
            if copy is None:
                output.fatal(f"tile {tile!r} has no valid copy for {task!r}")
            task.data[i].data_in = copy
        return HOOK_DONE

    def _gather_args(self, task: DTDTask, flow_payloads: Sequence[Any]) -> List[Any]:
        return [flow_payloads[v] if kind == "flow" else v
                for kind, v in task.arg_spec]

    def _cpu_hook(self, stream, task: DTDTask) -> int:
        """CPU chore: run the body on host tensors and land its outputs in
        the tiles' host copies. An input whose newest version lives on the
        card comes home first (a copy that waits for it), so the body never
        computes on the card outside the device module's stream, and a host
        copy never holds a device tensor."""
        tc: DTDTaskClass = task.task_class
        payloads = [_on_host(s.data_in.payload) if s.data_in is not None
                    else None for s in task.data]
        outs = _as_outputs(tc.fn(*self._gather_args(task, payloads)))
        oi = 0
        for i, acc in enumerate(tc.flow_accesses):
            if acc & WRITE:
                tile = task.tiles[i]
                new = outs[oi] if oi < len(outs) else payloads[i]
                oi += 1
                host = tile.data.get_copy(0)
                if host is None:
                    host = tile.data.create_copy(0, new, COHERENCY_OWNED)
                else:
                    host.payload = new
                tile.data.bump_version(0)
                task.data[i].data_out = host
        return HOOK_DONE

    def _cuda_hook(self, stream, task: DTDTask) -> int:
        """CUDA chore: enqueue on the selected device, with batching metadata
        (plays the generated GPU hook role, jdf2c.c:6613)."""
        dev: CUDADevice = task.selected_device
        tc: DTDTaskClass = task.task_class
        gt = CUDATask(task, self._cuda_submit, batchable=tc.batchable,
                      batch_submit=self._cuda_batch_submit
                      if tc.batchable else None)
        return dev.kernel_scheduler(stream, task, cuda_task=gt)

    def _cuda_batch_submit(self, device: CUDADevice, tasks: List[DTDTask],
                           inputs_list: List[List[Any]]):
        """One dispatch over a batch of compatible independent tasks (they
        are mutually independent by construction: only dependency-free
        tasks sit in the device queue). The bodies run one after the other
        inside it — a body may launch a hand-written kernel, which no batch
        transform can trace through."""
        return [self._cuda_submit(device, t, inp)
                for t, inp in zip(tasks, inputs_list)]

    def _cuda_submit(self, device: CUDADevice, task: DTDTask,
                     inputs: List[Any]):
        """CUDA chore body: call the class function on device tensors (its
        kernels go to the device module's stream, which is current here).
        Outputs follow the WRITE flows, the contract shared with the device
        epilog."""
        tc: DTDTaskClass = task.task_class
        return tuple(_as_outputs(tc.fn(*self._gather_args(task, inputs))))

    def _complete_execution(self, stream, task: DTDTask) -> int:
        with self._exec_lock:
            self._executed += 1
        return HOOK_DONE

    @property
    def executed(self) -> int:
        return self._executed

    def _release_deps(self, stream, task: DTDTask) -> None:
        """DTD successor release (ref: parsec_dtd_ordering_correctly,
        insert_function_internal.h:277): flip completed, wake successors."""
        with task.lock:
            task.completed = True
            succs = task.successors
            task.successors = []
        # retire the task's object graph (the mempool-return moment of
        # parsec_dtd_release_task): dropping the tile/copy references here
        # lets refcounting reclaim payload buffers immediately and keeps
        # the completed shell acyclic
        task.tiles = ()
        task.arg_spec = ()
        task.data = ()
        task.pending_inputs = None
        ready = [s for s in succs if s.dep_satisfied()]
        if ready:
            self.ctx.schedule(ready, stream)

    # ------------------------------------------------------------- flush/wait
    def data_flush(self, tile: DTDTile) -> None:
        """parsec_dtd_data_flush (ref: parsec_dtd_data_flush.c): insert a task
        that writes the tile's newest version back home (host copy)."""
        self.insert_task(_flush_body, (tile, RW), name="dtd_flush", jit=False)

    def data_flush_all(self, dc: DataCollection) -> None:
        """parsec_dtd_data_flush_all: flush every tile of ``dc`` seen so far."""
        with self._tiles_lock:
            tiles = [t for t in self._touched_tiles if t.dc is dc]
        for t in tiles:
            self.data_flush(t)

    def wait(self, timeout: Optional[float] = None) -> bool:
        """parsec_dtd_taskpool_wait: drain everything this process executes
        (a captured pool: execute the recorded window as one program)."""
        if self._capture is not None:
            if not self._capture_deferred:
                self._capture.execute()
                return True
            # deferred window: its tasks went through the scheduler — drain
            # them like an uncaptured pool, then re-arm capture
            self._capture_deferred = False
        self.ctx.start()
        target = self.local_inserted
        self.ctx._progress_loop(self.ctx.streams[0],
                                until=lambda: self.executed >= target and
                                self.nb_tasks == 0,
                                timeout=timeout)
        return self.executed >= target

    def close(self) -> None:
        """End of insertion: drop the open action so termination can fire."""
        if self._capture is not None and self._capture.ops:
            # scheduler-mode inserts execute without an explicit wait();
            # captured ops must not be silently dropped on close
            self._capture.execute()
        if self._open:
            self._open = False
            self.addto_nb_pending_actions(-1)

    def __enter__(self) -> "DTDTaskpool":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.wait()
        self.close()
