"""DTD: dynamic task discovery — the insert-task frontend.

Re-design of parsec/interfaces/dtd (insert_function.c, insert_function.h,
insert_function_internal.h). The user (on every rank, in the same order)
inserts tasks against *tiles*; the runtime builds the DAG on the fly from
each tile's access chain and executes tasks as their dependencies retire:

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
* distributed mode: every rank runs the same insert sequence; tasks are
  placed by the affinity tile's rank (owner-computes); remote edges go to the
  comm layer (rank_sent_to bitmaps, delayed release — wired in
  :mod:`parsec_tpu_torch.comm.remote_dep`), and ``--mca dtd_audit`` digests
  every rank's link decisions and compares them at wait().

Two engines link the chains. The native engine (``csrc/ptdtd.cpp``, built
and loaded by :mod:`parsec_tpu_torch.native`) runs on every context and
has two lanes: the per-task lane (one C call links a task's chains, one C
call walks its successors at completion; Python keeps the task objects and
runs the bodies through the scheduler FSM and the device module) and, on a
context without a CUDA device, the batched lane (repeat inserts of one
class buffer their specs, link N at a time, and execute inside the engine's
ready drain through per-class callbacks, draining through the scheduler
plane). The all-Python engine below serves ``--mca native_enabled 0`` and
``--mca pins_paranoid 1``, distributed pools and the replay audit (the
Python engine owns the distributed protocol's bookkeeping).

Bodies are *functional* — ``fn(*args) -> outputs`` returns fresh tensors for
its WRITE flows instead of mutating in place. The same body runs as the CPU
chore (on host tensors) or the CUDA chore (on device tensors, its kernels
enqueued on the device module's stream), which makes version-tracked copies
natural (every write is a new buffer).
"""

from __future__ import annotations

import threading
import zlib
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..core import pins as pins_mod
from ..core.context import Context
from ..core.task import (
    Chore, DEV_ALL, DEV_CPU, DEV_CUDA, Flow, FLOW_ACCESS_READ, FLOW_ACCESS_RW,
    FLOW_ACCESS_WRITE, HOOK_DONE, TASK_STATUS_COMPLETE, Task, TaskClass,
    TaskData, Taskpool,
)
from ..data.collection import DataCollection
from ..data.data import COHERENCY_OWNED, Data, DataCopy, data_from_array
from ..data.matrix import torch_dtype
from ..device.cuda import CUDADevice, CUDATask
from ..utils import mca, output
from ..utils.counters import Counters

# access flags for insert_task args (ref: PARSEC_INPUT/OUTPUT/INOUT | AFFINITY)
READ = FLOW_ACCESS_READ
WRITE = FLOW_ACCESS_WRITE
RW = FLOW_ACCESS_RW
AFFINITY = 0x100          # ref: PARSEC_AFFINITY bit on a dtd param
NOTRACK = 0x200           # ref: PARSEC_DONT_TRACK (dtd_test_flag_dont_track.c):
                          # the tile's VALUE flows to the body, but the access
                          # creates no RAW/WAR/WAW edges and no distributed
                          # version bookkeeping — ordering w.r.t. tracked
                          # accesses of the same tile is the caller's problem.
                          # Rank-local by contract (like tile_new scratch).

mca.register("dtd_window_size", 2048,
             "Max in-flight inserted-but-not-executed tasks", type=int)
mca.register("dtd_audit", False,
             "Replay auditor: digest every rank's (tile, version, rank) "
             "link decisions and compare across ranks at wait() (the DTD "
             "analogue of the PTG iterators_checker)", type=bool)
mca.register("dtd_threshold_size", 1024,
             "Catch-up target once the window is hit", type=int)
mca.register("dtd_batch_insert", True,
             "Batched native insert lane: buffer eligible insert_task calls "
             "and link them in the engine N at a time under one GIL drop; "
             "ready tasks execute through in-engine batched drains "
             "(drain_ready) instead of per-task scheduler cycles", type=bool)

#: engagement counters of the native DTD lanes. ``tasks_native`` counts
#: inserts the engine's per-task lane linked (on every context),
#: ``pools_batch`` pools that armed the batched lane, ``tasks_batched``
#: inserts that rode its buffer, ``batches`` its flushes,
#: ``tasks_per_task`` inserts on
#: batch-enabled pools that took the per-task lane (first insert of a
#: class, shape mismatch, priority/where/NOTRACK/AFFINITY, jittable bodies
#: with by-value args), ``classes_ineligible`` refused batch classes;
#: ``capture_*`` count capture windows deferred to the scheduler and the
#: fused regions (and their tasks) those windows inserted
PTDTD_STATS = Counters(tasks_native=0, pools_batch=0, tasks_batched=0,
                       tasks_per_task=0,
                       batches=0, classes_ineligible=0,
                       capture_windows_deferred=0,
                       capture_regions_fused=0, capture_tasks_fused=0)

#: "batch registration not yet attempted" marker for the one-entry class
#: cache (None means attempted-and-ineligible, which must not retry)
_BINFO_UNSET = object()


class AdmissionBackpressure(RuntimeError):
    """insert_task(nowait=True) on a pool past its scheduler-plane
    admission window (--mca sched_admission_window / tp.admission_window):
    the ready plane is protecting itself from a runaway inserter. Retry
    later, drop the request, or insert blocking (the default)."""


def _flush_body(arr):
    """data_flush task body: bring the newest version home to the host."""
    return arr.cpu()


#: serializes Context._dtd_batch_pools updates and engine creation (pools
#: arming/retiring from different threads)
_BATCH_POOLS_LOCK = threading.Lock()


def _pool_sync_on_complete(tp: "DTDTaskpool") -> None:
    """Taskpool.on_complete hook for batch-lane pools: sync the engine's
    tile payload slots into tile.data even when the user never calls
    tp.wait() (close + ctx.wait drains through termination detection),
    then hand the pool's engine-side state back (termdet fires this
    exactly once, after close() — no further inserts can arrive)."""
    tp._sync_slots()
    tp._retire_batch_lane()


class DTDTile:
    """Ref: parsec_dtd_tile_t (insert_function_internal.h:174-196)."""

    __slots__ = ("data", "key", "dc", "lock", "last_writer", "readers",
                 "rank", "new_tile", "compact_at", "wcount", "writer_rank",
                 "last_writer_version", "nid")

    def __init__(self, data: Data, key: Any, dc: Optional[DataCollection],
                 rank: int = 0, new_tile: bool = False) -> None:
        self.data = data
        self.key = key
        self.dc = dc
        self.rank = rank
        self.new_tile = new_tile
        self.lock = threading.Lock()
        self.last_writer: Optional["DTDTask"] = None
        self.readers: List["DTDTask"] = []
        self.compact_at = 32      # next reader-list compaction watermark
        #: logical write sequence number (one per linked write, on every
        #: lane: the batched lane syncs its writes in at quiescence),
        #: identical on every rank because all ranks replay the same insert
        #: sequence (the basis remote transfers are keyed on)
        self.wcount = 0
        self.writer_rank = rank      # rank holding the newest version
        self.last_writer_version = 0
        #: native-engine tile id (the chains in csrc/ptdtd.cpp), assigned
        #: on the first native link. Tiles are pool-local, so a tile's
        #: chain lives entirely in one engine
        self.nid: Optional[int] = None

    def __repr__(self) -> str:  # pragma: no cover
        return f"<DTDTile {self.key}>"


class DTDTask(Task):
    """Task with runtime-discovered deps (ref: parsec_dtd_task_t)."""

    __slots__ = ("deps_remaining", "successors", "completed", "lock",
                 "arg_spec", "tiles", "rank", "pending_inputs",
                 "remote_sends", "ident", "nid")

    def __init__(self, taskpool, task_class, priority=0) -> None:
        super().__init__(taskpool, task_class, None, priority)
        self.ident = 0          # insertion index (repr/debug identity)
        self.nid = -1           # native-engine task id (-1: Python engine)
        # starts at 1: the insertion-in-progress guard (dropped at the end of
        # insert_task, mirroring the count-then-activate protocol of
        # parsec_dtd_schedule_task_if_ready, insert_function.c:2963)
        self.deps_remaining = 1
        self.completed = False
        # the Python engine assigns a real lock + successor list at insert
        # (pred linking / release walk); the native lane never touches
        # either (the engine owns the successor lists)
        self.successors: Optional[List[DTDTask]] = None
        self.lock = None
        self.arg_spec: List[Tuple[str, Any]] = []  # ('flow', i) | ('value', v)
        self.tiles: List[Optional[DTDTile]] = []
        self.rank = 0
        #: flow_index -> payload snapshotted at insert (NOTRACK flows) or
        #: delivered by the comm engine (exact-version remote inputs
        #: override newest_copy resolution). Lazily allocated: a per-task
        #: dict is churn on the insert hot path
        self.pending_inputs: Optional[Dict[int, Any]] = None
        #: id(tile) -> (tile, version, {dst ranks}) — the rank_sent_to
        #: bitmap; lazily allocated for the same reason
        self.remote_sends: Optional[Dict[int, Tuple]] = None

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

    @property
    def fast_inline(self) -> bool:
        """True when this class can take the fused inline cycle: exactly
        one synchronous CPU chore, no evaluate gate — completion is
        immediate, so the progress loop can run prepare->hook->complete in
        one call."""
        fi = getattr(self, "_fast_inline", None)
        if fi is None:
            fi = self._fast_inline = (
                len(self.incarnations) == 1
                and self.incarnations[0].device_type == DEV_CPU
                and self.incarnations[0].evaluate is None)
        return fi


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


def _land_host(tile: "DTDTile", new) -> DataCopy:
    """A CPU-side write of ``new`` into the tile's host copy, one version
    bump (the CPU chore's tail)."""
    data = tile.data
    host = data.get_copy(0)
    if host is None:
        host = data.create_copy(0, new, COHERENCY_OWNED)
    else:
        host.payload = new
    data.bump_version(0)
    return host


class DTDTaskpool(Taskpool):
    """Ref: parsec_dtd_taskpool_new (insert_function.c:1513).

    ``capture`` (``True``/``"auto"``, ``"inline"`` or ``"scan"``) records
    the inserts instead of scheduling them and runs each wait()-delimited
    window as one program (:mod:`parsec_tpu_torch.dsl.capture`): a CUDA
    graph on a card context, an eager replay on a CPU one.

    ``qos_weight`` and ``admission_window``, set before the first insert,
    are the pool's weight and admission window on the scheduler plane (the
    batched lane's pools register there)."""

    def __init__(self, context: Context, name: str = "dtd",
                 capture: Any = False) -> None:
        # per-context (i.e. per-rank) sequence number per base name: every
        # rank constructs its taskpools in the same order, so "dtd#3" means
        # the same pool on all ranks while two concurrently-live pools never
        # collide in the remote-dep registry
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
        #: are an advertised contract (the tile.nid check-then-create, the
        #: inserted/local_inserted RMWs and the tile chains must stay
        #: exact). REENTRANT on purpose: a window-stalled inserter executes
        #: tasks inline, and a body may itself insert (recursive task
        #: insertion). NOT held across the window stall (see
        #: _window_stall); _stall_lock elects the one user thread that
        #: drives the master stream's drain loop
        self._insert_lock = threading.RLock()
        self._stall_lock = threading.Lock()
        self.inserted = 0
        self.local_inserted = 0   # tasks this rank executes
        self.window_stalls = 0    # inserter blocked on the task window
        self._executed = 0
        self._exec_lock = threading.Lock()
        self._open = False
        self._touched_tiles: List[DTDTile] = []
        self._new_tile_count = 0
        self._audit = mca.get("dtd_audit", False)
        self._audit_digest = 0      # zlib.crc32 chain: process-independent
        self._audit_count = 0
        #: native dependency engine (csrc/ptdtd.cpp), decided at the first
        #: insert (see _native_engine)
        self._neng = None
        self._neng_decided = False
        #: batched native insert lane: eligible repeat inserts of one class
        #: buffer their specs here (plain list: append is GIL-atomic, so
        #: the fast path takes NO lock; flushers serialize on the insert
        #: lock and drain a snapshot prefix with del-slice, which can never
        #: race a concurrent tail append) and link in the engine N at a
        #: time (engine.insert_many). Batched tasks have NO Python task
        #: object: the engine owns the whole insert->link->ready->execute->
        #: release cycle; bodies run through per-class batched callbacks at
        #: the drain points (Context._dtd_drain in every stream's hot loop)
        self._batch_on = False
        self._batch_retired = False   # final-completion hand-back ran
        self._slots_stale = False     # quiescence sync emptied the slots
        #: scheduler-plane pool handle (core/sched_plane.py): set when the
        #: batch lane arms on a plane-carrying context; batch classes
        #: register with it so their ready tasks drain by QoS weight, and
        #: the admission window backpressures insert_task through it
        self._sched_pool: Optional[int] = None
        self._bbuf: List[tuple] = []
        self._batch_flush_n = max(1, min(256, self.window_size // 2))
        #: one-entry FAST-PATH cache: (fn, jit, batch, kinds|k0, cls_nid,
        #: bbuf, flush_n, DTDTile) — everything the native try_buffer fast
        #: path needs in one tuple. kinds collapses to the bare acc int for
        #: the single-flow shape. Rebound wherever _last_class gains a
        #: batch registration; cleared on close()
        self._fast: Optional[tuple] = None
        self._tbuf = None        # native try_buffer (set with _batch_on)
        #: ready-at-insert batch (native per-task lane): ready tasks buffer
        #: here and enter the scheduler in BULK at the drain points (window
        #: stall, wait, close, a starving progress loop) — one push lock
        #: and one priority sort per batch instead of per task
        self._ready_buf: List[DTDTask] = []
        #: (fn, accs, nvals, jit, batch, tc, batch registration)
        self._last_class = None
        #: True while the CURRENT insert window is deferred to the
        #: scheduler (a non-capturable insert poisoned it); wait() resets
        #: it so the next window captures again (per-window auto-defer)
        self._capture_deferred = False
        # whole-DAG capture mode (dsl/capture.py): record inserts, execute
        # the pool as ONE program at wait()
        self._capture = None
        if context.comm is not None:
            # distributed: global termination detection + name-keyed registry
            context.comm.fourcounter.monitor_taskpool(self)
            context.comm.register_taskpool(self)
        if capture:
            if context.nb_ranks > 1:
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
                t = DTDTile(data, key, dc, rank=dc.rank_of(*indices))
                self._tiles[key] = t
                self._touched_tiles.append(t)
            return t

    def tile_of_key(self, dc: DataCollection, key: Any) -> DTDTile:
        """The tile of ``dc`` stored under ``key`` (its data_key)."""
        tkey = (dc.name, key)
        with self._tiles_lock:
            t = self._tiles.get(tkey)
            if t is None:
                data = dc.data_of_key(key)
                t = DTDTile(data, tkey, dc, rank=dc.rank_of_key(key))
                self._tiles[tkey] = t
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
        t = DTDTile(data, ("new", self.name, self._new_tile_count), None,
                    rank=self.ctx.my_rank, new_tile=True)
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

    # ------------------------------------------------------- native engine
    def _native_engine(self):
        """The per-context native DTD engine, or None (the Python engine).

        Declined for a distributed context (a comm engine attached, or more
        than one rank), for ``--mca dtd_audit 1`` (the Python engine owns the
        distributed protocol's bookkeeping and the replay digest, as in the
        reference), for ``--mca pins_paranoid 1`` (with PINS callbacks
        registered) and for ``--mca native_enabled 0``; with the engine on,
        a failed build or load raises. On a context with no CUDA device the
        batched lane arms too."""
        if self._neng_decided:
            return self._neng
        self._neng_decided = True
        ctx = self.ctx
        if ctx.comm is not None or ctx.nb_ranks > 1 or self._audit \
                or ctx.pins.paranoid or not mca.get("native_enabled", True):
            return None
        eng = ctx._dtd_neng
        if eng is None:
            # serialized: two pools first-inserting from different client
            # threads must not BOTH mint an engine (the loser's tasks
            # would link into a chain state nobody drains)
            with _BATCH_POOLS_LOCK:
                eng = ctx._dtd_neng
                if eng is None:
                    from .. import native as native_mod
                    eng = ctx._dtd_neng = native_mod.load_ptdtd().Engine()
        # progress loops drain our ready buffer even when the user drives
        # the context directly (no tp.wait()); weakly bound so a dropped
        # pool unregisters itself
        ctx.register_drain_hook(self._flush_ready)
        # batched insert lane: on a context with no CUDA device and the
        # DEFAULT scheduler. CUDA contexts stay per-task — device selection
        # and async epilogs are policy the in-engine drain bypasses, and a
        # device epilog writing a tile behind the engine's payload slot
        # would break slot coherence. An explicitly chosen scheduler also
        # refuses the lane: a DTD pool mixes batch-lane tasks (plane-
        # ordered) with per-task-lane tasks (every prioritized or shape-
        # ineligible insert), and the user's policy spans BOTH, which no
        # per-lane ordering can honor
        if mca.get("dtd_batch_insert", True) \
                and not ctx.sched_explicit \
                and not any(d.type & DEV_CUDA for d in ctx.devices.devices):
            self._batch_on = True
            from .. import native as native_mod
            self._tbuf = native_mod.load_ptdtd().try_buffer
            # open-batch-pool count gates the stream hot loops' engine
            # drain; decremented at final completion
            with _BATCH_POOLS_LOCK:
                ctx._dtd_batch_pools += 1
            PTDTD_STATS["pools_batch"] += 1
            # scheduler plane: bind the engine (idempotent — one plane per
            # context) and register this pool's QoS identity; batch
            # classes then route ready tasks through the shared plane, so
            # concurrent DTD pools drain by DRR weight and the admission
            # window gains teeth
            plane = ctx.sched_plane
            if plane is not None:
                try:
                    eng.sched_bind(plane.capsule)
                    h = plane.register_pool(
                        self.name, plane.KIND_PTDTD,
                        weight=getattr(self, "qos_weight", None),
                        window=getattr(self, "admission_window", None))
                    self._sched_pool = h if h >= 0 else None
                except Exception:  # noqa: BLE001 — private ready path
                    self._sched_pool = None
            # tile payload slots sync back into tile.data when the pool
            # completes, even when the user never calls wait(). CHAIN any
            # prior hook: it must see the synced tile.data values
            prev = self.on_complete
            if prev is None:
                self.on_complete = _pool_sync_on_complete
            else:
                def _chained(tp, _prev=prev):
                    _pool_sync_on_complete(tp)
                    _prev(tp)
                self.on_complete = _chained
        # ring lifecycle (enable): the engine records both lanes into its
        # in-lane rings and histograms. The batched lane surfaces no
        # per-task PINS events, so its rings are armed whenever the bridge
        # runs (marker-only under PINS alone); the per-task lane fires the
        # PINS events itself, so its rings are armed only for a tracer
        # (markers would count its tasks twice). The engine is per-CONTEXT
        # and outlives pools, so its events carry taskpool id 0
        if self._batch_on or ctx.profiling is not None:
            ctx._ntrace_attach("ptdtd", eng)
        ctx._hist_attach("ptdtd", eng)
        self._neng = eng
        return eng

    def _tile_nid(self, tile: DTDTile) -> int:
        """The tile's engine chain id, created (and its payload slot
        seeded) on first native touch. The check-then-create runs under
        the insert lock: two threads racing here must not mint two engine
        chains for one shared tile."""
        nid = tile.nid
        if nid is None:
            with self._insert_lock:
                nid = tile.nid
                if nid is None:
                    neng = self._neng
                    nid = neng.tile()
                    if self._batch_on:
                        copy = tile.data.newest_copy()
                        if copy is not None:
                            neng.slot_set(nid, copy.payload)
                    tile.nid = nid
        return nid

    def _slot_payload(self, tile: DTDTile):
        """Newest payload of a tile on a batch-lane pool: the engine slot
        is authoritative while batched writers are in flight (tile.data
        syncs at wait/complete); falls back to newest_copy."""
        if self._batch_on and tile.nid is not None:
            p = self._neng.slot_get(tile.nid)
            if p is not None:
                return p
        copy = tile.data.newest_copy()
        return None if copy is None else copy.payload

    # ------------------------------------------------------- batched lane
    def _mk_batch_callback(self, tc: "DTDTaskClass", argmap: Tuple[int, ...]):
        """The per-class batched dispatch the engine's drain_ready invokes
        once per (class, batch): run every body on its gathered args (the
        body as it is — there is no compilation step) and hand WRITE-flow
        outputs back for native slot landing, as tensors like the CPU
        chore's. Execution accounting does NOT happen here — the engine
        invokes ``_batch_retire`` only after the outputs have landed, so a
        wait()er can never observe the counters ahead of the payloads."""
        fn = tc.fn
        nw = sum(1 for a in tc.flow_accesses if a & WRITE)
        # arg position each write flow's input payload sits at (a body
        # returning fewer outputs keeps the old payload, like the CPU chore)
        wpos = [argmap.index(i)
                for i, a in enumerate(tc.flow_accesses) if a & WRITE]

        def _batch_cb(args_list):
            if not nw:
                for vals in args_list:
                    fn(*vals)
                return None
            outs_list = []
            for vals in args_list:
                o = _as_outputs(fn(*vals))
                if len(o) < nw:
                    o += [vals[wpos[k]] for k in range(len(o), nw)]
                outs_list.append(tuple(o))
            return outs_list

        return _batch_cb

    def _batch_retire(self, ne: int) -> None:
        """Engine-invoked AFTER a batch's outputs have landed in the tile
        slots and its release walk has run: retire the batch's execution
        accounting in bulk. Retiring inside the batch callback — before
        the landing — would let a concurrent wait() see ``executed >=
        target`` and _sync_slots() the PRE-batch payloads."""
        with self._exec_lock:
            self._executed += ne
        self.addto_nb_tasks(-ne)

    def _mk_batch_info(self, tc: "DTDTaskClass", flow_accesses,
                       arg_spec) -> Optional[tuple]:
        """Register an engine batch class for (tc, arg interleaving), or
        None when ineligible. Eligibility (refusals ride the per-task lane
        and count in PTDTD_STATS):
          * plain READ/WRITE/RW flows only (NOTRACK snapshots the value at
            insert time, which a deferred batch cannot honor);
          * jittable bodies (``jit=True``) take no by-value args;
          * CUDA contexts never reach here (pool-level gate)."""
        if not self._batch_on:
            return None
        for acc in flow_accesses:
            if acc & ~0x3:
                PTDTD_STATS["classes_ineligible"] += 1
                return None
        if tc.jit_ok and any(kind != "flow" for kind, _ in arg_spec):
            PTDTD_STATS["classes_ineligible"] += 1
            return None
        kinds: List[Optional[int]] = []
        argmap: List[int] = []
        for kind, v in arg_spec:
            if kind == "flow":
                kinds.append(flow_accesses[v])
                argmap.append(v)
            else:
                kinds.append(None)
                argmap.append(-1)
        reg = getattr(tc, "_breg", None)
        if reg is None:
            reg = tc._breg = {}
        key = tuple(argmap)
        nid = reg.get(key)
        if nid is None:
            cb = self._mk_batch_callback(tc, key)
            nid = self._neng.register_class(
                cb, key, [a & 0x3 for a in flow_accesses],
                self._batch_retire,
                -1 if self._sched_pool is None else self._sched_pool)
            reg[key] = nid
        return (nid, tuple(kinds))

    def _flush_batch(self) -> None:
        """Hand the buffered insert specs to the engine in one call."""
        if not self._bbuf:
            return
        with self._insert_lock:
            self._flush_batch_locked()

    def _flush_batch_locked(self) -> None:
        lst = self._bbuf
        n = len(lst)
        if not n:
            return
        if self._slots_stale:
            # a quiescence sync emptied the slots (tile.data became
            # authoritative again, honoring any user reseed since); the
            # next batch gathers args from the slots, so refill them from
            # the host copies before linking
            self._slots_stale = False
            neng = self._neng
            with self._tiles_lock:
                tiles = list(self._touched_tiles)
            for t in tiles:
                if t.nid is not None:
                    copy = t.data.newest_copy()
                    if copy is not None:
                        neng.slot_set(t.nid, copy.payload)
        chunk = lst[:n]
        del lst[:n]
        # count BEFORE linking: a linked task may be drained by a worker
        # immediately, and its -1 must never underflow the counter
        self.addto_nb_tasks(n)
        self.inserted += n
        self.local_inserted += n
        PTDTD_STATS["tasks_batched"] += n
        PTDTD_STATS["batches"] += 1
        try:
            self._neng.insert_many(chunk)
        except BaseException:
            # insert_many validates the WHOLE batch before linking any of
            # it, so a raise means nothing linked: roll the counters back
            # or the pool could never quiesce
            self.addto_nb_tasks(-n)
            self.inserted -= n
            self.local_inserted -= n
            PTDTD_STATS["tasks_batched"] -= n
            PTDTD_STATS["batches"] -= 1
            raise

    def _sync_slots(self) -> None:
        """Land the engine's tile payload slots back into tile.data (the
        slot-ownership hand-off: C owned the values while batched writers
        were in flight; Python re-takes them at quiescence points). The
        version delta equals the number of batched writes, keeping
        tile.data.version in parity with the per-task lanes. slot_sync
        also EMPTIES each slot, making tile.data authoritative until the
        next flush re-seeds — a user reseeding a tile's host copy between
        waits is honored exactly like on the per-task lanes. Runs under
        the insert lock, so no concurrent flush links a batch against
        slots this sync is emptying."""
        if not self._batch_on:
            return
        neng = self._neng
        with self._insert_lock:
            with self._tiles_lock:
                tiles = list(self._touched_tiles)
            synced = False
            for t in tiles:
                nid = t.nid
                if nid is None:
                    continue
                payload, writes = neng.slot_sync(nid)
                synced = True
                if not writes:
                    continue
                data = t.data
                host = data.get_copy(0)
                if host is None:
                    data.create_copy(0, payload, COHERENCY_OWNED)
                else:
                    host.payload = payload
                data.bump_version(0, writes)
                t.wcount += writes
                t.last_writer_version = t.wcount
            if synced:
                self._slots_stale = True

    def _retire_batch_lane(self) -> None:
        """Final-completion hand-back for batch-lane pools (fires once,
        from on_complete): drop this pool from the context's open-batch
        count and release the engine-side state the pool pinned."""
        if not self._batch_on or self._batch_retired:
            return
        self._batch_retired = True
        with _BATCH_POOLS_LOCK:
            self.ctx._dtd_batch_pools -= 1
        self._release_native()
        if self._sched_pool is not None:
            # free the plane slot AFTER release_pool cleared the classes'
            # pool routing (a released class must never route to a slot
            # another pool may reuse)
            plane = self.ctx.sched_plane
            if plane is not None:
                plane.unregister_pool(self._sched_pool)
            self._sched_pool = None
        self._land_trace()

    def _land_trace(self) -> None:
        """Ring lifecycle (quiescence): land the engine's in-lane events
        now — the engine outlives the pool, but a dumped trace must not be
        missing a completed pool's tail."""
        if self.ctx._ntrace is not None:
            self.ctx._ntrace.drain_all(wait=True)

    def _release_native(self) -> None:
        """Hand the pool's engine-side references back: tile payload slots
        and batch-class callbacks. The engine is per-CONTEXT while pools
        come and go — without this, every dead pool's payloads (and the
        pool itself, through the callback closures) stay pinned until the
        context goes. Called once the pool is fully drained."""
        with self._tiles_lock:
            nids = [t.nid for t in self._touched_tiles if t.nid is not None]
        cls_ids: List[int] = []
        for tc in self._classes.values():
            reg = getattr(tc, "_breg", None)
            if reg:
                cls_ids.extend(reg.values())
        if nids or cls_ids:
            self._neng.release_pool(nids, cls_ids)
        self._fast = None

    # -------------------------------------------------- native per-task lane
    def _run_lean(self, task: "DTDTask", tc: "DTDTaskClass",
                  tiles, arg_spec) -> None:
        """Side-effectful (``jit=False``) fused body: resolve payloads
        straight from the tiles, run it on host tensors, write WRITE flows
        back — the CPU chore without TaskData slot churn."""
        pend = task.pending_inputs
        batch_on = self._batch_on
        payloads = []
        for i, tile in enumerate(tiles):
            p = pend.pop(i, None) if pend else None
            if p is None and batch_on and tile.nid is not None:
                # batch-lane coherence: the engine slot holds the newest
                # payload while batched writers are in flight
                p = self._neng.slot_get(tile.nid)
            if p is None:
                copy = tile.data.newest_copy()
                if copy is None:
                    output.fatal(f"tile {tile!r} has no valid copy "
                                 f"for {task!r}")
                p = copy.payload
            payloads.append(_on_host(p))
        outs = _as_outputs(tc.fn(*[payloads[v] if kind == "flow" else v
                                   for kind, v in arg_spec]))
        oi = 0
        for i, acc in enumerate(tc.flow_accesses):
            if acc & WRITE:
                new = outs[oi] if oi < len(outs) else payloads[i]
                oi += 1
                tile = tiles[i]
                _land_host(tile, new)
                if batch_on and tile.nid is not None:
                    # mirror into the engine slot so batched readers see
                    # this write (slot_set bumps no batch-write counter:
                    # the version was bumped above)
                    self._neng.slot_set(tile.nid, new)

    def _lean_cycle(self, stream, task: "DTDTask") -> None:
        """The fused task cycle for native-lane side-effectful bodies:
        run, land outputs, retire, release successors — one call from the
        progress loop instead of the generic prepare/execute/complete FSM.
        With PINS enabled it fires the EXEC and COMPLETE/RELEASE pairs and
        the engine-successor mirror itself; ``--mca pins_paranoid 1``
        restores the full FSM (which also fires the PREPARE_INPUT pair)."""
        tc = task.task_class
        pins = self.ctx.pins
        pins_on = pins.enabled
        if pins_on:
            pins.fire(pins_mod.EXEC_BEGIN, stream, task)
        self._run_lean(task, tc, task.tiles, task.arg_spec)
        stream.nb_executed += 1
        if pins_on:
            pins.fire(pins_mod.EXEC_END, stream, task)
            pins.fire(pins_mod.COMPLETE_EXEC_BEGIN, stream, task)
            # engine-successor mirror for RELEASE consumers; complete()
            # below moves the engine's list out
            ntasks = self.ctx._dtd_ntasks
            task.successors = [ntasks[s]
                               for s in self._neng.successors(task.nid)
                               if s in ntasks]
            pins.fire(pins_mod.RELEASE_DEPS_BEGIN, stream, task)
        task.status = TASK_STATUS_COMPLETE
        task.completed = True
        with self._exec_lock:
            self._executed += 1
        ready_ids = self._neng.complete(task.nid)
        self.ctx._dtd_ntasks.pop(task.nid, None)
        task.tiles = ()
        task.arg_spec = ()
        task.data = ()
        task.pending_inputs = None
        if ready_ids:
            self._schedule_native_ready(ready_ids, stream)
        if pins_on:
            task.successors = None
            pins.fire(pins_mod.RELEASE_DEPS_END, stream, task)
            pins.fire(pins_mod.COMPLETE_EXEC_END, stream, task)
        self.addto_nb_tasks(-1)

    def _schedule_native_ready(self, ready_ids, stream=None) -> None:
        """Map newly-ready native task ids to their Python tasks and queue
        them (shared by the release path and the lean cycle)."""
        ntasks = self.ctx._dtd_ntasks
        rtasks = []
        for rid in ready_ids:
            rt = ntasks[rid]
            rt.deps_remaining = 0   # paranoid-check coherence
            rtasks.append(rt)
        self.ctx.schedule(rtasks, stream)

    def _flush_ready(self) -> None:
        """Hand the buffered ready-at-insert batch to the scheduler (and
        flush the batch-lane insert buffer: this doubles as the pool's
        progress-loop drain hook, so starving loops always see buffered
        work)."""
        if self._bbuf:
            self._flush_batch()
        if not self._ready_buf:
            return
        with self._exec_lock:
            buf = self._ready_buf
            self._ready_buf = []
        if buf:
            self.ctx.schedule(buf)

    # ------------------------------------------------------- flow control
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
        self._flush_ready()
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

    def _admission_stall(self) -> None:
        """Admission backpressure: the scheduler plane reported this pool
        past its admission window (in-flight inserted-but-not-completed
        tasks > --mca sched_admission_window / tp.admission_window), so
        the inserting thread HELPS DRAIN until the pool is back under.
        Same discipline as _window_stall: never blocks inside a task body,
        one elected drainer."""
        h = self._sched_pool
        if h is None:
            return
        plane = self.ctx.sched_plane
        if plane is None or not plane.over_window(h):
            return
        if self.ctx.in_progress_loop():
            return              # mid-body insert: never block flow control
        self._flush_ready()
        plane.count_stall(h)
        self.ctx.start()
        while plane.over_window(h):
            if self.ctx._error is not None or self._batch_retired:
                return
            if self._stall_lock.acquire(blocking=False):
                try:
                    self.ctx._progress_loop(
                        self.ctx.streams[0],
                        until=lambda: not plane.over_window(h))
                finally:
                    self._stall_lock.release()
                return
            time.sleep(50e-6)   # another user thread is draining

    # ------------------------------------------------------------- insert
    def insert_task(self, fn: Callable, *args, priority: int = 0,
                    where: int = DEV_ALL, name: Optional[str] = None,
                    jit: bool = True, batch: bool = False,
                    nowait: bool = False) -> Optional[DTDTask]:
        """parsec_dtd_insert_task (ref: insert_function.c:3617).

        ``args``: ``(tile, access)`` tuples become data flows; anything else
        is a by-value parameter. ``access`` may carry the NOTRACK bit to pass
        the tile's value without dependency tracking (ref PARSEC_DONT_TRACK),
        and the AFFINITY bit, which picks the task's rank in a distributed
        run (owner-computes; default: the first tracked WRITE tile's
        rank).

        ``jit=True`` (the default) declares the body a pure tensor function
        that may run as the CUDA chore; ``jit=False`` keeps a side-effectful
        body on the CPU device. ``batch=True`` lets the device module
        collapse compatible ready tasks into one dispatch. ``where`` is a
        device-type mask: it is recorded by capture, and an insert with
        anything but ``DEV_ALL`` stays off the batched lane.

        Returns the task, or None for an insert that a captured pool
        recorded or that rode the batched lane: on a context without a
        CUDA device, repeat inserts of an eligible class (same body fn,
        same flow shape) buffer their specs and link in the engine N at a
        time, with no per-task Python object. The FIRST insert of a class,
        and any ineligible insert (priority, NOTRACK/AFFINITY, ``where``,
        jittable body with by-value args), takes the per-task path and
        returns the task. Buffered inserts flush at window boundaries, at
        wait/close, and whenever a progress loop starves.

        Admission backpressure: past the scheduler plane's per-pool window
        the insert BLOCKS (helping drain) — or raises
        :class:`AdmissionBackpressure` with ``nowait=True``. The window is
        a soft limit: buffered-but-unflushed specs do not count against it.

        Thread-safe: concurrent user threads may insert into one pool — the
        whole linking path runs under the taskpool insert lock; window flow
        control runs AFTER the lock drops.
        """
        if nowait and self._sched_pool is not None:
            plane = self.ctx.sched_plane
            if plane is not None and plane.over_window(self._sched_pool):
                from ..core.sched_plane import SCHED_STATS
                SCHED_STATS["admission_rejects"] += 1
                raise AdmissionBackpressure(
                    f"taskpool {self.name!r} over its admission window "
                    f"(in-flight tasks > configured "
                    f"sched_admission_window)")
        # batch-lane fast path: NO lock — validate + spec build + buffer
        # append in one C call (try_buffer); the list append it performs
        # is GIL-atomic. A 0 return (unknown fn, shape mismatch, priority,
        # device restriction, un-entered tile) takes the per-task path
        fi = self._fast
        if fi is not None:
            r = self._tbuf(fi, fn, args, priority, where, jit, batch)
            if r:
                if r == 2:      # flush threshold reached
                    self._flush_batch()
                    self._window_stall()
                    if not nowait:
                        self._admission_stall()
                return None
        with self._insert_lock:
            task = self._insert_task_locked(fn, args, priority, where, name,
                                            jit, batch)
        self._window_stall()
        if not nowait:
            self._admission_stall()
        return task

    def _insert_task_locked(self, fn: Callable, args, priority: int,
                            where: int, name: Optional[str],
                            jit: bool, batch: bool) -> Optional[DTDTask]:
        if not self._open:
            output.fatal("insert_task on a closed DTD taskpool")
        if self._bbuf:
            # chain-order guarantee: buffered batch specs precede this
            # task in program order, so they must link first
            self._flush_batch_locked()
        if self._capture is not None and not self._capture_deferred:
            from .capture import CaptureDeferred
            try:
                self._capture.record(fn, args, jit=jit, name=name or "",
                                     priority=priority, where=where)
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
                PTDTD_STATS["capture_windows_deferred"] += 1
                n_rec = len(self._capture.ops)
                # capturable RUNS of the deferred window collapse into one
                # fused super-task insert each
                replays = self._capture.take_ops(
                    fuse=bool(mca.get("region_fusion", True)))
                self.inserted -= n_rec          # re-counted by the replay
                for rfn, rargs, rprio, rwhere, rname in replays:
                    nf = getattr(rfn, "_ptdtd_fused", 0)
                    if nf:
                        PTDTD_STATS["capture_regions_fused"] += 1
                        PTDTD_STATS["capture_tasks_fused"] += nf
                    self._insert_task_locked(rfn, rargs, rprio,
                                             DEV_ALL if rwhere is None
                                             else rwhere, rname or None,
                                             True, False)
                # fall through: THIS task inserts normally below
        flow_accesses: List[int] = []
        arg_spec: List[Tuple[str, Any]] = []
        tiles: List[DTDTile] = []
        affinity_tile: Optional[DTDTile] = None
        for a in args:
            if isinstance(a, tuple) and len(a) == 2 and isinstance(a[0], DTDTile):
                tile, acc = a
                if acc & AFFINITY:
                    affinity_tile = tile
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
        # class reuse), so the 5-tuple dict key is usually redundant.
        # Entry 6 is the batch-lane registration (engine class id + arg
        # kind pattern) the insert_task fast path matches against
        lc = self._last_class
        if lc is not None and lc[0] is fn and lc[1] == flow_accesses \
                and lc[2] == len(arg_spec) and lc[3] == jit and lc[4] == batch:
            tc = lc[5]
            binfo = lc[6]
        else:
            tc = self._class_of(fn, tuple(flow_accesses), len(arg_spec),
                                name, jit_ok=jit, batchable=batch)
            binfo = _BINFO_UNSET
            self._last_class = (fn, list(flow_accesses), len(arg_spec),
                                jit, batch, tc, None)
        task = DTDTask(self, tc, priority)
        task.arg_spec = arg_spec
        task.tiles = tiles
        task.ident = self.inserted
        self.inserted += 1

        neng = self._neng if self._neng_decided else self._native_engine()
        if neng is not None:
            # single-rank: owner-computes placement is the identity
            task.rank = self.ctx.my_rank
            if self._batch_on:
                if binfo is _BINFO_UNSET:
                    # register (or refuse) the batch-lane class for this
                    # arg interleaving so the NEXT insert can take the
                    # lock-free buffered fast path
                    binfo = self._mk_batch_info(tc, flow_accesses, arg_spec)
                    self._last_class = (fn, list(flow_accesses),
                                        len(arg_spec), jit, batch, tc, binfo)
                    if binfo is not None:
                        kinds = binfo[1]
                        if len(kinds) == 1 and kinds[0] is not None:
                            kinds = kinds[0]    # single-flow collapse
                        self._fast = (fn, jit, batch, kinds, binfo[0],
                                      self._bbuf, self._batch_flush_n,
                                      DTDTile)
                PTDTD_STATS["tasks_per_task"] += 1
            # native lane: per-tile chain linking and pred discovery happen
            # in ONE C call; Python keeps the id->task map plus a cheap
            # chain MIRROR (last_writer/readers/wcount) so tile
            # introspection keeps its documented meaning
            nids, naccs = [], []
            for fi, (tile, acc) in enumerate(zip(tiles, flow_accesses)):
                if acc & NOTRACK:
                    p = self._slot_payload(tile)
                    if p is not None:
                        if task.pending_inputs is None:
                            task.pending_inputs = {}
                        task.pending_inputs[fi] = p
                    continue
                nid = tile.nid
                if nid is None:
                    nid = self._tile_nid(tile)
                nids.append(nid)
                naccs.append(acc & 0x3)
                if acc & WRITE:
                    tile.last_writer = task
                    tile.readers = []
                    tile.compact_at = 32
                    tile.wcount += 1
                    tile.last_writer_version = tile.wcount
                else:
                    readers = tile.readers
                    if len(readers) >= tile.compact_at:
                        live = [r for r in readers if not r.completed]
                        live.append(task)
                        tile.readers = live
                        tile.compact_at = max(32, 2 * len(live))
                    else:
                        readers.append(task)
            # count-then-activate (ref: parsec_dtd_schedule_task_if_ready,
            # insert_function.c:2963): insert() links the chains but KEEPS
            # the insertion guard held, so a fast predecessor completing on
            # a worker thread cannot surface this id from complete() before
            # the id->task map below is populated (the activation race).
            # activate() drops the guard only after the task is findable
            tid, _held = neng.insert(nids, naccs)
            PTDTD_STATS["tasks_native"] += 1
            task.nid = tid
            self.ctx._dtd_ntasks[tid] = task
            self.addto_nb_tasks(1)
            self.local_inserted += 1
            if neng.activate(tid) == 0:
                task.deps_remaining = 0
                # ready now — but insert_task is ASYNCHRONOUS by contract
                # (bodies run at the window stall / wait drain, never at
                # insert): batch toward the scheduler so priorities stay
                # policy-visible while the push cost amortizes. The lock
                # pairs the append with the flusher's swap
                with self._exec_lock:
                    buf = self._ready_buf
                    buf.append(task)
                if len(buf) >= 1024:
                    self._flush_ready()
            return task     # window stall runs after the insert lock drops

        task.lock = threading.Lock()      # Python engine: preds/release lock
        task.successors = []
        # owner-computes rank (ref: rank from affinity tile's rank_of_key);
        # untracked flows don't steer placement
        if affinity_tile is None:
            for t, acc in zip(tiles, flow_accesses):
                if acc & WRITE and not acc & NOTRACK:
                    affinity_tile = t
                    break
            if affinity_tile is None:
                # the fallback prefers tracked flows too: an untracked
                # scratch tile is rank-local and would diverge owner-computes
                # placement across the distributed replay
                tracked = [t for t, acc in zip(tiles, flow_accesses)
                           if not acc & NOTRACK]
                if tracked:
                    affinity_tile = tracked[0]
                elif tiles:
                    affinity_tile = tiles[0]
        task.rank = affinity_tile.rank if affinity_tile is not None \
            else self.ctx.my_rank
        distributed = self.ctx.comm is not None and self.ctx.nb_ranks > 1
        remote = distributed and task.rank != self.ctx.my_rank
        # link against each tile's chain (ref: parsec_dtd_set_params_of_task
        # insert_function.c:2896; WAR via overlap_strategies.c). In
        # distributed mode every rank replays the same sequence, so the
        # version bookkeeping below is globally consistent without messages
        for fi, (tile, acc) in enumerate(zip(tiles, flow_accesses)):
            self._link_tile(task, tile, acc, fi, remote, distributed)
        if remote:
            # shadow task: executes elsewhere; local role is only data routing
            self.ctx.comm.dtd_remote_task(self, task)
            return task
        self.addto_nb_tasks(1)
        self.local_inserted += 1
        if task.dep_satisfied():
            # ref: parsec_dtd_schedule_task_if_ready (insert_function.c:2963)
            self.ctx.schedule([task])
        return task     # window stall runs after the insert lock drops

    def _link_tile(self, task: DTDTask, tile: DTDTile, acc: int,
                   flow_index: int, remote: bool = False,
                   distributed: bool = False) -> None:
        if acc & NOTRACK:
            # untracked access: no chaining, no version bump, no comm
            # bookkeeping, no audit entry — and the
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
        my = self.ctx.my_rank
        preds: List[DTDTask] = []
        with tile.lock:
            read_version = tile.wcount
            src_rank = tile.writer_rank
            # the producer of read_version — captured BEFORE the write side
            # below replaces last_writer (the consumer must attach its send
            # to the task that PRODUCES the version it reads, not to itself)
            prev_writer = tile.last_writer
            if acc & READ or not (acc & WRITE):
                # RAW: predecessor is the last writer (local chain) or a
                # remote version expectation / outbound send
                if tile.last_writer is not None and \
                        (not distributed or tile.last_writer.rank == my):
                    preds.append(tile.last_writer)
                if not remote:
                    readers = tile.readers
                    if len(readers) >= tile.compact_at:
                        # amortized compaction: completed readers are
                        # already-satisfied WAR predecessors — pruning them
                        # keeps long read-chains from growing unboundedly
                        # between writes. The watermark doubles past the
                        # survivors so a burst of never-retiring readers
                        # costs O(n log n) total, not a full rescan per
                        # insert
                        live = [r for r in readers if not r.completed]
                        live.append(task)
                        tile.readers = live
                        tile.compact_at = max(32, 2 * len(live))
                    else:
                        readers.append(task)
            if acc & WRITE:
                # WAR: wait on local readers since the previous write; WAW
                # on the local last writer (remote ones are covered by the
                # version expectation on the READ side of RW, or need no
                # local ordering at all)
                for r in tile.readers:
                    if not distributed or r.rank == my:
                        preds.append(r)
                if tile.last_writer is not None and \
                        (not distributed or tile.last_writer.rank == my) and \
                        tile.last_writer not in preds:
                    preds.append(tile.last_writer)
                tile.last_writer = task
                tile.readers = []
                tile.compact_at = 32
                tile.wcount += 1
                tile.last_writer_version = tile.wcount
                tile.writer_rank = task.rank
        if self._audit and not tile.new_tile:
            # deterministic digest of this link decision (crc32: stable
            # across processes, unlike str hash under PYTHONHASHSEED): all
            # ranks replay the same COLLECTION-BACKED inserts, so the
            # chains must agree (tile_new scratch tiles are rank-local by
            # contract and excluded). Collection keys are (dc.name,
            # data_key) with int/str parts, byte-compiled by a %-format;
            # other keys go through repr
            key = tile.key
            if type(key) is tuple and len(key) == 2 and \
                    isinstance(key[1], (int, str)):
                item = b"%s\x00%a\x00%d\x00%d\x00%d\x00%d" % (
                    key[0].encode(), key[1], acc & 0x3, read_version,
                    src_rank, task.rank)
            else:
                item = repr((key, acc & 0x3, read_version, src_rank,
                             task.rank)).encode()
            self._audit_digest = zlib.crc32(item, self._audit_digest)
            self._audit_count += 1
        if distributed:
            comm = self.ctx.comm
            needs_data = bool(acc & READ)   # pure WRITE flows ship nothing
            if not remote and needs_data and src_rank != my:
                # local consumer of a remotely-produced version
                comm.expect(self, task, tile, read_version, src_rank,
                            flow_index)
            elif remote and needs_data and src_rank == my:
                # remote consumer of a locally-held/produced version
                comm.note_send(self, tile, read_version, task.rank,
                               writer=prev_writer)
        if remote:
            return
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
        batch_on = self._batch_on
        for i, tile in enumerate(task.tiles):
            pend = pending.pop(i, None) if pending else None
            if pend is None and batch_on and tile.nid is not None:
                # batch-lane coherence: in-flight batched writes live in
                # the engine slot, not yet in tile.data (synced at wait)
                p = self._neng.slot_get(tile.nid)
                copy = tile.data.newest_copy()
                if p is not None and (copy is None or p is not copy.payload):
                    pend = p
            if pend is not None:
                # a value snapshotted at insert, or a slot payload: an
                # unattached copy carries the right Data for write-back
                # without perturbing newest_copy resolution
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
                task.data[i].data_out = _land_host(tile, new)
                if self._batch_on and tile.nid is not None:
                    # keep the engine slot coherent for batched readers
                    # (no batch-write count: version bumped above)
                    self._neng.slot_set(tile.nid, new)
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
        if task.nid >= 0 and self.ctx.pins.enabled:
            # instrumentation mirror: the native engine owns the successor
            # lists, but PINS consumers read task.successors at
            # RELEASE_DEPS_BEGIN — which fires after this hook and before
            # _release_deps moves the engine's list. Only per-task-lane
            # successors have Python task objects
            ntasks = self.ctx._dtd_ntasks
            task.successors = [ntasks[s]
                               for s in self._neng.successors(task.nid)
                               if s in ntasks]
        return HOOK_DONE

    @property
    def executed(self) -> int:
        return self._executed

    def _release_deps(self, stream, task: DTDTask) -> None:
        """DTD successor release (ref: parsec_dtd_ordering_correctly,
        insert_function_internal.h:277): flip completed, wake successors."""
        if task.nid >= 0:
            # native lane: the successor walk + newly-ready collection is
            # one C call
            task.completed = True
            ready_ids = self._neng.complete(task.nid)
            self.ctx._dtd_ntasks.pop(task.nid, None)
            task.tiles = ()
            task.arg_spec = ()
            task.data = ()
            task.pending_inputs = None
            task.successors = None   # drop the instrumentation mirror
            if ready_ids:
                self._schedule_native_ready(ready_ids, stream)
            return
        with task.lock:
            task.completed = True
            succs = task.successors
            task.successors = []
        # ship remote sends FIRST: the payloads must be snapshotted before
        # any released successor can write the tile again
        if self.ctx.comm is not None:
            self.ctx.comm.dtd_task_completed(self, task)
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

    def wait_mesh(self, mesh, axis_names=None) -> bool:
        """Capture-mode only: execute the recorded window as one
        owner-computes program over ``mesh``, a 2-D ``DeviceMesh`` of the
        process group's ranks, each of which calls this on its own
        single-rank context with the same recording (see
        :meth:`~parsec_tpu_torch.dsl.capture.GraphCapture.execute_mesh`)."""
        if self._capture is None:
            output.fatal("wait_mesh requires DTDTaskpool(capture=True)")
        self._capture.execute_mesh(mesh, axis_names)
        return True

    def wait(self, timeout: Optional[float] = None) -> bool:
        """parsec_dtd_taskpool_wait: drain everything this rank executes
        (a captured pool: execute the recorded window as one program)."""
        if self._capture is not None:
            if not self._capture_deferred:
                self._capture.execute()
                return True
            # deferred window: its tasks went through the scheduler — drain
            # them like an uncaptured pool, then re-arm capture (the batch
            # fast path too must record again, not buffer)
            self._capture_deferred = False
            self._fast = None
        if self._audit and self.ctx.comm is not None and self.ctx.nb_ranks > 1:
            # replay audit BEFORE blocking on completion: a divergent insert
            # sequence surfaces as a fatal here instead of a silent hang
            self.ctx.comm.audit_check(self, self._audit_digest,
                                      self._audit_count)
        self._flush_ready()
        self.ctx.start()
        target = self.local_inserted
        self.ctx._progress_loop(self.ctx.streams[0],
                                until=lambda: self.executed >= target and
                                self.nb_tasks == 0,
                                timeout=timeout)
        done = self.executed >= target
        if done:
            # slot-ownership hand-off: batched writes land back in
            # tile.data now that the pool is drained
            self._sync_slots()
            self._land_trace()
        return done

    def close(self) -> None:
        """End of insertion: drop the open action so termination can fire."""
        self._fast = None     # closed pools must fatal via the slow path
        if self._capture is not None and self._capture.ops:
            # scheduler-mode inserts execute without an explicit wait();
            # captured ops must not be silently dropped on close
            self._capture.execute()
        self._flush_ready()
        if self._neng is not None:
            self.ctx.unregister_drain_hook(self._flush_ready)
        if self._open:
            self._open = False
            self.addto_nb_pending_actions(-1)

    def __enter__(self) -> "DTDTaskpool":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.wait()
        self.close()
