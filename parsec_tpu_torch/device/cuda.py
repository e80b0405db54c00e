"""CUDA device module: async kernel dispatch, device tile heap, stage in/out.

This module stands where parsec/mca/device/cuda + the generic GPU runtime
(parsec/mca/device/device_gpu.c) stand in the reference:

* ``kernel_scheduler`` mirrors parsec_device_kernel_scheduler
  (device_gpu.c:3376): the calling worker enqueues and returns ``HOOK_ASYNC``;
  whichever thread wins the manager try-lock drives the device (the CAS
  owner/manager model of device_gpu.c:3398-3424).
* One CUDA stream per device carries every copy and kernel the module issues
  (PaRSEC's C splits push/exec/pop over streams[0..n],
  device_gpu.c:3438-3515; the TPU runtime this port follows has no such
  split, and neither has the port). A ``torch.cuda.Event``
  recorded after each submit plays the completion event, polled with
  ``query()`` (ref: parsec_device_progress_stream, device_gpu.c:2593). The
  native device lane (:mod:`.native`) launches on a stream of its own but
  issues its stage-ins on this one, so every transfer into the card is on
  this stream; a tile the lane computed reaches this module only after the
  lane's event for it completed, and the lane marks such a tile used on
  this stream (``record_stream``) so its block is not recycled under a
  reader queued here.
* Stage-in re-creates parsec_device_data_stage_in (device_gpu.c:1800):
  version-checked transfer from the newest copy (host tensor or another
  device's tensor) via ``Tensor.to(device, non_blocking=True)``.
* The device tile heap re-creates the LRU management of
  parsec_device_data_reserve_space (device_gpu.c:1210): resident copies are
  tracked in an LRU; exceeding the byte budget evicts the least recently used
  unpinned copy, writing back owned ones first (the w2r task role,
  transfer_gpu.c). With the native device lane's module on (``--mca
  device_native``, the default), the C coherency table (``CohTable``,
  csrc/ptdev.cpp) is the residency authority: it decides whether a
  stage-in needs a transfer (the version check), keeps the LRU order and
  the budget and picks the eviction victims; this module performs the
  transfers and write-backs, and its ``_lru`` becomes the mirror the tests
  inspect. Every resident tile also holds a segment of a zone ledger
  (:mod:`..utils.zone_malloc`, the reference's zone_malloc heap) so
  occupancy and fragmentation are first-class stats (:meth:`zone_stats`).
* Task batching (parsec_gpu_task_collect_batch, device_gpu.c:2229):
  compatible queued tasks are handed to a batch hook in one dispatch when the
  task class opts in.
* Profiling (ref: per-GPU-stream profiling streams, profiling.h:146-440):
  with a tracer on the context, the module records one ``<name>::exec``
  interval per task on a stream of its own — START when the body is
  launched (after its stage-ins), END in the epilog, once the task's
  completion event has been observed — and one ``<name>::mem`` POINT per
  residency change, carrying the resident bytes after it (read by
  ``tools/mem_view``). The span is host-side: it covers the launch, the
  queueing on the stream and the poll that saw the event complete, not
  the kernel's device time, which belongs to torch.profiler.
* :func:`make_cuda_hook` builds the chore hook of a PTG ``BODY
  [type=CUDA]`` (the generated GPU hook, jdf2c.c:6613). PTG intermediates
  ride as tensors with no backing ``Data``: they bypass the tile heap and
  are only placed on the card.

Test mode (``--mca device_cuda_over_cpu 1`` on a ``device="cpu"`` context)
registers the same module over CPU tensors with events that are complete at
once, so the whole device logic runs without a card.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import (Any, Callable, Deque, Dict, List, Optional, Sequence,
                    Tuple)

import torch

from ..core.task import (DEV_CUDA, FLOW_ACCESS_CTL, FLOW_ACCESS_WRITE,
                         HOOK_ASYNC, HOOK_DONE, Task)
from ..data.data import (COHERENCY_INVALID, COHERENCY_OWNED, COHERENCY_SHARED,
                         Data, DataCopy)
from ..utils import mca, output
from ..utils.trace import EVENT_FLAG_END, EVENT_FLAG_POINT, EVENT_FLAG_START
from .device import DeviceModule

mca.register("device_cuda_max_bytes", 0,
             "Device tile-heap budget in bytes (0 = 75% of the device memory "
             "free at discovery)", type=int)
mca.register("device_cuda_max_inflight", 64,
             "Max concurrently dispatched device tasks", type=int)
mca.register("device_cuda_batch_max", 16,
             "Max compatible tasks collapsed into one batched dispatch",
             type=int)
mca.register("device_cuda_over_cpu", False,
             "TEST MODE: register the device module over CPU tensors on a "
             "device='cpu' context", type=bool)


class _DoneEvent:
    """Completion event of the CPU test mode: the work ran synchronously."""

    @staticmethod
    def query() -> bool:
        return True


_DONE = _DoneEvent()


class CUDATask:
    """Device-side task descriptor (ref: parsec_gpu_task_t, device_gpu.h:117-155)."""

    __slots__ = ("task", "submit", "batchable", "batch_submit", "load",
                 "out_arrays", "event", "oom_retries", "pinned", "trace_span")

    def __init__(self, task: Task, submit: Callable, batchable: bool = False,
                 batch_submit: Optional[Callable] = None) -> None:
        self.task = task
        self.submit = submit          # submit(device, task, inputs)->outputs
        self.batchable = batchable
        #: batch_submit(device, tasks, inputs_list) -> list of output tuples;
        #: compatible queued tasks collapse into one dispatch
        #: (ref: parsec_gpu_task_collect_batch, device_gpu.c:2229)
        self.batch_submit = batch_submit
        self.load = 0.0
        self.out_arrays: Optional[Sequence[Any]] = None
        #: recorded on the device stream right after the submit; the task
        #: is complete once it reports done
        self.event: Any = None
        self.oom_retries = 0
        #: device copies whose ``readers`` count this inflight task holds
        #: (pinned against eviction between stage-in and epilog, ref:
        #: the readers guard of parsec_device_data_stage_in/epilog,
        #: device_gpu.c:1210,1800)
        self.pinned: List[Any] = []
        #: its open exec span: (the trace stream its START went to, the END
        #: key, the span's id), or None (not traced). The id is unique a
        #: span, since DTD tasks share their class's key; the END goes to
        #: the START's stream even if the context's tracer changed between
        self.trace_span: Optional[Tuple[Any, int, int]] = None


class CUDADevice(DeviceModule):
    """One CUDA card (or, in test mode, the CPU) as a PaRSEC-style device
    module."""

    def __init__(self, torch_device: torch.device) -> None:
        on_card = torch_device.type == "cuda"
        super().__init__(f"cuda({torch_device.index})" if on_card
                         else "cuda-over-cpu", DEV_CUDA)
        self.torch_device = torch_device
        #: the one stream every copy and kernel of this module runs on
        self.stream = torch.cuda.Stream(torch_device) if on_card else None
        # crude per-card speed for ETA selection; real estimates come from
        # task-class time_estimate properties
        self.gflops = 100_000.0
        self._pending: Deque[CUDATask] = collections.deque()
        self._inflight: Deque[CUDATask] = collections.deque()
        self._manager_lock = threading.Lock()  # the CAS mutex (device_gpu.c:3408)
        self._fifo_lock = threading.Lock()
        self.batched_dispatches = 0
        # LRU tile heap bookkeeping (ref: gpu_mem_lru / gpu_mem_owned_lru)
        self._lru: "collections.OrderedDict[Any, DataCopy]" = collections.OrderedDict()
        self._lru_sizes: Dict[Any, int] = {}   # accounted bytes per key
        self._lru_segs: Dict[Any, Any] = {}    # key -> zone ledger segment
        self._resident_bytes = 0
        self.evictions = 0          # copies evicted (budget pressure stat)
        self.pinned_skips = 0       # eviction walks that skipped a pinned copy
        budget = mca.get("device_cuda_max_bytes", 0)
        if not budget and on_card:
            free, _total = torch.cuda.mem_get_info(torch_device)
            budget = int(free * 0.75)
        self._budget = budget or (12 << 30)
        # the heap ledger: every resident tile owns a zone segment (offset
        # + size); the caching allocator owns the physical bytes. 64 KiB
        # units keep the ledger close to the byte-exact accounting even
        # for small tiles
        from ..utils.zone_malloc import ZoneMalloc
        self._zone = ZoneMalloc(self._budget, unit=65536)
        # the native coherency/residency table: C owns the POLICY (LRU
        # order, budget, the stage-in version check, victim selection),
        # Python the payloads and the write-back mechanism
        from .native import make_coh_table
        self._ncoh = make_coh_table(self._budget)
        #: bytes that captured programs of this card hold (their static
        #: buffers, stacked stores and graph pools), counted against the
        #: budget beside the resident tiles (dsl/capture.py charges them)
        self.program_bytes = 0
        #: called at :meth:`fini` (graph capture releases this card's
        #: programs there)
        self.fini_hooks: List[Callable[[], None]] = []
        # the tracer the stream and keywords are bound to (_prof), and the
        # exec spans' ids
        self._prof_ref = None
        self._prof_stream = None
        self._prof_keys = None
        self._exec_ids = itertools.count(1)
        # serializes the residency mirror (_lru/_lru_sizes/_lru_segs/_zone/
        # _resident_bytes and the reader pins): worker threads mutate it
        # from stage-ins and epilogs and the device lane's manager thread
        # from its stage-ins, and the compound updates are not GIL-atomic
        self._heap_lock = threading.RLock()

    @staticmethod
    def res_key(data: Data) -> int:
        """The residency key of a datum. ``data.key`` is only unique per
        collection (A(0,0)/B(0,0)/C(0,0) all carry key 0), so the Data
        object's identity is the key: a resident entry's DataCopy pins its
        Data, so the id cannot be reused while the entry lives."""
        return id(data)

    def _coh_pin(self, data: Optional[Data]) -> None:
        if self._ncoh is not None and data is not None:
            self._ncoh.pin(self.res_key(data))

    def _coh_unpin(self, data: Optional[Data]) -> None:
        if self._ncoh is not None and data is not None:
            self._ncoh.unpin(self.res_key(data))

    def _coh_mark_owned(self, data: Data, copy: DataCopy) -> None:
        """Writer completed on this device: the table's entry becomes the
        OWNER at the new version (the epilog bump); growth past the budget
        returns eviction victims to apply."""
        if self._ncoh is None:
            return
        victims = self._ncoh.mark_owned(self.res_key(data),
                                        data.version & 0xFFFFFFFF,
                                        _nbytes(copy.payload))
        if victims:
            self._apply_victims(victims)

    def adopt_copy(self, data: Data, copy: DataCopy) -> None:
        """A copy that arrived already resident on this card (a remote
        payload the comm layer landed here, ``comm/remote_dep.py``): the
        residency mirror and the table take it at the datum's version, so
        the next stage-in of that version is a hit with no transfer. It is
        taken as owned: the host copy may hold the same tensor, and an
        eviction then writes it back to host memory."""
        self._lru_touch(self.res_key(data), copy)
        self._coh_mark_owned(data, copy)

    def _apply_victims(self, victims) -> None:
        """Commit the C table's eviction decisions: write back + invalidate
        each victim ATOMICALLY with its version check (Data.evict_copy),
        then update the mirror (sizes, zone ledger, counters). Policy came
        from C; this is pure mechanism."""
        with self._heap_lock:
            self._apply_victims_locked(victims)

    def _apply_victims_locked(self, victims) -> None:
        for key, _owned in victims:
            copy = self._lru.get(key)
            if copy is None:
                continue
            if copy.readers > 0:
                # a Python-side pin the table could not see: veto the
                # eviction — the table already dropped its entry, so the
                # next stage-in simply re-reserves, and the reader keeps
                # its payload
                self.pinned_skips += 1
                continue
            self._lru.pop(key)
            self._evict_key_locked(key, copy, drop_table=False)

    def _evict_key_locked(self, key: Any, copy: DataCopy,
                          drop_table: bool) -> None:
        """The ONE eviction mechanism (heap lock held, ``key`` already out
        of ``_lru``): mirror bookkeeping, the atomic write-back +
        invalidate (Data.evict_copy), and the counters. ``drop_table``
        removes the C entry too (the Python LRU decided the victim itself;
        C-decided victims already left the table)."""
        freed = self._lru_sizes.pop(key, 0)
        self._resident_bytes -= freed
        seg = self._lru_segs.pop(key, None)
        if seg is not None:
            seg.free()
        data = copy.original
        wrote = False
        if data is not None:
            _evicted, wrote = data.evict_copy(self.device_index)
        else:
            copy.coherency_state = COHERENCY_INVALID
            copy.payload = None
        if wrote:
            self.transfer_out_bytes += freed
            if self._ncoh is not None:
                self._ncoh.count_writeback(freed)
        if drop_table and self._ncoh is not None:
            self._ncoh.drop(key)
        self.evictions += 1
        self._trace_mem(-freed)

    def coh_stats(self) -> Optional[Dict[str, int]]:
        """The native coherency/residency counters, or None when the table
        is off (the Python LRU is the policy then)."""
        return None if self._ncoh is None else self._ncoh.stats()

    def _on_stream(self):
        """Context in which this module's copies and kernels are issued."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def _record_event(self):
        if self.stream is None:
            return _DONE
        ev = torch.cuda.Event()
        ev.record(self.stream)
        return ev

    # ------------------------------------------------------------- dispatch API
    def kernel_scheduler(self, stream, task: Task,
                         cuda_task: CUDATask) -> int:
        """Enqueue a device task; ref: parsec_device_kernel_scheduler
        (device_gpu.c:3376). Returns HOOK_ASYNC immediately."""
        cuda_task.load = self.time_estimate(task)
        self.load_add(cuda_task.load)
        with self._fifo_lock:
            self._pending.append(cuda_task)
        # opportunistically become the manager right away
        self.progress(stream)
        return HOOK_ASYNC

    # ------------------------------------------------------------- progress
    def progress(self, stream) -> int:
        """Manager drive: submit pending, poll events, run epilogs.

        Only one thread at a time is the manager (try-lock = the CAS in
        device_gpu.c:3398-3424); others return immediately after enqueueing.
        """
        if not self._pending and not self._inflight:
            # idle fast-path: this poll sits in every hot-loop iteration (an
            # enqueue racing this check is picked up on the next iteration)
            return 0
        if not self._manager_lock.acquire(blocking=False):
            return 0
        try:
            completed = 0
            max_inflight = mca.get("device_cuda_max_inflight", 64)
            # kernel_push + kernel_exec phases (device_gpu.c:2746,2874)
            batch_max = mca.get("device_cuda_batch_max", 16)
            while len(self._inflight) < max_inflight:
                with self._fifo_lock:
                    if not self._pending:
                        break
                    head = self._pending[0]
                    # batchable head while the device is busy: let the batch
                    # accumulate — deferral is free, the card has work
                    # (the collect discipline of parsec_gpu_task_collect_batch)
                    if (head.batchable and head.batch_submit is not None and
                            self._inflight and
                            len(self._pending) < batch_max):
                        break
                    gt = self._pending.popleft()
                    group = [gt]
                    # collect compatible pending tasks into one dispatch
                    if gt.batchable and gt.batch_submit is not None:
                        while (self._pending and len(group) < batch_max and
                               self._pending[0].batchable and
                               self._pending[0].batch_submit == gt.batch_submit and
                               self._pending[0].task.task_class is gt.task.task_class):
                            group.append(self._pending.popleft())
                if len(group) > 1:
                    submitted = self._submit_group(group)
                    if len(submitted) == len(group):
                        self.batched_dispatches += 1
                else:
                    submitted = group if self._submit_one_retry(gt) else []
                self._inflight.extend(submitted)
            # event polling + kernel_pop/epilog: poll each task's event
            # independently — inflight tasks are mutually independent (their
            # deps only release at epilog), so one slow kernel must not
            # head-of-line block completed peers behind it (ref: per-stream
            # event polls, device_gpu.c:2593,2944,3179)
            still: Deque[CUDATask] = collections.deque()
            while self._inflight:
                gt = self._inflight.popleft()
                if gt.event is not None and not gt.event.query():
                    still.append(gt)
                    continue
                self._epilog(stream, gt)
                completed += 1
            self._inflight = still
            return completed
        finally:
            self._manager_lock.release()

    # ------------------------------------------------------------- internals
    def _stage_in_copy(self, data: Data, access: int,
                       pin: bool = False) -> DataCopy:
        """Version-checked stage-in (ref: parsec_device_data_stage_in
        device_gpu.c:1800). Returns the device-resident copy.

        With the native table up, the residency decision — is a copy of
        exactly this version resident, and which victims must leave to
        make room — is C's (``CohTable.stage_in`` does the early reserve of
        the push stage); this method stays the transfer MECHANISM.
        ``pin=True`` takes the eviction pin INSIDE the table's reserve
        critical section (a concurrent stage-in on another thread could
        otherwise evict this entry between the reserve and the caller's
        pin) and bumps the Python reader count to match — release with
        :meth:`unpin_copy`."""
        dev_idx = self.device_index
        copy = data.get_copy(dev_idx)
        newest = data.newest_copy()
        if self._ncoh is not None and newest is not None:
            need, victims = self._ncoh.stage_in(
                self.res_key(data), _nbytes(newest.payload),
                newest.version & 0xFFFFFFFF, 0, 1 if pin else 0)
            if victims:
                self._apply_victims(victims)
            if self.program_bytes:
                self._fit_programs()
            if not need and copy is not None and \
                    copy.version == newest.version and \
                    copy.coherency_state != COHERENCY_INVALID:
                self._lru_touch(self.res_key(data), copy)
                if pin:
                    with self._heap_lock:
                        copy.readers += 1     # table half pinned above
                return copy
            # the table said transfer (or the mirror lost the payload: the
            # stale table entry was already replaced by stage_in)
        elif copy is not None and newest is not None and \
                copy.version == newest.version and \
                copy.coherency_state != COHERENCY_INVALID:
            self._lru_touch(self.res_key(data), copy)
            if pin:
                self.pin_copy(copy)
            return copy
        src = newest
        if src is None:
            raise RuntimeError(f"no valid copy to stage in for {data!r}")
        payload = torch.as_tensor(src.payload)
        nbytes = _nbytes(payload)
        if self._ncoh is None:
            self._reserve(nbytes)   # native mode: stage_in reserved above
        arr = payload.to(self.torch_device, non_blocking=True)  # async H2D
        if copy is None:
            copy = data.create_copy(dev_idx, arr, COHERENCY_SHARED)
        else:
            copy.payload = arr
            copy.coherency_state = COHERENCY_SHARED
        copy.version = src.version
        self.transfer_in_bytes += nbytes
        self._lru_touch(self.res_key(data), copy)
        if pin:
            if self._ncoh is not None:
                with self._heap_lock:
                    copy.readers += 1     # table half pinned in stage_in
            else:
                self.pin_copy(copy)
        return copy

    def lane_stage_in(self, data: Data, pin: bool = False) -> DataCopy:
        """Stage-in entry of the native device lane's dispatch (the push
        phase of ptdev): version-checked through the C table, asynchronous,
        returns the device copy — pinned atomically with the reserve when
        ``pin``. The transfer is issued on this module's stream, the card's
        one push stream: the module's own readers of the copy are behind it
        in stream order, and the lane orders its stream after this one
        before its launches read the copy."""
        with self._on_stream():
            return self._stage_in_copy(data, 0, pin=pin)

    # ------------------------------------------------------------ profiling
    def _prof(self):
        """The module's profiling stream, lazily bound to ctx.profiling
        (None without a tracer) and bound anew when the context's tracer
        changes, so each tracer's dump holds the events recorded while it
        was attached."""
        prof = getattr(self.context, "profiling", None)
        if prof is None:
            return None
        if prof is not self._prof_ref:
            self._prof_stream = prof.stream(self.name)
            self._prof_keys = prof.add_dictionary_keyword(f"{self.name}::exec")
            # memory-ledger events (the dbp2mem surface, tools/profiling/
            # dbp2mem.c): every residency change is a POINT event carrying
            # the post-change occupancy, rendered over time by
            # parsec_tpu_torch.tools.mem_view
            self._mem_key = prof.add_dictionary_keyword(
                f"{self.name}::mem", info_desc="resident{q};delta{q}")[0]
            self._prof_ref = prof
            self._mem_seq = 0
        return self._prof_stream

    def _trace_mem(self, delta: int) -> None:
        """Record a residency change (bytes) on the device's trace stream;
        called with the heap lock held, so the events are in update order."""
        ps = self._prof()
        if ps is None or delta == 0:
            return
        self._mem_seq += 1
        ps.trace(self._mem_key, self._mem_seq, 0, EVENT_FLAG_POINT,
                 self._prof_ref.pack_info(f"{self.name}::mem",
                                          resident=self._resident_bytes,
                                          delta=delta))

    def _trace_launch(self, ps, gt: CUDATask, t0: float) -> None:
        """The START of a task's exec span, stamped ``t0`` (taken before
        the launch) and appended only once the launch succeeded, so an OOM
        retry leaves one START for its one END."""
        sid = next(self._exec_ids)
        gt.trace_span = (ps, self._prof_keys[1], sid)
        ps.events.append((self._prof_keys[0], sid,
                          gt.task.taskpool.taskpool_id, t0, EVENT_FLAG_START,
                          b""))

    def _submit_one(self, gt: CUDATask) -> None:
        ps = self._prof()
        with self._on_stream():
            inputs = self._gather_inputs(gt)
            t0 = time.perf_counter()
            gt.out_arrays = _as_tuple(gt.submit(self, gt.task, inputs))
            gt.event = self._record_event()
        if ps is not None:
            self._trace_launch(ps, gt, t0)

    def _gather_inputs(self, gt: CUDATask) -> List[Any]:
        task = gt.task
        inputs: List[Any] = []
        for flow in task.task_class.flows:
            slot = task.data[flow.flow_index]
            if flow.access & FLOW_ACCESS_CTL or slot.data_in is None:
                inputs.append(None)
                continue
            data = getattr(slot.data_in, "original", None)
            if data is None:
                # a PTG intermediate (a tensor, or a copy attached to no
                # Data): no heap entry, just placed on the card
                payload = getattr(slot.data_in, "payload", slot.data_in)
                inputs.append(None if payload is None else
                              torch.as_tensor(payload).to(
                                  self.torch_device, non_blocking=True))
                continue
            # pin between stage-in and epilog: the eviction walks skip copies
            # with readers > 0, so an inflight task's inputs can never be
            # evicted under it (device_gpu.c:1210)
            dev_copy = self._stage_in_copy(data, flow.access, pin=True)
            slot.data_in = dev_copy
            gt.pinned.append(dev_copy)
            inputs.append(dev_copy.payload)
        return inputs

    def _unpin(self, gt: CUDATask) -> None:
        """Drop this task's reader pins (epilog or failed submit)."""
        for copy in gt.pinned:
            self.unpin_copy(copy)
        gt.pinned.clear()

    def _submit_one_retry(self, gt: CUDATask) -> bool:
        """Submit with the OOM -> evict -> retry -> reschedule discipline of
        device_gpu.c. Returns True when dispatched; False when the task was
        bounced back to the scheduler."""
        try:
            self._submit_one(gt)
            return True
        except Exception as e:  # noqa: BLE001 - only OOM is retried
            self._unpin(gt)     # the retry re-gathers (and re-pins) inputs
            if not _is_oom(e):
                self.load_sub(gt.load)
                output.fatal(f"CUDA submit failed for {gt.task!r}: {e}")
            freed = self.evict_bytes(max(self._resident_bytes // 2, 1))
            try:
                self._submit_one(gt)
                return True
            except Exception as e2:  # noqa: BLE001 - only OOM is retried
                self._unpin(gt)
                if not _is_oom(e2):
                    self.load_sub(gt.load)
                    output.fatal(f"CUDA submit failed for {gt.task!r}: {e2}")
                gt.oom_retries += 1
                if freed == 0 or gt.oom_retries > 8:
                    output.fatal(
                        f"task {gt.task!r} does not fit in device memory "
                        f"(resident={self._resident_bytes}, "
                        f"retries={gt.oom_retries})")
                self.load_sub(gt.load)
                self.context.schedule([gt.task])
                return False

    def _submit_group(self, group: List[CUDATask]) -> List[CUDATask]:
        """One dispatch for a batch of compatible independent tasks; a batch
        that fails (a stage-in out of memory) is resubmitted task by task
        under the OOM discipline. Returns the tasks actually dispatched."""
        ps = self._prof()
        try:
            with self._on_stream():
                inputs_list = [self._gather_inputs(g) for g in group]
                t0 = time.perf_counter()
                outs_list = group[0].batch_submit(
                    self, [g.task for g in group], inputs_list)
                ev = self._record_event()
        except Exception as e:  # noqa: BLE001 - retried task by task below
            output.debug_verbose(2, "device",
                                 f"batch of {len(group)} resubmitted: {e}")
            # unpin EVERY member (a stage-in failure mid-gather leaves
            # earlier members pinned); per-task retries re-gather + re-pin
            for g in group:
                self._unpin(g)
            return [g for g in group if self._submit_one_retry(g)]
        for g, outs in zip(group, outs_list):
            g.out_arrays = _as_tuple(outs)
            g.event = ev
            if ps is not None:
                self._trace_launch(ps, g, t0)
        return group

    def _epilog(self, stream, gt: CUDATask) -> None:
        """parsec_device_kernel_epilog (device_gpu.c:3179): attach outputs,
        bump versions, then complete the task."""
        task = gt.task
        tc = task.task_class
        outs = list(gt.out_arrays or ())
        oi = 0
        for flow in tc.flows:
            if not (flow.access & FLOW_ACCESS_WRITE) or flow.access & FLOW_ACCESS_CTL:
                continue
            if oi >= len(outs):
                break
            arr = outs[oi]
            oi += 1
            slot = task.data[flow.flow_index]
            data = getattr(slot.data_in, "original", None)
            if data is None:
                slot.data_out = arr         # a PTG intermediate
                continue
            copy = data.get_copy(self.device_index)
            if copy is None:
                copy = data.create_copy(self.device_index, arr, COHERENCY_OWNED)
            else:
                copy.payload = arr
            data.bump_version(self.device_index)
            slot.data_out = copy
            self._lru_touch(self.res_key(data), copy)
            self._coh_mark_owned(data, copy)
        if gt.trace_span is not None:
            ps, end_key, sid = gt.trace_span
            ps.trace(end_key, sid, task.taskpool.taskpool_id, EVENT_FLAG_END)
        self._unpin(gt)     # inputs consumed: copies evictable again
        self.executed_tasks += 1
        self.load_sub(gt.load)
        if self.context is not None:
            self.context.complete_task_execution(stream, task)

    # ------------------------------------------------------------- LRU heap
    def _lru_touch(self, key: Any, copy: DataCopy) -> None:
        # account by the size actually resident under this key: an epilog may
        # rebind the copy's payload to a different-sized tensor, and the
        # budget must follow (the eviction math drifts otherwise)
        with self._heap_lock:
            self._lru.pop(key, None)
            new_size = _nbytes(copy.payload)
            old_size = self._lru_sizes.get(key, 0)
            self._resident_bytes += new_size - old_size
            self._lru_sizes[key] = new_size
            self._lru[key] = copy
            self._trace_mem(new_size - old_size)
            if new_size != old_size or key not in self._lru_segs:
                # re-register on a size change AND whenever the key has no
                # live segment (an allocate() miss under pressure must not
                # drop the tile from the ledger for good)
                seg = self._lru_segs.pop(key, None)
                if seg is not None:
                    seg.free()
                seg = self._zone.allocate(new_size)
                if seg is not None:
                    self._lru_segs[key] = seg

    def _evict_one(self) -> bool:
        """Evict the least-recently-used unpinned copy; an OWNED copy
        writes back AND downgrades atomically with the version check
        (Data.evict_copy — one critical section, so a reader racing the
        eviction can never see the newest version without a valid
        payload). The Python LRU's path; with the native table up, victim
        selection comes from C (:meth:`_apply_victims`)."""
        with self._heap_lock:
            for key in list(self._lru):
                copy = self._lru[key]
                if copy.readers > 0:
                    self.pinned_skips += 1
                    continue
                self._lru.pop(key)
                self._evict_key_locked(key, copy, drop_table=True)
                return True
        return False

    def evict_bytes(self, nbytes: int) -> int:
        """Force eviction of about ``nbytes`` of resident clean/dirty copies
        (the explicit half of the OOM retry path). Returns bytes freed. With
        the native table up, the victim set is C's decision."""
        freed0 = self._resident_bytes
        if self._ncoh is not None:
            victims, skips = self._ncoh.evict(nbytes)
            self._apply_victims(victims)
            self.pinned_skips += skips
            return freed0 - self._resident_bytes
        target = max(0, self._resident_bytes - nbytes)
        while self._resident_bytes > target and self._lru:
            if not self._evict_one():
                break
        return freed0 - self._resident_bytes

    def pin_copy(self, copy: DataCopy) -> None:
        """Pin a device copy against eviction (the inflight-task reader
        guard): bumps the Python reader count AND the native table's pin, so
        C's victim selection honors it. The reader count mutates from
        worker threads and the device lane's manager thread — the
        non-atomic ``+=`` goes under the heap lock so no update is lost."""
        with self._heap_lock:
            copy.readers += 1
        self._coh_pin(copy.original)

    def unpin_copy(self, copy: DataCopy) -> None:
        with self._heap_lock:
            copy.readers -= 1
        self._coh_unpin(copy.original)

    def _reserve(self, nbytes: int) -> None:
        """Evict LRU copies until ``nbytes`` fits the budget
        (ref: parsec_device_data_reserve_space device_gpu.c:1210)."""
        while self._resident_bytes + self.program_bytes + nbytes > \
                self._budget and self._lru:
            if not self._evict_one():
                break  # everything pinned; rely on the caching allocator

    def _fit_programs(self) -> None:
        """Native mode: the table budgets the tiles alone; when captured
        programs push tiles and programs over the budget, evict the excess
        of tiles through the table (the Python path's ``_reserve`` counts
        ``program_bytes`` itself)."""
        over = self._resident_bytes + self.program_bytes - self._budget
        if over > 0:
            self.evict_bytes(over)

    def zone_stats(self) -> Dict[str, int]:
        """Device-heap ledger stats (occupancy, fragmentation, high-water
        mark) — the zonemalloc_benchmark surface of the reference."""
        return self._zone.stats()

    def set_budget(self, nbytes: int, unit: Optional[int] = None) -> None:
        """Resize the device tile budget (tests / MCA reconfiguration): the
        table applies it first (its victims leave both views), then the
        zone ledger is rebuilt with ``unit``-byte units and the residents
        re-registered."""
        from ..utils.zone_malloc import ZoneMalloc
        with self._heap_lock:
            self._budget = nbytes
            if self._ncoh is not None:
                self._apply_victims_locked(self._ncoh.set_budget(nbytes))
            self._zone = ZoneMalloc(nbytes, unit)
            self._lru_segs = {}
            for key, sz in self._lru_sizes.items():
                seg = self._zone.allocate(sz)
                if seg is not None:
                    self._lru_segs[key] = seg

    def fini(self) -> None:
        if self.stream is not None:
            self.stream.synchronize()
        for hook in self.fini_hooks:
            hook()
        self.fini_hooks.clear()
        self._lru.clear()
        self._lru_sizes.clear()
        for seg in self._lru_segs.values():
            seg.free()
        self._lru_segs.clear()
        self._resident_bytes = 0
        self._pending.clear()


def make_cuda_hook(submit: Callable) -> Callable:
    """Build a chore hook that dispatches ``submit`` on the selected CUDA
    device (the generated GPU hook, jdf2c.c:6613, wrapping the body into a
    gpu_task for the kernel scheduler). ``submit(device, task, inputs)``
    returns the output tensors of the WRITE flows in flow order. With no
    CUDA device selected the body runs inline on the host copies."""
    def hook(stream, task: Task) -> int:
        dev = task.selected_device
        if not isinstance(dev, CUDADevice):
            return _run_inline(stream, task, submit)
        return dev.kernel_scheduler(stream, task, CUDATask(task, submit))
    return hook


def _run_inline(stream, task: Task, submit: Callable) -> int:
    """Run a device body synchronously on the host copies (no CUDA device
    was selected for the task)."""
    inputs = []
    for flow in task.task_class.flows:
        slot = task.data[flow.flow_index]
        inputs.append(None if slot.data_in is None
                      else getattr(slot.data_in, "payload", slot.data_in))
    outs = _as_tuple(submit(None, task, inputs))
    oi = 0
    for flow in task.task_class.flows:
        if flow.access & FLOW_ACCESS_WRITE and oi < len(outs):
            slot = task.data[flow.flow_index]
            data = getattr(slot.data_in, "original", None)
            if data is not None:
                slot.data_in.payload = outs[oi]
                data.bump_version(slot.data_in.device_index)
                slot.data_out = slot.data_in
            else:
                slot.data_out = outs[oi]
            oi += 1
    return HOOK_DONE


def _as_tuple(outs) -> tuple:
    if outs is None:
        return ()
    if isinstance(outs, (tuple, list)):
        return tuple(outs)
    return (outs,)


def _is_oom(e: Exception) -> bool:
    return isinstance(e, torch.OutOfMemoryError) or \
        "OUT OF MEMORY" in str(e).upper()


def _nbytes(arr) -> int:
    return int(arr.nbytes)


def discover_cuda_devices(want: torch.device) -> List[CUDADevice]:
    """The device module for the context's device (ref: device discovery,
    device_cuda_module.c:45). ``want`` is the card the context asked for;
    on a ``cpu`` context the test mode may register the module over the
    CPU. A context that asked for CUDA on a machine without it raises, and
    so does one whose backend probe (:mod:`.probe`, a subprocess under a
    timeout, decided once per process) found no card: with the probe's
    reason."""
    if want.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA device was asked for, but "
                               "torch.cuda.is_available() is False")
        from . import probe
        platform, _count = probe.decide_backend()
        if platform != "cuda":
            raise RuntimeError(f"a CUDA device was asked for, but the "
                               f"backend probe decided {platform!r}: "
                               f"{probe.reason()}")
        index = want.index if want.index is not None \
            else torch.cuda.current_device()
        return [CUDADevice(torch.device("cuda", index))]
    if mca.get("device_cuda_over_cpu", False):
        return [CUDADevice(torch.device("cpu"))]
    return []
