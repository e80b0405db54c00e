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
  ``query()`` (ref: parsec_device_progress_stream, device_gpu.c:2593). Keeping
  every allocation and use on one stream is also what lets PyTorch's caching
  allocator recycle a freed tile without ``record_stream``.
* Stage-in re-creates parsec_device_data_stage_in (device_gpu.c:1800):
  version-checked transfer from the newest copy (host tensor or another
  device's tensor) via ``Tensor.to(device, non_blocking=True)``.
* The device tile heap re-creates the LRU management of
  parsec_device_data_reserve_space (device_gpu.c:1210): resident copies are
  tracked in an LRU; exceeding the byte budget evicts the least recently used
  unpinned copy, writing back owned ones first (the w2r task role,
  transfer_gpu.c).
* Task batching (parsec_gpu_task_collect_batch, device_gpu.c:2229):
  compatible queued tasks are handed to a batch hook in one dispatch when the
  task class opts in.

Test mode (``--mca device_cuda_over_cpu 1`` on a ``device="cpu"`` context)
registers the same module over CPU tensors with events that are complete at
once, so the whole device logic runs without a card.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence

import torch

from ..core.task import (DEV_CUDA, FLOW_ACCESS_CTL, FLOW_ACCESS_WRITE,
                         HOOK_ASYNC, Task)
from ..data.data import (COHERENCY_INVALID, COHERENCY_OWNED, COHERENCY_SHARED,
                         Data, DataCopy)
from ..utils import mca, output
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
                 "out_arrays", "event", "oom_retries", "pinned")

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
        self._resident_bytes = 0
        self.evictions = 0          # copies evicted (budget pressure stat)
        self.pinned_skips = 0       # eviction walks that skipped a pinned copy
        budget = mca.get("device_cuda_max_bytes", 0)
        if not budget and on_card:
            free, _total = torch.cuda.mem_get_info(torch_device)
            budget = int(free * 0.75)
        self._budget = budget or (12 << 30)
        #: bytes that captured programs of this card hold (their static
        #: buffers, stacked stores and graph pools), counted against the
        #: budget beside the resident tiles (dsl/capture.py charges them)
        self.program_bytes = 0
        #: called at :meth:`fini` (graph capture releases this card's
        #: programs there)
        self.fini_hooks: List[Callable[[], None]] = []
        # serializes the residency bookkeeping (_lru/_lru_sizes/
        # _resident_bytes and the reader pins): worker threads mutate it
        # from stage-ins and epilogs, and the compound updates are not
        # GIL-atomic
        self._heap_lock = threading.RLock()

    @staticmethod
    def res_key(data: Data) -> int:
        """The residency key of a datum. ``data.key`` is only unique per
        collection (A(0,0)/B(0,0)/C(0,0) all carry key 0), so the Data
        object's identity is the key: a resident entry's DataCopy pins its
        Data, so the id cannot be reused while the entry lives."""
        return id(data)

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
        device_gpu.c:1800). Returns the device-resident copy; ``pin=True``
        also takes an eviction pin on it (release with :meth:`unpin_copy`)."""
        dev_idx = self.device_index
        copy = data.get_copy(dev_idx)
        newest = data.newest_copy()
        if copy is not None and newest is not None and \
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
        self._reserve(nbytes)       # make room before allocating
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
            self.pin_copy(copy)
        return copy

    def _submit_one(self, gt: CUDATask) -> None:
        with self._on_stream():
            inputs = self._gather_inputs(gt)
            gt.out_arrays = _as_tuple(gt.submit(self, gt.task, inputs))
            gt.event = self._record_event()

    def _gather_inputs(self, gt: CUDATask) -> List[Any]:
        task = gt.task
        inputs: List[Any] = []
        for flow in task.task_class.flows:
            slot = task.data[flow.flow_index]
            if flow.access & FLOW_ACCESS_CTL or slot.data_in is None:
                inputs.append(None)
                continue
            # pin between stage-in and epilog: the eviction walks skip copies
            # with readers > 0, so an inflight task's inputs can never be
            # evicted under it (device_gpu.c:1210)
            dev_copy = self._stage_in_copy(slot.data_in.original, flow.access,
                                           pin=True)
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
        try:
            with self._on_stream():
                inputs_list = [self._gather_inputs(g) for g in group]
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
            data = slot.data_in.original
            copy = data.get_copy(self.device_index)
            if copy is None:
                copy = data.create_copy(self.device_index, arr, COHERENCY_OWNED)
            else:
                copy.payload = arr
            data.bump_version(self.device_index)
            slot.data_out = copy
            self._lru_touch(self.res_key(data), copy)
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

    def _evict_one(self) -> bool:
        """Evict the least-recently-used unpinned copy; an OWNED copy
        writes back AND downgrades atomically with the version check
        (Data.evict_copy — one critical section, so a reader racing the
        eviction can never see the newest version without a valid
        payload)."""
        with self._heap_lock:
            for key in list(self._lru):
                copy = self._lru[key]
                if copy.readers > 0:
                    self.pinned_skips += 1
                    continue
                self._lru.pop(key)
                freed = self._lru_sizes.pop(key, 0)
                self._resident_bytes -= freed
                data = copy.original
                wrote = False
                if data is not None:
                    _evicted, wrote = data.evict_copy(self.device_index)
                else:
                    copy.coherency_state = COHERENCY_INVALID
                    copy.payload = None
                if wrote:
                    self.transfer_out_bytes += freed
                self.evictions += 1
                return True
        return False

    def evict_bytes(self, nbytes: int) -> int:
        """Force eviction of about ``nbytes`` of resident clean/dirty copies
        (the explicit half of the OOM retry path). Returns bytes freed."""
        freed0 = self._resident_bytes
        target = max(0, self._resident_bytes - nbytes)
        while self._resident_bytes > target and self._lru:
            if not self._evict_one():
                break
        return freed0 - self._resident_bytes

    def pin_copy(self, copy: DataCopy) -> None:
        """Pin a device copy against eviction (the inflight-task reader
        guard). The reader count mutates from several worker threads — the
        non-atomic ``+=`` goes under the heap lock so no update is lost."""
        with self._heap_lock:
            copy.readers += 1

    def unpin_copy(self, copy: DataCopy) -> None:
        with self._heap_lock:
            copy.readers -= 1

    def _reserve(self, nbytes: int) -> None:
        """Evict LRU copies until ``nbytes`` fits the budget
        (ref: parsec_device_data_reserve_space device_gpu.c:1210)."""
        while self._resident_bytes + self.program_bytes + nbytes > \
                self._budget and self._lru:
            if not self._evict_one():
                break  # everything pinned; rely on the caching allocator

    def set_budget(self, nbytes: int) -> None:
        """Resize the device tile budget (tests / MCA reconfiguration)."""
        with self._heap_lock:
            self._budget = nbytes

    def fini(self) -> None:
        if self.stream is not None:
            self.stream.synchronize()
        for hook in self.fini_hooks:
            hook()
        self.fini_hooks.clear()
        self._lru.clear()
        self._lru_sizes.clear()
        self._resident_bytes = 0
        self._pending.clear()


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
    CPU. A context that asked for CUDA on a machine without it raises."""
    if want.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA device was asked for, but "
                               "torch.cuda.is_available() is False")
        index = want.index if want.index is not None \
            else torch.cuda.current_device()
        return [CUDADevice(torch.device("cuda", index))]
    if mca.get("device_cuda_over_cpu", False):
        return [CUDADevice(torch.device("cpu"))]
    return []
