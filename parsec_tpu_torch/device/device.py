"""Device module interface and registry.

Re-design of parsec/mca/device/device.{c,h}:

* :class:`DeviceModule` — the module vtable (ref: device.h:83-160:
  attach/detach; the reference's taskpool_register/memory_register/
  data_advise come with the slices that use them) plus the
  accelerator-facing hooks the GPU superclass defines (device_gpu.h:246-281).
* :class:`DeviceRegistry` — ordered list of devices (device 0 = CPU, device
  1 = the recursive device, then the CUDA card, ref: device.c), per-device
  load tracking and **best-device
  selection** (ref: parsec_select_best_device, device.c:100-277): data
  affinity first (run where the write-copy already lives), else minimal
  estimated-time-of-availability with the load-balance skew tunables
  (device_load_balance_skew device.c:56, .._allow_cpu device.c:62).

The accelerator here is the CUDA module (:mod:`parsec_tpu_torch.device.cuda`),
standing where parsec/mca/device/cuda stands in the reference; the documented
extension point matches the reference's template module
(parsec/mca/device/template/device_template.h:28-40).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from ..core.task import DEV_CPU, Task
from ..utils import mca, output

mca.register("device_load_balance_skew", 20,
             "Percent skew tolerated before moving work off the affine device", type=int)
mca.register("device_load_balance_allow_cpu", True,
             "Allow spilling accelerator-capable tasks to the CPU device", type=bool)
mca.register("device_recursive_enabled", True,
             "Register the recursive device (tasks whose body is a "
             "sub-taskpool)", type=bool)


class DeviceModule:
    """One device (ref: parsec_device_module_t, device.h:83-160)."""

    def __init__(self, name: str, dev_type: int) -> None:
        self.name = name
        self.type = dev_type
        self.device_index = -1
        self.context = None
        # weighted load in estimated seconds of queued work (ref: device_load /
        # time_estimate device.c)
        self.device_load = 0.0
        self.gflops = 1.0            # relative speed for default time estimates
        # statistics (ref: device.c show_statistics)
        self.executed_tasks = 0
        self.transfer_in_bytes = 0
        self.transfer_out_bytes = 0
        self._lock = threading.Lock()

    # -- lifecycle ------------------------------------------------------------
    def attach(self, context) -> None:
        self.context = context

    def detach(self) -> None:
        self.context = None

    # -- execution ------------------------------------------------------------
    def progress(self, stream) -> int:
        """Advance async work; return #completions (0 when idle)."""
        return 0

    def time_estimate(self, task: Task) -> float:
        """Default load estimate (ref: parsec_device_load + time_estimate)."""
        tc = task.task_class
        if tc.time_estimate is not None:
            return tc.time_estimate(task, self)
        return 1.0 / self.gflops

    def load_add(self, dt: float) -> None:
        with self._lock:
            self.device_load += dt

    def load_sub(self, dt: float) -> None:
        with self._lock:
            self.device_load = max(0.0, self.device_load - dt)

    def fini(self) -> None:
        pass

    def __repr__(self) -> str:  # pragma: no cover
        return f"<Device {self.device_index}:{self.name} type={self.type:#x}>"


class DeviceRegistry:
    """Ordered device list + selection (ref: parsec_mca_device_init, device.c)."""

    def __init__(self, context) -> None:
        self.context = context
        self.devices: List[DeviceModule] = []
        self._progressive: Optional[tuple] = None
        self._sel_epoch = 0      # bumped on add(): invalidates class caches
        self._discover(context)

    def _discover(self, context) -> None:
        """Device 0 is the CPU, device 1 the recursive device (unless
        ``device_recursive_enabled`` is off), and the CUDA module follows:
        code that needs a device's index reads it from the registry. A
        context that asked for the card gets it or an exception: discovery
        never carries on quietly without it."""
        from .cpu import CPUDevice
        self.add(CPUDevice())
        if mca.get("device_recursive_enabled", True):
            from .recursive import RecursiveDevice
            self.add(RecursiveDevice())
        from .cuda import discover_cuda_devices
        for dev in discover_cuda_devices(context.device):
            self.add(dev)

    def add(self, dev: DeviceModule) -> DeviceModule:
        dev.device_index = len(self.devices)
        dev.attach(self.context)
        self.devices.append(dev)
        self._progressive = None   # recompute the progress-needing subset
        self._sel_epoch += 1
        output.debug_verbose(2, "device", f"registered {dev!r}")
        return dev

    @property
    def cpu(self) -> DeviceModule:
        return self.devices[0]

    def by_type(self, dev_type: int) -> List[DeviceModule]:
        """The registered devices of ``dev_type`` (ref: the device-type
        filters of device.c)."""
        return [d for d in self.devices if d.type & dev_type]

    def progress(self, stream) -> int:
        # only devices that OVERRIDE progress get polled: the base is a
        # no-op, and this poll sits in every hot-loop iteration
        lst = self._progressive
        if lst is None:
            lst = self._progressive = tuple(
                d for d in self.devices
                if type(d).progress is not DeviceModule.progress)
        n = 0
        for d in lst:
            n += d.progress(stream)
        return n

    def select_best_device(self, task: Task) -> Optional[DeviceModule]:
        """parsec_select_best_device (ref: device.c:100-277).

        1. If a written datum already has a valid copy on a capable device,
           prefer that device (data affinity / owner keeps computing).
        2. Otherwise pick the capable device with the smallest estimated time
           of availability (load + estimate), with the skew tunable biasing
           toward accelerators.
        """
        tc = task.task_class
        mask = task.chore_mask & task.taskpool.devices_index_mask
        # candidate filtering amortizes to a dict hit on the per-task hot
        # path. The cache lives ON the task class (it dies with the class;
        # a registry-held cache would pin dead taskpools through their
        # bound-method chores) and is validated against this registry +
        # its device epoch, so a class reused across contexts or a
        # late-registered device can never serve stale candidates
        cache = tc._dev_sel_cache
        if cache is not None and cache[0]() is self \
                and cache[1] == self._sel_epoch:
            candidates = cache[2].get(mask)
        else:
            import weakref
            cache = (weakref.ref(self), self._sel_epoch, {})
            tc._dev_sel_cache = cache
            candidates = None
        if candidates is None:
            chore_types = 0
            for ch in tc.incarnations:
                chore_types |= ch.device_type
            candidates = tuple(d for d in self.devices
                               if d.type & mask & chore_types)
            cache[2][mask] = candidates
        if not candidates:
            return None
        if len(candidates) == 1:
            return candidates[0]
        # data affinity: where does the first written flow's copy live?
        for flow_i, slot in enumerate(task.data):
            copy = slot.data_in
            if copy is None:
                continue
            owner = getattr(copy, "device_index", None)
            if owner is not None:
                for d in candidates:
                    if d.device_index == owner and d.type != DEV_CPU:
                        return d
        # min estimated time of availability
        skew = 1.0 + mca.get("device_load_balance_skew", 20) / 100.0
        allow_cpu = mca.get("device_load_balance_allow_cpu", True)
        best, best_eta = None, float("inf")
        for d in candidates:
            eta = d.device_load + d.time_estimate(task)
            if d.type == DEV_CPU:
                if not allow_cpu and len(candidates) > 1:
                    continue
                eta *= skew  # bias toward accelerators
            if eta < best_eta:
                best, best_eta = d, eta
        return best

    def statistics(self) -> Dict[str, Dict[str, float]]:
        """Ref: parsec_mca_device show_statistics at fini."""
        return {
            d.name: {
                "executed_tasks": d.executed_tasks,
                "transfer_in_bytes": d.transfer_in_bytes,
                "transfer_out_bytes": d.transfer_out_bytes,
                "load": d.device_load,
            }
            for d in self.devices
        }

    def fini(self) -> None:
        for d in self.devices:
            d.fini()
