"""CPU device module (device 0).

Ref: in PaRSEC device 0 is the CPU device created in parsec_mca_device_init
(parsec/mca/device/device.c); CPU chores run inline in the worker thread
(generated CPU hook, jdf2c.c:6978). Here a CPU chore's hook simply runs the
Python/torch body synchronously and returns HOOK_DONE.
"""

from __future__ import annotations

import os

from ..core.task import DEV_CPU
from .device import DeviceModule


class CPUDevice(DeviceModule):
    def __init__(self) -> None:
        super().__init__("cpu", DEV_CPU)
        # crude relative speed so ETA-based selection prefers the GPU for
        # matmul-shaped tasks (ref: device_cuda_module.c:45 flop-rate table)
        self.gflops = 10.0 * (os.cpu_count() or 1)
