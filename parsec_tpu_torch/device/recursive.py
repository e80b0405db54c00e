"""Recursive device: tasks whose body is a whole sub-taskpool.

Re-design of PARSEC_DEV_RECURSIVE (parsec/mca/device/device.h:65,
parsec/recursive.h): a chore on the recursive device does not compute — it
*builds* a nested taskpool (typically over a finer tiling of its input, the
subtile collection role) and completes when that taskpool completes. The
parent task returns ASYNC; the sub-taskpool's on_complete resumes it.
"""

from __future__ import annotations

from typing import Any, Callable

from ..core.task import DEV_RECURSIVE, HOOK_ASYNC, Task
from .device import DeviceModule


class RecursiveDevice(DeviceModule):
    """Device 1 (CPU = 0, recursive = 1, the CUDA card after them)."""

    def __init__(self) -> None:
        super().__init__("recursive", DEV_RECURSIVE)
        self.gflops = 1.0

    def spawn(self, stream, task: Task,
              builder: Callable[[Task], Any]) -> int:
        """Run ``builder(task)`` to create+enqueue the sub-taskpool; complete
        ``task`` when it finishes (ref: parsec_recursive_callback)."""
        ctx = self.context
        sub = builder(task)
        if sub is None:
            ctx.complete_task_execution(stream, task)
            return HOOK_ASYNC
        prev = sub.on_complete

        def done(_tp):
            if prev is not None:
                prev(_tp)
            ctx.complete_task_execution(stream, task)

        sub.on_complete = done
        if sub.context is None:
            ctx.add_taskpool(sub)
        return HOOK_ASYNC


def make_recursive_hook(builder: Callable[[Task], Any]) -> Callable:
    """Chore hook for DEV_RECURSIVE task classes."""
    def hook(stream, task: Task) -> int:
        dev = task.selected_device
        if not isinstance(dev, RecursiveDevice):
            # find it on the context registry
            for d in task.taskpool.context.devices.devices:
                if isinstance(d, RecursiveDevice):
                    dev = d
                    break
        return dev.spawn(stream, task, builder)
    return hook
