"""The device-timeline tracing bridge: ``torch.profiler`` and NVTX.

The role profiling_nvtx.c plays in the original runtime (annotating runtime
spans for the vendor profiler), on the card: a ``torch.profiler`` session
captures the host's operators and the card's kernels (CUPTI) into a Chrome
trace, and runtime task spans are pushed as NVTX ranges and as
``record_function`` ranges (which the profiler's trace holds, on the host
row and on the card's), so kernel activity lines up with task names.

Usage::

    with xla_trace("/tmp/tb"):            # device + host timeline
        ... run taskpools, training steps ...

or annotate spans through :class:`TaskAnnotator` (a PINS module) or
:func:`annotate`.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

from ..core import pins as P
from . import mca, output

mca.register("profile_xla_dir", "",
             "Capture a torch.profiler trace into this dir")


@contextlib.contextmanager
def xla_trace(logdir: Optional[str] = None) -> Iterator[None]:
    """Capture a torch.profiler trace around a region: the host's
    operators, and the card's kernels and copies when there is a card. At
    the end it writes ``<logdir>/trace_<pid>_<ns>.json`` (Chrome trace
    format, which Perfetto and TensorBoard read). A no-op without a dir
    (``--mca profile_xla_dir`` is the default)."""
    logdir = logdir or mca.get("profile_xla_dir", "")
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        path = os.path.join(logdir, f"trace_{os.getpid()}_"
                                    f"{time.monotonic_ns()}.json")
        prof.export_chrome_trace(path)
        output.inform(f"torch.profiler trace captured to {path}")


class _Range:
    """One NVTX range (on a card) and its ``record_function`` twin, opened
    and closed on the same thread."""

    def __init__(self, name: str) -> None:
        self.nvtx = torch.cuda.is_available()
        if self.nvtx:
            torch.cuda.nvtx.range_push(name)
        self.rf = torch.profiler.record_function(name)
        self.rf.__enter__()

    def close(self) -> None:
        self.rf.__exit__(None, None, None)
        if self.nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named range around a region: NVTX (nsys and other CUPTI tools see
    it) and ``record_function`` (a ``torch.profiler`` trace holds it)."""
    r = _Range(name)
    try:
        yield
    finally:
        r.close()


class TaskAnnotator:
    """PINS module: wrap task execution in a range named
    ``<pool>::<class>`` (:func:`annotate`'s pair, pushed at EXEC_BEGIN and
    popped at EXEC_END) so device kernels group under their task names in
    the timeline (the NVTX range push/pop role)."""

    name = "xla_annotator"

    def __init__(self) -> None:
        self._open = {}

    def enable(self, context) -> None:
        self.context = context
        context.pins.register(P.EXEC_BEGIN, self._begin)
        context.pins.register(P.EXEC_END, self._end)

    def disable(self, context) -> None:
        context.pins.unregister(P.EXEC_BEGIN, self._begin)
        context.pins.unregister(P.EXEC_END, self._end)

    def _begin(self, stream, task, extra) -> None:
        self._open[id(task)] = _Range(
            f"{task.taskpool.name}::{task.task_class.name}")

    def _end(self, stream, task, extra) -> None:
        r = self._open.pop(id(task), None)
        if r is not None:
            r.close()
