"""The port's profiler bridge (``utils/xla_trace.py``): the reference's two
``test_xla_trace`` tests, and what the port's trace holds (the annotated
task ranges, ``<pool>::<class>``) read back from the Chrome trace file."""

import glob
import json
import os

import torch

from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.dsl.dtd import DTDTaskpool, RW
from parsec_tpu_torch.utils.xla_trace import (TaskAnnotator, annotate,
                                              xla_trace)


def test_xla_trace_capture(tmp_path):
    ctx = Context(nb_cores=1, device="cpu")
    ann = TaskAnnotator()
    ann.enable(ctx)
    logdir = str(tmp_path / "tb")
    with xla_trace(logdir):
        tp = DTDTaskpool(ctx, "xt")
        t = tp.tile_new((8, 8), torch.float32)

        def scale(x):
            return x * 1.5
        for _ in range(4):
            tp.insert_task(scale, (t, RW))
        tp.wait(); tp.close(); ctx.wait()
        with annotate("train::step"):
            torch.ones(4) * 2
    ann.disable(ctx)
    ctx.fini()
    # a profile directory with at least one trace artifact exists
    produced = glob.glob(os.path.join(logdir, "**", "*"), recursive=True)
    files = [p for p in produced if os.path.isfile(p)]
    assert files, produced
    with open(files[0]) as f:
        names = [ev.get("name", "") for ev in json.load(f)["traceEvents"]]
    # the four tasks' range (one a batch where the CPU context's batched
    # lane runs them together)
    assert "xt::scale" in names, sorted(set(names))[:20]
    assert "train::step" in names


def test_xla_trace_noop_without_dir():
    with xla_trace(None):
        pass  # must be a clean no-op
