"""parsec_tpu_torch — the task-based dataflow runtime on PyTorch and CUDA.

The port of the TPU runtime in this repository to one NVIDIA H100 (Hopper):
applications are DAGs of tile tasks with dataflow dependencies, inserted
through the dynamic insert-task interface (DTD) and executed by a runtime
that manages versioned tile copies between host memory and the card. Task
bodies are torch functions; the hot tile kernels are written by hand in CUDA
C++ (``csrc/``) and built with nvcc at first use; the DTD engine and the
scheduler plane are C++ host lanes (``csrc/ptdtd.cpp``, ``csrc/ptsched.cpp``)
built with the host compiler at first use (:mod:`parsec_tpu_torch.native`).

Layer map:
  utils/   — config (MCA params), logging
  core/    — task model, scheduling, the scheduler plane, termdet, PINS,
             the progress loop
  data/    — data copies/coherency, collections, tiled matrices
  device/  — device modules: the CPU and the CUDA card
  dsl/     — DTD insert_task (the native engine's per-task and batched
             lanes, the Python engine), graph capture
  native   — build and load of the C++ host lanes
  ops/     — tile bodies (gemm, potrf) and the CUDA kernels (gemm_chain,
             flash_attention)
  parallel/ — the model layer: the GPT-class LM's serving path (forward,
             loss, KV-cached generation) with the flash attention kernel

The runtime runs on the card unless the caller asks for the CPU:
``Context()`` drives CUDA and raises without it; ``Context(device="cpu")``
runs every body on the CPU.
"""

__version__ = "0.1.0"

from .core.context import Context
from .core.task import (
    Task, TaskClass, Taskpool, Flow, Dep, Chore,
    HOOK_DONE, HOOK_AGAIN, HOOK_ASYNC, HOOK_NEXT, HOOK_DISABLE, HOOK_ERROR,
    FLOW_ACCESS_READ, FLOW_ACCESS_WRITE, FLOW_ACCESS_RW, FLOW_ACCESS_CTL,
    DEV_CPU, DEV_CUDA, DEV_ALL,
)
from .data.matrix import TiledMatrix, TwoDimBlockCyclic, collection_from_numpy
from .dsl.dtd import AFFINITY, DTDTaskpool, READ, RW, WRITE
from .utils import mca

__all__ = [
    "Context", "Task", "TaskClass", "Taskpool", "Flow", "Dep", "Chore", "mca",
    "HOOK_DONE", "HOOK_AGAIN", "HOOK_ASYNC", "HOOK_NEXT", "HOOK_DISABLE",
    "HOOK_ERROR",
    "FLOW_ACCESS_READ", "FLOW_ACCESS_WRITE", "FLOW_ACCESS_RW",
    "FLOW_ACCESS_CTL", "DEV_CPU", "DEV_CUDA", "DEV_ALL",
    "DTDTaskpool", "READ", "WRITE", "RW", "AFFINITY",
    "TiledMatrix", "TwoDimBlockCyclic", "collection_from_numpy",
]
