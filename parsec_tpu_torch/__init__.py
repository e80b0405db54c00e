"""parsec_tpu_torch — the task-based dataflow runtime on PyTorch and CUDA.

The port of the TPU runtime in this repository to one NVIDIA H100 (Hopper):
applications are DAGs of tile tasks with dataflow dependencies, inserted
through the dynamic insert-task interface (DTD) and executed by a runtime
that manages versioned tile copies between host memory and the card. Task
bodies are torch functions; the hot tile kernels are written by hand in CUDA
C++ (``csrc/``) and built with nvcc at first use; the DTD engine and the
scheduler plane are C++ host lanes (``csrc/ptdtd.cpp``, ``csrc/ptsched.cpp``)
built with the host compiler at first use (:mod:`parsec_tpu_torch.native`).
The PTG frontend (``dsl/ptg/``) compiles a JDF-style program into task
classes and drains eligible pools through the native execution lane
(``csrc/ptexec.cpp``).

Layer map:
  utils/   — config (MCA params), logging, tracing, checkpoint/restore
  core/    — task model, scheduling, the scheduler plane, termdet, PINS,
             the progress loop
  data/    — data copies/coherency, collections (the tiled matrices and
             their distributions, subtile views), arenas, collection ops,
             redistribution
  device/  — device modules: the CPU, the recursive device and the CUDA
             card; the backend probe
  dsl/     — DTD insert_task (the native engine's per-task and batched
             lanes, the Python engine), graph capture, the PTG frontend
             (parser, compiler, the native ptexec lane)
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

from .core.context import Context, fini, init
from .core.task import (
    Task, TaskClass, Taskpool, Flow, Dep, Chore,
    HOOK_DONE, HOOK_AGAIN, HOOK_ASYNC, HOOK_NEXT, HOOK_DISABLE, HOOK_ERROR,
    FLOW_ACCESS_READ, FLOW_ACCESS_WRITE, FLOW_ACCESS_RW, FLOW_ACCESS_CTL,
    DEV_CPU, DEV_CUDA, DEV_ALL,
)
from .core.compound import compose
from .data.matrix import (SBCDistribution, SymTwoDimBlockCyclic,
                          SymTwoDimBlockCyclicBand, TiledMatrix,
                          TwoDimBlockCyclic, VectorTwoDimCyclic,
                          collection_from_numpy)
from .dsl.dtd import AFFINITY, DTDTaskpool, READ, RW, WRITE
from .utils import mca

__all__ = [
    "Context", "init", "fini", "Task", "TaskClass", "Taskpool", "Flow", "Dep", "Chore", "mca",
    "HOOK_DONE", "HOOK_AGAIN", "HOOK_ASYNC", "HOOK_NEXT", "HOOK_DISABLE",
    "HOOK_ERROR",
    "FLOW_ACCESS_READ", "FLOW_ACCESS_WRITE", "FLOW_ACCESS_RW",
    "FLOW_ACCESS_CTL", "DEV_CPU", "DEV_CUDA", "DEV_ALL",
    "DTDTaskpool", "READ", "WRITE", "RW", "AFFINITY",
    "TiledMatrix", "TwoDimBlockCyclic", "collection_from_numpy", "compose",
    "SymTwoDimBlockCyclic", "SymTwoDimBlockCyclicBand", "SBCDistribution",
    "VectorTwoDimCyclic",
    # lazy (PEP 562) exports below
    "compile_ptg", "NamedDatatype", "checkpoint",
]

# the rest of the user surface resolves lazily so `import parsec_tpu_torch`
# stays light
_LAZY = {
    "compile_ptg": ("parsec_tpu_torch.dsl.ptg.compiler", "compile_ptg"),
    "NamedDatatype": ("parsec_tpu_torch.data.reshape", "NamedDatatype"),
    "checkpoint": ("parsec_tpu_torch.utils.checkpoint", None),
}


def __getattr__(name):
    entry = _LAZY.get(name)
    if entry is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    mod = importlib.import_module(entry[0])
    value = mod if entry[1] is None else getattr(mod, entry[1])
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(list(globals()) + list(_LAZY)))
