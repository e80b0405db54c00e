"""Hand-written CUDA kernels for the hot tile operations.

Each kernel sits beside its plain PyTorch version. The wrapper launches the
kernel for tensors on the card and takes the plain version only for tensors
on the CPU; it never falls back from one to the other.

* :func:`gemm_chain` — the fused k-chain  C + Σ_k A[k]·B[k]  as ONE kernel
  (``csrc/gemm_chain.cu``): a thread block owns an output sub-tile and keeps
  it in registers across the whole chain. It replaces the TPU kernel
  ``_gemm_chain_call`` of the reference package's ``ops/pallas_kernels.py``.

The CUDA sources are compiled at first use with ``nvcc`` for ``sm_90a`` into
``parsec_tpu_torch/build/`` and bound with ctypes through a plain C entry
point; a machine with a card but no ``nvcc`` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict

import torch

from ..utils import mca

mca.register("tile_dot_precision", "highest",
             "Precision of float32 tile dots: 'highest' (full float32; the "
             "only mode computed in this release — 'high' and 'default' are "
             "accepted and computed at 'highest'). bf16 tiles multiply "
             "natively with float32 accumulation.", type=str)

_PRECISIONS = ("highest", "high", "default")


def dot_precision() -> str:
    """The float32 tile-dot policy. Every name computes at 'highest':
    TF32 is switched off for matmuls and cuDNN alike, so float32 tile dots
    are float32-exact FMA sums."""
    name = str(mca.get("tile_dot_precision", "highest")).lower()
    if name not in _PRECISIONS:
        raise ValueError(f"tile_dot_precision {name!r} not in {_PRECISIONS}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name


# ---------------------------------------------------------------------------
# build + binding
# ---------------------------------------------------------------------------

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}
_libs_lock = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default
    location. Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.access(default, os.X_OK):
        return default
    raise RuntimeError("nvcc not found (neither on PATH nor under "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` into a shared library (once per source
    content and flags) and return its path."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
        os.replace(tmp, so)     # atomic: a concurrent builder sees all or none
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def _library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        with _libs_lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(build(name))
                _bind(name, lib)
                _libs[name] = lib
    return lib


def _bind(name: str, lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    if name == "gemm_chain":
        # (c, a, b, out, kt, m, k, n, dtype, stream) -> cudaError_t
        lib.gemm_chain.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]
        lib.gemm_chain.restype = ci


# ---------------------------------------------------------------------------
# fused GEMM k-chain
# ---------------------------------------------------------------------------

#: dtype codes of the C entry point
_GEMM_CHAIN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_gemm_chain(c, a_stack, b_stack) -> None:
    if a_stack.dim() != 3 or b_stack.dim() != 3 or c.dim() != 2:
        raise ValueError("gemm_chain takes C (m, n), A (kt, m, k), "
                         "B (kt, k, n)")
    kt, m, k = a_stack.shape
    if b_stack.shape[0] != kt or b_stack.shape[1] != k or \
            tuple(c.shape) != (m, b_stack.shape[2]) or kt < 1:
        raise ValueError(f"gemm_chain shapes do not chain: C {tuple(c.shape)}, "
                         f"A {tuple(a_stack.shape)}, B {tuple(b_stack.shape)}")
    if not (c.dtype == a_stack.dtype == b_stack.dtype) or \
            c.dtype not in _GEMM_CHAIN_DTYPES:
        raise TypeError(f"gemm_chain takes one dtype of float32/bfloat16, got "
                        f"{c.dtype}, {a_stack.dtype}, {b_stack.dtype}")
    if not (c.device == a_stack.device == b_stack.device):
        raise ValueError("gemm_chain operands lie on different devices")
    if not (c.is_contiguous() and a_stack.is_contiguous()
            and b_stack.is_contiguous()):
        raise ValueError("gemm_chain takes contiguous operands")


def gemm_chain_plain(c, a_stack, b_stack):
    """The plain PyTorch version of :func:`gemm_chain`: each step's product
    is summed in float32, rounded to C's dtype, then added in C's dtype."""
    dot_precision()
    out = c
    for k in range(a_stack.shape[0]):
        out = out + torch.matmul(a_stack[k].float(),
                                 b_stack[k].float()).to(c.dtype)
    return out


def gemm_chain_bf16_tolerance(c, a_stack, b_stack):
    """Elementwise tolerance between two correct bf16 chains: 2 bf16 ulps
    of the largest |C| the element passes through along the plain chain
    (a float32 tensor on c's device).

    Two implementations sum each step's product in different orders, so a
    step's bf16 rounding may land one ulp apart, and the running C carries
    that gap on, at the scale of its largest value, as a random walk: a rare
    element drifts past 2 ulps, so callers bound the share of elements
    beyond this tolerance, and check exact agreement on inputs whose
    float32 sums are order-free (small integers)."""
    out = c
    peak = c.float().abs()
    for k in range(a_stack.shape[0]):
        out = out + torch.matmul(a_stack[k].float(),
                                 b_stack[k].float()).to(c.dtype)
        peak = torch.maximum(peak, out.float().abs())
    # bf16 keeps 8 significant bits: with |x| = f * 2**e, f in [0.5, 1),
    # one ulp is 2**(e - 8)
    _, exp = torch.frexp(peak)
    return 2.0 * torch.ldexp(torch.ones_like(peak), exp - 8)


def gemm_chain(c, a_stack, b_stack):
    """C + Σ_k A[k] @ B[k], returned as a new tensor; one kernel launch on
    the current CUDA stream, C kept in registers throughout.

    Same function as the TPU kernel, per-step rounding included: each
    step's product is summed in float32 (float32 FMA, never TF32), rounded
    to C's dtype and added in C's dtype, so a bf16 C rounds at every k.
    CPU tensors take :func:`gemm_chain_plain`; CUDA tensors launch the
    kernel or raise."""
    _check_gemm_chain(c, a_stack, b_stack)
    if c.device.type == "cpu":
        return gemm_chain_plain(c, a_stack, b_stack)
    if c.device.type != "cuda":
        raise ValueError(f"gemm_chain has no kernel for {c.device}")
    lib = _library("gemm_chain")
    kt, m, k = a_stack.shape
    n = b_stack.shape[2]
    out = torch.empty_like(c)
    err = lib.gemm_chain(c.data_ptr(), a_stack.data_ptr(), b_stack.data_ptr(),
                         out.data_ptr(), kt, m, k, n,
                         _GEMM_CHAIN_DTYPES[c.dtype],
                         torch.cuda.current_stream(c.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gemm_chain kernel launch failed: CUDA error {err}")
    gemm_chain.launches += 1
    return out


#: kernel launches since the last reset (the main path's proof that it ran
#: through the kernel); only the wrapper's launch adds to it
gemm_chain.launches = 0
