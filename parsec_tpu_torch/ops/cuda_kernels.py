"""Hand-written CUDA kernels for the hot tile operations.

Each kernel sits beside its plain PyTorch version. The wrapper launches the
kernel for tensors on the card and takes the plain version only for tensors
on the CPU; it never falls back from one to the other.

* :func:`gemm_chain` — the fused k-chain  C + Σ_k A[k]·B[k]
  (``csrc/gemm_chain.cu``), on one of three routes chosen from the shapes
  before the launch (:func:`chain_route`): ``tile`` (bf16: TMA ring and
  ``wgmma``; float32: a register-tiled SIMT kernel), a block walking every
  step of a 128 x 128 output tile; ``split``, one work unit per (tile,
  step) and a second pass that sums the rounded step products in step
  order, for outputs too small to fill the card; ``general`` for row
  pitches TMA cannot address. It replaces the TPU kernel
  ``_gemm_chain_call`` of the reference package's ``ops/pallas_kernels.py``.
  It takes one dtype (float32 or bf16), or bf16 A and B with a float32 C.
* :func:`flash_attention` — softmax(q·kᵀ·scale)·v as ONE kernel
  (``csrc/flash_attention.cu``): a thread block owns a q tile and streams
  k/v tiles past an online softmax held in registers, on the route
  :func:`flash_route` picks: ``wgmma`` (bf16 at head dims 33-128 that are
  multiples of 8: a TMA ring fed by a producer warp, two consumer
  warpgroups on ``wgmma``), ``mma`` (other bf16: ``mma.sync``) or ``simt``
  (float32). Any head dim up to 256 runs, on the instantiation at the next
  built size, its extra columns zero-filled as they load. It replaces the
  TPU kernel ``_flash_attn_call`` of the same module.
* :func:`matmul` — blocked A·B with the output accumulated in its own dtype
  per k block, a second entry point of ``csrc/gemm_chain.cu`` that runs the
  chain's routes with C = 0 over the k blocks of A. It replaces
  ``_matmul_call``.
* :func:`stencil1d` — the fused 3-point weighted stencil over a tile with
  halo columns from its neighbours (``csrc/stencil1d.cu``), one thread per
  output element. It replaces ``_stencil_call``.

The CUDA sources are compiled at first use with ``nvcc`` for ``sm_90a`` into
``parsec_tpu_torch/build/`` and bound with ctypes through a plain C entry
point; a machine with a card but no ``nvcc`` raises. Every wrapper launches
on the current stream and allocates only through the caching allocator, so
a call can be captured into a CUDA graph once it has run outside one (the
first call builds the library and sets the kernel's attributes).
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import re
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
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas",
              "-warn-spills", "-I", CSRC_DIR)

_libs: Dict[str, ctypes.CDLL] = {}
_libs_lock = threading.Lock()
#: nvcc's messages (its warnings) for each library built by this process
build_log: Dict[str, str] = {}


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


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources(path: str, seen=None) -> list:
    """``path`` and, recursively, every file it includes with ``#include
    "..."`` (found beside the file that includes it), each once."""
    seen = [] if seen is None else seen
    if path not in seen:
        seen.append(path)
        with open(path, "rb") as f:
            for inc in _INCLUDE.findall(f.read()):
                _sources(os.path.join(os.path.dirname(path), inc.decode()),
                         seen)
    return seen


def library_path(name: str) -> str:
    """Where :func:`build` puts the library of ``csrc/<name>.cu``: a name
    that holds a digest of the source, of every header it includes and of
    the flags, so an edit to any of them builds anew."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(os.path.join(CSRC_DIR, f"{name}.cu")):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` into a shared library (once per content of
    the source and its headers, and flags) and return its path."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    so = library_path(name)
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
        build_log[name] = proc.stderr
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
        # (c, a, b, out, scratch, kt, m, k, n, dtype, route, sms, stream)
        # -> cudaError_t
        lib.gemm_chain.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci,
                                   ci, vp]
        lib.gemm_chain.restype = ci
        # (a, b, out, scratch, m, k, n, bk, dtype, route, sms, stream)
        # -> cudaError_t
        lib.blocked_matmul.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci,
                                       ci, vp]
        lib.blocked_matmul.restype = ci
    elif name == "stencil1d":
        # (x, left, right, out, rows, cols, lcols, rcols, w0, w1, w2, dtype,
        #  stream) -> cudaError_t
        cf = ctypes.c_float
        lib.stencil1d.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, cf, cf, cf,
                                  ci, vp]
        lib.stencil1d.restype = ci
    elif name == "flash_attention":
        # (q, k, v, out, bh, sq, sk, d, causal, scale, q_off, k_off, dtype,
        #  route, sms, stream) -> cudaError_t
        lib.flash_attention.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                        ctypes.c_float, ci, ci, ci, ci, ci, vp]
        lib.flash_attention.restype = ci


# ---------------------------------------------------------------------------
# fused GEMM k-chain
# ---------------------------------------------------------------------------

#: dtype codes of the C entry points (``matmul``: one dtype)
_GEMM_CHAIN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: ``gemm_chain``'s forms by (C, A, B) dtypes: one dtype, or bf16 A and B
#: with a float32 C (the mixed form, code 2)
_CHAIN_FORMS = {(torch.float32,) * 3: 0, (torch.bfloat16,) * 3: 1,
                (torch.float32, torch.bfloat16, torch.bfloat16): 2}
#: route codes of the C entry points
CHAIN_ROUTES = {"general": 0, "tile": 1, "split": 2}
#: output tile of the tile and split routes
CHAIN_TILE = 128


def chain_route(kt: int, m: int, k: int, n: int, lda: int, a_step: int,
                elem_size: int, aligned: bool, sms: int) -> str:
    """The route of a chain of ``kt`` (m x k) @ (k x n) steps, row i of A's
    step s at ``s * a_step + i * lda`` elements: a pure function of the
    shapes, the operands' 16-byte alignment and the card's SM count.

    ``general`` where TMA and cp.async cannot address the operands (a row
    pitch or step offset that is not a multiple of 16 bytes, or a base that
    is not 16-byte aligned); else ``split`` where the 128 x 128 output tiles
    would fill at most a quarter of the SMs and there is more than one step
    to spread, since a block per tile would leave three quarters of the
    card idle for the whole chain; else ``tile``."""
    pitches = (k, n, lda, a_step)
    if not aligned or any(p * elem_size % 16 for p in pitches):
        return "general"
    tiles = -(-m // CHAIN_TILE) * -(-n // CHAIN_TILE)
    return "split" if kt > 1 and 4 * tiles <= sms else "tile"


_SM_COUNTS: Dict[int, int] = {}


def _sm_count(device) -> int:
    """The SM count of a CUDA device (looked up once a device)."""
    n = _SM_COUNTS.get(device.index)
    if n is None:
        n = _SM_COUNTS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def _aligned16(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _requires_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and \
        any(t is not None and t.requires_grad for t in tensors)


def _check_gemm_chain(c, a_stack, b_stack) -> None:
    if a_stack.dim() != 3 or b_stack.dim() != 3 or c.dim() != 2:
        raise ValueError("gemm_chain takes C (m, n), A (kt, m, k), "
                         "B (kt, k, n)")
    kt, m, k = a_stack.shape
    if b_stack.shape[0] != kt or b_stack.shape[1] != k or \
            tuple(c.shape) != (m, b_stack.shape[2]) or kt < 1:
        raise ValueError(f"gemm_chain shapes do not chain: C {tuple(c.shape)}, "
                         f"A {tuple(a_stack.shape)}, B {tuple(b_stack.shape)}")
    if (c.dtype, a_stack.dtype, b_stack.dtype) not in _CHAIN_FORMS:
        raise TypeError(f"gemm_chain takes one dtype of float32/bfloat16, or "
                        f"bfloat16 A and B with a float32 C; got {c.dtype}, "
                        f"{a_stack.dtype}, {b_stack.dtype}")
    if not (c.device == a_stack.device == b_stack.device):
        raise ValueError("gemm_chain operands lie on different devices")
    if not (c.is_contiguous() and a_stack.is_contiguous()
            and b_stack.is_contiguous()):
        raise ValueError("gemm_chain takes contiguous operands")


def gemm_chain_plain(c, a_stack, b_stack):
    """The plain PyTorch version of :func:`gemm_chain`: each step's product
    is summed in float32, rounded to C's dtype, then added in C's dtype (for
    the mixed form: float32 sums of the exact bf16 products, unrounded)."""
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


def gemm_chain_backward(c, a_stack, b_stack, g):
    """(dC, dA, dB) of :func:`gemm_chain` for the upstream gradient ``g``,
    the gradient of the reference's chain expression written with library
    calls: every step's product is added to C, so each step sees ``g``, cast
    from C's dtype to float32 as the reference's per-step cast back to C's
    dtype has it, and

        dC = g,  dA[s] = g·B[s]ᵀ,  dB[s] = A[s]ᵀ·g,

    summed in float32 (TF32 off) and returned in the operands' dtypes."""
    dot_precision()
    gf = g.to(c.dtype).float()
    da = torch.matmul(gf, b_stack.float().transpose(1, 2))
    db = torch.matmul(a_stack.float().transpose(1, 2), gf)
    return g.to(c.dtype), da.to(a_stack.dtype), db.to(b_stack.dtype)


class _GemmChain(torch.autograd.Function):
    """:func:`gemm_chain` under autograd: the wrapper's forward (the kernel
    on CUDA tensors, the plain version on the CPU), the backward
    :func:`gemm_chain_backward`."""

    @staticmethod
    def forward(ctx, c, a_stack, b_stack):
        ctx.save_for_backward(c, a_stack, b_stack)
        return _gemm_chain_forward(c, a_stack, b_stack)

    @staticmethod
    def backward(ctx, g):
        return gemm_chain_backward(*ctx.saved_tensors, g)


def gemm_chain(c, a_stack, b_stack):
    """C + Σ_k A[k] @ B[k], returned as a new tensor, computed on the
    current CUDA stream by the route :func:`chain_route` picks: ``tile`` and
    ``general`` are one kernel; ``split`` is two (the step products into a
    scratch tensor, then their sum in step order from C).

    Same function as the TPU kernel, per-step rounding included: each
    step's product is summed in float32 (float32 FMA, never TF32), rounded
    to C's dtype and added in C's dtype, so a bf16 C rounds at every k.
    bf16 A and B with a float32 C (the mixed form) run the bf16 kernels'
    loads with a float32 epilogue: the chain of float32 sums of exact
    products that the reference computes.

    CPU tensors take :func:`gemm_chain_plain`; ``meta`` tensors get an
    empty result of C's shape and dtype (shape inference, no launch); CUDA
    tensors launch the kernel or raise. Under autograd (grad mode on and an
    operand that requires grad) the call goes through :class:`_GemmChain`:
    the same forward, and :func:`gemm_chain_backward` for the gradients."""
    _check_gemm_chain(c, a_stack, b_stack)
    if c.device.type == "meta":
        return torch.empty_like(c)
    if _requires_grad(c, a_stack, b_stack):
        return _GemmChain.apply(c, a_stack, b_stack)
    return _gemm_chain_forward(c, a_stack, b_stack)


def _gemm_chain_forward(c, a_stack, b_stack):
    """:func:`gemm_chain`'s forward on checked operands."""
    if c.device.type == "cpu":
        return gemm_chain_plain(c, a_stack, b_stack)
    if c.device.type != "cuda":
        raise ValueError(f"gemm_chain has no kernel for {c.device}")
    lib = _library("gemm_chain")
    kt, m, k = a_stack.shape
    n = b_stack.shape[2]
    sms = _sm_count(c.device)
    route = chain_route(kt, m, k, n, k, m * k, a_stack.element_size(),
                        _aligned16(c, a_stack, b_stack), sms)
    out = torch.empty_like(c)
    scratch = (torch.empty(kt, m, n, dtype=c.dtype, device=c.device)
               if route == "split" else None)
    err = lib.gemm_chain(c.data_ptr(), a_stack.data_ptr(), b_stack.data_ptr(),
                         out.data_ptr(),
                         None if scratch is None else scratch.data_ptr(),
                         kt, m, k, n,
                         _CHAIN_FORMS[c.dtype, a_stack.dtype, b_stack.dtype],
                         CHAIN_ROUTES[route], sms,
                         torch.cuda.current_stream(c.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gemm_chain kernel launch failed ({route} route):"
                           f" CUDA error {err}")
    if not torch.cuda.is_current_stream_capturing():
        gemm_chain.launches += 1
        gemm_chain.launches_by_route[route] += 1
    return out


#: wrapper calls that launched the kernel since the last reset (the main
#: path's proof that it ran through the kernel), one per call whatever the
#: route; only the wrapper's launch adds to it. A call on a stream that is
#: being captured into a CUDA graph records the kernel without launching it
#: and does not count; the graph's replays launch it without the wrapper,
#: so they are counted from a trace of the device (torch.profiler)
gemm_chain.launches = 0
#: the same calls by route (:func:`chain_route`)
gemm_chain.launches_by_route = dict.fromkeys(CHAIN_ROUTES, 0)


# ---------------------------------------------------------------------------
# blocked matmul
# ---------------------------------------------------------------------------

def _check_matmul(a, b) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul takes A (m, k) and B (k, n), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if min(a.shape[0], a.shape[1], b.shape[1]) < 1:
        raise ValueError("matmul needs non-empty operands")
    if a.dtype != b.dtype or a.dtype not in _GEMM_CHAIN_DTYPES:
        raise TypeError(f"matmul takes one dtype of float32/bfloat16, got "
                        f"{a.dtype}, {b.dtype}")
    if a.device != b.device:
        raise ValueError("matmul operands lie on different devices")


def _matmul_blocks(a, b, block):
    """The reference's block clipping: (bm, bn, bk), each at most the
    operand's own extent."""
    m, k = a.shape
    n = b.shape[1]
    return min(block[0], m), min(block[1], n), min(block[2], k)


def matmul_plain(a, b, block=(256, 256, 256)):
    """The plain PyTorch version of :func:`matmul` on shapes the kernel
    takes: the output starts at zero and each bk-wide step's product is
    summed in float32, rounded to the output dtype and added in that
    dtype."""
    _check_matmul(a, b)
    _, _, bk = _matmul_blocks(a, b, block)
    k = a.shape[1]
    if k % bk:
        raise ValueError(f"matmul_plain: k = {k} is not a multiple of "
                         f"bk = {bk}")
    dot_precision()
    out = torch.zeros(a.shape[0], b.shape[1], dtype=a.dtype, device=a.device)
    for k0 in range(0, k, bk):
        out = out + torch.matmul(a[:, k0:k0 + bk].float(),
                                 b[k0:k0 + bk].float()).to(a.dtype)
    return out


def matmul_backward(a, b, g):
    """(dA, dB) of :func:`matmul` for the upstream gradient ``g``: the
    gradient of the reference's blocked expression (each bk block's product
    added to the output, so every block sees ``g``), with library calls:
    dA = g·Bᵀ, dB = Aᵀ·g, summed in float32 (TF32 off) and returned in
    the operands' dtype."""
    dot_precision()
    gf = g.to(a.dtype).float()
    return (torch.matmul(gf, b.float().t()).to(a.dtype),
            torch.matmul(a.float().t(), gf).to(b.dtype))


class _Matmul(torch.autograd.Function):
    """:func:`matmul` under autograd on shapes its blocks divide: the
    wrapper's forward (the kernel on CUDA tensors, the plain version on the
    CPU), the backward :func:`matmul_backward`."""

    @staticmethod
    def forward(ctx, a, b, block):
        ctx.save_for_backward(a, b)
        return _matmul_forward(a, b, block)

    @staticmethod
    def backward(ctx, g):
        return (*matmul_backward(*ctx.saved_tensors, g), None)


def matmul(a, b, block=(256, 256, 256)):
    """Blocked A @ B with (bm, bn, bk) = ``block`` clipped to the shape,
    computed on the current CUDA stream by :func:`gemm_chain`'s kernels.

    Same function as the TPU kernel: the output accumulates in its own
    dtype, one rounded float32 step product per bk-wide block of k, so a
    bf16 output rounds k/bk times; bm and bn only tile the work. The route
    is :func:`chain_route`'s, with the bk-wide column blocks of A as steps. Shapes that
    the blocks do not divide take the reference's own route, one
    ``torch.matmul`` with float32 accumulation and a single rounding. Else
    CPU tensors take :func:`matmul_plain`, and CUDA tensors launch the
    kernel (contiguous operands) or raise. Under autograd the kernel's
    route goes through :class:`_Matmul`: the same forward, and
    :func:`matmul_backward` for the gradients."""
    _check_matmul(a, b)
    bm, bn, bk = _matmul_blocks(a, b, block)
    m, k = a.shape
    n = b.shape[1]
    if m % bm or n % bn or k % bk:
        dot_precision()
        return torch.matmul(a.float(), b.float()).to(a.dtype)
    if _requires_grad(a, b):
        return _Matmul.apply(a, b, block)
    return _matmul_forward(a, b, block)


def _matmul_forward(a, b, block):
    """:func:`matmul`'s forward on checked operands its blocks divide."""
    if a.device.type == "cpu":
        return matmul_plain(a, b, block)
    if a.device.type != "cuda":
        raise ValueError(f"matmul has no kernel for {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul takes contiguous operands")
    _, _, bk = _matmul_blocks(a, b, block)
    m, k = a.shape
    n = b.shape[1]
    lib = _library("gemm_chain")
    kt = k // bk
    sms = _sm_count(a.device)
    route = chain_route(kt, m, bk, n, k, bk, a.element_size(),
                        _aligned16(a, b), sms)
    out = torch.empty(m, n, dtype=a.dtype, device=a.device)
    scratch = (torch.empty(kt, m, n, dtype=a.dtype, device=a.device)
               if route == "split" else None)
    err = lib.blocked_matmul(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                             None if scratch is None else scratch.data_ptr(),
                             m, k, n, bk, _GEMM_CHAIN_DTYPES[a.dtype],
                             CHAIN_ROUTES[route], sms,
                             torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"matmul kernel launch failed ({route} route): "
                           f"CUDA error {err}")
    if not torch.cuda.is_current_stream_capturing():
        matmul.launches += 1
        matmul.launches_by_route[route] += 1
    return out


#: wrapper calls that launched the kernel since the last reset, one per
#: call whatever the route; only the wrapper's launch adds to it
matmul.launches = 0
#: the same calls by route (:func:`chain_route`)
matmul.launches_by_route = dict.fromkeys(CHAIN_ROUTES, 0)


# ---------------------------------------------------------------------------
# fused 1D stencil
# ---------------------------------------------------------------------------

#: dtype codes of the C entry point
_STENCIL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_stencil(x, left, right) -> None:
    if x.dim() != 2 or min(x.shape) < 1:
        raise ValueError(f"stencil1d takes a non-empty (rows, cols) tile, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _STENCIL_DTYPES:
        raise TypeError(f"stencil1d takes float32 or bfloat16, got {x.dtype}")
    for side, h in (("left", left), ("right", right)):
        if h is None:
            continue
        if h.dim() != 2 or h.shape[0] != x.shape[0] or h.shape[1] < 1:
            raise ValueError(f"stencil1d: {side} halo tile {tuple(h.shape)} "
                             f"does not border x {tuple(x.shape)}")
        if h.dtype != x.dtype or h.device != x.device:
            raise TypeError(f"stencil1d: {side} halo tile is {h.dtype} on "
                            f"{h.device}, x {x.dtype} on {x.device}")


def stencil1d_plain(x, left, right, weights=(0.25, 0.5, 0.25)):
    """The plain PyTorch version of :func:`stencil1d`. The weights are
    rounded to x's dtype first, and every product and sum is rounded to it,
    in the order (w0·xm + w1·x) + w2·xp — what the TPU kernel computes on
    weakly typed weights, bf16 included."""
    _check_stencil(x, left, right)
    w0, w1, w2 = torch.tensor(weights, dtype=x.dtype, device=x.device)
    zero = x.new_zeros(x.shape[0], 1)
    lcol = left[:, -1:] if left is not None else zero
    rcol = right[:, :1] if right is not None else zero
    xm = torch.cat([lcol, x[:, :-1]], dim=1)
    xp = torch.cat([x[:, 1:], rcol], dim=1)
    return (w0 * xm + w1 * x) + w2 * xp


def stencil1d_backward(x, left, right, g, weights=(0.25, 0.5, 0.25)):
    """(dx, dleft, dright) of :func:`stencil1d` for the upstream gradient
    ``g``: the transposed 3-point stencil in x's dtype, the weights rounded
    to it as the forward has them,

        dx[:, j] = w1·g[:, j] + w0·g[:, j+1] + w2·g[:, j-1]

    (the terms past either end dropped), and the halo columns the forward
    read get theirs: dleft[:, -1] = w0·g[:, 0], dright[:, 0] = w2·g[:, -1],
    every other halo column 0. A ``None`` halo gets ``None``."""
    w0, w1, w2 = torch.tensor(weights, dtype=x.dtype, device=x.device)
    g = g.to(x.dtype)
    dx = w1 * g
    dx[:, :-1] += w0 * g[:, 1:]
    dx[:, 1:] += w2 * g[:, :-1]
    dleft = dright = None
    if left is not None:
        dleft = torch.zeros_like(left)
        dleft[:, -1] = w0 * g[:, 0]
    if right is not None:
        dright = torch.zeros_like(right)
        dright[:, 0] = w2 * g[:, -1]
    return dx, dleft, dright


class _Stencil1d(torch.autograd.Function):
    """:func:`stencil1d` under autograd: the wrapper's forward (the kernel
    on CUDA tensors, the plain version on the CPU), the backward
    :func:`stencil1d_backward`."""

    @staticmethod
    def forward(ctx, x, left, right, weights):
        ctx.save_for_backward(x, left, right)
        ctx.weights = weights
        return _stencil1d_forward(x, left, right, weights)

    @staticmethod
    def backward(ctx, g):
        x, left, right = ctx.saved_tensors
        return (*stencil1d_backward(x, left, right, g, ctx.weights), None)


def stencil1d(x, left, right, weights=(0.25, 0.5, 0.25)):
    """out = w0·xm + w1·x + w2·xp over a (rows, cols) tile, xm/xp the tile
    shifted right/left by one column with the halo columns ``left[:, -1]``
    and ``right[:, 0]`` at its ends; ``None`` for a halo is a zero column
    (the domain boundary). One kernel launch on the current CUDA stream.

    Bit for bit the function of :func:`stencil1d_plain` (the kernel rounds
    every product and sum, never fusing them). CPU tensors take the plain
    version; ``meta`` tensors get an empty result (shape inference, no
    launch); CUDA tensors launch the kernel (contiguous tiles) or raise.
    Under autograd the call goes through :class:`_Stencil1d`: the same
    forward, and :func:`stencil1d_backward` for the gradients."""
    _check_stencil(x, left, right)
    if x.device.type == "meta":
        return torch.empty_like(x)
    weights = tuple(float(w) for w in weights)
    if _requires_grad(x, left, right):
        return _Stencil1d.apply(x, left, right, weights)
    return _stencil1d_forward(x, left, right, weights)


def _stencil1d_forward(x, left, right, weights):
    """:func:`stencil1d`'s forward on checked tiles."""
    if x.device.type == "cpu":
        return stencil1d_plain(x, left, right, weights)
    if x.device.type != "cuda":
        raise ValueError(f"stencil1d has no kernel for {x.device}")
    if not all(t is None or t.is_contiguous() for t in (x, left, right)):
        raise ValueError("stencil1d takes contiguous tiles")
    lib = _library("stencil1d")
    rows, cols = x.shape
    out = torch.empty_like(x)
    w0, w1, w2 = weights
    err = lib.stencil1d(
        x.data_ptr(), None if left is None else left.data_ptr(),
        None if right is None else right.data_ptr(), out.data_ptr(),
        rows, cols, 0 if left is None else left.shape[1],
        0 if right is None else right.shape[1], w0, w1, w2,
        _STENCIL_DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stencil1d kernel launch failed: CUDA error {err}")
    if not torch.cuda.is_current_stream_capturing():
        stencil1d.launches += 1
    return out


#: kernel launches since the last reset; only the wrapper's launch adds to it
#: (not a call being captured into a CUDA graph, see gemm_chain.launches)
stencil1d.launches = 0


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

#: the widest head dim of a single-pass launch; it is built at 16, 32, 64,
#: 128 and 256, and a launch at head dim d runs the smallest of them >= d,
#: with columns d .. D - 1 zero-filled as they load. A wider head dim takes
#: the ``chunked`` route
FLASH_MAX_HEAD_DIM = 256
#: dtype codes of the C entry point
_FLASH_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: route codes of the C entry point
FLASH_ROUTES = {"simt": 0, "mma": 1, "wgmma": 2, "chunked": 3}


def flash_route(dtype, d: int, aligned: bool) -> str:
    """The route of a flash launch: a pure function of the dtype, the head
    dim and the operands' 16-byte alignment. ``simt`` for float32 (no TF32,
    so the SIMT cores); ``wgmma`` (TMA and ``wgmma``, built at 64 and 128)
    for bf16 at 32 < d <= 128 with d % 8 == 0 on 16-byte aligned bases, as
    TMA needs 16-byte aligned rows; ``mma`` (``mma.sync``) for the other
    bf16 launches up to d = 256, d <= 32 included; ``chunked`` for either
    dtype at d > 256 (a grid axis over the output's 256-column chunks, S
    recomputed over all d in 256-column steps in each)."""
    if d > FLASH_MAX_HEAD_DIM:
        return "chunked"
    if dtype == torch.float32:
        return "simt"
    return "wgmma" if 32 < d <= 128 and d % 8 == 0 and aligned else "mma"


def _check_flash(q, k, v) -> None:
    if q.dim() < 2 or k.dim() < 2 or v.dim() < 2:
        raise ValueError("flash_attention takes (..., seq, head_dim) operands")
    if tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} differ")
    bh = q.numel() // max(1, q.shape[-2] * q.shape[-1])
    bhk = k.numel() // max(1, k.shape[-2] * k.shape[-1])
    if q.shape[-1] != k.shape[-1] or bh != bhk:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not match "
                         f"k/v {tuple(k.shape)}")
    if q.shape[-2] < 1 or k.shape[-2] < 1:
        raise ValueError("flash_attention needs sequence lengths >= 1")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _FLASH_DTYPES:
        raise TypeError(f"flash_attention takes one dtype of float32/bfloat16,"
                        f" got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention operands lie on different devices")


def _flash_weights(q, k, causal, scale, q_offset, k_offset):
    """Dense float32 attention weights (bh, sq, sk): the global-offset
    causal mask and a guarded softmax, so a fully masked row is all 0."""
    dot_precision()
    d, sq, sk = q.shape[-1], q.shape[-2], k.shape[-2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    q3 = q.reshape(-1, sq, d).float()
    k3 = k.reshape(-1, sk, d).float()
    s = torch.matmul(q3, k3.transpose(1, 2)) * scale
    if causal:
        qp = q_offset + torch.arange(sq, device=q.device)[:, None]
        kp = k_offset + torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(kp > qp, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(torch.isfinite(s),
                    torch.exp(s - torch.where(torch.isfinite(m), m, 0.0)),
                    0.0)
    return p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)


def flash_attention_plain(q, k, v, causal: bool = False, scale=None,
                          q_offset: int = 0, k_offset: int = 0):
    """The plain PyTorch version of :func:`flash_attention`: dense float32
    scores, the global-offset causal mask, a guarded softmax (a fully masked
    row gives zeros) and the output cast to q's dtype."""
    w = _flash_weights(q, k, causal, scale, q_offset, k_offset)
    v3 = v.reshape(-1, k.shape[-2], k.shape[-1]).float()
    return torch.matmul(w, v3).to(q.dtype).reshape(q.shape)


def flash_attention_bf16_tolerance(q, k, v, causal: bool = False, scale=None,
                                   q_offset: int = 0, k_offset: int = 0):
    """Elementwise bound on |kernel - plain| for bf16 operands: a float32
    tensor of q's shape, on q's device.

    The kernel rounds each weight of P to bf16 before P·V (relative error at
    most u = 2**-8) and the plain version does not, so before the output is
    rounded they differ by at most u·Σ_j w_j·|v_j| (w the softmax weights),
    plus float32 noise, here allowed 1e-4 of that sum. Rounding both to
    bf16 adds at most u·|y| each, y the plain float32 output. A row that sees
    no key gets a bound of 0: it must be exactly 0. Every element of a sound
    kernel lies within this bound; a skipped key tile or a lost correction
    factor moves whole rows by far more."""
    w = _flash_weights(q, k, causal, scale, q_offset, k_offset)
    v3 = v.reshape(-1, k.shape[-2], k.shape[-1]).float()
    u = 2.0 ** -8
    spread = torch.matmul(w, v3.abs())
    y = torch.matmul(w, v3).abs()
    return ((1 + u) * (u + 1e-4) * spread + 2 * u * y).reshape(q.shape)


def flash_attention_backward(q, k, v, dout, causal: bool = False,
                             scale=None, q_offset: int = 0,
                             k_offset: int = 0):
    """(dq, dk, dv) of the reference's dense flash expression for the
    upstream gradient ``dout``, written with library calls: P recomputed
    from q and k in float32 (TF32 off) with the global-offset causal mask
    and the guarded softmax (a fully masked row's weights, and so its
    gradients, are 0), then

        dV = Pᵀ·dO,  dP = dO·Vᵀ,  dS = P ⊙ (dP − rowsum(dO ⊙ O)),
        dQ = scale·dS·K,  dK = scale·dSᵀ·Q,

    with O = P·V in float32; each result cast to its input's dtype. It is
    the backward of :func:`flash_attention` on every device, the kernel's
    forward included: the kernel computes the same function, so this is
    its gradient too."""
    d, sq, sk = q.shape[-1], q.shape[-2], k.shape[-2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    p = _flash_weights(q, k, causal, scale, q_offset, k_offset)
    q3 = q.reshape(-1, sq, d).float()
    k3 = k.reshape(-1, sk, d).float()
    v3 = v.reshape(-1, sk, d).float()
    do = dout.reshape(-1, sq, d).float()
    dv = torch.matmul(p.transpose(1, 2), do)
    dp = torch.matmul(do, v3.transpose(1, 2))
    delta = (do * torch.matmul(p, v3)).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.matmul(ds, k3) * scale
    dk = torch.matmul(ds.transpose(1, 2), q3) * scale
    return (dq.to(q.dtype).reshape(q.shape), dk.to(k.dtype).reshape(k.shape),
            dv.to(v.dtype).reshape(v.shape))


class _FlashAttention(torch.autograd.Function):
    """:func:`flash_attention` under autograd: the forward is the wrapper's
    (the kernel on a CUDA tensor, the plain version on the CPU), the
    backward :func:`flash_attention_backward`. Only q, k and v are saved:
    the backward recomputes the weights, as a flash backward does."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_offset, k_offset):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, scale, q_offset, k_offset)
        return _flash_forward(q, k, v, causal, scale, q_offset, k_offset)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal: bool = False, scale=None,
                    q_offset: int = 0, k_offset: int = 0,
                    block_q: int = 256, block_k: int = 512):
    """Fused softmax(q·kᵀ·scale)·v over (..., seq, head_dim) operands; one
    kernel launch on the current CUDA stream.

    q is (..., sq, d), k and v (..., sk, d) with the same leading size; the
    output has q's shape and dtype, and ``scale`` defaults to 1/sqrt(d).
    ``q_offset``/``k_offset`` are the global positions of q's and k's first
    rows, so the causal mask holds on sequence shards; a row that sees no
    key returns zeros. ``block_q``/``block_k`` are accepted for the
    reference's signature and change nothing: the kernel tiles by itself
    and masks its own ragged tails, so any sq, sk >= 1 runs. The route is
    :func:`flash_route`'s.

    CPU tensors take :func:`flash_attention_plain`; CUDA tensors launch the
    kernel (contiguous operands, any head dim) or raise. Under autograd
    (grad mode on and an operand that requires grad) the call goes through
    :class:`_FlashAttention`: the same forward, and
    :func:`flash_attention_backward` for the gradients."""
    del block_q, block_k
    _check_flash(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if _requires_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, bool(causal), float(scale),
                                     int(q_offset), int(k_offset))
    return _flash_forward(q, k, v, causal, scale, q_offset, k_offset)


def _flash_forward(q, k, v, causal, scale, q_offset, k_offset):
    """:func:`flash_attention`'s forward on checked operands, ``scale``
    resolved."""
    d, sq, sk = q.shape[-1], q.shape[-2], k.shape[-2]
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, scale, q_offset,
                                     k_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention has no kernel for {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous operands")
    lib = _library("flash_attention")
    route = flash_route(q.dtype, d, _aligned16(q, k, v))
    out = torch.empty_like(q)
    err = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        q.numel() // (sq * d), sq, sk, d, int(bool(causal)), float(scale),
        int(q_offset), int(k_offset), _FLASH_DTYPES[q.dtype],
        FLASH_ROUTES[route], _sm_count(q.device),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed ({route} "
                           f"route): CUDA error {err}")
    if not torch.cuda.is_current_stream_capturing():
        flash_attention.launches += 1
        flash_attention.launches_by_route[route] += 1
    return out


#: kernel launches since the last reset; only the wrapper's launch adds to it
flash_attention.launches = 0
#: the same launches by route (:func:`flash_route`)
flash_attention.launches_by_route = dict.fromkeys(FLASH_ROUTES, 0)
