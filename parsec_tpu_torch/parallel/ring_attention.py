"""Sequence/context parallelism: ring attention and Ulysses all-to-all.

The port of the reference's ``parallel/ring_attention.py:39-201``, two schemes
over one mesh axis (``sp``), every rank of the group calling the entry
point together on the same global q/k/v (or DTensors sharded over the
sequence axis):

* :func:`ring_attention` — the sequence axis stays sharded; K/V blocks
  rotate around the ring (:func:`compat.ring_shift`, a
  ``batch_isend_irecv`` to the next rank) while each rank folds every
  block into the online softmax of :func:`_fold_block` (running max and
  rescaled sum). No S×S matrix anywhere; causal masking on global
  positions rebuilt from the ring step. Differentiable: a shift's backward
  is the inverse shift.
* :func:`ulysses_attention` — all-to-all seq→heads, then the hand-written
  flash kernel (``cuda_kernels.flash_attention``) on the rank's heads over
  the whole sequence, then all-to-all back (the reference's
  ``:151-153``). The kernel runs inside the rank's local body: a ctypes
  kernel has no DTensor sharding rule. Its forward is the kernel, its
  backward the library one of ``_FlashAttention``; the all-to-alls'
  backward is the inverse all-to-all.

Both return DTensors sharded ``P(None, None, "sp", None)``; a rank outside
the mesh gets None.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops import cuda_kernels as K
from . import compat
from .compat import P


def _seq_mesh(n_devices: Optional[int] = None, device_type: str = "cuda"):
    """A 1D mesh over the sequence-parallel axis ``sp``."""
    from .spmd import make_1d_mesh
    return make_1d_mesh("sp", n_devices, device_type)


def _fold_block(acc, k, v, src, q, scale, causal, q_pos, k_pos0, block):
    """Fold the resident K/V block (from ring position ``src``) into the
    (o, m, l) online softmax."""
    o, m, l = acc
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        kp = src * block + k_pos0                      # global key positions
        mask = kp[None, None, None, :] <= q_pos[None, None, :, None]
        s = s.masked_fill(~mask, float("-inf"))
    m_new = torch.maximum(m, s.amax(dim=-1))
    # exp(-inf - -inf) guards: a fully-masked row keeps m=-inf, p=0
    p = torch.exp(s - m_new[..., None])
    p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
    corr = torch.where(torch.isfinite(m), torch.exp(m - m_new),
                       torch.zeros_like(m))
    l = l * corr + p.sum(dim=-1)
    o = o * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, v)
    return o, m_new, l


def ring_local(qb, kb, vb, mesh, causal: bool, scale: float):
    """The per-rank ring body on this rank's (B, H, S/P, D) blocks: fold
    the resident block, then P-1 times (rotate, fold)."""
    axis = mesh.mesh_dim_names[0]
    g = compat.group(mesh, axis)
    nP = mesh.size(0)
    idx = mesh.get_local_rank(axis)
    block = qb.shape[2]
    dev = qb.device
    q_pos = idx * block + torch.arange(block, device=dev)
    k_pos0 = torch.arange(block, device=dev)
    o = torch.zeros_like(qb)
    m = torch.full(qb.shape[:-1], float("-inf"), dtype=qb.dtype, device=dev)
    l = torch.zeros(qb.shape[:-1], dtype=qb.dtype, device=dev)
    acc = _fold_block((o, m, l), kb, vb, idx, qb, scale, causal, q_pos,
                      k_pos0, block)
    k, v, src = kb, vb, idx
    for step in range(1, nP):
        k = compat.ring_shift(k, g)
        v = compat.ring_shift(v, g)
        src = (idx - step) % nP        # the block that arrived is its own
        acc = _fold_block(acc, k, v, src, qb, scale, causal, q_pos, k_pos0,
                          block)
    o, m, l = acc
    safe_l = torch.where(l > 0, l, torch.ones_like(l))
    return o / safe_l[..., None]


def ring_attention(q, k, v, mesh=None, causal: bool = False,
                   scale: Optional[float] = None):
    """Multi-head attention with the sequence axis sharded over the mesh.

    ``q``/``k``/``v``: (batch, heads, seq, head_dim) global values (the
    same on every rank) or DTensors sharded over the sequence axis; the
    mesh size must divide seq. Returns the attention output with the same
    global shape, sharded over the sequence axis."""
    mesh = mesh if mesh is not None else _seq_mesh()
    nP = mesh.size(0)
    B, H, S, D = q.shape
    if S % nP:
        raise ValueError(f"the {nP}-rank mesh must divide seq {S}")
    sc = scale if scale is not None else 1.0 / math.sqrt(D)
    spec = P(None, None, mesh.mesh_dim_names[0], None)
    fn = compat.shard_map(
        lambda qb, kb, vb: ring_local(qb, kb, vb, mesh, causal, sc),
        mesh, (spec, spec, spec), spec)
    return fn(q, k, v)


def ulysses_local(qb, kb, vb, mesh, causal: bool, scale: float):
    """The per-rank Ulysses body: (B, H, S/P, D) -> all-to-all ->
    (B, H/P, S, D) -> flash kernel -> all-to-all -> (B, H, S/P, D)."""
    g = compat.group(mesh, mesh.mesh_dim_names[0])

    def a2a(x):
        return compat.all_to_all_grad(x, g, split_dim=1, concat_dim=2)
    qh, kh, vh = a2a(qb), a2a(kb), a2a(vb)
    oh = K.flash_attention(qh.contiguous(), kh.contiguous(),
                           vh.contiguous(), causal=causal, scale=scale)
    return compat.all_to_all_grad(oh, g, split_dim=2, concat_dim=1)


def ulysses_attention(q, k, v, mesh=None, causal: bool = False,
                      scale: Optional[float] = None):
    """All-to-all (Ulysses) sequence parallelism: reshard seq->heads, run
    the flash kernel per rank on full sequences of H/P heads, reshard
    back. The mesh size must divide both heads and seq."""
    mesh = mesh if mesh is not None else _seq_mesh()
    nP = mesh.size(0)
    B, H, S, D = q.shape
    if H % nP or S % nP:
        raise ValueError(f"the {nP}-rank mesh must divide heads {H} and "
                         f"seq {S}")
    sc = scale if scale is not None else 1.0 / math.sqrt(D)
    spec = P(None, None, mesh.mesh_dim_names[0], None)
    fn = compat.shard_map(
        lambda qb, kb, vb: ulysses_local(qb, kb, vb, mesh, causal, sc),
        mesh, (spec, spec, spec), spec)
    return fn(q, k, v)


def dense_attention_reference(q, k, v, causal: bool = False,
                              scale: Optional[float] = None):
    """Single-device reference for the tests (tensors or numpy arrays)."""
    q, k, v = (torch.as_tensor(x) for x in (q, k, v))
    D = q.shape[-1]
    sc = scale if scale is not None else 1.0 / math.sqrt(D)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * sc
    if causal:
        S = s.shape[-1]
        mask = torch.ones((S, S), dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~mask[None, None], float("-inf"))
    a = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", a, v)
