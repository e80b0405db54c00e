"""One pre-LN transformer block on PyTorch, the building block of the LM.

The block keeps the reference's head-major parameter layouts, so one numpy
parameter set drives both packages: ``wqkv`` (3, H, D, d_head), ``wo``
(H, d_head, D), ``w1`` (D, F), ``w2`` (F, D). The attention core is a hook:
:func:`_dense_attention_core` (masked softmax) by default, or
:func:`flash_attention_core`, the hand-written CUDA kernel (differentiable:
its backward is the dense expression's). The projections are
``torch.einsum`` calls, which PyTorch hands to cuBLAS.

:func:`make_train_step` is the reference's SGD step of one block, on one
device or over a ``(dp, tp)`` ``DeviceMesh`` of ranks (the port of
reference's ``parallel/transformer.py:113-271``): the batch over ``dp``,
heads and the MLP hidden dimension over ``tp`` with Megatron's column and
row placements (:func:`_param_spec`). Where the reference annotates the
shardings and lets GSPMD insert the collectives, each rank here runs the
block on its shards (:func:`block_apply_tp`) with Megatron's conjugate
collectives (``compat.copy_to`` before a column-parallel product,
``compat.reduce_from`` after a row-parallel one), and the gradients are
summed over ``dp`` in one all-reduce after the backward. Sequence
parallelism (:func:`make_sp_train_step`) shards the sequence and runs
attention as the ring (:func:`ring_attention_core`); the block's other
parts are token-local. Every rank of the group calls these together.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops import cuda_kernels as K
from . import compat
from .compat import NamedSharding, P
from .moe import is_mesh, mesh_device
from .optim import sgd, tree_leaves, tree_map, value_and_grad


def init_block_params(seed: int, d_model: int, d_ff: int, n_heads: int,
                      dtype=np.float32) -> Dict[str, np.ndarray]:
    """LN + multi-head attention + 2-layer MLP, Xavier-ish init (numpy; the
    same seed gives the same arrays as the reference, draw for draw).

    Head-major layouts so the tensor-parallel axis is leading:
    ``wqkv``: (3, H, D, d_head), ``wo``: (H, d_head, D),
    ``w1``: (D, F), ``w2``: (F, D).
    """
    assert d_model % n_heads == 0
    dh = d_model // n_heads
    rng = np.random.default_rng(seed)

    def glorot(*shape, fan_in, fan_out):
        s = np.sqrt(2.0 / (fan_in + fan_out))
        return (rng.standard_normal(shape) * s).astype(dtype)

    return {
        "ln1_g": np.ones((d_model,), dtype), "ln1_b": np.zeros((d_model,), dtype),
        "ln2_g": np.ones((d_model,), dtype), "ln2_b": np.zeros((d_model,), dtype),
        "wqkv": glorot(3, n_heads, d_model, dh, fan_in=d_model, fan_out=d_model),
        "wo": glorot(n_heads, dh, d_model, fan_in=d_model, fan_out=d_model),
        "w1": glorot(d_model, d_ff, fan_in=d_model, fan_out=d_ff),
        "b1": np.zeros((d_ff,), dtype),
        "w2": glorot(d_ff, d_model, fan_in=d_ff, fan_out=d_model),
        "b2": np.zeros((d_model,), dtype),
    }


def _ln(x, g, b, eps=1e-5):
    """Layer norm written out (mean, biased variance) in x's dtype, as the
    reference writes it: ``F.layer_norm`` rounds at other places in bf16."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * g + b


def _dense_attention_core(q, k, v, causal: bool, scale: float):
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        S = s.shape[-1]
        mask = torch.ones((S, S), dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    a = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", a, v)


def flash_attention_core(q, k, v, causal: bool, scale: float):
    """Drop-in ``attention=`` core backed by the fused kernel
    (:func:`parsec_tpu_torch.ops.cuda_kernels.flash_attention`): scores and
    softmax stats stay on chip instead of materializing the S x S matrix.
    q, k and v are the (B, H, S, d_head) slices of the QKV projection, made
    contiguous for the kernel."""
    return K.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                             causal=causal, scale=scale)


def block_apply(params, x, causal: bool = True, attention=None,
                return_kv: bool = False, ffn=None):
    """One pre-LN transformer block: x -> x + MHA(LN(x)) -> + MLP(LN(.)).

    ``x``: (batch, seq, d_model). ``attention(q, k, v, causal, scale)``
    swaps the attention core. ``ffn(h) -> h`` swaps the position-wise MLP
    (the residual add stays here). ``return_kv=True`` additionally returns
    this block's (k, v), (B, H, S, d_head) each — the KV-cache prefill seed
    (:func:`parsec_tpu_torch.parallel.model.lm_generate`) — so generation
    shares THIS function's math rather than re-implementing it."""
    dh = params["wqkv"].shape[3]
    attn = attention if attention is not None else _dense_attention_core

    h = _ln(x, params["ln1_g"], params["ln1_b"])
    qkv = torch.einsum("bsd,chdk->cbhsk", h, params["wqkv"])   # (3,B,H,S,dh)
    ctx = attn(qkv[0], qkv[1], qkv[2], causal, 1.0 / math.sqrt(dh))
    x = x + torch.einsum("bhsd,hdo->bso", ctx, params["wo"])

    h = _ln(x, params["ln2_g"], params["ln2_b"])
    if ffn is not None:
        out = x + ffn(h)
    else:
        h = F.gelu(h @ params["w1"] + params["b1"], approximate="tanh")
        out = x + h @ params["w2"] + params["b2"]
    if return_kv:
        return out, qkv[1], qkv[2]
    return out


def _run_block(bp, x, remat: bool, **kw):
    """:func:`block_apply` of ``bp`` on ``x``; with ``remat`` under
    ``torch.utils.checkpoint`` (non-reentrant), the counterpart of the
    reference's rematerialization: the block's activations are not kept
    but recomputed in the backward pass."""
    if remat:
        return checkpoint(lambda p, h: block_apply(p, h, **kw), bp, x,
                          use_reentrant=False)
    return block_apply(bp, x, **kw)


def _placers(device):
    """(place_params, place_batch) for one device: the placement idiom
    every ``make_*_train_step`` shares. ``place_params`` copies a tree of
    numpy arrays or tensors onto ``device`` as float32 (a step updates what
    it returns in place, never the caller's tree); ``place_batch`` puts an
    integer batch there."""
    def place_params(params):
        def leaf(a):
            if isinstance(a, torch.Tensor):
                return a.detach().to(device, torch.float32, copy=True)
            return torch.from_numpy(np.array(a, np.float32)).to(device)
        return tree_map(leaf, params)

    def place_batch(x):
        return torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x).to(device)

    return place_params, place_batch


def make_train_step(mesh=None, dp: str = "dp", tp: str = "tp",
                    lr: float = 1e-2, causal: bool = True):
    """An SGD training step of one block.

    ``mesh`` a ``(dp, tp)`` ``DeviceMesh`` (:func:`make_tp_mesh`): the
    batch over ``dp``, Megatron placements over ``tp``; the placed
    parameters are DTensors, updated in place, and the loss a replicated
    DTensor. Otherwise the one device ``mesh`` names (the card when None).

    Returns ``(step, place_params, place_batch)``: call
    ``params = place_params(params)`` / ``x = place_batch(x)`` once, then
    ``params, loss = step(params, x, y)`` per iteration, the loss the mean
    squared error of the block's output against ``y`` before the step."""
    if is_mesh(mesh):
        pspec = _param_spec(mesh, dp, tp)
        xsh = NamedSharding(mesh, P(dp, None, None))

        def local_loss(lp, xl, yl, n):
            out = block_apply_tp(lp, xl, mesh, tp, causal=causal)
            return torch.sum((out - yl) ** 2) / n

        def step(params, x, y):
            lp = _local_tree(params, pspec)
            xl, yl = (compat.local_of(v, mesh, xsh.spec) for v in (x, y))
            loss, leaves, grads = _mesh_value_and_grad(
                lambda p: local_loss(p, xl, yl, _numel(y)), lp, mesh, dp)
            sgd(leaves, grads, lr)
            return params, loss

        return (step,) + _mesh_placers(pspec, xsh)
    device = mesh_device(mesh)

    def step(params, x, y):
        loss, leaves, grads = value_and_grad(
            lambda p: torch.mean((block_apply(p, x, causal=causal) - y) ** 2),
            params)
        sgd(leaves, grads, lr)
        return params, loss

    return (step,) + _placers(device)


# ------------------------------------------------------------------ meshes

def _param_spec(mesh, dp: str, tp: str) -> dict:
    """Megatron placement: heads/ff over ``tp``, everything small
    replicated (``dp`` replicates every parameter)."""
    specs = {
        "ln1_g": P(), "ln1_b": P(), "ln2_g": P(), "ln2_b": P(),
        "wqkv": P(None, tp, None, None),   # column-parallel (heads)
        "wo": P(tp, None, None),           # row-parallel
        "w1": P(None, tp),                 # column-parallel (ff)
        "b1": P(tp),
        "w2": P(tp, None),                 # row-parallel
        "b2": P(),
    }
    return {k: NamedSharding(mesh, v) for k, v in specs.items()}


def _numel(x) -> int:
    return int(np.prod(tuple(x.shape)))


def _local_tree(params, spec_tree):
    """This rank's shards of a placed tree (the DTensors' own storage)."""
    if isinstance(params, dict):
        return {k: _local_tree(v, spec_tree[k]) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [_local_tree(v, s) for v, s in zip(params, spec_tree)]
    return compat.local_of(params, spec_tree.mesh, spec_tree.spec)


def _mesh_placers(spec_tree, batch_sharding):
    """(place_params, place_batch) over a mesh: ``place_params`` copies a
    tree of numpy arrays or tensors (the same on every rank) into float32
    DTensors on ``spec_tree``'s shardings; ``place_batch`` puts a batch on
    ``batch_sharding``."""
    def place_params(params):
        def place(a, sh):
            return compat.distribute(a, sh.mesh, sh.spec, torch.float32)
        return _zip_map(place, params, spec_tree)

    def place_batch(x):
        return compat.distribute(x, batch_sharding.mesh, batch_sharding.spec)

    return place_params, place_batch


def _zip_map(fn, tree, spec_tree):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, spec_tree[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_zip_map(fn, v, s) for v, s in zip(tree, spec_tree)]
    return fn(tree, spec_tree)


def _sum_grads(grads: list, group) -> None:
    """Sum the gradients over ``group`` in place, in one flat all-reduce
    (the data-parallel gradient all-reduce GSPMD inserts)."""
    if compat._size(group) == 1 or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    compat.all_reduce_(flat, group)
    off = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[off:off + n].view_as(g))
        off += n


def _mesh_value_and_grad(local_loss, lp, mesh, dp: Optional[str]):
    """:func:`value_and_grad` of a rank's share of the loss: the
    gradients (and the loss) summed over the ``dp`` axis, the loss returned
    as a replicated DTensor."""
    loss, leaves, grads = value_and_grad(local_loss, lp)
    grads = [g.contiguous() for g in grads]
    if dp is not None:
        g = compat.group(mesh, dp)
        _sum_grads(grads, g)
        compat.all_reduce_(loss, g)
    return compat.from_local(loss, mesh, P()), leaves, grads


def block_apply_tp(lp, x, mesh, tp: str = "tp", causal: bool = True,
                   attention=None):
    """One pre-LN block on this rank's Megatron shards ``lp`` (its heads of
    ``wqkv``/``wo``, its columns of ``w1``/``b1`` and rows of ``w2``) and
    its batch ``x`` (replicated over ``tp``): the tp all-reduce after each
    row-parallel product (:func:`compat.reduce_from`), and
    :func:`compat.copy_to` before each column-parallel one."""
    g = compat.group(mesh, tp)
    dh = lp["wqkv"].shape[3]
    attn = attention if attention is not None else _dense_attention_core
    h = compat.copy_to(_ln(x, lp["ln1_g"], lp["ln1_b"]), g)
    qkv = torch.einsum("bsd,chdk->cbhsk", h, lp["wqkv"])     # local heads
    ctx = attn(qkv[0], qkv[1], qkv[2], causal, 1.0 / math.sqrt(dh))
    x = x + compat.reduce_from(torch.einsum("bhsd,hdo->bso", ctx, lp["wo"]),
                               g)
    h = compat.copy_to(_ln(x, lp["ln2_g"], lp["ln2_b"]), g)
    h = F.gelu(h @ lp["w1"] + lp["b1"], approximate="tanh")
    return x + compat.reduce_from(h @ lp["w2"], g) + lp["b2"]


def _seq_axis(mesh) -> str:
    if len(mesh.mesh_dim_names) != 1:
        raise ValueError(f"sequence-parallel training needs a 1D mesh (got "
                         f"axes {mesh.mesh_dim_names}); use make_1d_mesh/"
                         "_seq_mesh")
    return mesh.mesh_dim_names[0]


def ring_attention_core(mesh):
    """An ``attention=`` core running ring attention over ``mesh`` on
    replicated q/k/v (every rank holding the whole sequence, as in
    :func:`~parsec_tpu_torch.parallel.model.lm_apply`): each rank takes its
    sequence block (:func:`compat.scatter_to`), runs the ring, and the
    blocks are gathered back (:func:`compat.gather_from`)."""
    from .ring_attention import ring_local
    g = compat.group(mesh, _seq_axis(mesh))

    def core(q, k, v, causal, scale):
        qb, kb, vb = (compat.scatter_to(t.contiguous(), g, 2)
                      for t in (q, k, v))
        return compat.gather_from(ring_local(qb, kb, vb, mesh, causal, scale),
                                  g, 2)
    return core


def _ring_local_core(mesh):
    """An ``attention=`` core on this rank's sequence block: the ring's
    per-rank body (K/V rotating, gradients riding the reverse ring)."""
    from .ring_attention import ring_local

    def core(q, k, v, causal, scale):
        return ring_local(q, k, v, mesh, causal, scale)
    return core


def block_apply_sp(params, x, mesh, causal: bool = True):
    """The same pre-LN block with the SEQUENCE axis sharded over ``mesh``:
    attention runs as ring attention, the LN/MLP parts are token-local.
    ``x`` is global (a DTensor sharded over the sequence, or the full
    value); returns a DTensor sharded over the sequence."""
    axis = _seq_axis(mesh)
    spec = P(None, axis, None)
    fn = compat.shard_map(
        lambda xb: block_apply({k: compat.local_of(v, mesh, P())
                                for k, v in params.items()}, xb,
                               causal=causal,
                               attention=_ring_local_core(mesh)),
        mesh, (spec,), spec)
    return fn(x)


def make_sp_train_step(mesh, lr: float = 1e-2, causal: bool = True):
    """Long-context training: the sequence axis sharded over the 1D mesh,
    attention via the ring — per-rank memory O(S/P · S/P), no S×S
    anywhere, gradients riding the reverse ring and summed over the mesh.
    Same return shape as :func:`make_train_step`."""
    axis = _seq_axis(mesh)
    xsh = NamedSharding(mesh, P(None, axis, None))
    psp = NamedSharding(mesh, P())
    core = _ring_local_core(mesh)

    def step(params, x, y):
        lp = {k: compat.local_of(v, mesh, P()) for k, v in params.items()}
        xl, yl = (compat.local_of(v, mesh, xsh.spec) for v in (x, y))
        n = _numel(y)
        loss, leaves, grads = _mesh_value_and_grad(
            lambda p: torch.sum((block_apply(p, xl, causal=causal,
                                             attention=core) - yl) ** 2) / n,
            lp, mesh, axis)
        sgd(leaves, grads, lr)
        return params, loss

    place_params, place_batch = _mesh_placers(
        {k: psp for k in ("ln1_g", "ln1_b", "ln2_g", "ln2_b", "wqkv", "wo",
                          "w1", "b1", "w2", "b2")}, xsh)
    return step, place_params, place_batch


def make_tp_mesh(n_devices: Optional[int] = None,
                 dp_size: Optional[int] = None,
                 tp_must_divide: Optional[int] = None,
                 device_type: str = "cuda"):
    """A 2D (dp, tp) mesh over the group's first n ranks (all of them by
    default).

    ``tp_must_divide`` (typically ``n_heads``): the tensor-parallel axis is
    chosen among divisors of it, so the Megatron shardings always place —
    an arbitrary near-square split would crash for rank counts whose
    factors don't divide the head/ff dimensions."""
    from .multihost import device_mesh
    from .spmd import _world, best_grid
    n = _world(n_devices)
    if dp_size is None:
        dp_size, tp = best_grid(n)
        if tp_must_divide is not None and tp_must_divide % tp != 0:
            tp = next(t for t in range(min(tp, tp_must_divide), 0, -1)
                      if n % t == 0 and tp_must_divide % t == 0)
            dp_size = n // tp
    else:
        tp = n // dp_size
    if dp_size * tp != n:
        raise ValueError(f"dp {dp_size} does not divide {n} ranks")
    return device_mesh((dp_size, tp), ("dp", "tp"), device_type)
