"""GPT-class causal language model on PyTorch: serving and training on one
device.

A decoder-only LM (learned token + position embeddings, N pre-LN
transformer blocks, final LN, tied LM head) as functions of a plain
parameter dict whose keys and layouts are the reference's
(``embed``, ``pos``, ``lnf_g``, ``lnf_b``, ``blocks[i][ln1_g ... b2]``):

* :func:`lm_apply` / :func:`lm_loss` — forward and token cross-entropy
  under autograd, pluggable attention core (dense, or the flash kernel
  through :func:`~parsec_tpu_torch.parallel.transformer.flash_attention_core`,
  whose backward is the dense expression's), ``remat`` (each block under
  ``torch.utils.checkpoint``), ``compute_dtype`` for bf16 blocks with f32
  master parameters, logits and loss;
* :func:`make_lm_train_step` (SGD) and :func:`make_lm_opt_train_step`
  (the transforms of :mod:`parsec_tpu_torch.parallel.optim`, optax's
  AdamW and global-norm clip on ``torch.optim``) — one training step on
  one device;
* the MoE-LM: :func:`init_lm_moe_params`, :func:`lm_moe_apply` (the dense
  routed truth, or :func:`~parsec_tpu_torch.parallel.moe.moe_forward` on an
  expert group of one device) and :func:`make_lm_moe_train_step`;
* :func:`lm_generate` — KV-cached autoregressive decoding, greedy or
  sampled, dense or MoE: on a card the decode step is one CUDA graph,
  replayed once a token (the counterpart of the reference's jitted
  ``lax.scan``), on the CPU an eager loop of the same step;
* :func:`params_from_numpy` / :func:`params_to_numpy` — the parameter tree
  to and from numpy, key for key;
* :class:`LanguageModel` — a thin ``nn.Module`` holding that dict.

A ``mesh`` argument names one device (see
:func:`~parsec_tpu_torch.parallel.moe.mesh_device`) or is a
``DeviceMesh`` over ranks (the port of
reference's ``parallel/model.py:376-570``; every rank of the group calls
the entry point together):

* ``make_lm_train_step``/``make_lm_opt_train_step`` over ``(dp, tp)``: the
  batch over ``dp``, Megatron blocks and the vocab-parallel tied
  embedding and head over ``tp`` (:func:`_lm_param_spec`; a vocabulary
  the axis does not divide splits as ``torch.chunk`` does, as DTensor's
  ``Shard(0)``), the cross-entropy computed over the vocabulary shards,
  the optimizer moments placed like their parameters
  (:func:`_state_spec_like`) and the global-norm clip summed across
  shards;
* :func:`lm_pp_forward` — the blocks split into contiguous stages over a
  ``pp`` mesh, microbatches through the GPipe schedule;
* ``lm_moe_apply(mesh=ep)`` / ``make_lm_moe_train_step(mesh)`` — each
  block's experts spread over an ``ep`` mesh, dispatch and combine by
  all-to-all;
* ``lm_apply(..., attention=ring_attention_core(mesh))`` — attention as
  the ring over an ``sp`` mesh.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import threading
import weakref
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import cuda_kernels as K
from . import compat
from .compat import NamedSharding, P
from .moe import (_topk_gates, dense_reference, init_moe_params, is_mesh,
                  mesh_device, moe_ep_local, moe_forward)
from .optim import sgd, tree_leaves, tree_map, value_and_grad
from .transformer import (block_apply, block_apply_tp, init_block_params,
                          _ln, _local_tree, _mesh_placers,
                          _mesh_value_and_grad, _numel, _param_spec,
                          _placers, _run_block, _zip_map,
                          ring_attention_core)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Decoder-only LM hyperparameters (frozen: usable as a cache key)."""
    vocab_size: int = 256
    d_model: int = 128
    d_ff: int = 512
    n_heads: int = 8
    n_layers: int = 2
    max_seq: int = 256


def init_lm_params(seed: int, cfg: ModelConfig) -> dict:
    """Embeddings + per-block params + final LN, as numpy arrays (the same
    seed gives the reference's arrays bit for bit). The LM head is TIED to
    the token embedding (logits = h @ embed.T)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    p = {
        "embed": (rng.standard_normal((cfg.vocab_size, cfg.d_model)) *
                  0.02).astype(f32),
        "pos": (rng.standard_normal((cfg.max_seq, cfg.d_model)) *
                0.02).astype(f32),
        "lnf_g": np.ones(cfg.d_model, f32),
        "lnf_b": np.zeros(cfg.d_model, f32),
        "blocks": [init_block_params(seed + 1 + i, cfg.d_model, cfg.d_ff,
                                     cfg.n_heads)
                   for i in range(cfg.n_layers)],
    }
    return p


def _resolve_device(device) -> torch.device:
    """``None`` means the card; without one that raises (pass "cpu")."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the LM runs on the card unless "
                               "it is given device='cpu'")
        device = "cuda"
    return torch.device(device)


def params_from_numpy(tree, device=None, dtype=torch.float32) -> dict:
    """The reference's parameter tree (numpy leaves) as tensors on
    ``device`` (default: the card), floating leaves in ``dtype``; keys,
    nesting and layouts unchanged. Every leaf is a copy: a training step
    updates the tensors in place, never the numpy arrays."""
    dev = _resolve_device(device)

    def leaf(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(dev, dtype if t.is_floating_point() else t.dtype,
                    copy=True)
    return tree_map(leaf, tree)


def params_to_numpy(tree) -> dict:
    """Inverse of :func:`params_from_numpy`: every tensor leaf to a numpy
    array on the host (bf16 leaves widen to float32, exactly)."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree_map(leaf, tree)


def _moe_ffn(mp, k: int):
    """A block's ``ffn`` hook routing through its experts densely (the
    reference's ``mesh=None`` truth, :func:`dense_reference`)."""
    def ffn(h):
        return dense_reference(mp, h.reshape(-1, h.shape[-1]), k=k
                               ).reshape(h.shape)
    return ffn


def _check_seq(params, S: int) -> None:
    if S > params["pos"].shape[0]:
        raise ValueError(f"sequence length {S} exceeds the model's "
                         f"max_seq {params['pos'].shape[0]}")


def lm_apply(params: dict, tokens, causal: bool = True, attention=None,
             remat: bool = False, compute_dtype=None):
    """tokens (B, S) integer -> logits (B, S, V) float32.

    ``compute_dtype=torch.bfloat16`` runs the blocks in bf16: the embedding
    gather and position add run in f32 and are then cast, the block
    parameters are cast (f32 masters, so their gradients arrive in f32
    through the cast's backward), and the final LN and the tied head run in
    f32 (TF32 off). ``attention`` swaps the attention core of every block.
    ``remat=True`` runs each block under ``torch.utils.checkpoint``
    (non-reentrant), the counterpart of the reference's rematerialization:
    its activations are recomputed in the backward pass, the attention
    core's forward included. MoE-LM parameters (blocks with a ``moe``
    sub-dict) route each block's FFN through its top-2 experts densely, as
    :func:`lm_generate` decodes them."""
    K.dot_precision()                       # f32 products: TF32 off
    tokens = torch.as_tensor(tokens, device=params["embed"].device)
    S = tokens.shape[1]
    _check_seq(params, S)
    blocks = params["blocks"]
    h = F.embedding(tokens, params["embed"]) + params["pos"][:S][None, :, :]
    if compute_dtype is not None:
        def cast(t):
            return t.to(compute_dtype) if t.is_floating_point() else t
        h = cast(h)
        blocks = [tree_map(cast, bp) for bp in blocks]
    for bp in blocks:
        ffn = _moe_ffn(bp["moe"], 2) if "moe" in bp else None
        h = _run_block(bp, h, remat, causal=causal, attention=attention,
                       ffn=ffn)
    h = _ln(h.float(), params["lnf_g"], params["lnf_b"])
    return torch.einsum("bsd,vd->bsv", h, params["embed"])


def _xent(logits, targets):
    """Mean next-token cross-entropy of f32 logits (B, S, V)."""
    targets = torch.as_tensor(targets, device=logits.device).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None]).squeeze(-1)
    return (logz - gold).mean()


def lm_loss(params: dict, tokens, targets, causal: bool = True,
            attention=None, remat: bool = False, compute_dtype=None):
    """Mean next-token cross-entropy (f32); ``targets`` (B, S) integer."""
    return _xent(lm_apply(params, tokens, causal=causal, attention=attention,
                          remat=remat, compute_dtype=compute_dtype), targets)


# ----------------------------------------------------------- MoE-LM family

def init_lm_moe_params(seed: int, cfg: ModelConfig, n_experts: int) -> dict:
    """Switch/Mixtral-class variant: every block's position-wise MLP is
    replaced by a router + ``n_experts`` expert MLPs (hidden ``cfg.d_ff``).
    Attention/embedding/LN params are identical to :func:`init_lm_params`
    (numpy; bit for bit the reference's)."""
    p = init_lm_params(seed, cfg)
    for i, bp in enumerate(p["blocks"]):
        for k in ("w1", "b1", "w2", "b2"):
            bp.pop(k)
        bp["moe"] = init_moe_params(seed + 101 + i, n_experts,
                                    cfg.d_model, cfg.d_ff)
    return p


def lm_moe_apply(params: dict, tokens, causal: bool = True, k: int = 2,
                 mesh=None, capacity_factor: Optional[float] = None,
                 return_aux: bool = False, remat: bool = False):
    """MoE-LM forward: logits (B, S, V), with each block's FFN routed
    through its top-``k`` experts.

    ``mesh=None`` computes the routed FFN densely (every token through its
    selected experts — the truth). A ``mesh`` of one device (the
    parameters' own) runs each FFN through
    :func:`~parsec_tpu_torch.parallel.moe.moe_forward` on that expert
    group: dispatch into per-expert buffers of the capacity
    ``capacity_factor`` gives (no-drop by default, where both paths agree)
    and combine. An ``ep`` ``DeviceMesh`` (every rank holding the whole
    parameter tree, calling together) spreads each block's experts and its
    tokens over the ranks (:func:`_moe_mesh_ffn`): the rest of the model
    runs alike on every rank, and the gradients come out whole on each.
    ``return_aux=True`` adds ``{"aux_loss", "dropped"}`` — the
    mean Switch load-balancing loss over blocks (add ``lambda*aux`` to the
    training objective) and the total overflow drops (always 0 on the
    dense path)."""
    dev = params["embed"].device
    if mesh is not None and mesh_device(mesh) != dev:
        raise ValueError(f"the expert group's device {mesh_device(mesh)} is "
                         f"not the parameters' {dev}")
    tokens = torch.as_tensor(tokens, device=dev)
    B, S = tokens.shape
    _check_seq(params, S)
    if remat and return_aux:
        # the aux accumulator is a host-side closure; a rematerialized
        # backward would replay the appends and double-count it
        raise ValueError("remat=True is incompatible with return_aux=True "
                         "(compute the aux loss in a separate un-rematted "
                         "forward)")
    K.dot_precision()
    x = F.embedding(tokens, params["embed"]) + params["pos"][:S][None]
    aux_acc, drop_acc = [], []
    for bp in params["blocks"]:
        mp = bp["moe"]

        def ffn(h, mp=mp):
            h2 = h.reshape(B * S, -1)
            if mesh is None:
                if return_aux:
                    # Switch aux loss from the EXACT routed activation
                    E = mp["w1"].shape[0]
                    probs = torch.softmax(h2 @ mp["router"], dim=-1)
                    _, eid = _topk_gates(probs, k)
                    f = F.one_hot(eid[:, 0], E).float().mean(0)
                    aux_acc.append(E * torch.sum(f * probs.float().mean(0)))
                    drop_acc.append(h2.new_zeros((), dtype=torch.float32))
                out = dense_reference(mp, h2, k=k)
            elif is_mesh(mesh):
                out, aux, dropped = _moe_mesh_ffn(mp, h2, mesh, k,
                                                  capacity_factor)
                aux_acc.append(aux)
                drop_acc.append(dropped)
            elif return_aux:
                out, a = moe_forward(mp, h2, mesh=mesh, k=k,
                                     capacity_factor=capacity_factor,
                                     return_aux=True)
                aux_acc.append(a["aux_loss"])
                drop_acc.append(a["dropped"])
            else:
                out = moe_forward(mp, h2, mesh=mesh, k=k,
                                  capacity_factor=capacity_factor)
            return out.reshape(B, S, -1)

        x = _run_block(bp, x, remat, causal=causal, ffn=ffn)
    h = _ln(x, params["lnf_g"], params["lnf_b"])
    logits = torch.einsum("bsd,vd->bsv", h, params["embed"])
    if return_aux:
        return logits, {"aux_loss": sum(aux_acc) / len(aux_acc),
                        "dropped": sum(drop_acc)}
    return logits


def _moe_mesh_ffn(mp, h2, mesh, k: int, capacity_factor):
    """A block's routed FFN over an ``ep`` mesh on replicated tokens ``h2``
    and replicated experts: each rank takes its rows of the tokens and its
    experts (:func:`compat.scatter_to`, whose backward all-gathers the
    gradient), runs the expert-parallel layer and the rows are gathered
    back (:func:`compat.gather_from`). Returns (out, aux, dropped)."""
    g = compat.group(mesh, mesh.mesh_dim_names[0])
    nP = mesh.size(0)
    if h2.shape[0] % nP or mp["w1"].shape[0] % nP:
        raise ValueError(f"{h2.shape[0]} tokens and {mp['w1'].shape[0]} "
                         f"experts must split over the {nP}-rank ep mesh")
    lp = {"router": mp["router"], "w1": compat.scatter_to(mp["w1"], g, 0),
          "w2": compat.scatter_to(mp["w2"], g, 0)}
    y, aux, dropped = moe_ep_local(lp, compat.scatter_to(h2, g, 0), mesh, k,
                                   capacity_factor=capacity_factor)
    return compat.gather_from(y, g, 0), aux, dropped


def make_lm_moe_train_step(mesh=None, k: int = 2, lr: float = 1e-2,
                           aux_weight: float = 0.01, causal: bool = True):
    """An SGD step for the MoE-LM: token cross-entropy plus ``aux_weight``
    x the Switch load-balancing loss, gradients through the expert dispatch
    (:func:`moe_forward` on the one-device expert group ``mesh`` names, or
    the experts spread over an ``ep`` ``DeviceMesh``; the dense routed
    truth when ``mesh`` is None). Returns ``step(params, tokens, targets)
    -> (params, loss)``: the parameters are updated in place (the same
    dict is returned) and the loss is the pre-step one, a 0-dim tensor (a
    replicated DTensor on a mesh); losses from both paths agree under
    no-drop capacity."""
    if mesh is not None:
        mesh_device(mesh)           # a list of more than one device raises

    def loss_fn(p, tokens, targets):
        logits, aux = lm_moe_apply(p, tokens, causal=causal, k=k,
                                   mesh=mesh, return_aux=True)
        return _xent(logits, targets) + aux_weight * aux["aux_loss"]

    def step(params, tokens, targets):
        loss, leaves, grads = value_and_grad(
            lambda p: loss_fn(p, tokens, targets), params)
        sgd(leaves, grads, lr)
        if is_mesh(mesh):
            loss = compat.from_local(loss, mesh, P())
        return params, loss

    return step


# ----------------------------------------------------------- training steps

def make_lm_train_step(mesh=None, dp: str = "dp", tp: str = "tp",
                       lr: float = 1e-2, causal: bool = True,
                       n_layers: Optional[int] = None, params: dict = None):
    """An SGD LM training step: over a ``(dp, tp)`` ``DeviceMesh`` (the
    batch over ``dp``, Megatron blocks and the vocab-parallel tied
    embedding over ``tp``; the placed parameters are DTensors and the loss
    a replicated DTensor), or on the one device ``mesh`` names (the card
    when None).

    Returns ``(step, place_params, place_batch)``; ``n_layers`` is taken
    from ``params`` when given. ``step(params, tokens, targets) -> (params,
    loss)`` updates the placed parameters in place (the same tree is
    returned) and gives the pre-step loss. For a real optimizer use
    :func:`make_lm_opt_train_step`. Usage::

        step, place_p, place_t = make_lm_train_step(mesh, params=params)
        params = place_p(params)
        params, loss = step(params, place_t(tokens), place_t(targets))
    """
    if n_layers is None:
        if params is None:
            raise ValueError("pass n_layers= or params=")
        n_layers = len(params["blocks"])
    if is_mesh(mesh):
        pspec = _lm_param_spec(mesh, dp, tp, n_layers)
        tsh = NamedSharding(mesh, P(dp, None))

        def step(params, tokens, targets):
            loss, leaves, grads = _lm_mesh_grads(
                params, pspec, tsh, tokens, targets, mesh, dp, tp,
                dict(causal=causal))
            sgd(leaves, grads, lr)
            return params, loss

        return (step,) + _mesh_placers(pspec, tsh)
    device = mesh_device(mesh)

    def step(params, tokens, targets):
        loss, leaves, grads = value_and_grad(
            lambda p: lm_loss(p, tokens, targets, causal=causal), params)
        sgd(leaves, grads, lr)
        return params, loss

    return (step,) + _placers(device)


def make_lm_opt_train_step(mesh, tx, params: dict, dp: str = "dp",
                           tp: str = "tp", causal: bool = True,
                           remat: bool = False, compute_dtype=None,
                           attention=None):
    """An LM training step with the optimizer transform ``tx``, over a
    ``(dp, tp)`` ``DeviceMesh`` or on the one device ``mesh`` names (the
    card when None).

    ``tx`` is a transform of :mod:`parsec_tpu_torch.parallel.optim` —
    ``adamw(lr)`` or ``chain(clip_by_global_norm(1.0), adamw(lr))``, optax's
    defaults on ``torch.optim.AdamW`` and ``clip_grad_norm_`` (the mapping
    is in that module's docstring). On a mesh the moments are DTensors
    placed like the parameters they mirror (:func:`_state_spec_like`) and
    the clip's global norm sums the squares across the ``tp`` shards.
    ``remat``/``compute_dtype`` are :func:`lm_apply`'s memory levers (bf16
    compute keeps f32 master parameters and f32 gradients); ``attention``
    swaps the attention core (the flash kernel through
    ``flash_attention_core``). Returns ``(step, opt_state, place_params,
    place_batch)``, the state made by ``tx.init(params)`` and placed::

        step, opt_state, place_p, place_t = make_lm_opt_train_step(
            device, chain(clip_by_global_norm(1.0), adamw(3e-4)), params)
        params = place_p(params)
        params, opt_state, loss = step(params, opt_state, tokens, targets)

    The step updates the parameters and the state in place (the same
    objects are returned) and gives the pre-step loss (a replicated
    DTensor on a mesh)."""
    kw = dict(causal=causal, attention=attention, remat=remat,
              compute_dtype=compute_dtype)
    if is_mesh(mesh):
        pspec = _lm_param_spec(mesh, dp, tp, len(params["blocks"]))
        tsh = NamedSharding(mesh, P(dp, None))
        state = tx.init(params, "cpu")
        ospec = _state_spec_like(mesh, pspec, params, state)
        opt_state = _zip_map(
            lambda a, sh: compat.distribute(a, sh.mesh, sh.spec), state,
            ospec)
        tpg = compat.group(mesh, tp)
        groups = [tpg if tp in sh.spec else None for sh in tree_leaves(pspec)]

        def step(params, opt_state, tokens, targets):
            loss, leaves, grads = _lm_mesh_grads(
                params, pspec, tsh, tokens, targets, mesh, dp, tp, kw)
            tx.apply(leaves, grads, _local_tree(opt_state, ospec),
                     shard_groups=groups)
            return params, opt_state, loss

        return (step, opt_state) + _mesh_placers(pspec, tsh)
    device = mesh_device(mesh)
    opt_state = tx.init(params, device)

    def step(params, opt_state, tokens, targets):
        loss, leaves, grads = value_and_grad(
            lambda p: lm_loss(p, tokens, targets, **kw), params)
        tx.apply(leaves, grads, opt_state)
        return params, opt_state, loss

    return (step, opt_state) + _placers(device)


# ------------------------------------------------------------ LM on meshes

def _lm_param_spec(mesh, dp: str, tp: str, n_layers: int) -> dict:
    """Vocab-parallel embedding/head over ``tp``; Megatron block specs."""
    return {
        "embed": NamedSharding(mesh, P(tp, None)),   # vocab-parallel
        "pos": NamedSharding(mesh, P()),
        "lnf_g": NamedSharding(mesh, P()),
        "lnf_b": NamedSharding(mesh, P()),
        "blocks": [_param_spec(mesh, dp, tp) for _ in range(n_layers)],
    }


def _paths(tree, prefix=()):
    """(path, leaf) pairs of a tree, dict keys sorted (leaf order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (str(i),))
    else:
        yield prefix, tree


def _state_spec_like(mesh, pspec, params, state):
    """Shardings for an optimizer-state tree: the moment trees MIRROR the
    parameter tree, so a state leaf whose tree path ends with a parameter's
    full path (and matches its shape) adopts that parameter's sharding —
    AdamW's mu/nu land distributed exactly like their parameters.
    Everything else (the step count) replicates. Path matching (not shape
    matching) keeps equal-shaped parameters with different specs apart
    (the vocab-parallel ``embed`` and the replicated ``pos`` when
    vocab_size == max_seq)."""
    rep = NamedSharding(mesh, P())
    by_path = {path: (tuple(np.shape(leaf)), spec) for (path, leaf), spec
               in zip(_paths(params), tree_leaves(pspec))}

    def spec_of(path, leaf):
        for i in range(len(path)):
            hit = by_path.get(path[i:])
            if hit is not None and hit[0] == tuple(np.shape(leaf)):
                return hit[1]
        return rep

    def walk(tree, prefix=()):
        if isinstance(tree, dict):
            return {k: walk(v, prefix + (str(k),)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v, prefix + (str(i),)) for i, v in enumerate(tree)]
        return spec_of(prefix, tree)
    return walk(state)


def _vocab_bounds(mesh, tp: str, vocab: int):
    n = mesh.size(mesh.mesh_dim_names.index(tp))
    return compat.chunk_bounds(vocab, n, mesh.get_local_rank(tp))


def lm_apply_tp(lp: dict, tokens, mesh, tp: str, vocab: int,
                causal: bool = True, attention=None, remat: bool = False,
                compute_dtype=None):
    """The LM forward on this rank's shards ``lp`` and its batch ``tokens``
    (replicated over ``tp``): the vocab-parallel embedding (each rank looks
    up the tokens in its rows, the rest summed in), the Megatron blocks
    (:func:`~parsec_tpu_torch.parallel.transformer.block_apply_tp`), the
    final LN and this rank's columns of the tied head's logits
    (B, S, V_local), float32."""
    K.dot_precision()
    g = compat.group(mesh, tp)
    lo, hi = _vocab_bounds(mesh, tp, vocab)
    S = tokens.shape[1]
    if S > lp["pos"].shape[0]:
        raise ValueError(f"sequence length {S} exceeds the model's "
                         f"max_seq {lp['pos'].shape[0]}")
    tokens = tokens.long()
    mine = (tokens >= lo) & (tokens < hi)
    if hi > lo:
        e = F.embedding((tokens - lo).clamp(0, hi - lo - 1), lp["embed"])
        e = e * mine[..., None].to(e.dtype)
    else:
        e = lp["embed"].new_zeros(tokens.shape + (lp["pos"].shape[1],))
    h = compat.reduce_from(e, g) + lp["pos"][:S][None, :, :]
    blocks = lp["blocks"]
    if compute_dtype is not None:
        def cast(t):
            return t.to(compute_dtype) if t.is_floating_point() else t
        h = cast(h)
        blocks = [tree_map(cast, bp) for bp in blocks]

    def blk(bp, x):
        return block_apply_tp(bp, x, mesh, tp, causal=causal,
                              attention=attention)
    for bp in blocks:
        if remat:
            h = torch.utils.checkpoint.checkpoint(blk, bp, h,
                                                  use_reentrant=False)
        else:
            h = blk(bp, h)
    h = _ln(h.float(), lp["lnf_g"], lp["lnf_b"])
    return torch.einsum("bsd,vd->bsv", compat.copy_to(h, g), lp["embed"])


def _xent_tp(logits, targets, mesh, tp: str, vocab: int):
    """Per-token cross-entropy (B, S) of vocab-sharded logits: the max and
    the sum of exponentials, and the gold logit, summed over ``tp``."""
    g = compat.group(mesh, tp)
    lo, hi = _vocab_bounds(mesh, tp, vocab)
    if hi > lo:
        m = logits.detach().amax(dim=-1)
    else:
        m = logits.new_full(logits.shape[:-1], float("-inf"))
    compat.all_reduce_(m, g, "max")
    se = compat.reduce_from(torch.exp(logits - m[..., None]).sum(-1), g)
    targets = targets.long()
    mine = (targets >= lo) & (targets < hi)
    if hi > lo:
        gold = torch.gather(logits, -1, (targets - lo).clamp(
            0, hi - lo - 1)[..., None]).squeeze(-1) * mine.to(logits.dtype)
    else:
        gold = logits.new_zeros(targets.shape)
    return m + torch.log(se) - compat.reduce_from(gold, g)


def _lm_mesh_grads(params, pspec, tsh, tokens, targets, mesh, dp: str,
                   tp: str, kw: dict):
    """(loss, leaves, grads) of the LM's mean cross-entropy on the mesh:
    each rank differentiates its share (its dp rows), the gradients and
    the loss summed over ``dp``."""
    lp = _local_tree(params, pspec)
    tl, gl = (compat.local_of(v, mesh, tsh.spec) for v in (tokens, targets))
    vocab = params["embed"].shape[0]
    n = _numel(targets)
    return _mesh_value_and_grad(
        lambda p: _xent_tp(lm_apply_tp(p, tl, mesh, tp, vocab, **kw), gl,
                           mesh, tp, vocab).sum() / n, lp, mesh, dp)


def _lm_stage_fn(per: int, causal: bool):
    """A stage of ``per`` blocks (a list of block trees)."""
    def stage_fn(layers, act):
        for bp in layers:
            act = block_apply(bp, act, causal=causal)
        return act
    return stage_fn


def lm_pp_forward(params: dict, tokens, mesh=None,
                  n_micro: Optional[int] = None, causal: bool = True):
    """Pipeline-parallel LM forward: the blocks split into P contiguous
    stage groups (rank i of the ``pp`` mesh owns layers [i·L/P,
    (i+1)·L/P)), microbatches of the batch stream through the GPipe
    schedule (:func:`~parsec_tpu_torch.parallel.pipeline.pipe_local`);
    embedding and the tied head run replicated outside the pipe.
    ``tokens`` (B, S) with B divisible by ``n_micro``; returns logits
    (B, S, V) matching :func:`lm_apply`, a DTensor replicated over the
    mesh (None on a rank outside it). Every rank of the group calls it
    together, each holding the parameter tree (numpy or tensors)."""
    from .pipeline import make_pp_mesh, pipe_local
    mesh = mesh if mesh is not None else make_pp_mesh()
    nP = mesh.size(0)
    L = len(params["blocks"])
    if L % nP:
        raise ValueError(f"{L} layers do not split over {nP} stages")
    per = L // nP
    B, S = tokens.shape
    if S > params["pos"].shape[0]:
        raise ValueError(f"sequence length {S} exceeds the model's "
                         f"max_seq {params['pos'].shape[0]}")
    m = int(n_micro) if n_micro is not None else nP
    if B % m:
        raise ValueError(f"batch {B} not divisible by n_micro {m}")
    if not compat.in_mesh(mesh):
        return None
    K.dot_precision()
    idx = mesh.get_local_rank(mesh.mesh_dim_names[0])

    def here(a):
        return compat.local_of(a, mesh, P())
    layers = [tree_map(here, params["blocks"][idx * per + i])
              for i in range(per)]
    embed, pos = here(params["embed"]), here(params["pos"])
    tokens = here(tokens).long()
    x = F.embedding(tokens, embed) + pos[:S][None]
    xs = x.reshape(m, B // m, S, x.shape[-1])
    out = pipe_local(layers, xs, mesh, m, _lm_stage_fn(per, causal))
    h = _ln(out.reshape(B, S, -1), here(params["lnf_g"]),
            here(params["lnf_b"]))
    return compat.from_local(torch.einsum("bsd,vd->bsv", h, embed), mesh,
                             P())


def _decode_block(bp, x, ck, cv, pos, scale: float, ffn=None):
    """One transformer block for ONE new token at position ``pos`` (a 0-dim
    int64 tensor on the caches' device) against KV caches (B, H, S, dh):
    the new k/v are written into the caches in place at ``pos``
    (``index_copy_`` along the sequence axis; the caches are preallocated,
    the reference updates immutable arrays with ``dynamic_update_slice``),
    and the scores are masked to the positions written so far. Every
    position runs the same kernels on the same shapes, reading the position
    from the device, so one captured step serves them all."""
    h = _ln(x, bp["ln1_g"], bp["ln1_b"])                     # (B, 1, D)
    qkv = torch.einsum("bsd,chdk->cbhsk", h, bp["wqkv"])     # (3,B,H,1,dh)
    q, k, v = qkv[0], qkv[1], qkv[2]
    at = pos.reshape(1)
    ck.index_copy_(2, at, k)
    cv.index_copy_(2, at, v)
    s = torch.einsum("bhqd,bhkd->bhqk", q, ck) * scale       # (B,H,1,S)
    k_pos = torch.arange(ck.shape[2], device=ck.device)
    s = s.masked_fill(k_pos[None, None, None, :] > pos, float("-inf"))
    a = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", a, cv)
    x = x + torch.einsum("bhsd,hdo->bso", o, bp["wo"])
    h = _ln(x, bp["ln2_g"], bp["ln2_b"])
    if ffn is not None:
        return x + ffn(h), ck, cv
    h = F.gelu(h @ bp["w1"] + bp["b1"], approximate="tanh")
    return x + h @ bp["w2"] + bp["b2"], ck, cv


class _DecodeState:
    """What a decode step reads and writes on the device, the same from
    call to call: the per-layer KV caches, the token fed in, its position
    and the output; on a card, the step's CUDA graph once it is captured.
    The parameter tensors the graph reads are held weakly (a cached step
    does not keep a model alive) and checked at every lookup; the
    generator a sampled step advances is held."""

    def __init__(self, params, L, B, H, S, dh, n_tokens, int_dtype,
                 generator) -> None:
        like = params["embed"]
        self.cks = [like.new_zeros((B, H, S, dh)) for _ in range(L)]
        self.cvs = [like.new_zeros((B, H, S, dh)) for _ in range(L)]
        self.tok = torch.empty((B,), dtype=int_dtype, device=like.device)
        self.pos = torch.zeros((), dtype=torch.int64, device=like.device)
        self.out = torch.empty((B, n_tokens), dtype=int_dtype,
                               device=like.device)
        self.graph = None
        self.lock = threading.Lock()
        self.refs = [weakref.ref(t) for t in _param_tensors(params)]
        self.generator = generator

    def serves(self, params, generator) -> bool:
        return self.generator is generator and \
            all(r() is t for r, t in zip(self.refs, _param_tensors(params)))


def _param_tensors(params) -> list:
    return tree_leaves(params)


#: captured decode steps kept across calls (LRU): one per parameter set,
#: batch, prompt length, token count, prompt dtype and sampling (the
#: temperature and generator a sampled step bakes in)
_DECODE_GRAPHS_MAX = 8
_decode_graphs: "collections.OrderedDict[tuple, _DecodeState]" = \
    collections.OrderedDict()
_decode_lock = threading.Lock()


def _decode_state(params, generator, key, make) -> _DecodeState:
    """The cached decode state under ``key`` when it still serves
    ``params`` and ``generator``, else a new one from ``make()``, cached."""
    with _decode_lock:
        st = _decode_graphs.get(key)
        if st is not None and st.serves(params, generator):
            _decode_graphs.move_to_end(key)
            return st
        for k in [k for k, v in _decode_graphs.items() if v.refs[0]() is None]:
            del _decode_graphs[k]               # their parameters are gone
        st = _decode_graphs[key] = make()
        _decode_graphs.move_to_end(key)
        while len(_decode_graphs) > _DECODE_GRAPHS_MAX:
            _decode_graphs.popitem(last=False)
        return st


def lm_generate(params: dict, prompt, n_tokens: int, greedy: bool = True,
                temperature: float = 1.0,
                generator: Optional[torch.Generator] = None,
                moe_k: Optional[int] = None):
    """Autoregressive generation with per-layer KV caches: the whole prompt
    is prefilled in one pass through ``block_apply`` (dense attention core,
    as the reference) seeding caches of (B, H, P + n_tokens, dh), then one
    decode step per new token: the embedding, a ``_decode_block`` pass per
    layer, the head and the sampled token, which the step writes into the
    output and feeds to the next step, and the device position it advances.

    On a card the prefill runs eagerly and the decode step is one CUDA
    graph, replayed once a token. The graph and its buffers (caches, token,
    position, output) are kept across calls with the same parameter
    tensors, batch, prompt length, token count and sampling, so only the
    first such call pays the capture: it runs its first step eagerly on a
    side stream (the warm-up), captures the next and replays that graph
    for the remaining ``n_tokens - 2`` tokens; a later call replays it for
    all ``n_tokens - 1`` (sampling without a ``generator`` makes a new one
    every call, and so a new graph). A ``generator``'s state is registered
    with the graph, so sampling advances it on every replay; a graph that
    cannot take it raises. On the CPU the same step runs eagerly.

    ``prompt`` (B, P) integer; returns (B, P + n_tokens) in the prompt's
    integer dtype, on the parameters' device. Greedy (``argmax``, the first
    maximum on ties) by default; ``greedy=False`` samples from
    softmax(logits / temperature) with ``generator`` (a ``torch.Generator``
    on the parameters' device; a fresh one seeded 0 when None).
    ``temperature <= 0`` means greedy; ``n_tokens <= 0`` returns the prompt.
    MoE-LM parameters (blocks carrying a ``moe`` sub-dict) decode with their
    FFNs routed top-``moe_k`` (2 when detected), in the prefill and in every
    decode step.
    """
    return _generate(params, prompt, n_tokens, greedy, temperature,
                     generator, graph=True, moe_k=moe_k)


def _generate(params, prompt, n_tokens, greedy, temperature, generator,
              graph: bool, moe_k: Optional[int] = None):
    """:func:`lm_generate`; ``graph=False`` runs every decode step eagerly
    on a card as well (the comparison the card tests and the smoke run
    time the graph against)."""
    if moe_k is None and "moe" in params["blocks"][0]:
        moe_k = 2
    if n_tokens <= 0:
        return prompt
    dev = params["embed"].device
    prompt = torch.as_tensor(prompt, device=dev)
    B, P = prompt.shape
    if temperature <= 0:
        greedy = True
    if P + n_tokens > params["pos"].shape[0]:
        raise ValueError(
            f"prompt ({P}) + n_tokens ({n_tokens}) exceeds max_seq "
            f"{params['pos'].shape[0]}")
    cached = greedy or generator is not None
    if not greedy and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    blocks = params["blocks"]
    ffns = [None if moe_k is None else _moe_ffn(bp["moe"], moe_k)
            for bp in blocks]
    H, dh = blocks[0]["wqkv"].shape[1], blocks[0]["wqkv"].shape[3]
    S = P + n_tokens                  # caches sized to what's generated
    scale = 1.0 / math.sqrt(dh)
    K.dot_precision()
    graph = graph and dev.type == "cuda" and n_tokens >= 3

    sampler = None if greedy else generator

    def make():
        return _DecodeState(params, len(blocks), B, H, S, dh, n_tokens,
                            prompt.dtype, sampler)
    if graph and cached:
        key = (tuple(id(t) for t in _param_tensors(params)), B, P, n_tokens,
               prompt.dtype, None if greedy else (temperature, id(sampler)),
               moe_k)
        st = _decode_state(params, sampler, key, make)
    else:
        st = make()

    def sample(logits):
        if greedy:
            return torch.argmax(logits, dim=-1).to(prompt.dtype)
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator
                                 ).squeeze(-1).to(prompt.dtype)

    # the decode step: its state lives on the device (the token fed in, its
    # position, the output), so every step is the same program
    def step():
        x = params["embed"][st.tok][:, None, :] \
            + params["pos"].index_select(0, st.pos.reshape(1))[None]
        for li, bp in enumerate(blocks):
            x, _, _ = _decode_block(bp, x, st.cks[li], st.cvs[li], st.pos,
                                    scale, ffn=ffns[li])
        h = _ln(x, params["lnf_g"], params["lnf_b"])
        nxt = sample(torch.einsum("bd,vd->bv", h[:, 0], params["embed"]))
        st.out.index_copy_(1, (st.pos - (P - 1)).reshape(1), nxt[:, None])
        st.tok.copy_(nxt)
        st.pos.add_(1)

    with st.lock:
        # ---- prefill: the whole prompt in one pass through block_apply
        # (the ONE source of full-forward block math), seeding the caches
        x = params["embed"][prompt] + params["pos"][:P][None]
        for li, bp in enumerate(blocks):
            x, k, v = block_apply(bp, x, causal=True, return_kv=True,
                                  ffn=ffns[li])
            for c, kv in ((st.cks[li], k), (st.cvs[li], v)):
                c[:, :, :P] = kv
                c[:, :, P:] = 0
        h = _ln(x, params["lnf_g"], params["lnf_b"])
        st.tok.copy_(sample(torch.einsum("bd,vd->bv", h[:, -1],
                                         params["embed"])))
        st.out[:, 0] = st.tok
        st.pos.fill_(P)

        # ---- decode
        if not graph:
            for _ in range(n_tokens - 1):
                step()
        elif st.graph is not None:
            for _ in range(n_tokens - 1):
                st.graph.replay()
        else:
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                step()                                  # the warm-up
            torch.cuda.current_stream(dev).wait_stream(side)
            g = torch.cuda.CUDAGraph()
            if not greedy:
                g.register_generator_state(generator)
            # not through torch.cuda.graph, whose entry empties the caching
            # allocator: that can cost more than the capture
            with torch.cuda.stream(side):
                g.capture_begin()
                try:
                    step()
                finally:
                    g.capture_end()
            st.graph = g
            for _ in range(n_tokens - 2):
                g.replay()
        return torch.cat([prompt, st.out], dim=1)


class LanguageModel(nn.Module):
    """The LM as an ``nn.Module`` for serving: it holds the parameter dict
    under the reference's names (``embed``, ``pos``, ``lnf_g``, ``lnf_b``,
    ``blocks.<i>.<name>``; an MoE block's experts as ``moe_router``,
    ``moe_w1``, ``moe_w2``) as frozen parameters; ``forward`` is
    :func:`lm_apply` and ``generate`` is :func:`lm_generate` on
    :meth:`params`. Random weights from ``init_lm_params(seed, cfg)`` unless
    a numpy tree is given."""

    def __init__(self, cfg: ModelConfig, seed: int = 0, device=None,
                 tree: Optional[dict] = None):
        super().__init__()
        self.cfg = cfg
        p = params_from_numpy(tree if tree is not None
                              else init_lm_params(seed, cfg), device)
        for name in ("embed", "pos", "lnf_g", "lnf_b"):
            setattr(self, name, nn.Parameter(p[name], requires_grad=False))

        def flat(bp):
            out = {k: v for k, v in bp.items() if k != "moe"}
            out.update({f"moe_{k}": v for k, v in bp.get("moe", {}).items()})
            return out
        self.blocks = nn.ModuleList(
            nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                              for k, v in flat(bp).items()})
            for bp in p["blocks"])

    def params(self) -> dict:
        """The functional API's parameter dict (the module's own tensors)."""
        def nested(b):
            bp = {k: v for k, v in b.items() if not k.startswith("moe_")}
            moe = {k[4:]: v for k, v in b.items() if k.startswith("moe_")}
            if moe:
                bp["moe"] = moe
            return bp
        return {"embed": self.embed, "pos": self.pos, "lnf_g": self.lnf_g,
                "lnf_b": self.lnf_b,
                "blocks": [nested(b) for b in self.blocks]}

    def forward(self, tokens, causal: bool = True, attention=None,
                compute_dtype=None):
        return lm_apply(self.params(), tokens, causal=causal,
                        attention=attention, compute_dtype=compute_dtype)

    def generate(self, prompt, n_tokens: int, **kw):
        return lm_generate(self.params(), prompt, n_tokens, **kw)
