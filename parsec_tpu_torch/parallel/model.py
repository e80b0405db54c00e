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
:func:`~parsec_tpu_torch.parallel.moe.mesh_device`): meshes of more than
one device, pipeline and sequence parallelism wait for the mesh slice
(ROADMAP, queue 1, item 3b) and raise ``NotImplementedError``.
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
from .moe import (_topk_gates, dense_reference, init_moe_params,
                  mesh_device, moe_forward)
from .optim import sgd, tree_leaves, tree_map, value_and_grad
from .transformer import (block_apply, init_block_params, _ln, _placers,
                          _run_block)


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
    and combine. ``return_aux=True`` adds ``{"aux_loss", "dropped"}`` — the
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


def make_lm_moe_train_step(mesh=None, k: int = 2, lr: float = 1e-2,
                           aux_weight: float = 0.01, causal: bool = True):
    """An SGD step for the MoE-LM: token cross-entropy plus ``aux_weight``
    x the Switch load-balancing loss, gradients through the expert dispatch
    (:func:`moe_forward` on the one-device expert group ``mesh`` names, the
    dense routed truth when ``mesh`` is None). Returns
    ``step(params, tokens, targets) -> (params, loss)``: the parameters are
    updated in place (the same dict is returned) and the loss is the
    pre-step one, a 0-dim tensor; losses from both paths agree under
    no-drop capacity."""
    if mesh is not None:
        mesh_device(mesh)                   # more than one device raises

    def loss_fn(p, tokens, targets):
        logits, aux = lm_moe_apply(p, tokens, causal=causal, k=k,
                                   mesh=mesh, return_aux=True)
        return _xent(logits, targets) + aux_weight * aux["aux_loss"]

    def step(params, tokens, targets):
        loss, leaves, grads = value_and_grad(
            lambda p: loss_fn(p, tokens, targets), params)
        sgd(leaves, grads, lr)
        return params, loss

    return step


# ----------------------------------------------------------- training steps

def make_lm_train_step(mesh=None, dp: str = "dp", tp: str = "tp",
                       lr: float = 1e-2, causal: bool = True,
                       n_layers: Optional[int] = None, params: dict = None):
    """An SGD LM training step on the one device ``mesh`` names (the card
    when None; ``dp``/``tp`` name the reference's mesh axes and change
    nothing on one device).

    Returns ``(step, place_params, place_batch)``; ``n_layers`` is taken
    from ``params`` when given. ``step(params, tokens, targets) -> (params,
    loss)`` updates the placed parameters in place (the same dict is
    returned) and gives the pre-step loss as a 0-dim tensor. For a real
    optimizer use :func:`make_lm_opt_train_step`. Usage::

        step, place_p, place_t = make_lm_train_step(device, params=params)
        params = place_p(params)
        params, loss = step(params, place_t(tokens), place_t(targets))
    """
    device = mesh_device(mesh)
    if n_layers is None and params is None:
        raise ValueError("pass n_layers= or params=")

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
    """An LM training step with the optimizer transform ``tx`` on the one
    device ``mesh`` names (the card when None).

    ``tx`` is a transform of :mod:`parsec_tpu_torch.parallel.optim` —
    ``adamw(lr)`` or ``chain(clip_by_global_norm(1.0), adamw(lr))``, optax's
    defaults on ``torch.optim.AdamW`` and ``clip_grad_norm_`` (the mapping
    is in that module's docstring). ``remat``/``compute_dtype`` are
    :func:`lm_apply`'s memory levers (bf16 compute keeps f32 master
    parameters and f32 gradients); ``attention`` swaps the attention core
    (the flash kernel through ``flash_attention_core``). Returns ``(step,
    opt_state, place_params, place_batch)``, the state made by
    ``tx.init(params)`` on the device::

        step, opt_state, place_p, place_t = make_lm_opt_train_step(
            device, chain(clip_by_global_norm(1.0), adamw(3e-4)), params)
        params = place_p(params)
        params, opt_state, loss = step(params, opt_state, tokens, targets)

    The step updates the parameters and the state in place (the same
    objects are returned) and gives the pre-step loss as a 0-dim tensor."""
    device = mesh_device(mesh)
    opt_state = tx.init(params, device)

    def step(params, opt_state, tokens, targets):
        loss, leaves, grads = value_and_grad(
            lambda p: lm_loss(p, tokens, targets, causal=causal,
                              attention=attention, remat=remat,
                              compute_dtype=compute_dtype), params)
        tx.apply(leaves, grads, opt_state)
        return params, opt_state, loss

    return (step, opt_state) + _placers(device)


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
