"""GPT-class causal language model on PyTorch: the serving path.

A decoder-only LM (learned token + position embeddings, N pre-LN
transformer blocks, final LN, tied LM head) as functions of a plain
parameter dict whose keys and layouts are the reference's
(``embed``, ``pos``, ``lnf_g``, ``lnf_b``, ``blocks[i][ln1_g ... b2]``):

* :func:`lm_apply` / :func:`lm_loss` — forward and token cross-entropy,
  pluggable attention core (dense, or the flash kernel through
  :func:`~parsec_tpu_torch.parallel.transformer.flash_attention_core`),
  ``compute_dtype`` for bf16 blocks with f32 logits;
* :func:`lm_generate` — KV-cached autoregressive decoding, greedy or
  sampled: on a card the decode step is one CUDA graph, replayed once a
  token (the counterpart of the reference's jitted ``lax.scan``), on the
  CPU an eager loop of the same step;
* :func:`params_from_numpy` / :func:`params_to_numpy` — the parameter tree
  to and from numpy, key for key;
* :class:`LanguageModel` — a thin ``nn.Module`` holding that dict.

Training (gradients, ``remat``, optimizers), the MoE-LM, pipeline and
sequence parallelism and meshes are not here yet (ROADMAP, queue 1: the
SPMD and model layer).
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import math
import threading
import weakref
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import cuda_kernels as K
from .transformer import block_apply, init_block_params, _ln

_NOT_PORTED = ("is not ported yet (ROADMAP, queue 1: the SPMD and model "
               "layer)")


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


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(fn, v) for v in tree]
    return fn(tree)


def params_from_numpy(tree, device=None, dtype=torch.float32) -> dict:
    """The reference's parameter tree (numpy leaves) as tensors on
    ``device`` (default: the card), floating leaves in ``dtype``; keys,
    nesting and layouts unchanged."""
    dev = _resolve_device(device)

    def leaf(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(dev, dtype if t.is_floating_point() else t.dtype)
    return _map_tree(leaf, tree)


def params_to_numpy(tree) -> dict:
    """Inverse of :func:`params_from_numpy`: every tensor leaf to a numpy
    array on the host (bf16 leaves widen to float32, exactly)."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return _map_tree(leaf, tree)


def _check_dense_lm(params: dict, remat: bool = False) -> None:
    if remat:
        raise NotImplementedError(f"remat=True (training) {_NOT_PORTED}")
    if params["blocks"] and "moe" in params["blocks"][0]:
        raise NotImplementedError(f"the MoE-LM {_NOT_PORTED}")


def lm_apply(params: dict, tokens, causal: bool = True, attention=None,
             remat: bool = False, compute_dtype=None):
    """tokens (B, S) integer -> logits (B, S, V) float32.

    ``compute_dtype=torch.bfloat16`` runs the blocks in bf16: the embedding
    gather and position add run in f32 and are then cast, the block
    parameters are cast, and the final LN and the tied head run in f32
    (TF32 off). ``attention`` swaps the attention core of every block."""
    _check_dense_lm(params, remat)
    K.dot_precision()                       # f32 products: TF32 off
    tokens = torch.as_tensor(tokens, device=params["embed"].device)
    S = tokens.shape[1]
    if S > params["pos"].shape[0]:
        raise ValueError(f"sequence length {S} exceeds the model's "
                         f"max_seq {params['pos'].shape[0]}")
    blocks = params["blocks"]
    h = params["embed"][tokens] + params["pos"][:S][None, :, :]
    if compute_dtype is not None:
        def cast(t):
            return t.to(compute_dtype) if t.is_floating_point() else t
        h = cast(h)
        blocks = [{k: cast(v) for k, v in bp.items()} for bp in blocks]
    step = functools.partial(block_apply, causal=causal, attention=attention)
    for bp in blocks:
        h = step(bp, h)
    h = _ln(h.float(), params["lnf_g"], params["lnf_b"])
    return torch.einsum("bsd,vd->bsv", h, params["embed"])


def lm_loss(params: dict, tokens, targets, causal: bool = True,
            attention=None, remat: bool = False, compute_dtype=None):
    """Mean next-token cross-entropy (f32); ``targets`` (B, S) integer."""
    logits = lm_apply(params, tokens, causal=causal, attention=attention,
                      remat=remat, compute_dtype=compute_dtype)
    targets = torch.as_tensor(targets, device=logits.device).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None]).squeeze(-1)
    return (logz - gold).mean()


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
    return [params[k] for k in ("embed", "pos", "lnf_g", "lnf_b")] + \
        [bp[k] for bp in params["blocks"] for k in sorted(bp)]


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
                generator: Optional[torch.Generator] = None):
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
    """
    return _generate(params, prompt, n_tokens, greedy, temperature,
                     generator, graph=True)


def _generate(params, prompt, n_tokens, greedy, temperature, generator,
              graph: bool):
    """:func:`lm_generate`; ``graph=False`` runs every decode step eagerly
    on a card as well (the comparison the card tests and the smoke run
    time the graph against)."""
    _check_dense_lm(params)
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
               prompt.dtype, None if greedy else (temperature, id(sampler)))
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
                                    scale)
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
            x, k, v = block_apply(bp, x, causal=True, return_kv=True)
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
    ``blocks.<i>.<name>``) as frozen parameters; ``forward`` is
    :func:`lm_apply` and ``generate`` is :func:`lm_generate` on
    :meth:`params`. Random weights from ``init_lm_params(seed, cfg)`` unless
    a numpy tree is given."""

    def __init__(self, cfg: ModelConfig, seed: int = 0, device=None,
                 tree: Optional[dict] = None):
        super().__init__()
        self.cfg = cfg
        p = params_from_numpy(tree if tree is not None
                              else init_lm_params(seed, cfg), device)
        _check_dense_lm(p)
        for name in ("embed", "pos", "lnf_g", "lnf_b"):
            setattr(self, name, nn.Parameter(p[name], requires_grad=False))
        self.blocks = nn.ModuleList(
            nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                              for k, v in bp.items()})
            for bp in p["blocks"])

    def params(self) -> dict:
        """The functional API's parameter dict (the module's own tensors)."""
        return {"embed": self.embed, "pos": self.pos, "lnf_g": self.lnf_g,
                "lnf_b": self.lnf_b,
                "blocks": [dict(b.items()) for b in self.blocks]}

    def forward(self, tokens, causal: bool = True, attention=None,
                compute_dtype=None):
        return lm_apply(self.params(), tokens, causal=causal,
                        attention=attention, compute_dtype=compute_dtype)

    def generate(self, prompt, n_tokens: int, **kw):
        return lm_generate(self.params(), prompt, n_tokens, **kw)
