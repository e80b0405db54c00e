"""One pre-LN transformer block on PyTorch, the building block of the LM.

The block keeps the reference's head-major parameter layouts, so one numpy
parameter set drives both packages: ``wqkv`` (3, H, D, d_head), ``wo``
(H, d_head, D), ``w1`` (D, F), ``w2`` (F, D). The attention core is a hook:
:func:`_dense_attention_core` (masked softmax) by default, or
:func:`flash_attention_core`, the hand-written CUDA kernel. The projections
are ``torch.einsum`` calls, which PyTorch hands to cuBLAS.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import cuda_kernels as K


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
