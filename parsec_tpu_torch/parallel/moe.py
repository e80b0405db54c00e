"""Expert parallelism: a top-k routed MoE layer, on an expert group of one
device.

The GShard/Switch dispatch pattern as torch functions: a router scores
every token, the top-k experts per token are packed into fixed-capacity
per-expert buffers (one-hot dispatch einsum, static shapes), the expert
MLPs run dense, and the combine einsum unpacks and gate-weights the
results. Capacity >= the tokens means no drops, which makes the layer
equal to its dense equivalent (:func:`dense_reference`); tighter
capacities drop overflow tokens with the drop COUNT reported, and the
Switch-style auxiliary load-balancing loss is computed over the batch.

Routing follows the standard recipes: top-1 gates with the raw router
probability (Switch); top-k>=2 renormalizes the k gates to sum to one
(GShard/Mixtral). Slot assignment is choice-major — every token's first
choice claims buffer slots before any second choice — so under pressure
drops hit lower-priority routes first, as in GShard.

The expert group is one device: the reference's ``all_to_all`` dispatch
and return trips over an ``ep`` mesh are identities there. Experts spread
over more than one device wait for the mesh slice (ROADMAP, queue 1, item
3b) and raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

#: what a mesh of more than one device raises with
MESH_ITEM = ("ROADMAP, queue 1, item 3b: meshes of more than one device "
             "(dp x tp, ep) are not ported yet")


def mesh_device(mesh, like=None) -> torch.device:
    """The one device a ``mesh`` argument names: ``None`` means ``like``'s
    device when ``like`` is a tensor, else the card (raises without one);
    a ``torch.device`` or device string is itself; a sequence or numpy
    array of exactly one device is that device. More than one device
    raises ``NotImplementedError``. A card without an index is the current
    one (``cuda`` is ``cuda:0`` there), so the devices returned compare
    equal to the tensors' own."""
    if mesh is None:
        if isinstance(like, torch.Tensor):
            return like.device
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the model layer runs on the "
                               "card unless it is given a CPU device")
        return _indexed(torch.device("cuda"))
    if isinstance(mesh, (torch.device, str)):
        return _indexed(torch.device(mesh))
    devs = list(np.asarray(mesh, dtype=object).reshape(-1))
    if len(devs) != 1:
        raise NotImplementedError(f"a mesh of {len(devs)} devices: "
                                  f"{MESH_ITEM}")
    return _indexed(torch.device(devs[0]))


def _indexed(device: torch.device) -> torch.device:
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def init_moe_params(seed: int, n_experts: int, d: int, d_ff: int,
                    dtype=np.float32):
    """Router + per-expert 2-layer MLPs (expert-major leading axis), as
    numpy arrays: the same seed gives the reference's arrays bit for bit."""
    rng = np.random.default_rng(seed)

    def g(*shape, fan):
        return (rng.standard_normal(shape) / np.sqrt(fan)).astype(dtype)

    return {
        "router": g(d, n_experts, fan=d),
        "w1": g(n_experts, d, d_ff, fan=d),
        "w2": g(n_experts, d_ff, d, fan=d_ff),
    }


def _expert_mlp(w1, w2, x):
    return F.gelu(x @ w1, approximate="tanh") @ w2


def _topk_gates(probs, k: int):
    """(gates, expert ids), both (T, k): raw top-1 prob for k=1 (Switch),
    renormalized over the k winners for k>=2 (GShard/Mixtral). Equal
    probabilities rank the lower expert id first, as ``lax.top_k`` does (a
    stable descending sort)."""
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    eid_k = order[..., :k]
    gate_k = torch.gather(probs, -1, eid_k)
    if k > 1:
        gate_k = gate_k / gate_k.sum(-1, keepdim=True).clamp_min(1e-9)
    return gate_k, eid_k


def _check_device(params, x, device) -> None:
    for t in (x, params["router"], params["w1"], params["w2"]):
        if t.device != device:
            raise ValueError(f"MoE operand on {t.device}, expected {device}")


def dense_reference(params, x, k: int = 1):
    """Every token through its top-k routed experts, no parallelism (the
    truth the expert-parallel layer must match when nothing is dropped);
    ``params`` (router, w1, w2) and ``x`` tensors on one device."""
    _check_device(params, x, x.device)
    logits = x @ params["router"]
    gate_k, eid_k = _topk_gates(torch.softmax(logits, dim=-1), k)
    E = params["w1"].shape[0]
    out = torch.zeros_like(x)
    for e in range(E):
        y = _expert_mlp(params["w1"][e], params["w2"][e], x)
        w = (gate_k * (eid_k == e)).sum(-1)          # this expert's gate
        out = out + y * w[:, None]
    return out


def _moe_local(router, w1, w2, xb, capacity: int, k: int):
    """The reference's per-device body with one device in the group: the
    dispatch and return ``all_to_all``s are identities. Returns (y, aux
    loss, dropped count)."""
    T, D = xb.shape
    E = w1.shape[0]
    probs = torch.softmax(xb @ router, dim=-1)
    gate_k, eid_k = _topk_gates(probs, k)                      # (T, k)
    # choice-major slot assignment: flatten (k, T) so every token's 1st
    # choice claims capacity before any 2nd choice (GShard priority);
    # cumsum over that order numbers the slots
    oh = F.one_hot(eid_k, E).to(xb.dtype)                      # (T, k, E)
    ohf = oh.transpose(0, 1).reshape(k * T, E)                 # (kT, E)
    posf = (torch.cumsum(ohf, dim=0) - 1.0) * ohf
    keepf = ohf * (posf < capacity).to(xb.dtype)
    dropped = ohf.sum() - keepf.sum()
    # a slot past the capacity is not kept; clamp it into range so the
    # one-hot is defined (the reference's one_hot gives zeros there)
    slot = posf.long().clamp(max=capacity - 1)
    dispf = keepf[..., None] * F.one_hot(slot, capacity).to(xb.dtype)
    disp = dispf.reshape(k, T, E, capacity).transpose(0, 1)    # (T,k,E,C)
    dispatch = disp.sum(1)                       # (T, E, C) raw packing
    combine = torch.einsum("tkec,tk->tec", disp, gate_k)     # gate-weighted
    buf = torch.einsum("td,tec->ecd", xb, dispatch)          # (E, C, D)
    done = torch.stack([_expert_mlp(w1[e], w2[e], buf[e])
                        for e in range(E)])
    y = torch.einsum("ecd,tec->td", done, combine)
    # Switch aux load-balancing loss: E * sum_e f_e * p_e, f_e = fraction
    # of tokens whose TOP-1 is e, p_e = mean router prob for e
    f = F.one_hot(eid_k[:, 0], E).float().sum(0) / T
    p = probs.float().sum(0) / T
    return y, E * torch.sum(f * p), dropped


def moe_forward(params, x, mesh=None, capacity: Optional[int] = None,
                k: int = 1, capacity_factor: Optional[float] = None,
                return_aux: bool = False):
    """Forward of the top-k routed MoE layer on an expert group of one
    device.

    ``params`` (router, w1, w2) and ``x`` (tokens, d) are tensors on the
    one device ``mesh`` names (``None``: ``x``'s device; see
    :func:`mesh_device`); ``k`` <= experts. Per-expert buffer capacity, in
    priority order:

    * ``capacity`` — explicit slots per expert;
    * ``capacity_factor`` — ``ceil(cf * k * T / E)`` slots, the GShard
      convention (cf=1.0 is "fair share", cf>1 headroom);
    * default — ``T`` slots: no token can be dropped, and the result
      matches :func:`dense_reference`.

    ``return_aux=True`` also returns ``{"aux_loss", "dropped"}`` — the
    Switch load-balancing loss over the batch (add ``lambda * aux_loss``
    to the training objective) and the count of routed (token, choice)
    pairs that overflowed capacity (float32 tensors)."""
    _check_device(params, x, mesh_device(mesh, x))
    T, _ = x.shape
    E = params["w1"].shape[0]
    assert 1 <= k <= E, f"top-{k} routing needs k in [1, {E}]"
    if capacity is not None:
        cap = int(capacity)
    elif capacity_factor is not None:
        cap = max(1, math.ceil(capacity_factor * k * T / E))
    else:
        cap = T
    y, aux, dropped = _moe_local(params["router"], params["w1"],
                                 params["w2"], x, cap, k)
    if return_aux:
        return y, {"aux_loss": aux, "dropped": dropped}
    return y
