"""Expert parallelism: a top-k routed MoE layer over a mesh axis.

The GShard/Switch dispatch pattern as torch functions (the port of
reference's ``parallel/moe.py:31-204``): tokens are data-sharded over
``ep``; a router scores every local token, the top-k experts per token
are packed into fixed-capacity per-expert buffers (one-hot dispatch
einsum, static shapes), an all-to-all ships each expert's slice to the
rank that OWNS that expert, the expert MLPs run local and dense, and a
second all-to-all brings results home, where the combine einsum unpacks
and gate-weights them. Capacity >= local tokens means no drops, which
makes the layer equal to its dense equivalent (:func:`dense_reference`);
tighter capacities drop overflow tokens with the drop COUNT reported, and
the Switch-style auxiliary load-balancing loss is computed over the global
batch (all-reduced across the mesh).

Routing follows the standard recipes: top-1 gates with the raw router
probability (Switch); top-k>=2 renormalizes the k gates to sum to one
(GShard/Mixtral). Slot assignment is choice-major — every token's first
choice claims buffer slots before any second choice — so under pressure
drops hit lower-priority routes first, as in GShard.

The ``mesh`` is a ``DeviceMesh`` over ranks (:func:`make_ep_mesh`, every
rank of the group calling the layer together), or one device: there the
two all-to-alls are identities. The all-to-alls are
:func:`compat.all_to_all_grad`, whose backward is the inverse all-to-all.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import compat
from .compat import P


def is_mesh(mesh) -> bool:
    """True for a ``DeviceMesh`` (a rank group's mesh)."""
    return isinstance(mesh, compat.DeviceMesh)


def make_ep_mesh(n_devices: Optional[int] = None, device_type: str = "cuda"):
    from .spmd import make_1d_mesh
    return make_1d_mesh("ep", n_devices, device_type)


def mesh_device(mesh, like=None) -> torch.device:
    """The device a ``mesh`` argument puts tensors on: ``None`` means
    ``like``'s device when ``like`` is a tensor, else the card (raises
    without one); a ``DeviceMesh`` its ranks' device; a ``torch.device``
    or device string is itself; a sequence or numpy array of exactly one
    device is that device. A list of more than one device raises
    ``ValueError``: more than one device is a ``DeviceMesh`` over a rank
    group. A card without an index is the current one (``cuda`` is
    ``cuda:0`` there), so the devices returned compare equal to the
    tensors' own."""
    if is_mesh(mesh):
        return compat.mesh_device(mesh)
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
        raise ValueError(f"a mesh of {len(devs)} devices is a DeviceMesh "
                         "over a rank group (make_mesh, make_tp_mesh, "
                         "make_ep_mesh, ... inside the ranks), not a list "
                         "of devices")
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


def _moe_local(router, w1, w2, xb, capacity: int, k: int, group=None):
    """The reference's per-device body: ``xb`` (T_loc, D) this rank's
    tokens, ``w1``/``w2`` this rank's experts, ``group`` the ``ep``
    sub-group (None: one device, where the two all-to-alls are
    identities). Returns (y, aux loss over the global batch, dropped
    count over the group)."""
    nP = 1 if group is None else compat._size(group)
    epd = w1.shape[0]
    T, D = xb.shape
    E = nP * epd
    probs = torch.softmax(xb @ router, dim=-1)
    gate_k, eid_k = _topk_gates(probs, k)                      # (T, k)
    # choice-major slot assignment: flatten (k, T) so every token's 1st
    # choice claims capacity before any 2nd choice (GShard priority);
    # cumsum over that order numbers the slots
    oh = F.one_hot(eid_k, E).to(xb.dtype)                      # (T, k, E)
    ohf = oh.transpose(0, 1).reshape(k * T, E)                 # (kT, E)
    posf = (torch.cumsum(ohf, dim=0) - 1.0) * ohf
    keepf = ohf * (posf < capacity).to(xb.dtype)
    dropped = (ohf.sum() - keepf.sum()).detach()
    # a slot past the capacity is not kept; clamp it into range so the
    # one-hot is defined (the reference's one_hot gives zeros there)
    slot = posf.long().clamp(max=capacity - 1)
    dispf = keepf[..., None] * F.one_hot(slot, capacity).to(xb.dtype)
    disp = dispf.reshape(k, T, E, capacity).transpose(0, 1)    # (T,k,E,C)
    dispatch = disp.sum(1)                       # (T, E, C) raw packing
    combine = torch.einsum("tkec,tk->tec", disp, gate_k)     # gate-weighted
    # pack per global expert, grouped by owning rank
    buf = torch.einsum("td,tec->ecd", xb, dispatch)          # (E, C, D)
    buf = buf.reshape(nP, epd, capacity, D)
    if group is not None:
        # ship slice [dst] to rank dst; recv[s, e] = source s's tokens for
        # MY local expert e
        buf = compat.all_to_all_grad(buf, group, 0, 0)
    work = buf.transpose(0, 1).reshape(epd, nP * capacity, D)
    done = torch.stack([_expert_mlp(w1[e], w2[e], work[e])
                        for e in range(epd)])
    done = done.reshape(epd, nP, capacity, D).transpose(0, 1)
    if group is not None:
        # the return trip: slice [src] goes home to rank src, in the
        # (global expert, capacity) layout dispatch used
        done = compat.all_to_all_grad(done.contiguous(), group, 0, 0)
    y = torch.einsum("ecd,tec->td", done.reshape(E, capacity, D), combine)
    # Switch aux load-balancing loss over the GLOBAL batch:
    # E * sum_e f_e * p_e, f_e = fraction of tokens whose TOP-1 is e,
    # p_e = mean router prob for e (both summed over the group)
    f = F.one_hot(eid_k[:, 0], E).float().sum(0)
    p = probs.float().sum(0)
    if group is not None:
        compat.all_reduce_(f, group)
        p = compat.reduce_from(p, group)
        dropped = compat.all_reduce_(dropped.clone(), group)
    aux = E * torch.sum((f / (T * nP)) * (p / (T * nP)))
    return y, aux, dropped


def _capacity(capacity, capacity_factor, k: int, t_loc: int, E: int) -> int:
    if capacity is not None:
        return int(capacity)
    if capacity_factor is not None:
        return max(1, math.ceil(capacity_factor * k * t_loc / E))
    return t_loc


def moe_ep_local(params, xb, mesh, k: int, capacity: Optional[int] = None,
                 capacity_factor: Optional[float] = None):
    """The expert-parallel layer on this rank's tokens ``xb`` (T_loc, D):
    ``params`` holds this rank's experts (``w1``/``w2`` with E/P on the
    leading axis) and the router; the router enters through
    :func:`compat.copy_to` (its gradient summed over the group). Returns
    (y_local, aux, dropped)."""
    g = compat.group(mesh, mesh.mesh_dim_names[0])
    nP = mesh.size(0)
    E = params["w1"].shape[0] * nP
    cap = _capacity(capacity, capacity_factor, k, xb.shape[0], E)
    return _moe_local(compat.copy_to(params["router"], g), params["w1"],
                      params["w2"], xb, cap, k, group=g)


def moe_forward(params, x, mesh=None, capacity: Optional[int] = None,
                k: int = 1, capacity_factor: Optional[float] = None,
                return_aux: bool = False):
    """Forward of the top-k routed MoE layer.

    With an ``ep`` ``DeviceMesh`` (:func:`make_ep_mesh`) every rank of the
    group calls it together on the same global ``params`` (router, w1, w2:
    numpy arrays, tensors or DTensors; the experts are sharded over the
    mesh) and ``x`` (tokens, d): tokens and experts must divide the mesh
    size; the result is a DTensor sharded ``P("ep", None)`` (None on a
    rank outside the mesh). Otherwise ``params`` and ``x`` are tensors on
    the one device ``mesh`` names (``None``: ``x``'s device; see
    :func:`mesh_device`). ``k`` <= experts. Per-expert buffer capacity, in
    priority order:

    * ``capacity`` — explicit slots per (expert, source rank);
    * ``capacity_factor`` — ``ceil(cf * k * T_loc / E)`` slots, the GShard
      convention (cf=1.0 is "fair share", cf>1 headroom);
    * default — ``T_loc`` slots: no token can be dropped, and the result
      matches :func:`dense_reference`.

    ``return_aux=True`` also returns ``{"aux_loss", "dropped"}`` — the
    Switch load-balancing loss over the global batch (add
    ``lambda * aux_loss`` to the training objective) and the global count
    of routed (token, choice) pairs that overflowed capacity (float32;
    replicated DTensors on a mesh)."""
    E = params["w1"].shape[0]
    assert 1 <= k <= E, f"top-{k} routing needs k in [1, {E}]"
    if is_mesh(mesh):
        axis = mesh.mesh_dim_names[0]
        nP = mesh.size(0)
        if x.shape[0] % nP or E % nP:
            raise ValueError(f"{x.shape[0]} tokens and {E} experts must "
                             f"split over the {nP}-rank ep mesh")
        if not compat.in_mesh(mesh):
            return None
        lp = {"router": compat.local_of(params["router"], mesh, P()),
              "w1": compat.local_of(params["w1"], mesh, P(axis, None, None)),
              "w2": compat.local_of(params["w2"], mesh, P(axis, None, None))}
        xb = compat.local_of(x, mesh, P(axis, None))
        y, aux, dropped = moe_ep_local(lp, xb, mesh, k, capacity,
                                       capacity_factor)
        y = compat.from_local(y, mesh, P(axis, None))
        aux = compat.from_local(aux, mesh, P())
        dropped = compat.from_local(dropped, mesh, P())
    else:
        _check_device(params, x, mesh_device(mesh, x))
        cap = _capacity(capacity, capacity_factor, k, x.shape[0], E)
        y, aux, dropped = _moe_local(params["router"], params["w1"],
                                     params["w2"], x, cap, k)
    if return_aux:
        return y, {"aux_loss": aux, "dropped": dropped}
    return y
