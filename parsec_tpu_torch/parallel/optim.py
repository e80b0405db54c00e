"""Optimizer transforms for the LM training steps, the counterparts of the
optax transforms the reference's steps take.

The reference's steps take any ``optax.GradientTransformation``; its tests
and examples use two, ``optax.adamw(lr)`` and
``optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(lr))``. Here
they are :func:`adamw`, :func:`clip_by_global_norm` and :func:`chain`,
with optax's defaults, applied by ``torch.optim.AdamW`` and
``torch.nn.utils.clip_grad_norm_``:

* ``adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4)`` is optax's
  ``adamw`` (``eps_root`` 0, no mask: every leaf decays). optax computes
  p - lr·(m̂/(√v̂ + eps) + wd·p); ``torch.optim.AdamW`` first scales p by
  (1 - lr·wd), then subtracts lr·m̂/(√v̂ + eps) — the same update (the
  decoupled decay reads the pre-step p in both), with m̂ = m/(1 - b1ᵗ) and
  v̂ = v/(1 - b2ᵗ).
* ``clip_by_global_norm(max_norm)`` scales every gradient by max_norm / ‖g‖
  when the global norm ‖g‖ exceeds max_norm, as optax does;
  ``clip_grad_norm_`` scales by min(1, max_norm / (‖g‖ + 1e-6)), a factor
  1 - 1e-6·‖g‖/max_norm off optax's when it clips.

The optimizer state is a plain tree, ``{"count", "mu", "nu"}`` (optax's
``ScaleByAdamState`` fields): the step count as an int64 tensor and the
first and second moments mirroring the parameter tree, on the parameters'
device. It is what :mod:`parsec_tpu_torch.utils.model_ckpt` saves.

On a mesh the state's leaves are DTensors placed like the parameters they
mirror: :meth:`AdamW.apply` works on their local shards (the update is
elementwise), and with ``shard_groups`` its clip takes the global norm
across the shards: the squares of a leaf sharded over a group are summed
over that group, a replicated leaf's counted once.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def tree_leaves(tree) -> list:
    """The tensor leaves of a nested dict/list tree, dict keys sorted (the
    leaf order of the reference's parameter trees)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def value_and_grad(loss_fn, params):
    """``(loss, leaves, grads)`` of ``loss_fn(params)``: the loss detached,
    ``leaves`` the parameter tensors as leaves that require grad and share
    their storage (an in-place update of one updates the parameter), and
    ``grads`` their gradients in :func:`tree_leaves` order (zeros for a
    leaf the loss does not reach). The caller's tensors are left as they
    are."""
    params_leaves = tree_leaves(params)
    leaves = [t.detach().requires_grad_(True) for t in params_leaves]
    by_id = {id(t): s for t, s in zip(params_leaves, leaves)}
    with torch.enable_grad():
        loss = loss_fn(tree_map(lambda t: by_id[id(t)], params))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    return loss.detach(), leaves, grads


def sgd(leaves: list, grads: list, lr: float) -> None:
    """p <- p - lr·g in place, the reference's SGD update."""
    with torch.no_grad():
        for p, g in zip(leaves, grads):
            p.sub_(lr * g)


@dataclasses.dataclass(frozen=True)
class ClipByGlobalNorm:
    max_norm: float


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax's ``adamw`` with an optional global-norm clip before it."""
    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4
    max_norm: Optional[float] = None

    def init(self, params, device=None) -> dict:
        """The zero state for ``params`` (a tree of tensors or numpy
        arrays), on ``device`` (default: each tensor leaf's own)."""
        def zeros(a):
            if isinstance(a, torch.Tensor):
                return torch.zeros_like(a, device=device)
            return torch.zeros(tuple(np.shape(a)), device=device)
        return {"count": torch.zeros((), dtype=torch.int64),
                "mu": tree_map(zeros, params),
                "nu": tree_map(zeros, params)}

    def apply(self, leaves: list, grads: list, state: dict,
              shard_groups: Optional[list] = None) -> None:
        """One update of ``leaves`` (leaf tensors sharing the parameters'
        storage) in place from ``grads``, the moments of ``state`` (tensors,
        or DTensors whose local shards line up with ``leaves``) updated in
        place and its count advanced. ``shard_groups`` (one per leaf: the
        process group the leaf is sharded over, or None) makes the clip's
        norm the global one across the shards."""
        state = tree_map(_local, state)
        for p, g in zip(leaves, grads):
            p.grad = g
        if self.max_norm is not None and shard_groups is not None:
            _clip_sharded(grads, shard_groups, self.max_norm)
        elif self.max_norm is not None:
            torch.nn.utils.clip_grad_norm_(leaves, self.max_norm)
        opt = torch.optim.AdamW(leaves, lr=self.learning_rate,
                                betas=(self.b1, self.b2), eps=self.eps,
                                weight_decay=self.weight_decay)
        n = float(int(state["count"]))
        for p, m, v in zip(leaves, tree_leaves(state["mu"]),
                           tree_leaves(state["nu"])):
            # one step tensor for each parameter: the optimizer adds one to
            # each in place
            opt.state[p] = {"step": torch.tensor(n, dtype=torch.float32),
                            "exp_avg": m, "exp_avg_sq": v}
        opt.step()
        for p in leaves:
            p.grad = None
        state["count"] += 1


def _local(t):
    """A DTensor's local shard (its own storage), any other leaf itself."""
    to_local = getattr(t, "to_local", None)
    return to_local() if to_local is not None else t


def global_norm(grads: list, shard_groups: list) -> torch.Tensor:
    """The 2-norm of gradients sharded over process groups: the squares of
    the leaves of each group summed over it, the replicated leaves' (group
    None) added once."""
    from . import compat
    total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    by_group: dict = {}
    for g, grp in zip(grads, shard_groups):
        sq = g.detach().float().pow(2).sum()
        if grp is None:
            total = total + sq
        else:
            by_group[grp] = by_group.get(grp, 0) + sq
    for grp, sq in by_group.items():
        total = total + compat.all_reduce_(sq.reshape(1).clone(), grp)[0]
    return total.sqrt()


def _clip_sharded(grads: list, shard_groups: list, max_norm: float) -> None:
    """``clip_grad_norm_``'s scaling, min(1, max_norm / (‖g‖ + 1e-6)), with
    the global norm across the shards."""
    coef = torch.clamp(max_norm / (global_norm(grads, shard_groups) + 1e-6),
                       max=1.0)
    with torch.no_grad():
        for g in grads:
            g.mul_(coef.to(g.dtype))


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4) -> AdamW:
    """optax's ``adamw`` with its defaults (see the module docstring)."""
    return AdamW(float(learning_rate), b1, b2, eps, weight_decay)


def clip_by_global_norm(max_norm: float) -> ClipByGlobalNorm:
    return ClipByGlobalNorm(float(max_norm))


def chain(*transforms) -> AdamW:
    """``optax.chain`` of the forms the reference's steps are used with:
    an optional :func:`clip_by_global_norm` followed by :func:`adamw`."""
    *clips, last = transforms
    if not isinstance(last, AdamW) or len(clips) > 1 or \
            not all(isinstance(c, ClipByGlobalNorm) for c in clips):
        raise TypeError("chain takes clip_by_global_norm(...) and then "
                        "adamw(...)")
    if not clips:
        return last
    return dataclasses.replace(last, max_norm=clips[0].max_norm)
