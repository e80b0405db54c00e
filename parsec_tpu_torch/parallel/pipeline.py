"""Pipeline parallelism: GPipe-style microbatch streaming over a mesh axis.

The port of the reference's ``parallel/pipeline.py:20-189``. Each rank of the
``pp`` axis owns ONE stage's parameters (stage-major trees whose leaves
have a leading stage axis, sharded over ``pp``); microbatches enter stage
0, and activations hop to the next rank every tick (a neighbour
``batch_isend_irecv``, :func:`compat.ring_shift`). After the P-1 fill
ticks every rank computes every tick: the (M + P - 1)-tick schedule of the
reference's ``lax.scan``, here a Python loop on every rank. The output
lives on the last stage; ``replicate_out`` sums it onto every rank (the
reference's masked ``psum``).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import compat
from .compat import P
from .optim import tree_leaves, tree_map


def make_pp_mesh(n_devices: Optional[int] = None, device_type: str = "cuda"):
    from .spmd import make_1d_mesh
    return make_1d_mesh("pp", n_devices, device_type)


def init_pipeline_params(seed: int, n_stages: int, d: int,
                         dtype=np.float32):
    """Stage-major weights: one (W, b) per stage, leading axis = stage
    (numpy; the reference's arrays for the same seed)."""
    rng = np.random.default_rng(seed)
    s = np.sqrt(1.0 / d)
    return {
        "w": (rng.standard_normal((n_stages, d, d)) * s).astype(dtype),
        "b": np.zeros((n_stages, d), dtype),
    }


def stage_apply(w, b, x):
    """One pipeline stage: x -> gelu(x W + b) + x."""
    return x + F.gelu(x @ w + b, approximate="tanh")


def reference_forward(params, x):
    """Sequential application of all stages (the single-device truth)."""
    out = torch.as_tensor(x)
    for i in range(params["w"].shape[0]):
        out = stage_apply(torch.as_tensor(params["w"][i]),
                          torch.as_tensor(params["b"][i]), out)
    return out


def _mlp_stage(sp, x):
    """The simple-MLP stage as a stage-tree function."""
    return stage_apply(sp["w"], sp["b"], x)


def pipe_local(p0, xs, mesh, n_micro: int, stage_fn: Callable,
               replicate_out: bool = True):
    """The per-rank GPipe body: ``p0`` this rank's stage parameters, ``xs``
    the (n_micro, B, ...) microbatches (the same on every rank). Returns
    the outputs on every rank (``replicate_out``) or on the last stage
    (zeros elsewhere)."""
    axis = mesh.mesh_dim_names[0]
    g = compat.group(mesh, axis)
    nP = mesh.size(0)
    idx = mesh.get_local_rank(axis)
    act = torch.zeros_like(xs[0])                      # the in-flight bubble
    outs = [torch.zeros_like(xs[0]) for _ in range(n_micro)]
    for t in range(n_micro + nP - 1):
        if idx == 0:                # stage 0 ingests microbatch t
            act = xs[t] if t < n_micro else torch.zeros_like(xs[0])
        act = stage_fn(p0, act)
        done = t - (nP - 1)         # the LAST stage retires microbatch done
        if idx == nP - 1 and done >= 0:
            outs[done] = act
        act = compat.ring_shift(act, g)
    out = torch.stack(outs)
    if replicate_out:
        # outputs live on the last stage only: everyone else holds zeros,
        # one all-reduce replicates them
        return compat.reduce_from(out, g)
    return out


def _stage_spec(axis: str, leaf) -> P:
    return P(axis, *([None] * (np.ndim(leaf) - 1)))


def pipeline_forward_stages(stage_params, x, stage_fn, mesh=None,
                            n_micro: Optional[int] = None,
                            replicate_out: bool = True):
    """GPipe over an arbitrary stage tree: every leaf of ``stage_params``
    has leading axis P (stage-major); rank i runs ``stage_fn(stage_i,
    act)`` (shape-preserving). ``x``: (n_micro, B, ...) microbatches;
    returns the same shape, a DTensor replicated over ``pp``
    (``replicate_out``), or with ``replicate_out=False`` a DTensor of
    global shape (P·m, B, ...) sharded over ``pp`` whose last block is the
    output (the reference's layout), read where the last stage made it.
    Every rank of the group calls it together; a rank outside the mesh
    gets None."""
    mesh = mesh if mesh is not None else make_pp_mesh()
    axis = mesh.mesh_dim_names[0]
    nP = mesh.size(0)
    leaves = tree_leaves(stage_params)
    if not leaves or any(l.shape[0] != nP for l in leaves):
        raise ValueError(f"every stage-params leaf needs leading axis {nP} "
                         "(the stage axis)")
    xs = x if isinstance(x, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(x))
    m = int(n_micro) if n_micro is not None else xs.shape[0]
    if m > xs.shape[0]:
        raise ValueError(f"n_micro={m} exceeds the {xs.shape[0]} provided "
                         "microbatches")
    if not compat.in_mesh(mesh):
        return None
    sp = tree_map(lambda l: compat.local_of(l, mesh, _stage_spec(axis, l)),
                  stage_params)
    xl = compat.local_of(xs, mesh, P())[:m]
    out = pipe_local(tree_map(lambda l: l[0], sp), xl, mesh, m, stage_fn,
                     replicate_out)
    if replicate_out:
        return compat.from_local(out, mesh, P())
    return compat.from_local(out, mesh, _stage_spec(axis, out))


def pipeline_forward(params, x, mesh=None, n_micro: Optional[int] = None):
    """Run (n_micro, B, d) microbatches through the P-stage MLP pipeline
    (the :func:`pipeline_forward_stages` schedule with the simple-MLP
    stage). ``params['w']``: (P, d, d) — stage i's weights live on rank
    i. Returns (n_micro, B, d), matching :func:`reference_forward` applied
    per microbatch within float32 tolerance."""
    mesh = mesh if mesh is not None else make_pp_mesh()
    if params["w"].shape[0] != mesh.size(0):
        raise ValueError(f"{params['w'].shape[0]} stages need a "
                         f"{params['w'].shape[0]}-rank mesh (have "
                         f"{mesh.size(0)})")
    return pipeline_forward_stages(
        {"w": params["w"], "b": params["b"]}, x, _mlp_stage, mesh=mesh,
        n_micro=n_micro)
