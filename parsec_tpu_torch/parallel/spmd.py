"""SPMD execution paths over rank meshes: Cannon's GEMM, the all-gather
GEMM, a blocked Cholesky, and the GEMM + POTRF composite.

The port of the reference's ``parallel/spmd.py:37-224``. The reference lays the
P×Q grid over a device mesh and writes each algorithm as a ``shard_map``
body with ``ppermute``/``all_gather``. Here the grid is a ``DeviceMesh``
over P·Q ranks (:func:`make_mesh`), every rank runs the same body on its
block (the entry points are called by every rank of the group together),
and the collectives are :mod:`~parsec_tpu_torch.parallel.compat`'s over
the mesh's ``p`` and ``q`` sub-groups: Cannon's skews and shifts are
``batch_isend_irecv`` permutations, the panels are all-gathers or
all-reduces. Results are DTensors sharded ``P("p", "q")``; a rank outside
the mesh gets None. The local products run with TF32 off
(``cuda_kernels.dot_precision``), as the reference's ``highest`` f32 dots.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..ops import cuda_kernels as K
from . import compat
from .compat import P

_PQ = P("p", "q")


def best_grid(n: int) -> Tuple[int, int]:
    """Most-square P×Q factorization of n (grid helper, ref grid_2Dcyclic.c)."""
    p = int(math.sqrt(n))
    while n % p:
        p -= 1
    return p, n // p


def _world(n_devices: Optional[int]) -> int:
    import torch.distributed as dist
    if n_devices:
        return int(n_devices)
    if not dist.is_initialized():
        raise RuntimeError("a mesh spans the ranks of a torch.distributed "
                           "group: run inside a RankPool job, or call "
                           "init_multihost first")
    return dist.get_world_size()


def make_1d_mesh(axis_name: str, n_devices: Optional[int] = None,
                 device_type: str = "cuda"):
    """A 1D mesh over the group's first n ranks (the seq/pipeline/expert
    axis builder shared by ring_attention/pipeline/moe)."""
    from .multihost import device_mesh
    return device_mesh((_world(n_devices),), (axis_name,), device_type)


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Tuple[str, str] = ("p", "q"),
              device_type: str = "cuda"):
    """A 2D mesh (the most square P×Q grid) over the group's first n ranks
    (all of them by default)."""
    from .multihost import device_mesh
    return device_mesh(best_grid(_world(n_devices)), axis_names,
                       device_type)


def _grid(mesh):
    return mesh.size(0), mesh.size(1)


def distributed_gemm(A, B, mesh=None, dtype=None):
    """C = A @ B via Cannon's algorithm on a P×P mesh.

    Per step: one local product, then one neighbour shift per operand
    (``a`` left along ``q``, ``b`` up along ``p``). Requires a square grid;
    takes the all-gather variant otherwise."""
    mesh = make_mesh() if mesh is None else mesh
    Pm, Qm = _grid(mesh)
    if Pm != Qm:
        return distributed_gemm_allgather(A, B, mesh, dtype)
    if not compat.in_mesh(mesh):
        return None
    K.dot_precision()
    T = Pm
    a = compat.local_of(A, mesh, _PQ).contiguous()
    b = compat.local_of(B, mesh, _PQ).contiguous()
    out_dtype = a.dtype if dtype is None else dtype
    gp, gq = compat.group(mesh, "p"), compat.group(mesh, "q")
    p, q = mesh.get_local_rank("p"), mesh.get_local_rank("q")
    # pre-skew: block (p, j) moves to (p, (j - p) % T); (i, q) to
    # ((i - q) % T, q)
    a = compat.permute(a, gq, [(j - p) % T for j in range(T)])
    b = compat.permute(b, gp, [(i - q) % T for i in range(T)])
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32,
                      device=a.device)
    left = compat.ring_dst(T, -1)
    for _ in range(T):
        acc += a.float() @ b.float()
        a = compat.permute(a, gq, left)
        b = compat.permute(b, gp, left)
    return compat.from_local(acc.to(out_dtype), mesh, _PQ)


def distributed_gemm_allgather(A, B, mesh=None, dtype=None):
    """C = A @ B with row/col panel all-gathers and one local product:
    C[p,q] = (gather_q A[p,:]) @ (gather_p B[:,q])."""
    mesh = make_mesh() if mesh is None else mesh
    if not compat.in_mesh(mesh):
        return None
    K.dot_precision()
    a = compat.local_of(A, mesh, _PQ).contiguous()
    b = compat.local_of(B, mesh, _PQ).contiguous()
    a_row = compat.all_gather(a, compat.group(mesh, "q"), dim=1)
    b_col = compat.all_gather(b, compat.group(mesh, "p"), dim=0)
    out = a_row.float() @ b_col.float()
    return compat.from_local(out.to(a.dtype if dtype is None else dtype),
                             mesh, _PQ)


def _mesh_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """All-reduce over every rank of a 2D mesh (its rows, then its
    columns)."""
    compat.all_reduce_(t, compat.group(mesh, "q"))
    return compat.all_reduce_(t, compat.group(mesh, "p"))


def distributed_potrf(A, mesh=None, block: Optional[int] = None):
    """Blocked right-looking Cholesky (lower) over the mesh.

    A is sharded ``P("p", "q")``. Each outer step k: the panel column
    [*, k:k+nb] is summed onto every rank from the blocks that hold it
    (the reference's panel broadcast), every rank factors the diagonal
    block and solves the panel (the same small work everywhere), writes
    the new panel into its block and applies its share of the trailing
    update A22 -= L21 L21^T. Returns the lower factor with the strict upper
    triangle zeroed, sharded like A."""
    mesh = make_mesh() if mesh is None else mesh
    if not compat.in_mesh(mesh):
        return None
    K.dot_precision()
    Pm, Qm = _grid(mesh)
    a = compat.local_of(A, mesh, _PQ).clone()
    n = a.shape[0] * Pm
    if a.shape[0] * Pm != a.shape[1] * Qm:
        raise ValueError(f"distributed_potrf: {n}x{a.shape[1] * Qm} is not "
                         "square or not split evenly over the mesh")
    nb = min(block or max(n // (Pm * 4), 128), n)
    mb, nbl = a.shape
    r0 = mesh.get_local_rank("p") * mb
    c0 = mesh.get_local_rank("q") * nbl
    dev = a.device
    rows = torch.arange(r0, r0 + mb, device=dev)[:, None]
    cols = torch.arange(c0, c0 + nbl, device=dev)[None, :]
    grows = torch.arange(n, device=dev)[:, None]

    def gather_cols(lo: int, hi: int) -> torch.Tensor:
        """Columns [lo, hi) of the whole matrix on every rank."""
        buf = torch.zeros((n, hi - lo), dtype=a.dtype, device=dev)
        s, e = max(lo, c0), min(hi, c0 + nbl)
        if s < e:
            buf[r0:r0 + mb, s - lo:e - lo] = a[:, s - c0:e - c0]
        return _mesh_sum(buf, mesh)

    def put_cols(lo: int, vals: torch.Tensor) -> None:
        s, e = max(lo, c0), min(lo + vals.shape[1], c0 + nbl)
        if s < e:
            a[:, s - c0:e - c0] = vals[r0:r0 + mb, s - lo:e - lo]

    nsteps = n // nb
    for i in range(nsteps):
        k = i * nb
        panel = gather_cols(k, k + nb)
        lkk = torch.linalg.cholesky(panel[k:k + nb])
        l21 = torch.linalg.solve_triangular(lkk, panel.T, upper=False).T
        l21 = torch.where(grows >= k + nb, l21, 0.0)   # rows below the block
        newpanel = l21.clone()
        newpanel[k:k + nb] = lkk
        put_cols(k, newpanel)
        # this rank's share of A -= l21 l21^T on the trailing block
        upd = l21[r0:r0 + mb] @ l21[c0:c0 + nbl].T
        mask = (rows >= k + nb) & (cols >= k + nb)
        a -= torch.where(mask, upd, 0.0)
    tail = n - nsteps * nb
    if tail:
        s = nsteps * nb
        blk = gather_cols(s, n)[s:]
        lt = torch.zeros((n, tail), dtype=a.dtype, device=dev)
        lt[s:] = torch.linalg.cholesky(blk)
        keep = a.clone()
        put_cols(s, lt)
        a = torch.where(rows >= s, a, keep)
    a = torch.where(cols <= rows, a, 0.0)
    return compat.from_local(a, mesh, _PQ)


def training_step(A, B, C, mesh=None):
    """One flagship 'step': C += A@B then Cholesky-factor the SPD-ified
    result, C2 @ C2^T / n + 2 I (replicated on every rank). Returns
    (C2 sharded like C, L replicated)."""
    mesh = make_mesh() if mesh is None else mesh
    c2 = distributed_gemm_allgather(A, B, mesh)
    if c2 is None:
        return None
    c2 = compat.from_local(c2.to_local() + compat.local_of(C, mesh, _PQ),
                           mesh, _PQ)
    full = compat.full_tensor(c2)
    n = full.shape[0]
    sym = full @ full.T / n + torch.eye(n, dtype=full.dtype,
                                        device=full.device) * 2.0
    L = torch.linalg.cholesky(sym)
    return c2, compat.from_local(L, mesh, P())
