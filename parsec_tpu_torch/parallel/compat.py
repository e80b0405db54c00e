"""torch.distributed shims for the parallel layer: one place for what differs
between PyTorch builds, and for what gloo does not take on CUDA tensors.

The reference's shim (its ``parallel/compat.py:21-40``) picks a
``shard_map`` spelling by probing with ``TypeError``; this one probes too,
never by version string:

* **Names.** The DTensor types and ``DeviceMesh`` import from
  ``torch.distributed.tensor`` (or the older ``torch.distributed._tensor``;
  :func:`shard_map` wraps with ``to_local``/``from_local``, which every
  build has, not the experimental ``local_map``);
  the tensor forms of all-gather and reduce-scatter are ``*_single`` where
  the build has them and ``all_gather_into_tensor``/``reduce_scatter_tensor``
  where it does not (newer builds mark the latter deprecated).
* **What gloo takes.** A device is a rank here, and every rank of a group
  may sit on the one card: NCCL refuses two ranks on one GPU, so the
  group's backend is gloo for CPU and CUDA tensors alike
  (:data:`BACKEND`). Which collectives gloo runs on CUDA tensors depends
  on the build. :func:`probe_collectives` runs each one (:data:`OPS`) on
  small tensors of a device type in a throwaway group and keeps what ran
  and gave the right answer. All-reduce, all-gather, reduce-scatter and
  all-to-all call gloo, and raise naming the op where the probe found it
  refused; send/recv, which gloo refuses on CUDA tensors (torch 2.11's
  aborts the process), is staged through host copies onto the CPU, where
  gloo takes it (:func:`isend` posts one tensor to a rank without waiting
  and :func:`recv` blocks for one: the transfers of mesh capture's plans;
  :func:`gather_bytes` gathers host tensors of any dtype). :data:`STATS`
  counts every call and its bytes by ``(op, route)``, route ``"gloo"`` or
  ``"staged"``.
* **``shard_map``.** :func:`shard_map` runs a per-rank body on local shards
  and wraps what it returns as DTensors on the given placements; specs are
  the reference's ``PartitionSpec`` tuples of mesh-axis names
  (:class:`PartitionSpec`, :class:`NamedSharding`). A ctypes kernel has no
  DTensor sharding rule, so the kernels run inside such bodies.

Gradients through the collectives are the conjugate pairs of Megatron-LM's
tensor parallelism, for a loss that every rank of the group computes
alike: :func:`copy_to` (identity forward, all-reduce backward) where a
replicated tensor feeds per-rank work, :func:`reduce_from` (all-reduce
forward, identity backward) where per-rank partial sums become replicated,
:func:`gather_from` (all-gather forward; the backward keeps the rank's own
slice, each rank already holding the whole gradient), :func:`scatter_to`
(slice forward, all-gather backward), :func:`all_to_all` (the inverse
all-to-all backward) and :func:`ring_shift`/:func:`permute` (the inverse
shift or permutation backward).
"""

from __future__ import annotations

import datetime
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

try:                                     # the public module
    from torch.distributed.tensor import DTensor, Replicate, Shard
except ImportError:                      # older builds
    from torch.distributed._tensor import DTensor, Replicate, Shard
try:
    from torch.distributed.device_mesh import DeviceMesh
except ImportError:
    from torch.distributed._tensor.device_mesh import DeviceMesh

#: the backend of every rank group: gloo for CPU and CUDA tensors, never NCCL
BACKEND = "cpu:gloo,cuda:gloo"

#: the collectives :func:`probe_collectives` runs
OPS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
       "send_recv")

#: per device type and op: True (gloo takes it), False (refused: staged
#: for send/recv, an error for the others), None (not probed in this
#: process)
NATIVE: Dict[str, Dict[str, Optional[bool]]] = {
    "cpu": dict.fromkeys(OPS), "cuda": dict.fromkeys(OPS)}

#: (op, route) -> [calls, bytes]: every collective this process ran
STATS: Dict[Tuple[str, str], list] = {}


def _pick(*names):
    for n in names:
        f = getattr(dist, n, None)
        if f is not None:
            return f
    raise AttributeError(f"torch.distributed has none of {names}")


_all_gather_tensor = _pick("all_gather_single", "all_gather_into_tensor",
                           "_all_gather_base")
_reduce_scatter_tensor = _pick("reduce_scatter_single",
                               "reduce_scatter_tensor", "_reduce_scatter_base")


def reset_stats() -> None:
    STATS.clear()


def _count(op: str, route: str, t: torch.Tensor) -> None:
    s = STATS.setdefault((op, route), [0, 0])
    s[0] += 1
    s[1] += t.numel() * t.element_size()


def stats_summary() -> dict:
    """``{"op/route": {"calls", "bytes"}}`` of :data:`STATS`."""
    return {f"{op}/{route}": {"calls": c, "bytes": b}
            for (op, route), (c, b) in sorted(STATS.items())}


# ---------------------------------------------------------------------------
# the probe
# ---------------------------------------------------------------------------

def _probe_device(device_type: str) -> torch.device:
    if device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device_type)


def _probe_one(op: str, g, dev: torch.device) -> bool:
    n, r = dist.get_world_size(g), dist.get_rank(g)
    base = torch.arange(n * 4, dtype=torch.float32, device=dev) + 100 * r
    if op == "all_reduce":
        t = base.clone()
        dist.all_reduce(t, group=g)
        m = base.clone()
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g)
        want = torch.arange(n * 4, dtype=torch.float32) * n + \
            100 * n * (n - 1) / 2
        return torch.equal(t.cpu(), want) and \
            torch.equal(m.cpu(), torch.arange(n * 4.) + 100 * (n - 1))
    if op == "all_gather":
        out = torch.empty(n * 4, device=dev)
        _all_gather_tensor(out, base[:4].contiguous(), group=g)
        want = torch.cat([torch.arange(4.) + 100 * i for i in range(n)])
        return torch.equal(out.cpu(), want)
    if op == "reduce_scatter":
        out = torch.empty(4, device=dev)
        _reduce_scatter_tensor(out, base, group=g)
        want = torch.arange(4 * r, 4 * r + 4, dtype=torch.float32) * n + \
            100 * n * (n - 1) / 2
        return torch.equal(out.cpu(), want)
    if op == "all_to_all":
        out = torch.empty_like(base)
        dist.all_to_all_single(out, base, group=g)
        want = torch.cat([torch.arange(4 * r, 4 * r + 4.) + 100 * i
                          for i in range(n)])
        return torch.equal(out.cpu(), want)
    if op == "send_recv":
        got = torch.empty(4, device=dev)
        nxt = dist.get_global_rank(g, (r + 1) % n)
        prv = dist.get_global_rank(g, (r - 1) % n)
        works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, base[:4].contiguous(), nxt, group=g),
            dist.P2POp(dist.irecv, got, prv, group=g)])
        for w in works:
            w.wait()
        return torch.equal(got.cpu(), torch.arange(4.) + 100 * ((r - 1) % n))
    raise ValueError(op)


def probe_collectives(device_type: str, known: Optional[dict] = None,
                      timeout_s: float = 20.0, log=print) -> dict:
    """Which of :data:`OPS` gloo runs on ``device_type`` tensors in this
    process's group: every rank calls this together. Each op runs in a
    throwaway group of all the ranks (a failed collective can leave its
    group unusable), and the ranks agree, over the world group on CPU
    tensors, that it ran and gave the right answer everywhere. ``known``
    results are taken as they are. The table is installed in
    :data:`NATIVE` and returned. ``log`` announces each op before it runs:
    a refusal can abort the process (torch 2.11's gloo does so on CUDA
    send/recv, an uncatchable ``gloo::IoException``), and the announcement
    left last in a rank's output names the op, which a rank group then
    restarts with marked refused (:class:`~.multihost.RankPool`)."""
    table = dict(known or {})
    dev = _probe_device(device_type)
    for op in OPS:
        if op in table:
            continue
        log(f"compat probe {device_type} {op}", flush=True)
        g = dist.new_group(timeout=datetime.timedelta(seconds=timeout_s))
        try:
            ok = _probe_one(op, g, dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        except Exception:  # noqa: BLE001 - a refusal is the answer
            ok = False
        flag = torch.tensor([1.0 if ok else 0.0])
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        table[op] = bool(flag.item() == 1.0)
    NATIVE[device_type].update(table)
    return table


def native(op: str, device_type: str) -> bool:
    v = NATIVE.get(device_type, {}).get(op)
    if v is None:
        raise RuntimeError(f"{op} on {device_type} tensors has not been "
                           "probed in this process: call probe_collectives "
                           "(the rank group's bring-up does)")
    return v


def routes(device_type: str) -> dict:
    """How each op runs on ``device_type`` tensors: ``gloo``, ``staged``
    (send/recv through host copies) or ``refused`` (the op raises)."""
    out = {}
    for op in OPS:
        if native(op, device_type):
            out[op] = "gloo"
        else:
            out[op] = "staged" if op == "send_recv" else "refused"
    return out


# ---------------------------------------------------------------------------
# collectives (no autograd)
# ---------------------------------------------------------------------------

def _gloo(op: str, t: torch.Tensor) -> None:
    """Count ``op`` on ``t`` by gloo; raise where the probe found gloo
    refusing it on t's device type."""
    if not native(op, t.device.type):
        raise RuntimeError(f"{op}: gloo refused it on {t.device.type} "
                           "tensors in the group's probe, and nothing "
                           "replaces it")
    _count(op, "gloo", t)


def _size(g) -> int:
    return dist.get_world_size(g)


def all_reduce_(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """In-place all-reduce (``op`` ``sum`` or ``max``); returns ``t``."""
    rop = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
    if _size(group) == 1:
        return t
    _gloo("all_reduce", t)
    dist.all_reduce(t, op=rop, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's ``t`` concatenated along ``dim`` in group-rank order
    (every rank's ``t`` the same shape)."""
    n = _size(group)
    if n == 1:
        return t.clone()
    x = t.movedim(dim, 0).contiguous()
    _gloo("all_gather", x)
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _all_gather_tensor(out, x, group=group)
    return out.movedim(0, dim)


def reduce_scatter(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's chunk (along ``dim``, which the group size divides) of
    the group's sum of ``t``."""
    n = _size(group)
    if n == 1:
        return t.clone()
    x = t.movedim(dim, 0).contiguous()
    if x.shape[0] % n:
        # gloo aborts the process on a mis-sized reduce-scatter; refuse here
        raise ValueError(f"reduce_scatter: dim {dim} of size {x.shape[0]} "
                         f"does not split over {n} ranks")
    c = x.shape[0] // n
    _gloo("reduce_scatter", x)
    out = torch.empty((c,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _reduce_scatter_tensor(out, x, group=group)
    return out.movedim(0, dim)


def _p2p(sends, recvs, group) -> None:
    """``sends``/``recvs``: (tensor, group rank) pairs, posted together."""
    ops = [dist.P2POp(dist.isend, t, dist.get_global_rank(group, p),
                      group=group) for t, p in sends]
    ops += [dist.P2POp(dist.irecv, t, dist.get_global_rank(group, p),
                       group=group) for t, p in recvs]
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()


class Sent:
    """A posted send (:func:`isend`): its work and the buffer it reads,
    kept alive until :meth:`wait` returns."""

    __slots__ = ("work", "buf")

    def __init__(self, work, buf: torch.Tensor) -> None:
        self.work, self.buf = work, buf

    def wait(self) -> None:
        self.work.wait()
        self.buf = None


def _staged(device: torch.device) -> bool:
    """True where send/recv on ``device`` tensors goes through host copies
    (gloo refused it there in the group's probe)."""
    return device.type != "cpu" and not native("send_recv", device.type)


def isend(t: torch.Tensor, dst: int, tag: int = 0,
          op: str = "send_recv") -> Sent:
    """Post a send of ``t`` to global rank ``dst`` and return at once; the
    caller waits on the returned :class:`Sent` (which holds the buffer,
    a host copy on the ``staged`` route) before it may reuse ``t``'s
    storage. Counted in :data:`STATS` under ``(op, route)``."""
    x = t.detach().contiguous()
    route = "gloo"
    if _staged(x.device):
        route, x = "staged", x.to("cpu")
    _count(op, route, x)
    return Sent(dist.isend(x, dst, tag=tag), x)


def recv(shape, dtype: torch.dtype, device, src: int,
         tag: int = 0) -> torch.Tensor:
    """Block until the tensor global rank ``src`` sent with ``tag``
    arrives; returned on ``device`` (received into a host buffer on the
    ``staged`` route). The sender's :func:`isend` counts the transfer."""
    dev = torch.device(device)
    staged = _staged(dev)
    buf = torch.empty(tuple(shape), dtype=dtype,
                      device="cpu" if staged else dev)
    dist.recv(buf, src, tag=tag)
    return buf.to(dev) if staged else buf


def gather_bytes(t: torch.Tensor, op: str) -> torch.Tensor:
    """Every rank's ``t`` (each the same shape) stacked in rank order on
    the host, moved as bytes (any dtype, bit for bit) by one gloo
    all-gather of CPU tensors over the whole group, counted under ``(op,
    "gloo")``."""
    x = t.detach().contiguous().cpu()
    raw = x.reshape(-1).view(torch.uint8)
    if not native("all_gather", "cpu"):
        raise RuntimeError("all_gather: gloo refused it on cpu tensors in "
                           "the group's probe, and nothing replaces it")
    _count(op, "gloo", raw)
    out = torch.empty(dist.get_world_size() * raw.numel(), dtype=torch.uint8)
    _all_gather_tensor(out, raw)
    return out.view(x.dtype).reshape((-1,) + tuple(x.shape))


def all_to_all(t: torch.Tensor, group, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """The reference's tiled ``all_to_all``: ``t`` is cut into group-size
    chunks along ``split_dim``; chunk j goes to rank j; what arrives is
    concatenated along ``concat_dim`` in source-rank order."""
    n = _size(group)
    if n == 1:
        return t.clone()
    if t.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of size "
                         f"{t.shape[split_dim]} does not split over {n}")
    x = t.movedim(split_dim, 0).contiguous()
    chunk = (x.shape[0] // n,) + tuple(x.shape[1:])
    _gloo("all_to_all", x)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    # out is (n * chunk0, ...) in source order, chunks along split_dim
    pieces = out.reshape((n,) + chunk).movedim(1, split_dim + 1)
    # pieces[j] is source j's chunk with split_dim back in place
    return torch.cat(list(pieces), dim=concat_dim)


def permute(t: torch.Tensor, group, dst_of: Sequence[int]) -> torch.Tensor:
    """The reference's ``ppermute``: group rank i sends ``t`` to
    ``dst_of[i]``; the result is what this rank received (zeros where nothing arrives)."""
    n, r = _size(group), dist.get_rank(group)
    x = t.contiguous()
    out = torch.zeros_like(x)
    if dst_of[r] == r:
        out.copy_(x)
    sends = [(x, dst_of[r])] if dst_of[r] != r else []
    recvs = [(out, i) for i in range(n) if dst_of[i] == r and i != r]
    if native("send_recv", t.device.type):
        _count("send_recv", "gloo", x)
        _p2p(sends, recvs, group)
        return out
    _count("send_recv", "staged", x)
    hs = [(a.cpu(), p) for a, p in sends]
    hr = [(torch.empty(a.shape, dtype=a.dtype), p) for a, p in recvs]
    _p2p(hs, hr, group)
    for (a, _), (h, _) in zip(recvs, hr):
        a.copy_(h)
    return out


def ring_dst(n: int, shift: int) -> list:
    return [(i + shift) % n for i in range(n)]


# ---------------------------------------------------------------------------
# the same collectives under autograd
# ---------------------------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.size = group, dim, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.size, ctx.size).contiguous(), \
            None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n, r = _size(group), dist.get_rank(group)
        c = x.shape[dim] // n
        return x.narrow(dim, r * c, c).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.group, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, concat_dim, split_dim)
        return all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, *ctx.args), None, None, None


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dst_of):
        ctx.group = group
        inv = [0] * len(dst_of)
        for i, d in enumerate(dst_of):
            inv[d] = i
        ctx.inv = inv
        return permute(x, group, dst_of)

    @staticmethod
    def backward(ctx, g):
        return permute(g, ctx.group, ctx.inv), None, None


def _grad_on(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def copy_to(x, group):
    """Identity forward; the backward all-reduces the gradient over
    ``group`` (a replicated tensor feeding per-rank work)."""
    return _CopyTo.apply(x, group) if _grad_on(x) else x


def reduce_from(x, group):
    """All-reduce (sum) over ``group``; identity backward."""
    if _grad_on(x):
        return _ReduceFrom.apply(x, group)
    return all_reduce_(x.contiguous().clone(), group)


def gather_from(x, group, dim: int = 0):
    """All-gather along ``dim``; the backward keeps this rank's slice."""
    if _grad_on(x):
        return _GatherFrom.apply(x, group, dim)
    return all_gather(x, group, dim)


def scatter_to(x, group, dim: int = 0):
    """This rank's chunk along ``dim``; the backward all-gathers."""
    if _grad_on(x):
        return _ScatterTo.apply(x, group, dim)
    n, r = _size(group), dist.get_rank(group)
    c = x.shape[dim] // n
    return x.narrow(dim, r * c, c)


def all_to_all_grad(x, group, split_dim: int, concat_dim: int):
    """:func:`all_to_all` whose backward is the inverse all-to-all."""
    if _grad_on(x):
        return _AllToAll.apply(x, group, split_dim, concat_dim)
    return all_to_all(x, group, split_dim, concat_dim)


def permute_grad(x, group, dst_of: Sequence[int]):
    """:func:`permute` whose backward is the inverse permutation."""
    if _grad_on(x):
        return _Permute.apply(x, group, list(dst_of))
    return permute(x, group, dst_of)


def ring_shift(x, group, shift: int = 1):
    """Rank i's ``x`` arrives at rank i + shift (mod the group size); the
    backward shifts the gradient back."""
    return permute_grad(x, group, ring_dst(_size(group), shift))


# ---------------------------------------------------------------------------
# specs, placements, local shards
# ---------------------------------------------------------------------------

class PartitionSpec(tuple):
    """The reference's ``PartitionSpec``: for each tensor dim, the mesh axis
    name it is sharded over, or None."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


class NamedSharding:
    """A mesh and a :class:`PartitionSpec`: what the reference's
    ``NamedSharding`` says, for DTensors."""

    def __init__(self, mesh, spec: Sequence = ()):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    @property
    def placements(self) -> list:
        return placements(self.mesh, self.spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def placements(mesh, spec: Sequence) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on the mesh
    dim named at tensor dim d, ``Replicate()`` elsewhere."""
    names = mesh.mesh_dim_names
    out = [Replicate() for _ in names]
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        if isinstance(ax, (tuple, list)):
            raise ValueError(f"spec {spec}: a tensor dim over more than one "
                             "mesh axis is not supported")
        if ax not in names:
            raise ValueError(f"spec {spec} names {ax!r}, not an axis of the "
                             f"mesh {names}")
        out[names.index(ax)] = Shard(d)
    return out


def in_mesh(mesh) -> bool:
    return mesh.get_coordinate() is not None


def group(mesh, axis: str):
    """The process group of this rank's line along ``axis``."""
    return mesh.get_group(axis)


def mesh_device(mesh) -> torch.device:
    """The device the mesh's tensors live on (every CUDA rank on its
    current card)."""
    return _probe_device(mesh.device_type)


def chunk_bounds(size: int, n: int, i: int) -> Tuple[int, int]:
    """[start, stop) of chunk i of ``torch.chunk(x, n)`` along a dim of
    ``size`` (empty past the last chunk): DTensor's ``Shard`` layout."""
    c = -(-size // n) if size else 0
    lo = min(size, i * c)
    return lo, min(size, lo + c)


def _as_tensor(x, device, dtype=None) -> torch.Tensor:
    if isinstance(x, DTensor):
        x = full_tensor(x)
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    if dtype is not None and x.is_floating_point():
        x = x.to(dtype)
    return x.to(device)


def local_slice(x: torch.Tensor, mesh, spec: Sequence) -> torch.Tensor:
    """This rank's shard of the full value ``x`` under ``spec`` (a view)."""
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        n = mesh.size(mesh.mesh_dim_names.index(ax))
        lo, hi = chunk_bounds(x.shape[d], n, mesh.get_local_rank(ax))
        x = x.narrow(d, lo, hi - lo)
    return x


def distribute(x, mesh, spec: Sequence = (), dtype=None) -> DTensor:
    """The full value ``x`` (numpy or tensor, the same on every rank of the
    mesh) as a DTensor on ``spec``'s placements; the local shard is a copy
    on the mesh's device (uneven dims split as ``torch.chunk`` does)."""
    full = _as_tensor(x, "cpu", dtype)
    local = local_slice(full, mesh, spec).contiguous().to(
        mesh_device(mesh), copy=True)
    return DTensor.from_local(local, mesh, placements(mesh, spec),
                              run_check=False, shape=full.shape,
                              stride=full.stride())


def from_local(local: torch.Tensor, mesh, spec: Sequence,
               shape=None) -> DTensor:
    """A DTensor over this rank's ``local`` shard; ``shape`` (the global
    one) defaults to the even split's."""
    if shape is None:
        shape = list(local.shape)
        for d, ax in enumerate(spec):
            if ax is not None:
                shape[d] *= mesh.size(mesh.mesh_dim_names.index(ax))
    shape = torch.Size(shape)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, placements(mesh, spec),
                              run_check=False, shape=shape, stride=stride)


def spec_of(x: DTensor) -> PartitionSpec:
    """The :class:`PartitionSpec` of a DTensor's placements."""
    names = x.device_mesh.mesh_dim_names
    axes = [None] * x.ndim
    for name, p in zip(names, x.placements):
        if isinstance(p, Shard):
            if axes[p.dim] is not None:
                raise ValueError(f"{x.placements}: two mesh axes on dim "
                                 f"{p.dim}")
            axes[p.dim] = name
        elif not isinstance(p, Replicate):
            raise ValueError(f"placement {p} is not Shard or Replicate")
    return PartitionSpec(*axes)


def full_tensor(x: DTensor) -> torch.Tensor:
    """The whole value of a Shard/Replicate DTensor on every rank of its
    mesh, gathered with this module's collectives (uneven shards padded to
    the chunk size on the wire and trimmed)."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    out = x.to_local()
    for name, p in zip(mesh.mesh_dim_names, x.placements):
        if not isinstance(p, Shard):
            continue
        n = mesh.size(mesh.mesh_dim_names.index(name))
        size = x.shape[p.dim]
        c = -(-size // n) if size else 0
        pad = c - out.shape[p.dim]
        if pad:
            widths = [0, 0] * (out.ndim - 1 - p.dim) + [0, pad]
            out = torch.nn.functional.pad(out, widths)
        out = all_gather(out.contiguous(), group(mesh, name), p.dim)
        out = out.narrow(p.dim, 0, size)
    return out


def local_of(x, mesh, spec: Sequence, device=None) -> torch.Tensor:
    """This rank's shard of ``x`` under ``spec``: a DTensor on those
    placements gives its local tensor (the same storage); a DTensor on
    others is gathered first; anything else is taken as the full value."""
    if isinstance(x, DTensor):
        if x.device_mesh is mesh and \
                list(x.placements) == placements(mesh, spec):
            return x.to_local()
        x = full_tensor(x)
    t = _as_tensor(x, device or mesh_device(mesh))
    return local_slice(t, mesh, spec)


def shard_map(f: Callable, mesh, in_specs: Sequence, out_specs,
              out_shapes=None):
    """``shard_map(f, mesh, in_specs, out_specs)``: a function of global
    arguments (DTensors, or full values) that runs ``f`` on this rank's
    shards (:func:`local_of`) and returns its outputs as DTensors on
    ``out_specs`` (one spec, or a tuple of specs for a tuple of outputs;
    ``out_shapes`` the global shapes where a split is uneven). On a rank
    outside the mesh it returns None."""
    def run(*args):
        if not in_mesh(mesh):
            return None
        locs = [local_of(a, mesh, s) for a, s in zip(args, in_specs)]
        out = f(*locs)
        if isinstance(out_specs, PartitionSpec):
            return from_local(out, mesh, out_specs,
                              None if out_shapes is None else out_shapes)
        shapes = out_shapes or [None] * len(out_specs)
        return tuple(from_local(o, mesh, s, sh)
                     for o, s, sh in zip(out, out_specs, shapes))
    return run
