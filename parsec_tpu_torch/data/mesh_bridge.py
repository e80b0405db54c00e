"""Collection <-> sharded-global-tensor bridge: the task runtime's tiled data
handed to the SPMD world (the mesh programs of ``parallel/``) and back.

The port of the reference's ``data/mesh_bridge.py:30-105``. A tiled collection
assembles into one DTensor sharded over a rank mesh (:func:`to_global`),
any mesh program runs on it, and the result scatters back into the
collection's tiles with version bumps (:func:`from_global`), so DTD/PTG
taskpools and ``parallel/spmd.py`` programs compose on the same matrices.
Every rank of the mesh holds the collection (each rank its own copy, as
every controller holds it in the reference's single process) and calls
these together.

:func:`redistribute_mesh` rides the same seam: assemble, reshard, scatter.
The host-side :mod:`parsec_tpu_torch.data.redistribute` remains the
task-dataflow variant for cross-RANK moves of distributed collections.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..utils import output
from .data import COHERENCY_OWNED
from .matrix import TiledMatrix


def _check_uniform(dc: TiledMatrix) -> None:
    if dc.lm % dc.mb or dc.ln % dc.nb:
        output.fatal(f"mesh bridge: collection {dc.name} has partial edge "
                     f"tiles ({dc.lm}x{dc.ln} over {dc.mb}x{dc.nb})")


def _dense(dc: TiledMatrix) -> torch.Tensor:
    """The collection's stored tiles assembled on the host (zeros where no
    copy holds a payload)."""
    dense = torch.zeros((dc.lm, dc.ln), dtype=dc.dtype)
    for m in range(dc.lmt):
        for n in range(dc.lnt):
            if not dc.stored(m, n):
                continue
            c = dc.data_of(m, n).newest_copy()
            if c is not None and c.payload is not None:
                dense[m * dc.mb:(m + 1) * dc.mb,
                      n * dc.nb:(n + 1) * dc.nb] = \
                    torch.as_tensor(c.payload).cpu()
    return dense


def to_global(dc: TiledMatrix, mesh=None, axes: Sequence[str] = None):
    """Assemble a tiled collection into one array; with ``mesh``, a DTensor
    sharded over both mesh axes (``P(*axes)``, the mesh's own names by
    default) so mesh programs run on it. Without a mesh, returns the dense
    host assembly (numpy: useful for tests and staging)."""
    _check_uniform(dc)
    dense = _dense(dc)
    if mesh is None:
        return dense.numpy() if dc.dtype != torch.bfloat16 else \
            dense.float().numpy()
    from ..parallel import compat
    ax = tuple(axes) if axes is not None else tuple(mesh.mesh_dim_names)
    sizes = [mesh.size(mesh.mesh_dim_names.index(a)) for a in ax]
    if dc.lm % sizes[0] or dc.ln % sizes[1]:
        output.fatal(f"mesh bridge: {dc.name} {dc.lm}x{dc.ln} not divisible "
                     f"by mesh {sizes[0]}x{sizes[1]}")
    return compat.distribute(dense, mesh, compat.P(*ax))


def from_global(dc: TiledMatrix, arr) -> None:
    """Scatter a global array (a DTensor, gathered on every rank of its
    mesh, or a full tensor or numpy array) back into the collection's
    tiles (stored triangle only, version bumps like task completions):
    the mesh program's result becomes visible to subsequent taskpools."""
    from ..parallel import compat
    _check_uniform(dc)
    if tuple(arr.shape) != (dc.lm, dc.ln):
        output.fatal(f"mesh bridge: array {tuple(arr.shape)} does not match "
                     f"collection {dc.name} {dc.lm}x{dc.ln}")
    if isinstance(arr, compat.DTensor):
        arr = compat.full_tensor(arr)
    host = torch.as_tensor(np.asarray(arr) if not isinstance(
        arr, torch.Tensor) else arr).detach().cpu()
    for m in range(dc.lmt):
        for n in range(dc.lnt):
            if not dc.stored(m, n):
                continue
            tilev = host[m * dc.mb:(m + 1) * dc.mb,
                         n * dc.nb:(n + 1) * dc.nb].to(
                device=dc.device, dtype=dc.dtype).contiguous()
            d = dc.data_of(m, n)
            c = d.get_copy(0)
            if c is None:
                d.create_copy(0, tilev, COHERENCY_OWNED)
            else:
                c.payload = tilev
            d.bump_version(0)


def redistribute_mesh(src: TiledMatrix, dst: TiledMatrix, mesh=None,
                      axes: Sequence[str] = None) -> None:
    """Move a matrix between two tiled layouts (different tile sizes and/or
    distributions) through the sharded-global seam: assemble -> (reshard
    onto ``P(*axes)``) -> scatter. Extents must match; everything else
    (mb/nb, grids) may differ."""
    if (src.lm, src.ln) != (dst.lm, dst.ln):
        output.fatal(f"redistribute_mesh: extents differ "
                     f"({src.lm}x{src.ln} vs {dst.lm}x{dst.ln})")
    g = to_global(src, mesh, axes)
    if mesh is not None:
        from ..parallel import compat
        ax = tuple(axes) if axes is not None else tuple(mesh.mesh_dim_names)
        # the destination sharding may equal the source's: then the local
        # shard is taken as it is, otherwise gathered and cut anew
        g = compat.from_local(compat.local_of(g, mesh, compat.P(*ax)),
                              mesh, compat.P(*ax), shape=g.shape)
    from_global(dst, g)
