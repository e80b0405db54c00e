"""Generic per-tile helper algorithms over collections.

Re-design of the reference's helper taskpools in parsec/data_dist/matrix
(apply.jdf + wrapper, reduce.jdf / reduce_col.jdf / reduce_row.jdf,
broadcast.jdf, map_operator.c): each builds a small task DAG through the DTD
frontend against any tiled collection. Every body is a functional torch
function (tile -> new tile), so on a card context it runs as the CUDA chore,
on the tiles' device copies.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..dsl.dtd import AFFINITY, DTDTaskpool, READ, RW
from .matrix import TiledMatrix


def _copy_src(dst, s):
    return s


def apply(tp: DTDTaskpool, A: TiledMatrix,
          op: Callable[[int, int, Any], Any], uplo: str = "full") -> int:
    """Apply ``op(m, n, tile) -> tile`` to every tile (ref: apply.jdf).

    ``uplo`` restricts to 'lower'/'upper' triangles like the reference.
    """
    n0 = tp.inserted
    for m in range(A.mt):
        for n in range(A.nt):
            if uplo == "lower" and n > m:
                continue
            if uplo == "upper" and n < m:
                continue
            tp.insert_task(lambda x, _m, _n: op(int(_m), int(_n), x),
                           (tp.tile_of(A, m, n), RW | AFFINITY), m, n,
                           name="apply")
    return tp.inserted - n0


def map_operator(tp: DTDTaskpool, A: TiledMatrix, B: TiledMatrix,
                 op: Callable[[Any, Any], Any]) -> int:
    """dst tile = op(src tile, dst tile) over two collections
    (ref: map_operator.c)."""
    n0 = tp.inserted
    for m in range(A.mt):
        for n in range(A.nt):
            tp.insert_task(op, (tp.tile_of(A, m, n), READ),
                           (tp.tile_of(B, m, n), RW | AFFINITY),
                           name="map2")
    return tp.inserted - n0


def reduce_all(tp: DTDTaskpool, A: TiledMatrix,
               op: Callable[[Any, Any], Any],
               root: tuple = (0, 0)) -> int:
    """Binary-tree reduction of every tile into tile ``root``
    (ref: reduce.jdf). Returns task count; result lands in A[root]."""
    tiles = [(m, n) for m in range(A.mt) for n in range(A.nt)]
    tiles.remove(root)
    tiles.insert(0, root)
    n0 = tp.inserted
    stride = 1
    while stride < len(tiles):
        for i in range(0, len(tiles) - stride, 2 * stride):
            dst, src = tiles[i], tiles[i + stride]
            tp.insert_task(op, (tp.tile_of(A, *dst), RW | AFFINITY),
                           (tp.tile_of(A, *src), READ), name="reduce")
        stride *= 2
    return tp.inserted - n0


def reduce_row(tp: DTDTaskpool, A: TiledMatrix,
               op: Callable[[Any, Any], Any]) -> int:
    """Reduce each row of tiles into column 0 (ref: reduce_row.jdf)."""
    n0 = tp.inserted
    for m in range(A.mt):
        for n in range(1, A.nt):
            tp.insert_task(op, (tp.tile_of(A, m, 0), RW | AFFINITY),
                           (tp.tile_of(A, m, n), READ), name="reduce_row")
    return tp.inserted - n0


def reduce_col(tp: DTDTaskpool, A: TiledMatrix,
               op: Callable[[Any, Any], Any]) -> int:
    """Reduce each column of tiles into row 0 (ref: reduce_col.jdf)."""
    n0 = tp.inserted
    for n in range(A.nt):
        for m in range(1, A.mt):
            tp.insert_task(op, (tp.tile_of(A, 0, n), RW | AFFINITY),
                           (tp.tile_of(A, m, n), READ), name="reduce_col")
    return tp.inserted - n0


def band_pack(b, d, sd=None):
    """One packed band tile (the body of :func:`diag_band_to_rect`): a tile
    shaped like ``b``, (MB+1, NB+2), whose column j holds the diagonal
    tile ``d``'s column j from the diagonal down, then the subdiagonal tile
    ``sd``'s top j + 1 rows (zeros when ``sd`` is None); the trailing two
    columns are zero. Element (i, j) is row i + j of ``d`` stacked over
    ``sd``, so the whole tile is one gather."""
    mb, nb = d.shape
    lower = sd if sd is not None else torch.zeros_like(d)
    stacked = torch.cat([d, lower[:mb]], dim=0)              # (2 MB, NB)
    rows = (torch.arange(mb + 1, device=d.device)[:, None]
            + torch.arange(nb, device=d.device)[None, :])
    out = torch.zeros(b.shape, dtype=b.dtype, device=d.device)
    out[:, :nb] = torch.gather(stacked, 0, rows)
    return out


def _zero_pad(b):
    return torch.zeros_like(b)


def diag_band_to_rect(tp: DTDTaskpool, A: TiledMatrix, B: TiledMatrix) -> int:
    """Pack the diagonal band of a symmetric (lower) tiled matrix into a 1D
    row of rectangular tiles (ref: diag_band_to_rect.jdf).

    For each tile column k, output tile B(0, k) of shape (MB+1, NB+2) packs
    global column j of the band: the diagonal tile's column from the
    diagonal down, then the subdiagonal tile's top rows — the LAPACK
    band-storage layout used between band reduction and bulge chasing in
    eigensolvers. The trailing two columns (and a trailing padding tile,
    when B has NT+1 column-tiles) are zeroed, mirroring the reference's
    k == NT branch.

    A must have square tiles (MB == NB); B(0, k) tiles must be
    (MB+1) × (NB+2). Each convert task carries read deps on A(k,k) and
    A(k+1,k) (the JDF's read_diag / read_subdiag relay tasks exist only to
    home the sends of a distributed run; DTD's owner-computes affinity
    gives the same placement directly).
    """
    mb, nb = A.mb, A.nb
    if mb != nb:
        raise ValueError("diag_band_to_rect requires square tiles (MB == NB)")
    if A.lm % mb or A.ln % nb:
        raise ValueError("diag_band_to_rect requires full tiles "
                         f"({A.lm}x{A.ln} not divisible by {mb}x{nb})")
    nt = min(A.mt, A.nt)
    if B.tile_shape(0, 0) != (mb + 1, nb + 2):
        raise ValueError(f"B tiles must be ({mb + 1},{nb + 2}), "
                         f"got {B.tile_shape(0, 0)}")
    n0 = tp.inserted
    for k in range(nt):
        if k < nt - 1:
            tp.insert_task(band_pack, (tp.tile_of(B, 0, k), RW | AFFINITY),
                           (tp.tile_of(A, k, k), READ),
                           (tp.tile_of(A, k + 1, k), READ),
                           name="convert_diag")
        else:
            tp.insert_task(band_pack, (tp.tile_of(B, 0, k), RW | AFFINITY),
                           (tp.tile_of(A, k, k), READ),
                           name="convert_diag")
    if B.nt > nt:  # padding tile(s), ref's k == NT branch
        for k in range(nt, B.nt):
            tp.insert_task(_zero_pad, (tp.tile_of(B, 0, k), RW | AFFINITY),
                           name="convert_pad")
    return tp.inserted - n0


def broadcast(tp: DTDTaskpool, A: TiledMatrix, root: tuple = (0, 0)) -> int:
    """Copy tile ``root`` into every tile of A (ref: broadcast.jdf): each
    copy task moves the root's payload by reference."""
    n0 = tp.inserted
    src = tp.tile_of(A, *root)
    for m in range(A.mt):
        for n in range(A.nt):
            if (m, n) == root:
                continue
            tp.insert_task(_copy_src,
                           (tp.tile_of(A, m, n), RW | AFFINITY), (src, READ),
                           name="bcast")
    return tp.inserted - n0
