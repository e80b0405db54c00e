"""Redistribution: move a submatrix between two tiled collections.

Re-design of parsec/data_dist/matrix/redistribute (redistribute.jdf,
redistribute_internal.h, redistribute_dtd.c): copy an m×n region from
source collection S (offset si, sj) into target collection T (offset ti,
tj), where S and T may have different tile sizes, grids and alignments.

Strategy (the reference's general case): one task per *target tile
fragment*: every target tile intersects up to four+ source tiles when
offsets are unaligned; each intersection becomes a copy task reading the
source tile and writing the slice of the target tile. A fragment copy is a
clone of the target tile with the slice assigned, on the tiles' device (the
card on a card context). Owner-computes places each task on the target
tile's rank; in a distributed run the cross-rank source reads ride the
remote-dep machinery (``comm/remote_dep.py``).
"""

from __future__ import annotations

from typing import Optional

from ..dsl.dtd import AFFINITY, DTDTaskpool, READ, RW
from .matrix import TiledMatrix


def _frag_copy(dst, src, sr, sc, tr, tc, h, w):
    out = dst.clone()
    out[tr:tr + h, tc:tc + w] = src[sr:sr + h, sc:sc + w]
    return out


def _tile_move(dst, src):
    """Whole-tile move (the reshuffle fast path, ref:
    redistribute_reshuffle.jdf:1-128): same geometry + aligned offsets map
    each target tile to exactly ONE source tile, so the payload moves by
    reference — no slice, no copy. Safe under the runtime's functional
    tile discipline (bodies never mutate inputs in place; a later write to
    either tile REPLACES its payload)."""
    return src


def redistribute(tp: DTDTaskpool, S: TiledMatrix, T: TiledMatrix,
                 m: Optional[int] = None, n: Optional[int] = None,
                 si: int = 0, sj: int = 0, ti: int = 0, tj: int = 0) -> int:
    """Insert copy tasks moving S[si:si+m, sj:sj+n] -> T[ti:ti+m, tj:tj+n].

    Returns the number of inserted tasks. Supports arbitrary tile sizes and
    non-aligned offsets on both sides (ref: redistribute_internal.h's
    NEW/OLD displacement algebra). Target tiles that T does not store (the
    other triangle of a symmetric collection) are skipped.
    """
    m = m if m is not None else min(S.lm - si, T.lm - ti)
    n = n if n is not None else min(S.ln - sj, T.ln - tj)
    if not (si + m <= S.lm and sj + n <= S.ln):
        raise ValueError("source region out of bounds")
    if not (ti + m <= T.lm and tj + n <= T.ln):
        raise ValueError("target region out of bounds")
    n0 = tp.inserted

    # reshuffle fast path precondition: identical tile geometry AND dtype
    # (the fragment path casts through the target's dtype on assignment;
    # a by-reference move must not change a collection's dtype) and
    # congruent offsets — every FULL target tile then maps to exactly one
    # source tile and moves whole, by reference (no fragment algebra)
    same_geom = (S.mb == T.mb and S.nb == T.nb
                 and getattr(S, "dtype", None) == getattr(T, "dtype", None)
                 and (si - ti) % S.mb == 0 and (sj - tj) % S.nb == 0)

    # iterate target tiles touched by the region
    t_m0, t_m1 = ti // T.mb, (ti + m - 1) // T.mb
    t_n0, t_n1 = tj // T.nb, (tj + n - 1) // T.nb
    for tm in range(t_m0, t_m1 + 1):
        for tn in range(t_n0, t_n1 + 1):
            if not T.stored(tm, tn):
                continue
            # region rows/cols covered by this target tile
            r0 = max(tm * T.mb, ti) - ti
            r1 = min((tm + 1) * T.mb, ti + m) - ti
            c0 = max(tn * T.nb, tj) - tj
            c1 = min((tn + 1) * T.nb, tj + n) - tj
            if same_geom and (ti + r0) % T.mb == 0 and r1 - r0 == T.mb \
                    and (tj + c0) % T.nb == 0 and c1 - c0 == T.nb:
                # whole aligned tile: one move task, zero copies
                sm, sn = (si + r0) // S.mb, (sj + c0) // S.nb
                tp.insert_task(_tile_move,
                               (tp.tile_of(T, tm, tn), RW | AFFINITY),
                               (tp.tile_of(S, sm, sn), READ),
                               name="reshuffle")
                continue
            # source tiles intersecting [r0:r1, c0:c1] (region coords)
            s_m0, s_m1 = (si + r0) // S.mb, (si + r1 - 1) // S.mb
            s_n0, s_n1 = (sj + c0) // S.nb, (sj + c1 - 1) // S.nb
            dst_tile = tp.tile_of(T, tm, tn)
            for sm in range(s_m0, s_m1 + 1):
                for sn in range(s_n0, s_n1 + 1):
                    fr0 = max(sm * S.mb - si, r0)
                    fr1 = min((sm + 1) * S.mb - si, r1)
                    fc0 = max(sn * S.nb - sj, c0)
                    fc1 = min((sn + 1) * S.nb - sj, c1)
                    if fr0 >= fr1 or fc0 >= fc1:
                        continue
                    # slice coordinates inside the source / target tiles
                    sr, sc = si + fr0 - sm * S.mb, sj + fc0 - sn * S.nb
                    tr, tc = ti + fr0 - tm * T.mb, tj + fc0 - tn * T.nb
                    h, w = fr1 - fr0, fc1 - fc0

                    tp.insert_task(_frag_copy, (dst_tile, RW | AFFINITY),
                                   (tp.tile_of(S, sm, sn), READ),
                                   sr, sc, tr, tc, h, w,
                                   name="redistribute")
    return tp.inserted - n0
