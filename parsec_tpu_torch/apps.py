"""Application-level algorithms (the reference's tests/apps set).

* :func:`merge_sort` — DTD merge sort: chunk sort tasks, then a merge tree
  whose tasks each write a new tile.
* :func:`all2all` — every tile contributes to every other tile (the dense
  exchange of tests/apps/all2all).
* :func:`pingpong` — a tile bounced between two tiles N times
  (tests/apps/pingpong): each hop is a remote dep in distributed mode.
* :func:`haar_transform` — pairwise averaging tree (the dynamic-tree shape
  of the reference's haar-tree test).
* :func:`generalized_reduction` — forest-of-binary-trees reduction of an
  arbitrary tile count (tests/apps/generalized_reduction/BT_reduction.jdf).

The sort and merge bodies are host code (``jit=False``: they run as the CPU
chore); the others are tensor functions that run on the card when the
context has one.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .data.matrix import TiledMatrix
from .dsl.dtd import AFFINITY, DTDTaskpool, READ, RW


# module-level bodies: one task class each (loop-local lambdas would mint a
# task class per insertion)
def _acc_add(d, s):
    return d + s


def _bounce(d, s):
    return s + 1.0


def _pair_mean(o, a, b):
    return (a + b) * 0.5


def _merge_sorted(_o, x, y):
    return torch.sort(torch.cat([x, y])).values


def _sort_chunk(x):
    return torch.sort(x).values


def merge_sort(tp: DTDTaskpool, chunks: List[np.ndarray]):
    """Sort the concatenation of ``chunks`` through a DTD task tree.

    Returns the tile holding the fully sorted array. Sort tasks run first;
    each round of the merge tree pairs tiles into a new tile.
    """
    tiles = [tp.tile_new(np.asarray(c, dtype=np.float32)) for c in chunks]

    for t in tiles:
        tp.insert_task(_sort_chunk, (t, RW), name="sort", jit=False)

    # merge tree: each round pairs tiles; merged output goes to a new tile
    round_tiles = tiles
    while len(round_tiles) > 1:
        nxt = []
        for i in range(0, len(round_tiles) - 1, 2):
            a, b = round_tiles[i], round_tiles[i + 1]
            out = tp.tile_new((1,), np.float32)
            tp.insert_task(_merge_sorted, (out, RW), (a, READ), (b, READ),
                           name="merge", jit=False)
            nxt.append(out)
        if len(round_tiles) % 2:
            nxt.append(round_tiles[-1])
        round_tiles = nxt
    return round_tiles[0]


def all2all(tp: DTDTaskpool, A: TiledMatrix, B: TiledMatrix) -> int:
    """B[j] = reduce over i of A[i] — the dense exchange pattern
    (tests/apps/all2all): n^2 read edges, each remote in distributed mode."""
    n0 = tp.inserted
    for j in range(B.nt):
        for i in range(A.nt):
            tp.insert_task(_acc_add,
                           (tp.tile_of(B, 0, j), RW | AFFINITY),
                           (tp.tile_of(A, 0, i), READ), name="a2a")
    return tp.inserted - n0


def pingpong(tp: DTDTaskpool, A: TiledMatrix, hops: int) -> int:
    """Bounce tile (0,0) <-> (1,0) for ``hops`` steps (tests/apps/pingpong).

    With A distributed over 2 ranks each hop crosses the fabric."""
    n0 = tp.inserted
    t0, t1 = tp.tile_of(A, 0, 0), tp.tile_of(A, 1, 0)
    src, dst = t0, t1
    for _ in range(hops):
        tp.insert_task(_bounce, (dst, RW | AFFINITY), (src, READ),
                       name="pingpong")
        src, dst = dst, src
    return tp.inserted - n0


def haar_transform(tp: DTDTaskpool, leaves: List) -> List:
    """Bottom-up pairwise tree: each node = mean of its children (the
    haar-tree DAG shape). Returns the list of per-level root tiles."""
    level = list(leaves)
    roots = []
    while len(level) > 1:
        nxt = []
        for i in range(0, len(level) - 1, 2):
            out = tp.tile_new(np.zeros((1,), np.float32))
            tp.insert_task(_pair_mean,
                           (out, RW), (level[i], READ), (level[i + 1], READ),
                           name="haar")
            nxt.append(out)
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
        roots.append(level[0])
    return roots


def generalized_reduction(tp: DTDTaskpool, tiles: List, op=None):
    """BT_reduction: reduce ANY number of tiles (not just powers of two)
    through a forest of binary trees plus a linear pass over the roots
    (ref: tests/apps/generalized_reduction/BT_reduction.jdf — REDUCTION
    feeds per-tree BT_REDUC levels, tree roots chain through
    LINEAR_REDUC). The tile count's set bits pick the tree sizes exactly
    as the reference's index_to_tree/compute_offset helpers do.

    ``op(left, right) -> combined`` must be associative (the tree
    reorders associations, like any parallel reduction) but NOT
    commutative: every pairwise task keeps the lower-index operand on
    the left, so the result is tiles[0] op tiles[1] op ... in order.
    Returns the tile holding the final value (the first tree's root).
    """
    if op is None:
        op = _acc_add
    nt = len(tiles)
    if nt == 0:
        raise ValueError("nothing to reduce")
    # one tree per set bit, LSB first (compute_offset's ordering)
    trees = []
    off = 0
    for bit in range(nt.bit_length()):
        if (nt >> bit) & 1:
            trees.append((off, 1 << bit))
            off += 1 << bit
    roots = []
    for off, size in trees:
        # BT_REDUC levels: each pair combines into its EVEN (left) child,
        # keeping left-to-right association for non-commutative ops
        level = [tiles[off + j] for j in range(size)]
        while len(level) > 1:
            nxt = []
            for j in range(0, len(level), 2):
                a, b = level[j], level[j + 1]
                tp.insert_task(op, (a, RW), (b, READ), name="bt_reduc")
                nxt.append(a)
            level = nxt
        roots.append(level[0])
    # LINEAR_REDUC: fold tree roots last -> first (earlier root stays on
    # the left); result lands at the first tree's root (offset 0)
    for i in range(len(roots) - 1, 0, -1):
        tp.insert_task(op, (roots[i - 1], RW), (roots[i], READ),
                       name="linear_reduc")
    return roots[0]
