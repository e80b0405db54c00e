"""ex16: redistribution between tiled collections.

The reference's redistribute component (redistribute.jdf /
redistribute_reshuffle.jdf) as it looks here: move a submatrix between
collections with different tile geometries and unaligned offsets (the
general fragment algebra), then an aligned same-geometry move that takes
the whole-tile zero-copy reshuffle fast path. The collections live on the
context's device: the card, or the host with ``--cpu``.

Run: ``python examples_torch/ex16_redistribute.py [--cpu]``
"""

import numpy as np

from _common import device

import parsec_tpu_torch as pt                                   # noqa: E402
from parsec_tpu_torch.data.matrix import TiledMatrix            # noqa: E402
from parsec_tpu_torch.data.redistribute import redistribute     # noqa: E402


def main() -> None:
    dev = device()
    rng = np.random.default_rng(16)
    ctx = pt.Context(nb_cores=1, device=dev)

    # general case: different tile sizes, unaligned offsets
    src = rng.standard_normal((96, 96)).astype(np.float32)
    S = TiledMatrix("S", 96, 96, 16, 16, device=dev)
    T = TiledMatrix("T", 96, 96, 24, 24, device=dev)
    S.fill(lambda m, k: src[m*16:(m+1)*16, k*16:(k+1)*16])
    T.fill(lambda m, k: np.zeros((24, 24), np.float32))
    tp = pt.DTDTaskpool(ctx, "redist")
    ntasks = redistribute(tp, S, T, m=50, n=40, si=7, sj=13, ti=21, tj=5)
    tp.wait(); tp.close(); ctx.wait()
    expect = np.zeros((96, 96), np.float32)
    expect[21:71, 5:45] = src[7:57, 13:53]
    err = np.abs(T.to_dense() - expect).max()
    print(f"fragment path: {ntasks} tasks, max err {err:.1e}")

    # aligned same-geometry: the reshuffle fast path (whole-tile moves)
    U = TiledMatrix("U", 96, 96, 16, 16, device=dev)
    U.fill(lambda m, k: np.zeros((16, 16), np.float32))
    tp = pt.DTDTaskpool(ctx, "reshuffle")
    ntasks = redistribute(tp, S, U)          # full matrix, aligned
    tp.wait(); tp.close(); ctx.wait()
    moved = U.data_of(2, 2).newest_copy().payload \
        is S.data_of(2, 2).newest_copy().payload
    exact = bool((U.to_dense() == src).all())
    print(f"reshuffle path: {ntasks} tasks (one per tile), "
          f"zero-copy move: {moved}, exact: {exact}")
    ctx.fini()
    if err != 0.0 or not (moved and exact):
        raise SystemExit("ex16: the redistribution is wrong")


if __name__ == "__main__":
    main()
