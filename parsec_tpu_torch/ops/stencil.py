"""Stencil bodies and task graphs (halo exchange over the task graph).

Re-design of the reference's stencil app (tests/apps/stencil: stencil_1D.jdf
with ghost exchange + CORE kernel): each iteration's tile task reads its two
neighbours' tiles from the *previous* iteration (the halos); in distributed
runs those reads become remote deps. Jacobi-style double buffering keeps
bodies functional: every task writes a new tile.

The 1D body is the hand-written kernel
:func:`~parsec_tpu_torch.ops.cuda_kernels.stencil1d` for every tile, the
boundary tiles included (a missing neighbour is a null halo, a zero column),
so a DAG of nt tiles and it iterations launches it nt·it times. The 2D
(5-point) and 3D (7-point) bodies are plain torch, as the reference has no
kernel for them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.matrix import TiledMatrix
from ..dsl.dtd import AFFINITY, DTDTaskpool, READ, RW
from .cuda_kernels import stencil1d


def stencil1d_body(x, left, right, w0=0.25, w1=0.5, w2=0.25):
    """One Jacobi step on a (rows, nb) tile with halo columns from the
    neighbour tiles (``None`` at the domain boundary: a zero column)."""
    return stencil1d(x, left, right, (w0, w1, w2))


def _mk_body(has_left: bool, has_right: bool, w):
    w0, w1, w2 = w
    if has_left and has_right:
        def body(x, l, r):
            return stencil1d_body(x, l, r, w0, w1, w2)
    elif has_left:
        def body(x, l):
            return stencil1d_body(x, l, None, w0, w1, w2)
    elif has_right:
        def body(x, r):
            return stencil1d_body(x, None, r, w0, w1, w2)
    else:
        def body(x):
            return stencil1d_body(x, None, None, w0, w1, w2)
    return body


# one body fn per (has_left, has_right, weights): 4 task classes per weights
_BODIES = {}


def _body_for(has_left: bool, has_right: bool, w):
    key = (has_left, has_right, w)
    b = _BODIES.get(key)
    if b is None:
        b = _mk_body(has_left, has_right, w)
        _BODIES[key] = b
    return b


def insert_stencil1d_tasks(tp: DTDTaskpool, A: TiledMatrix, B: TiledMatrix,
                           iterations: int,
                           weights=(0.25, 0.5, 0.25)) -> int:
    """Jacobi 1D stencil over ``iterations`` steps, ping-ponging A <-> B.

    The result lands in A when ``iterations`` is even, else in B. Returns
    the number of inserted tasks (ref: the testing_stencil_1D.c test
    program).
    """
    if A.nt != B.nt or not A.mt == B.mt == 1:
        raise ValueError("1D stencil: A and B are one tile row of equal "
                         "tile count")
    n0 = tp.inserted
    src, dst = A, B
    weights = tuple(weights)
    for _ in range(iterations):
        for i in range(src.nt):
            args = [(tp.tile_of(dst, 0, i), RW | AFFINITY),
                    (tp.tile_of(src, 0, i), READ)]
            if i > 0:
                args.append((tp.tile_of(src, 0, i - 1), READ))
            if i < src.nt - 1:
                args.append((tp.tile_of(src, 0, i + 1), READ))
            body = _body_for(i > 0, i < src.nt - 1, weights)
            tp.insert_task(_StencilTask(body), *args, name="ST")
        src, dst = dst, src
    return tp.inserted - n0


class _StencilTask:
    """Callable wrapper with a stable identity per boundary variant, so the
    DTD task-class cache hits (a new object per insert would mint a new task
    class every time)."""

    _cache = {}

    def __new__(cls, body):
        inst = cls._cache.get(body)
        if inst is None:
            inst = super().__new__(cls)
            inst.body = body
            cls._cache[body] = inst
        return inst

    def __call__(self, d, x, *halos):
        return self.body(x, *halos)


def stencil_flops(n_points: int, iterations: int) -> float:
    """FLOPS_STENCIL_1D role (ref: testing_stencil_1D.c:142): 5 flops/point."""
    return 5.0 * n_points * iterations


def reference_stencil1d(dense: np.ndarray, iterations: int,
                        weights=(0.25, 0.5, 0.25)) -> np.ndarray:
    """Numpy oracle for tests (float64)."""
    w0, w1, w2 = weights
    x = dense.astype(np.float64)
    for _ in range(iterations):
        xm = np.concatenate([np.zeros_like(x[..., :1]), x[..., :-1]], axis=-1)
        xp = np.concatenate([x[..., 1:], np.zeros_like(x[..., :1])], axis=-1)
        x = w0 * xm + w1 * x + w2 * xp
    return x


# ---------------------------------------------------------------------------
# 2D stencil (5-point)
# ---------------------------------------------------------------------------

def stencil2d_body(x, up, down, left, right, w=(0.2, 0.2, 0.2, 0.2, 0.2)):
    """One Jacobi step of the 5-point stencil on an (mb, nb) tile with halo
    rows/columns from the four neighbour tiles (zeros at the boundary)."""
    wc, wu, wd, wl, wr = w
    urow = up[-1:, :] if up is not None else torch.zeros_like(x[:1, :])
    drow = down[:1, :] if down is not None else torch.zeros_like(x[:1, :])
    lcol = left[:, -1:] if left is not None else torch.zeros_like(x[:, :1])
    rcol = right[:, :1] if right is not None else torch.zeros_like(x[:, :1])
    xu = torch.cat([urow, x[:-1, :]], dim=0)
    xd = torch.cat([x[1:, :], drow], dim=0)
    xl = torch.cat([lcol, x[:, :-1]], dim=1)
    xr = torch.cat([x[:, 1:], rcol], dim=1)
    return wc * x + wu * xu + wd * xd + wl * xl + wr * xr


_BODIES2D = {}


def _body2d_for(has, w):
    key = (has, w)
    b = _BODIES2D.get(key)
    if b is not None:
        return b
    hu, hd, hl, hr = has

    def body(x, *halos):
        i = 0
        up = halos[i] if hu else None
        i += hu
        down = halos[i] if hd else None
        i += hd
        left = halos[i] if hl else None
        i += hl
        right = halos[i] if hr else None
        return stencil2d_body(x, up, down, left, right, w)

    wrapped = _StencilTask(body)
    _BODIES2D[key] = wrapped
    return wrapped


def insert_stencil2d_tasks(tp: DTDTaskpool, A: TiledMatrix, B: TiledMatrix,
                           iterations: int,
                           weights=(0.2, 0.2, 0.2, 0.2, 0.2)) -> int:
    """Jacobi 5-point stencil, A <-> B double buffering. The four halo reads
    become remote deps across an owner grid in distributed runs."""
    if (A.mt, A.nt) != (B.mt, B.nt):
        raise ValueError("2D stencil: A and B need the same tile grid")
    n0 = tp.inserted
    src, dst = A, B
    for _ in range(iterations):
        for mi in range(src.mt):
            for ni in range(src.nt):
                has = (mi > 0, mi < src.mt - 1, ni > 0, ni < src.nt - 1)
                args = [(tp.tile_of(dst, mi, ni), RW | AFFINITY),
                        (tp.tile_of(src, mi, ni), READ)]
                if has[0]:
                    args.append((tp.tile_of(src, mi - 1, ni), READ))
                if has[1]:
                    args.append((tp.tile_of(src, mi + 1, ni), READ))
                if has[2]:
                    args.append((tp.tile_of(src, mi, ni - 1), READ))
                if has[3]:
                    args.append((tp.tile_of(src, mi, ni + 1), READ))
                tp.insert_task(_body2d_for(has, tuple(weights)), *args,
                               name="ST2D")
        src, dst = dst, src
    return tp.inserted - n0


def reference_stencil2d(dense: np.ndarray, iterations: int,
                        weights=(0.2, 0.2, 0.2, 0.2, 0.2)) -> np.ndarray:
    """Numpy oracle for tests (float64)."""
    wc, wu, wd, wl, wr = weights
    x = dense.astype(np.float64)
    for _ in range(iterations):
        z = np.zeros_like(x)
        xu = np.concatenate([z[:1, :], x[:-1, :]], axis=0)
        xd = np.concatenate([x[1:, :], z[:1, :]], axis=0)
        xl = np.concatenate([z[:, :1], x[:, :-1]], axis=1)
        xr = np.concatenate([x[:, 1:], z[:, :1]], axis=1)
        x = wc * x + wu * xu + wd * xd + wl * xl + wr * xr
    return x


# ---------------------------------------------------------------------------
# 3D stencil (7-point): slab decomposition in Z (halo exchange across
# tiles), XY handled inside each brick
# ---------------------------------------------------------------------------

def stencil3d_body(x, above, below,
                   w=(0.4, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1)):
    """One Jacobi step of the 7-point stencil on a (sz, ny, nx) brick with
    Z halo planes from the neighbour slabs (zeros at the domain boundary)."""
    wc, wzm, wzp, wym, wyp, wxm, wxp = w
    aplane = above[-1:] if above is not None else torch.zeros_like(x[:1])
    bplane = below[:1] if below is not None else torch.zeros_like(x[:1])
    zm = torch.cat([aplane, x[:-1]], dim=0)
    zp = torch.cat([x[1:], bplane], dim=0)
    ym = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
    yp = torch.cat([x[:, 1:], torch.zeros_like(x[:, :1])], dim=1)
    xm = torch.cat([torch.zeros_like(x[..., :1]), x[..., :-1]], dim=2)
    xp = torch.cat([x[..., 1:], torch.zeros_like(x[..., :1])], dim=2)
    return wc * x + wzm * zm + wzp * zp + wym * ym + wyp * yp \
        + wxm * xm + wxp * xp


_BODIES3D = {}


def _body3d_for(has, w):
    key = (has, w)
    b = _BODIES3D.get(key)
    if b is not None:
        return b
    ha, hb = has

    def body(x, *halos):
        above = halos[0] if ha else None
        below = halos[ha] if hb else None
        return stencil3d_body(x, above, below, w)

    wrapped = _StencilTask(body)
    _BODIES3D[key] = wrapped
    return wrapped


def insert_stencil3d_tasks(tp: DTDTaskpool, bricks_a, bricks_b,
                           iterations: int,
                           weights=(0.4, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1)) -> int:
    """Jacobi 7-point stencil over Z-slab bricks (lists of DTD tiles, each
    holding a (sz, ny, nx) payload), A <-> B double buffering; the Z halo
    reads become remote deps when slabs live on different ranks."""
    if len(bricks_a) != len(bricks_b):
        raise ValueError("3D stencil: A and B need the same brick count")
    nz = len(bricks_a)
    n0 = tp.inserted
    src, dst = list(bricks_a), list(bricks_b)
    for _ in range(iterations):
        for zi in range(nz):
            has = (zi > 0, zi < nz - 1)
            args = [(dst[zi], RW | AFFINITY), (src[zi], READ)]
            if has[0]:
                args.append((src[zi - 1], READ))
            if has[1]:
                args.append((src[zi + 1], READ))
            tp.insert_task(_body3d_for(has, tuple(weights)), *args,
                           name="ST3D")
        src, dst = dst, src
    return tp.inserted - n0


def reference_stencil3d(dense: np.ndarray, iterations: int,
                        w=(0.4, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1)) -> np.ndarray:
    """Numpy oracle for tests (float32, as the reference's)."""
    wc, wzm, wzp, wym, wyp, wxm, wxp = w
    x = dense.astype(np.float32)

    def shift(a, axis, direction):
        pad = np.zeros_like(np.take(a, [0], axis=axis))
        if direction > 0:       # neighbour at index-1 (shift content down)
            body = np.take(a, range(a.shape[axis] - 1), axis=axis)
            return np.concatenate([pad, body], axis=axis)
        body = np.take(a, range(1, a.shape[axis]), axis=axis)
        return np.concatenate([body, pad], axis=axis)

    for _ in range(iterations):
        x = (wc * x
             + wzm * shift(x, 0, +1) + wzp * shift(x, 0, -1)
             + wym * shift(x, 1, +1) + wyp * shift(x, 1, -1)
             + wxm * shift(x, 2, +1) + wxp * shift(x, 2, -1))
    return x
