"""Tiled-matrix data collections and distribution layouts.

Re-design of parsec/data_dist/matrix: the tiled-matrix descriptor
(parsec_tiled_matrix_t, matrix.h:101-126) and its 2D block-cyclic
distribution (two_dim_rectangle_cyclic.c).

* :class:`TiledMatrix` — base: mb/nb tile sizes, lm/ln global extent,
  submatrix view (i/j/m/n), typed storage.
* :class:`TwoDimBlockCyclic` — the PBLAS 2D block-cyclic layout incl.
  k-cyclicity (ref: two_dim_rectangle_cyclic.c:16-21,109,195-197 closed
  forms; grid helper grid_2Dcyclic.c).

Tiles are torch tensors: the home copy (device index 0) lives where the
collection was built (the host by default), device copies are managed by the
device layer. :func:`collection_from_numpy` and :meth:`TiledMatrix.to_dense`
move a whole matrix in and out, tile for tile.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from .collection import DataCollection
from .data import COHERENCY_OWNED, Data


def torch_dtype(dtype: Any) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or a dtype name
    (``"bfloat16"`` included, which numpy lacks)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"no torch dtype for {dtype!r}")
    return dt


class TiledMatrix(DataCollection):
    """Base tiled matrix (ref: parsec_tiled_matrix_t, matrix.h:101-126)."""

    def __init__(self, name: str, lm: int, ln: int, mb: int, nb: int,
                 i: int = 0, j: int = 0, m: Optional[int] = None,
                 n: Optional[int] = None, dtype=torch.float32,
                 nodes: int = 1, myrank: int = 0,
                 device: Any = "cpu") -> None:
        super().__init__(name, nodes, myrank)
        self.lm, self.ln = lm, ln          # global extent
        self.mb, self.nb = mb, nb          # tile sizes
        self.i, self.j = i, j              # submatrix origin (elements)
        self.m = m if m is not None else lm
        self.n = n if n is not None else ln
        self.dtype = torch_dtype(dtype)
        #: where the home copies (device index 0) live
        self.device = torch.device(device)
        self.lmt = (lm + mb - 1) // mb     # tiles in M
        self.lnt = (ln + nb - 1) // nb     # tiles in N
        self.mt = (self.m + mb - 1) // mb
        self.nt = (self.n + nb - 1) // nb

    def data_key(self, *indices) -> Any:
        m, n = indices
        return m * self.lnt + n

    def key_to_indices(self, key: int) -> Tuple[int, int]:
        return divmod(key, self.lnt)

    def tile_shape(self, m: int, n: int) -> Tuple[int, int]:
        """Edge tiles may be partial (ref: remaining rows/cols in matrix.c)."""
        rows = min(self.mb, self.lm - m * self.mb)
        cols = min(self.nb, self.ln - n * self.nb)
        return rows, cols

    def _create_data(self, key: Any) -> Data:
        m, n = self.key_to_indices(key)
        shape = self.tile_shape(m, n)
        arr = torch.zeros(shape, dtype=self.dtype, device=self.device)
        d = Data(key=key, dc=self, shape=shape, dtype=self.dtype)
        d.create_copy(0, arr, COHERENCY_OWNED)
        return d

    # convenience: fill / gather for tests and benchmarks -------------------
    def fill(self, fn: Callable[[int, int], Any]) -> None:
        """Materialize every local tile via fn(m, n) -> array or tensor."""
        for m in range(self.mt):
            for n in range(self.nt):
                if self.rank_of(m, n) != self.myrank:
                    continue
                arr = torch.as_tensor(fn(m, n)).to(
                    device=self.device, dtype=self.dtype).contiguous()
                d = self.data_of(m, n)
                c = d.get_copy(0)
                if c is None:
                    d.create_copy(0, arr, COHERENCY_OWNED)
                else:
                    c.payload = arr
                d.version += 1
                cc = d.get_copy(0)
                cc.version = d.version

    def to_dense(self) -> np.ndarray:
        """Gather local tiles into a dense numpy array (single-rank testing
        only). bf16 tiles come back as float32, which holds them exactly."""
        np_dtype = np.float32 if self.dtype == torch.bfloat16 else \
            torch.empty((), dtype=self.dtype).numpy().dtype
        out = np.zeros((self.lm, self.ln), dtype=np_dtype)
        for m in range(self.mt):
            for n in range(self.nt):
                if self.rank_of(m, n) != self.myrank:
                    continue
                c = self.data_of(m, n).newest_copy()
                if c is None:
                    continue
                tile = torch.as_tensor(c.payload).cpu()
                if tile.dtype == torch.bfloat16:
                    tile = tile.float()
                r, co = self.tile_shape(m, n)
                out[m * self.mb:m * self.mb + r,
                    n * self.nb:n * self.nb + co] = tile[:r, :co].numpy()
        return out


class TwoDimBlockCyclic(TiledMatrix):
    """2D block-cyclic distribution over a P×Q grid with k-cyclicity.

    Closed forms re-derived from the PBLAS definition (the reference
    implements the same math in two_dim_rectangle_cyclic.c:109,195-197):
    tile (m, n) lives on grid row (m // kp) % P, grid col (n // kq) % Q.
    """

    def __init__(self, name: str, lm: int, ln: int, mb: int, nb: int,
                 P: int = 1, Q: Optional[int] = None, kp: int = 1, kq: int = 1,
                 nodes: int = 1, myrank: int = 0, **kw) -> None:
        super().__init__(name, lm, ln, mb, nb, nodes=nodes, myrank=myrank, **kw)
        if Q is None:
            Q = max(1, nodes // P)
        self.P, self.Q = P, Q
        self.kp, self.kq = kp, kq
        if P * Q > max(nodes, 1):
            raise ValueError(f"grid {P}x{Q} exceeds {nodes} ranks")

    def grid_of(self, m: int, n: int) -> Tuple[int, int]:
        return (m // self.kp) % self.P, (n // self.kq) % self.Q

    def rank_of(self, *indices) -> int:
        p, q = self.grid_of(*indices)
        return p * self.Q + q

    def rank_of_key(self, key: Any) -> int:
        return self.rank_of(*self.key_to_indices(key))


def collection_from_numpy(name: str, dense: np.ndarray, mb: int, nb: int,
                          dtype: Any = None,
                          device: Any = "cpu") -> TwoDimBlockCyclic:
    """A single-rank :class:`TwoDimBlockCyclic` holding ``dense`` cut into
    mb×nb tiles, in ``dtype`` (default: ``dense``'s own; pass
    ``torch.bfloat16`` or ``"bfloat16"`` for bf16), with its home copies on
    ``device``. The inverse of :meth:`TiledMatrix.to_dense`: a reference
    collection's ``to_dense()`` goes through here into the port tile for
    tile, with the same tiling and values."""
    dense = np.asarray(dense)
    if dense.ndim != 2:
        raise ValueError(f"need a 2-D matrix, got shape {dense.shape}")
    dt = torch_dtype(dense.dtype if dtype is None else dtype)
    if dense.dtype.name == "bfloat16":
        # a numpy bf16 extension array: torch cannot wrap it, and float32
        # holds every bf16 value exactly
        dense = dense.astype(np.float32)
    lm, ln = dense.shape
    M = TwoDimBlockCyclic(name, lm, ln, mb, nb, P=1, Q=1, dtype=dt,
                          device=device)
    # convert once on the target device, then cut: per-tile conversion of a
    # large matrix would pay the dtype cast and the transfer 1000s of times
    full = torch.from_numpy(np.ascontiguousarray(dense)).to(
        device=M.device, dtype=dt)
    M.fill(lambda m, n: full[m * mb:(m + 1) * mb, n * nb:(n + 1) * nb])
    if M.device.type == "cuda":
        # the tiles were cut on the current stream; the device module reads
        # them on its own, so they must be complete before the first task
        torch.cuda.synchronize(M.device)
    return M
