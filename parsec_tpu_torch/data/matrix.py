"""Tiled-matrix data collections and distribution layouts.

Re-design of parsec/data_dist/matrix: the tiled-matrix descriptor
(parsec_tiled_matrix_t, matrix.h:101-126) and its distributions:

* :class:`TiledMatrix` — base: mb/nb tile sizes, lm/ln global extent,
  submatrix view (i/j/m/n), typed storage.
* :class:`TwoDimBlockCyclic` — the PBLAS 2D block-cyclic layout incl.
  k-cyclicity (ref: two_dim_rectangle_cyclic.c:16-21,109,195-197 closed
  forms; grid helper grid_2Dcyclic.c).
* :class:`SymTwoDimBlockCyclic` — triangular storage variant
  (ref: sym_two_dim_rectangle_cyclic.c).
* :class:`TwoDimBlockCyclicBand` / :class:`SymTwoDimBlockCyclicBand` —
  band-storage variants (ref: two_dim_rectangle_cyclic_band.c,
  sym_two_dim_rectangle_cyclic_band.c): band tiles in a cyclic band
  collection, off-band delegated.
* :class:`SBCDistribution` — the symmetric block-cyclic layout (ref: sbc.c).
* :class:`VectorTwoDimCyclic` — a tile vector over a P×Q grid
  (ref: vector_two_dim_cyclic.c).
* :class:`TabularDistribution` — arbitrary rank table
  (ref: two_dim_tabular.c).

Tiles are torch tensors: the home copy (device index 0) lives where the
collection was built (the host by default), device copies are managed by the
device layer. :func:`collection_from_numpy` and :meth:`TiledMatrix.to_dense`
move a whole matrix in and out, tile for tile.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

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

    def stored(self, m: int, n: int) -> bool:
        """Whether tile (m, n) exists in this collection (triangular
        layouts store only one triangle)."""
        return True

    def _zeros(self, shape) -> torch.Tensor:
        """A zero home tile. On the card it is complete before it is
        returned: the device module reads home copies on its own stream,
        which does not wait for the caller's."""
        arr = torch.zeros(shape, dtype=self.dtype, device=self.device)
        if arr.is_cuda:
            torch.cuda.current_stream(arr.device).synchronize()
        return arr

    def _create_data(self, key: Any) -> Data:
        m, n = self.key_to_indices(key)
        shape = self.tile_shape(m, n)
        arr = self._zeros(shape)
        d = Data(key=key, dc=self, shape=shape, dtype=self.dtype)
        d.create_copy(0, arr, COHERENCY_OWNED)
        return d

    # convenience: fill / gather for tests and benchmarks -------------------
    def fill(self, fn: Callable[[int, int], Any]) -> None:
        """Materialize every local tile via fn(m, n) -> array or tensor."""
        for m in range(self.mt):
            for n in range(self.nt):
                if not self.stored(m, n) or self.rank_of(m, n) != self.myrank:
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
                if not self.stored(m, n) or self.rank_of(m, n) != self.myrank:
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


class SymTwoDimBlockCyclic(TwoDimBlockCyclic):
    """Symmetric (triangular) block-cyclic: only the uplo triangle is stored
    (ref: sym_two_dim_rectangle_cyclic.c)."""

    LOWER, UPPER = 0, 1

    def __init__(self, *args, uplo: int = 0, **kw) -> None:
        super().__init__(*args, **kw)
        self.uplo = uplo

    def in_triangle(self, m: int, n: int) -> bool:
        return (m >= n) if self.uplo == self.LOWER else (m <= n)

    def stored(self, m: int, n: int) -> bool:
        return self.in_triangle(m, n)

    def data_of(self, *indices) -> Data:
        m, n = indices
        if not self.in_triangle(m, n):
            raise KeyError(f"tile ({m},{n}) outside stored {('lower','upper')[self.uplo]} triangle")
        return super().data_of(m, n)


class TwoDimBlockCyclicBand(TiledMatrix):
    """Band distribution: tiles within ``band_size`` of the diagonal live in a
    cyclic band collection; the rest in a regular 2D block-cyclic
    (ref: two_dim_rectangle_cyclic_band.c composition)."""

    def __init__(self, name: str, full: TwoDimBlockCyclic, band_size: int) -> None:
        super().__init__(name, full.lm, full.ln, full.mb, full.nb,
                         dtype=full.dtype, nodes=full.nodes,
                         myrank=full.myrank, device=full.device)
        self.full = full
        self.band_size = band_size

    def in_band(self, m: int, n: int) -> bool:
        return abs(m - n) < self.band_size

    def rank_of(self, *indices) -> int:
        m, n = indices
        if self.in_band(m, n):
            return m % self.nodes  # cyclic along the diagonal
        return self.full.rank_of(m, n)

    def rank_of_key(self, key: Any) -> int:
        return self.rank_of(*self.key_to_indices(key))


class SymTwoDimBlockCyclicBand(TiledMatrix):
    """Symmetric band composition (ref: sym_two_dim_rectangle_cyclic_band.c).

    Tiles within ``band_size`` of the diagonal are re-indexed to
    ``(|m-n|, n)`` and delegated to a dedicated *band* collection (a
    band_size × lnt cyclic matrix, so diagonal k lives on a rank chosen by
    the band layout); everything else delegates to the symmetric off-band
    collection. This is the reference's exact composition design: the
    wrapper only rewrites coordinates and forwards the vtable calls.
    """

    def __init__(self, name: str, off_band: SymTwoDimBlockCyclic,
                 band: TwoDimBlockCyclic, band_size: int) -> None:
        super().__init__(name, off_band.lm, off_band.ln, off_band.mb,
                         off_band.nb, dtype=off_band.dtype,
                         nodes=off_band.nodes, myrank=off_band.myrank,
                         device=off_band.device)
        if band.lmt < band_size:
            raise ValueError(f"band collection holds {band.lmt} tile rows "
                             f"< band_size {band_size}")
        self.off_band = off_band
        self.band = band
        self.band_size = band_size
        self.uplo = off_band.uplo

    def in_band(self, m: int, n: int) -> bool:
        return abs(m - n) < self.band_size

    def in_triangle(self, m: int, n: int) -> bool:
        return (m >= n) if self.uplo == SymTwoDimBlockCyclic.LOWER else (m <= n)

    def stored(self, m: int, n: int) -> bool:
        return self.in_triangle(m, n)

    def rank_of(self, *indices) -> int:
        m, n = indices
        if self.in_band(m, n):
            return self.band.rank_of(abs(m - n), n)
        return self.off_band.rank_of(m, n)

    def rank_of_key(self, key: Any) -> int:
        return self.rank_of(*self.key_to_indices(key))

    def vpid_of(self, *indices) -> int:
        m, n = indices
        if self.in_band(m, n):
            return self.band.vpid_of(abs(m - n), n)
        return self.off_band.vpid_of(m, n)

    def data_of(self, *indices) -> Data:
        m, n = indices
        if not self.in_triangle(m, n):
            # mirror tiles are not stored; an upper in-band (m, n) would
            # alias band tile (n-m, n) belonging to a different lower tile
            raise KeyError(f"tile ({m},{n}) outside stored "
                           f"{('lower', 'upper')[self.uplo]} triangle")
        if self.in_band(m, n):
            return self.band.data_of(abs(m - n), n)
        return self.off_band.data_of(m, n)

    def data_of_key(self, key: Any) -> Data:
        return self.data_of(*self.key_to_indices(key))


class SBCDistribution(TiledMatrix):
    """Symmetric Block-Cyclic distribution (ref: sbc.c, implementing the
    layout of "Symmetric Block-Cyclic Distribution: Fewer Communications
    Leads to Faster Dense Cholesky Factorization").

    The rank pattern repeats every ``r`` tiles in each direction. An
    off-diagonal pattern position (a, b) and its mirror (b, a) share one
    owner — the packed upper-triangular pair index — so a Cholesky panel
    column and the mirrored row it updates need no transposition traffic.

    Diagonal pattern positions are the irregular part:

    * ``extended=True``: only the r(r-1)/2 off-diagonal pair ranks are used;
      the diagonal borrows pair ranks in patterns that rotate every ``r``
      tile columns (odd r: (r-1)/2 rotations; even r: r-1 rotations built
      from shifted half-packs).
    * ``extended=False`` (basic, even r only): r/2 extra ranks own the
      diagonal round-robin, for r²/2 ranks total.
    """

    LOWER, UPPER = 0, 1

    def __init__(self, name: str, lm: int, ln: int, mb: int, nb: int,
                 r: int = 2, extended: bool = True, uplo: int = 0,
                 nodes: int = 1, myrank: int = 0, **kw) -> None:
        super().__init__(name, lm, ln, mb, nb, nodes=nodes, myrank=myrank, **kw)
        if not extended and r % 2:
            raise ValueError("basic SBC requires even r")
        self.r = r
        self.extended = extended
        self.uplo = uplo
        if extended:
            self.diag_patterns = (r - 1) // 2 if r % 2 else r - 1
            self.num_ranks = r * (r - 1) // 2
        else:
            self.diag_patterns = 0
            self.num_ranks = r * (r - 1) // 2 + r // 2
        # the pattern defines the world size; a smaller world would leave
        # tiles unowned and silently unfilled (ref: sbc.c init rejects
        # nodes incompatible with r)
        if nodes != self.num_ranks:
            raise ValueError(f"SBC r={r} {'extended' if extended else 'basic'} "
                             f"requires exactly {self.num_ranks} nodes, got {nodes}")

    def in_triangle(self, m: int, n: int) -> bool:
        return (m >= n) if self.uplo == self.LOWER else (m <= n)

    def stored(self, m: int, n: int) -> bool:
        return self.in_triangle(m, n)

    @staticmethod
    def _pair_rank(a: int, b: int) -> int:
        lo, hi = (a, b) if a < b else (b, a)
        return hi * (hi - 1) // 2 + lo

    def _diag_pair(self, d: int, n: int) -> Tuple[int, int]:
        """Map diagonal pattern position d (tile column n) to the
        off-diagonal pair whose rank serves it (extended variant)."""
        r = self.r
        pattern = (n // r) % self.diag_patterns

        def stride_pair(d: int, l: int) -> Tuple[int, int]:
            # pair positions l apart, wrapping at the pattern edge
            return (d, d + l) if d < r - l else (d + l - r, d)

        if r % 2:
            return stride_pair(d, pattern + 1)
        half = r // 2
        normal = half - 1
        if pattern < normal:
            return stride_pair(d, pattern + 1)
        shifted = pattern - normal
        if d < half:
            return (d, d + half) if shifted == 0 else (d, d + shifted)
        if shifted == normal:
            return (d - half, d)
        return stride_pair(d, shifted + 1)

    def rank_of(self, *indices) -> int:
        m, n = indices
        if not self.in_triangle(m, n):
            raise KeyError(f"tile ({m},{n}) outside stored "
                           f"{('lower', 'upper')[self.uplo]} triangle")
        a, b = m % self.r, n % self.r
        if a != b:
            return self._pair_rank(a, b)
        if not self.extended:
            return self.r * (self.r - 1) // 2 + a % (self.r // 2)
        return self._pair_rank(*self._diag_pair(a, n))

    def rank_of_key(self, key: Any) -> int:
        return self.rank_of(*self.key_to_indices(key))

    def data_of(self, *indices) -> Data:
        m, n = indices
        if not self.in_triangle(m, n):
            raise KeyError(f"tile ({m},{n}) outside stored triangle")
        return super().data_of(m, n)


# vector distribution modes (ref: vector_two_dim_cyclic.c enum distrib)
VECTOR_DISTRIB_DIAG = "diag"
VECTOR_DISTRIB_ROW = "row"
VECTOR_DISTRIB_COL = "col"


class VectorTwoDimCyclic(TiledMatrix):
    """1D tile vector cyclically distributed over a P×Q grid
    (ref: vector_two_dim_cyclic.c).

    ``distrib`` picks which grid axis (or the diagonal) the vector walks:

    * ``'diag'`` — segment m lives on grid (m % P, m % Q): the diagonal of
      the grid, period lcm(P, Q). This matches a vector aligned with the
      diagonal tiles of a 2D block-cyclic matrix (e.g. the pivot/tau
      vectors of a factorization), so vector↔diagonal traffic is local.
    * ``'row'`` — segment m on (m % P, 0): aligned with matrix tile rows.
    * ``'col'`` — segment m on (0, m % Q): aligned with tile columns.

    Keys are the 1D segment index; each segment is an mb×nb tile.
    """

    def __init__(self, name: str, lm: int, mb: int, nb: int = 1,
                 P: int = 1, Q: int = 1,
                 distrib: str = VECTOR_DISTRIB_DIAG,
                 nodes: int = 1, myrank: int = 0, **kw) -> None:
        super().__init__(name, lm, nb, mb, nb, nodes=nodes, myrank=myrank, **kw)
        if distrib not in (VECTOR_DISTRIB_DIAG, VECTOR_DISTRIB_ROW,
                           VECTOR_DISTRIB_COL):
            raise ValueError(f"unknown vector distrib {distrib!r}")
        self.P, self.Q = P, Q
        self.distrib = distrib
        # distribution period along the vector (ref: dc->lcm)
        if distrib == VECTOR_DISTRIB_DIAG:
            self.period = P * Q // math.gcd(P, Q)
        elif distrib == VECTOR_DISTRIB_ROW:
            self.period = P
        else:
            self.period = Q

    def data_key(self, *indices) -> Any:
        return indices[0]

    def key_to_indices(self, key: int) -> Tuple[int]:
        return (key,)

    def tile_shape(self, m: int, n: int = 0) -> Tuple[int, int]:
        rows = min(self.mb, self.lm - m * self.mb)
        return rows, self.nb

    def _create_data(self, key: Any) -> Data:
        shape = self.tile_shape(key)
        d = Data(key=key, dc=self, shape=shape, dtype=self.dtype)
        d.create_copy(0, self._zeros(shape), COHERENCY_OWNED)
        return d

    def rank_of(self, *indices) -> int:
        m = indices[0]
        rr = m % self.P if self.distrib != VECTOR_DISTRIB_COL else 0
        cr = m % self.Q if self.distrib != VECTOR_DISTRIB_ROW else 0
        return rr * self.Q + cr

    def rank_of_key(self, key: Any) -> int:
        return self.rank_of(key)

    def nb_local_tiles(self) -> int:
        """Segments owned by this rank (ref: nb_local_tiles closed forms)."""
        return sum(1 for m in range(self.lmt)
                   if self.rank_of(m) == self.myrank)


class TabularDistribution(TiledMatrix):
    """Arbitrary (tabular) tile→rank assignment (ref: two_dim_tabular.c)."""

    def __init__(self, name: str, lm: int, ln: int, mb: int, nb: int,
                 table: Optional[Dict[Tuple[int, int], int]] = None,
                 rank_fn: Optional[Callable[[int, int], int]] = None,
                 **kw) -> None:
        super().__init__(name, lm, ln, mb, nb, **kw)
        self.table = table or {}
        self.rank_fn = rank_fn

    def set_rank(self, m: int, n: int, rank: int) -> None:
        self.table[(m, n)] = rank

    def rank_of(self, *indices) -> int:
        m, n = indices
        if (m, n) in self.table:
            return self.table[(m, n)]
        if self.rank_fn is not None:
            return self.rank_fn(m, n)
        return 0

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
