"""Datatype shim: layout descriptors with pack/unpack.

Re-design of parsec/datatype.{c,h} + datatype_mpi.c (the MPI-datatype shim:
create_contiguous / create_vector / create_resized, extent and size
queries, pack/unpack). The wire format for the comm engine is plain
contiguous buffers; these descriptors describe *strided host layouts* so
non-contiguous tiles (views, bands, submatrices) can be packed for
transfer and unpacked at the destination — the role MPI derived datatypes
play in the reference's remote-dep machinery.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class Datatype:
    """A strided layout over a base element type."""
    base: str                    # numpy dtype string
    count: int                   # number of blocks
    blocklen: int                # elements per block
    stride: int                  # elements between block starts
    lb: int = 0                  # lower bound (elements)
    extent_override: Optional[int] = None

    @property
    def size(self) -> int:
        """Bytes of actual data (ref: parsec_type_size)."""
        return self.count * self.blocklen * np.dtype(self.base).itemsize

    @property
    def extent(self) -> int:
        """Span in elements from first to one-past-last (ref: extent query)."""
        if self.extent_override is not None:
            return self.extent_override
        if self.count == 0:
            return 0
        return self.lb + (self.count - 1) * self.stride + self.blocklen


def create_contiguous(count: int, base="float32") -> Datatype:
    """parsec_type_create_contiguous."""
    return Datatype(str(np.dtype(base)), 1, count, count)


def create_vector(count: int, blocklen: int, stride: int,
                  base="float32") -> Datatype:
    """parsec_type_create_vector (column/band extraction layouts)."""
    return Datatype(str(np.dtype(base)), count, blocklen, stride)


def create_resized(dtt: Datatype, lb: int, extent: int) -> Datatype:
    """parsec_type_create_resized."""
    return Datatype(dtt.base, dtt.count, dtt.blocklen, dtt.stride,
                    lb=lb, extent_override=extent)


def pack(buf: np.ndarray, dtt: Datatype) -> np.ndarray:
    """Gather the described elements into a contiguous buffer
    (ref: comm-engine pack)."""
    flat = np.ascontiguousarray(buf).reshape(-1)
    out = np.empty(dtt.count * dtt.blocklen, dtype=flat.dtype)
    for i in range(dtt.count):
        s = dtt.lb + i * dtt.stride
        out[i * dtt.blocklen:(i + 1) * dtt.blocklen] = flat[s:s + dtt.blocklen]
    return out


def unpack(packed: np.ndarray, dtt: Datatype,
           out: Optional[np.ndarray] = None) -> np.ndarray:
    """Scatter a contiguous buffer back into the described layout."""
    if out is None:
        out = np.zeros(dtt.extent, dtype=packed.dtype)
        flat = out
    else:
        flat = out.reshape(-1)
    for i in range(dtt.count):
        s = dtt.lb + i * dtt.stride
        flat[s:s + dtt.blocklen] = packed[i * dtt.blocklen:(i + 1) * dtt.blocklen]
    return out
