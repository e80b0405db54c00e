"""Reshape engine: layout/datatype conversion between producer and consumer.

Re-design of parsec/parsec_reshape.c: when a consumer declares a different
datatype/layout than the producer's copy, the runtime inserts a *reshape
promise* — a :class:`..core.futures.DataCopyFuture` that converts
lazily on first request and is shared by all consumers of that copy
(ref: parsec_get_copy_reshape_from_dep, parsec_internal.h:688-696; local and
pre-send remote reshapes, remote_dep.h:117).

A conversion of a torch tensor is torch operations on the tensor's own
device (on the card, one more kernel on the stream); a numpy array converts
with numpy.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.futures import DataCopyFuture
from .data import COHERENCY_SHARED, Data, DataCopy


@dataclass(frozen=True)
class ReshapeSpec:
    """Target layout: dtype and/or shape (None = keep)."""
    dtype: Optional[str] = None
    shape: Optional[Tuple[int, ...]] = None
    transpose: bool = False


def default_convert(src_copy: DataCopy, spec: ReshapeSpec) -> DataCopy:
    """The default converter: cast / reshape / transpose with torch for a
    tensor (which stays on its device) and with numpy for an array."""
    x = src_copy.payload
    if isinstance(x, torch.Tensor):
        if spec.transpose:
            x = x.transpose(0, 1) if x.dim() == 2 else x.permute(
                *reversed(range(x.dim())))
        if spec.shape is not None:
            x = x.reshape(spec.shape)
        if spec.dtype is not None:
            x = x.to(_torch_dtype(spec.dtype))
    else:
        if spec.transpose:
            x = np.transpose(x)
        if spec.shape is not None:
            x = np.reshape(x, spec.shape)
        if spec.dtype is not None:
            x = x.astype(spec.dtype)
    out = DataCopy(src_copy.original, src_copy.device_index, x, COHERENCY_SHARED)
    out.version = src_copy.version
    return out


class ReshapeCache:
    """Per-copy promise cache: all consumers of (copy, spec) share one
    conversion (ref: the reshape repo entries of parsec_reshape.c)."""

    def __init__(self, convert: Callable[[DataCopy, ReshapeSpec], DataCopy] = default_convert) -> None:
        self._convert = convert
        self._promises: Dict[Tuple[int, ReshapeSpec], DataCopyFuture] = {}
        self._lock = threading.Lock()

    def promise(self, copy: DataCopy, spec: ReshapeSpec) -> DataCopyFuture:
        key = (id(copy), spec)
        with self._lock:
            f = self._promises.get(key)
            if f is None:
                f = DataCopyFuture(copy, spec, self._convert)
                self._promises[key] = f
            return f

    def get_reshaped(self, copy: DataCopy, spec: ReshapeSpec) -> DataCopy:
        """Resolve (and possibly trigger) the conversion now."""
        if not needs_reshape(copy, spec):
            return copy
        return self.promise(copy, spec).request()

    def flush(self) -> None:
        with self._lock:
            for f in self._promises.values():
                f.release()
            self._promises.clear()


class NamedDatatype:
    """A named dep datatype: the (arena, datatype) pair a JDF dep carries
    (ref: parsec_arena_datatype_t and the [type=...] dep annotations).

    ``extract(arr)`` produces the typed view of a full tile (e.g. its lower
    triangle); ``insert(dst, src)`` merges typed data back into a full tile
    (the complement of dst is preserved). ``identity`` marks the DEFAULT
    datatype: no conversion, consumers share the original copy (the
    avoidable-reshape case, tests/collections/reshape/avoidable_reshape.jdf).
    Hashable by name so one ReshapeCache promise is shared by every consumer
    of (copy, datatype) — the single-copy guarantee of
    input_dep_single_copy_reshape.jdf."""

    __slots__ = ("name", "extract", "insert", "identity")

    def __init__(self, name: str, extract: Optional[Callable] = None,
                 insert: Optional[Callable] = None,
                 identity: bool = False) -> None:
        self.name = name
        self.extract = extract if extract is not None else (lambda a: a)
        self.insert = insert if insert is not None else (lambda dst, src: src)
        self.identity = identity

    def __hash__(self) -> int:
        return hash(("NamedDatatype", self.name))

    def __eq__(self, other) -> bool:
        return isinstance(other, NamedDatatype) and other.name == self.name

    def __repr__(self) -> str:
        return f"NamedDatatype({self.name!r})"

    def convert(self, src_copy: DataCopy, _spec=None) -> DataCopy:
        """ReshapeCache-compatible converter (spec == self)."""
        out = DataCopy(src_copy.original, src_copy.device_index,
                       self.extract(src_copy.payload), COHERENCY_SHARED)
        out.version = src_copy.version
        return out


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


def _tril(a, k: int = 0):
    """Lower triangle of a tensor (on its device) or of an array."""
    if isinstance(a, torch.Tensor):
        return torch.tril(a, k)
    return np.tril(np.asarray(a), k)


def _triu(a, k: int = 0):
    if isinstance(a, torch.Tensor):
        return torch.triu(a, k)
    return np.triu(np.asarray(a), k)


def lower_tile(dtype=None) -> NamedDatatype:
    """The reference tests' LOWER_TILE: keep the (strictly including
    diagonal) lower triangle, zero above."""
    return NamedDatatype("LOWER_TILE",
                         extract=lambda a: _tril(a),
                         insert=lambda dst, src: _triu(dst, 1) + _tril(src))


def upper_tile(dtype=None) -> NamedDatatype:
    return NamedDatatype("UPPER_TILE",
                         extract=lambda a: _triu(a),
                         insert=lambda dst, src: _tril(dst, -1) + _triu(src))


def default_datatype() -> NamedDatatype:
    return NamedDatatype("DEFAULT", identity=True)


def needs_reshape(copy: DataCopy, spec: ReshapeSpec) -> bool:
    x = copy.payload
    if spec.transpose:
        return True
    if spec.shape is not None and tuple(getattr(x, "shape", ())) != tuple(spec.shape):
        return True
    if spec.dtype is not None:
        want = _torch_dtype(spec.dtype) if isinstance(x, torch.Tensor) \
            else np.dtype(spec.dtype)
        if getattr(x, "dtype", None) != want:
            return True
    return False
