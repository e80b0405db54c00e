"""Arenas: size-class allocators for communication/staging buffers.

Re-design of parsec/arena.{c,h} (parsec_arena_t, arena.h:49-59): remote copies
are allocated from the arena bound to their datatype; freed chunks go to a
LIFO cache capped by ``max_cached``; total live allocations capped by
``max_used`` (the MCA caps handled around parsec/parsec.c:690). Here an arena
hands out host torch buffers of one (shape, dtype) class — device buffers
are the caching allocator's; the arena feeds stage-in sources and receive
buffers.
"""

from __future__ import annotations

import threading
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..utils import mca
from .data import COHERENCY_SHARED, Data, DataCopy
from .matrix import torch_dtype

mca.register("arena_max_cached", 256, "Max free chunks cached per arena", type=int)
mca.register("arena_max_used", 0, "Max live chunks per arena (0 = unlimited)", type=int)


class ArenaChunk:
    """One allocation (ref: parsec_arena_chunk_t)."""

    __slots__ = ("arena", "buffer")

    def __init__(self, arena: "Arena", buffer: torch.Tensor) -> None:
        self.arena = arena
        self.buffer = buffer

    def free(self) -> None:
        self.arena.release_chunk(self)


class Arena:
    """Size-class pool for one datatype (ref: parsec_arena_t, arena.h:49-59)."""

    def __init__(self, shape: Tuple[int, ...], dtype: Any = torch.float32,
                 max_cached: Optional[int] = None,
                 max_used: Optional[int] = None) -> None:
        self.shape = tuple(shape)
        self.dtype = torch_dtype(dtype)
        numel = 1
        for s in self.shape:
            numel *= int(s)
        self.elem_size = numel * torch.empty((), dtype=self.dtype).element_size()
        self.max_cached = max_cached if max_cached is not None else mca.get("arena_max_cached", 256)
        self.max_used = max_used if max_used is not None else mca.get("arena_max_used", 0)
        self._cache: List[torch.Tensor] = []     # the LIFO of freed chunks
        self._lock = threading.Lock()
        self.used = 0
        self.max_used_hwm = 0

    def allocate(self) -> ArenaChunk:
        with self._lock:
            if self.max_used and self.used >= self.max_used:
                raise MemoryError(f"arena max_used={self.max_used} exhausted")
            buf = self._cache.pop() if self._cache else None
            self.used += 1
            self.max_used_hwm = max(self.max_used_hwm, self.used)
        if buf is None:
            buf = torch.empty(self.shape, dtype=self.dtype)
        return ArenaChunk(self, buf)

    def release_chunk(self, chunk: ArenaChunk) -> None:
        with self._lock:
            self.used -= 1
            if len(self._cache) < self.max_cached:
                self._cache.append(chunk.buffer)
        chunk.buffer = None  # chunk is dead; buffer may live on in the cache

    def new_copy(self, data: Data, device_index: int = 0) -> DataCopy:
        """Allocate a chunk and attach it as a copy of ``data`` (the receive
        path of remote deps: remote_dep_mpi_get_start allocates target copies
        from the arena, ref remote_dep_mpi.c:2120)."""
        chunk = self.allocate()
        copy = data.create_copy(device_index, chunk.buffer, COHERENCY_SHARED)
        copy.arena_chunk = chunk
        return copy

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"used": self.used, "cached": len(self._cache),
                    "hwm": self.max_used_hwm, "elem_size": self.elem_size}


class ArenaDatatype:
    """An (arena, datatype) pair as carried on deps
    (ref: parsec_arena_datatype_t, parsec_internal.h:42-47)."""

    __slots__ = ("arena", "dtt")

    def __init__(self, arena: Arena, dtt: Any = None) -> None:
        self.arena = arena
        self.dtt = dtt if dtt is not None else (arena.shape, arena.dtype)


_registry: Dict[Tuple[Tuple[int, ...], str], Arena] = {}
_registry_lock = threading.Lock()


def arena_for(shape: Tuple[int, ...], dtype: Any = torch.float32) -> Arena:
    """Process-wide arena registry keyed by (shape, dtype) size class."""
    key = (tuple(shape), str(torch_dtype(dtype)))
    with _registry_lock:
        a = _registry.get(key)
        if a is None:
            a = Arena(shape, dtype)
            _registry[key] = a
        return a


# buffer -> chunk bookkeeping for arena-backed receive buffers: the comm
# transport allocates recv buffers from arenas (the reference allocates
# remote copies from the dep's arena, remote_dep_mpi.c:2120); the protocol
# layer releases them at safe points (taskpool-termination GC) without
# knowing which transport (or whether an arena) produced the bytes.
# Lifecycle: explicit release_buffer() recycles the buffer into the arena
# cache; a buffer that instead dies naturally (became tile content, later
# replaced) gives its slot back through a weakref finalizer so ``used``
# accounting never drifts. The map holds no strong buffer reference.
_chunks: Dict[int, ArenaChunk] = {}
_chunks_lock = threading.Lock()


def _buffer_died(bid: int) -> None:
    with _chunks_lock:
        chunk = _chunks.pop(bid, None)
    if chunk is not None:
        with chunk.arena._lock:
            chunk.arena.used -= 1


def attach_chunk(buffer: torch.Tensor, chunk: ArenaChunk) -> None:
    chunk.buffer = None          # the buffer owns itself from here on
    with _chunks_lock:
        _chunks[id(buffer)] = chunk
    weakref.finalize(buffer, _buffer_died, id(buffer))


def release_buffer(buffer) -> None:
    """Recycle ``buffer`` into its arena's cache if it came from one (no-op
    otherwise). Only call at points where no consumer can still hold it —
    the comm layer does this at taskpool-termination GC."""
    with _chunks_lock:
        chunk = _chunks.pop(id(buffer), None)
    if chunk is not None:
        chunk.buffer = buffer    # re-arm (release_chunk caches it)
        chunk.free()
