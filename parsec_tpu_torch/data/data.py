"""Data and per-device data copies with MOESI-like coherency.

Re-design of parsec/data_internal.h:29-86 + parsec/data.{c,h}. One
:class:`Data` per logical datum (a tile); it owns one :class:`DataCopy` per
device that currently holds a version. Coherency states and version counters
follow the reference:

* ``INVALID``    — copy content is stale
* ``OWNED``      — this device owns the newest version, others may share
* ``EXCLUSIVE``  — only valid copy, writable
* ``SHARED``     — valid read-only replica

A device copy's payload is a ``torch.Tensor`` in the card's memory; the host
copy is a CPU ``torch.Tensor`` (numpy has no bf16). Transfers happen in the
device module
(stage_in/stage_out, ref device_gpu.c:1624-1800); this module only tracks
state, versions and reference counts.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Dict, Optional

import torch

# coherency states (ref: parsec/data.h:28-37)
COHERENCY_INVALID = 0
COHERENCY_OWNED = 1
COHERENCY_EXCLUSIVE = 2
COHERENCY_SHARED = 3

_data_keys = itertools.count()


class DataCopy:
    """One device-resident version of a datum (ref: parsec_data_copy_t)."""

    __slots__ = ("original", "device_index", "payload", "coherency_state",
                 "version", "readers", "refcount", "older", "arena_chunk",
                 "flags")

    def __init__(self, original: "Data", device_index: int, payload: Any = None,
                 state: int = COHERENCY_OWNED) -> None:
        self.original = original
        self.device_index = device_index
        self.payload = payload
        self.coherency_state = state
        self.version = 0
        self.readers = 0
        self.refcount = 1
        self.older = None
        self.arena_chunk = None
        self.flags = 0

    def retain(self) -> "DataCopy":
        self.refcount += 1
        return self

    def release(self) -> None:
        self.refcount -= 1
        if self.refcount <= 0:
            if self.arena_chunk is not None:
                self.arena_chunk.free()
                self.arena_chunk = None
            if self.original is not None:
                self.original._detach(self)
            self.payload = None

    def __repr__(self) -> str:  # pragma: no cover
        return (f"<DataCopy dev={self.device_index} v={self.version} "
                f"state={self.coherency_state}>")


class Data:
    """One logical datum with per-device copies (ref: parsec_data_t)."""

    __slots__ = ("key", "dc", "copies", "owner_device", "preferred_device",
                 "version", "nb_references", "shape", "dtype", "_lock")

    def __init__(self, key: Any = None, dc: Any = None, shape=None, dtype=None) -> None:
        self.key = key if key is not None else next(_data_keys)
        self.dc = dc                      # owning data collection, if any
        self.copies: Dict[int, DataCopy] = {}
        self.owner_device = 0
        self.preferred_device = -1
        self.version = 0
        self.nb_references = 0
        self.shape = shape
        self.dtype = dtype
        self._lock = threading.Lock()

    # -- copy management (ref: parsec_data_copy_attach/detach, data.c) --------
    def attach_copy(self, copy: DataCopy, device_index: Optional[int] = None) -> DataCopy:
        with self._lock:
            idx = device_index if device_index is not None else copy.device_index
            copy.device_index = idx
            prev = self.copies.get(idx)
            if prev is not None:
                copy.older = prev
            self.copies[idx] = copy
            copy.original = self
        return copy

    def _detach(self, copy: DataCopy) -> None:
        with self._lock:
            if self.copies.get(copy.device_index) is copy:
                if copy.older is not None:
                    self.copies[copy.device_index] = copy.older
                else:
                    del self.copies[copy.device_index]

    def get_copy(self, device_index: int = 0) -> Optional[DataCopy]:
        return self.copies.get(device_index)

    def newest_copy(self) -> Optional[DataCopy]:
        """The copy with the highest version (candidate transfer source,
        ref: stage_in source selection device_gpu.c:1800)."""
        copies = self.copies
        if len(copies) == 1:
            # hot path: single-copy data (the common host-only case) — the
            # read is one GIL-atomic dict access, no lock needed
            try:
                c = next(iter(copies.values()))
                return None if c.coherency_state == COHERENCY_INVALID else c
            except (StopIteration, RuntimeError):
                pass    # raced a concurrent attach/detach: take the lock
        with self._lock:
            best = None
            for c in self.copies.values():
                if c.coherency_state == COHERENCY_INVALID:
                    continue
                if best is None or c.version > best.version:
                    best = c
            return best

    def create_copy(self, device_index: int, payload: Any = None,
                    state: int = COHERENCY_OWNED) -> DataCopy:
        copy = DataCopy(self, device_index, payload, state)
        return self.attach_copy(copy)

    # -- coherency transitions (ref: parsec_data_transfer_ownership_to_copy,
    #    data.c) --------------------------------------------------------------
    def transfer_ownership(self, device_index: int, access: int) -> DataCopy:
        """Make the copy on ``device_index`` the owner; invalidate others on
        write access. ``access`` uses FLOW_ACCESS_* bits."""
        from ..core.task import FLOW_ACCESS_WRITE
        with self._lock:
            copy = self.copies[device_index]
            if access & FLOW_ACCESS_WRITE:
                for idx, other in self.copies.items():
                    if idx != device_index:
                        other.coherency_state = COHERENCY_INVALID
                copy.coherency_state = COHERENCY_OWNED
                self.owner_device = device_index
            else:
                if copy.coherency_state == COHERENCY_INVALID:
                    copy.coherency_state = COHERENCY_SHARED
            return copy

    def evict_copy(self, device_index: int, to_host=None):
        """Evict the copy on ``device_index`` atomically with the
        coherency/version bookkeeping (the zone-heap eviction gap, ISSUE
        10): under ONE hold of the data lock, a copy holding the newest
        version writes back to the host copy (which takes the version in
        SHARED state — the w2r moment of transfer_gpu.c) and only then
        drops its payload and goes INVALID. Before this, the device
        module's LRU and this class were two unsynchronized views: a
        reader racing the eviction could see the device copy still
        claiming the newest version with its payload already dropped (or
        the host copy not yet carrying it), and a concurrent host write
        between the version check and the write-back could be clobbered
        by the stale device payload.

        ``to_host(payload)`` converts the device tensor for the host copy
        (default :func:`host_tensor` — ``Tensor.cpu()``, which waits for the
        device value, the write-back barrier).

        Returns ``(evicted, wrote_back)``.
        """
        with self._lock:
            copy = self.copies.get(device_index)
            if copy is None or copy.payload is None:
                return (False, False)
            wrote = False
            newest_other = None
            for c in self.copies.values():
                if c is copy or c.coherency_state == COHERENCY_INVALID:
                    continue
                if newest_other is None or c.version > newest_other.version:
                    newest_other = c
            if device_index != 0 and \
                    copy.coherency_state != COHERENCY_INVALID and (
                    newest_other is None
                    or copy.version > newest_other.version):
                # dirty: the only valid holder of the newest version —
                # write back and downgrade BEFORE invalidating, inside
                # the same critical section as the version check
                host_payload = (to_host or host_tensor)(copy.payload)
                host = self.copies.get(0)
                if host is None:
                    host = DataCopy(self, 0, host_payload, COHERENCY_SHARED)
                    self.copies[0] = host
                else:
                    host.payload = host_payload
                host.version = copy.version
                host.coherency_state = COHERENCY_SHARED
                self.owner_device = 0
                wrote = True
            copy.coherency_state = COHERENCY_INVALID
            copy.payload = None
            return (True, wrote)

    def bump_version(self, device_index: int, n: int = 1) -> int:
        """Writer completed: new authoritative version on that device
        (ref: version bump in parsec_device_kernel_epilog, device_gpu.c:3180).
        ``n`` folds a batch of writes in one call, keeping version parity
        with per-write bumping."""
        with self._lock:
            self.version += n
            copy = self.copies.get(device_index)
            if copy is not None:
                copy.version = self.version
                copy.coherency_state = COHERENCY_OWNED
                self.owner_device = device_index
            return self.version

    def __repr__(self) -> str:  # pragma: no cover
        return f"<Data key={self.key} v={self.version} copies={list(self.copies)}>"


def host_tensor(payload: Any) -> Any:
    """A host (CPU) tensor holding ``payload``'s value."""
    if isinstance(payload, torch.Tensor):
        return payload.cpu()
    return torch.as_tensor(payload)


def data_from_array(array: Any, key: Any = None, dc: Any = None,
                    device_index: int = 0) -> Data:
    """Wrap an existing host array as a Data with one host copy
    (ref: parsec_data_create w/ existing pointer)."""
    d = Data(key=key, dc=dc, shape=getattr(array, "shape", None),
             dtype=getattr(array, "dtype", None))
    d.create_copy(device_index, array, COHERENCY_OWNED)
    return d
