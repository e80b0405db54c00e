"""Zone allocator: first-fit slab manager for a reserved memory segment.

Re-design of parsec/utils/zone_malloc.{c,h}: PaRSEC carves a device's
reserved device memory into fixed-size units and serves allocations from a unit
bitmap; parsec_device_memory_reserve builds the GPU tile heap on it
(device_gpu.c:867). Here the zone tracks *byte ranges* of an abstract
segment — the CUDA device module uses it as the ledger of its tile heap, and
tests exercise fragmentation/coalescing behavior directly.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from . import mca

mca.register("zone_unit_bytes", 1 << 20, "Zone allocator unit granularity", type=int)


class ZoneSegment:
    """One allocation (offset, size) within the zone."""

    __slots__ = ("zone", "offset", "size")

    def __init__(self, zone: "ZoneMalloc", offset: int, size: int) -> None:
        self.zone = zone
        self.offset = offset
        self.size = size

    def free(self) -> None:
        self.zone.free(self)


class ZoneMalloc:
    """Ref: zone_malloc_t — first-fit over unit-granular free ranges."""

    def __init__(self, total_bytes: int, unit: Optional[int] = None) -> None:
        self.unit = unit or mca.get("zone_unit_bytes", 1 << 20)
        self.total_units = max(1, total_bytes // self.unit)
        # free list of (start_unit, nb_units), sorted, coalesced
        self._free: List[Tuple[int, int]] = [(0, self.total_units)]
        self._lock = threading.Lock()
        self.in_use_units = 0
        self.hwm_units = 0

    def _units(self, nbytes: int) -> int:
        return max(1, (nbytes + self.unit - 1) // self.unit)

    def allocate(self, nbytes: int) -> Optional[ZoneSegment]:
        """zone_malloc: first fit; None when no hole is large enough."""
        need = self._units(nbytes)
        with self._lock:
            for i, (start, size) in enumerate(self._free):
                if size >= need:
                    if size == need:
                        self._free.pop(i)
                    else:
                        self._free[i] = (start + need, size - need)
                    self.in_use_units += need
                    self.hwm_units = max(self.hwm_units, self.in_use_units)
                    return ZoneSegment(self, start * self.unit, need * self.unit)
        return None

    def free(self, seg: ZoneSegment) -> None:
        """zone_free: return + coalesce with neighbors."""
        start = seg.offset // self.unit
        size = seg.size // self.unit
        with self._lock:
            self.in_use_units -= size
            lo, hi = 0, len(self._free)
            while lo < hi:
                mid = (lo + hi) // 2
                if self._free[mid][0] < start:
                    lo = mid + 1
                else:
                    hi = mid
            self._free.insert(lo, (start, size))
            # coalesce around lo
            merged: List[Tuple[int, int]] = []
            for s, n in self._free:
                if merged and merged[-1][0] + merged[-1][1] == s:
                    merged[-1] = (merged[-1][0], merged[-1][1] + n)
                else:
                    merged.append((s, n))
            self._free = merged

    def stats(self) -> Dict[str, int]:
        with self._lock:
            free_units = sum(n for _, n in self._free)
            largest = max((n for _, n in self._free), default=0)
        return {
            "total_bytes": self.total_units * self.unit,
            "free_bytes": free_units * self.unit,
            "in_use_bytes": self.in_use_units * self.unit,
            "hwm_bytes": self.hwm_units * self.unit,
            "largest_hole_bytes": largest * self.unit,
            "holes": len(self._free),
        }
