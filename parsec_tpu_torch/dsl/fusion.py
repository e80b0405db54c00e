"""The persistent program cache that graph capture shares, and its keys.

The port's own copy of what :mod:`parsec_tpu_torch.dsl.capture` needs from
the reference's region-fusion module:

* :class:`ExecCache` — the LRU cache of captured programs, shared across
  pool instantiations, with hit/miss/evict counters
  (:data:`CAPTURE_CACHE_STATS`). A second pool of the same DAG shape
  replays a warm program instead of capturing it again — the repeated-DAG
  shape of steady-state serving.
* :func:`device_fingerprint` — the device component of every program key: a
  program captured for one device layout is never replayed on another.
* the MCA parameters ``region_fusion``, ``region_fusion_min`` and
  ``region_fusion_max``, which a deferred capture window reads when it
  collapses its capturable runs into fused super-tasks
  (:meth:`GraphCapture.take_ops`).

The region pass over PTG pools is not here (it comes with the PTG frontend).
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

import torch

from ..utils import mca
from ..utils.counters import Counters

mca.register("region_fusion", True,
             "A deferred capture window (one that holds a non-capturable "
             "insert) collapses each maximal run of capturable inserts into "
             "ONE fused super-task replaying the run in insertion order; "
             "the scheduler handles only the seams. 0 restores per-task "
             "inserts", type=bool)
mca.register("region_fusion_min", 2,
             "Minimum run worth fusing: shorter capturable runs stay "
             "per-task (a 1-task 'region' is pure wrapper overhead)",
             type=int)
mca.register("region_fusion_max", 128,
             "Maximum tasks per fused region: longer runs split into "
             "consecutive chunks", type=int)


#: the program cache's engagement: ``cache_hits`` nonzero on the second
#: instantiation of the same DAG shape is the warm-pool contract
CAPTURE_CACHE_STATS = Counters(cache_hits=0, cache_misses=0,
                                cache_evictions=0)


def device_fingerprint() -> Tuple:
    """The device component of every program-cache key: the CUDA device's
    name, the current device index and the device count, or ``("cpu",)``
    where there is no card."""
    if not torch.cuda.is_available():
        return ("cpu",)
    index = torch.cuda.current_device()
    return (torch.cuda.get_device_name(index), index,
            torch.cuda.device_count())


class ExecCache:
    """LRU cache of captured programs keyed by (class signature, tile shapes
    and dtypes, device fingerprint) — the caller builds the key; this class
    owns lifetime and the hit/miss/evict accounting. An entry that leaves
    the cache (LRU overflow, :meth:`evict`, :meth:`discard`, :meth:`clear`)
    has its ``release()`` called, if it has one.

    ``get_or_build`` holds the lock across the builder call (builders only
    construct the program object; capture happens at its first run), so
    two concurrent instantiations of one shape share ONE program."""

    def __init__(self, cap: int = 64,
                 stats: Optional[Dict[str, int]] = None) -> None:
        self.cap = cap
        self.stats = CAPTURE_CACHE_STATS if stats is None else stats
        self._d: "collections.OrderedDict[Hashable, Any]" = \
            collections.OrderedDict()
        self._mu = threading.Lock()

    def get_or_build(self, key: Hashable,
                     builder: Callable[[], Any]) -> Tuple[Any, bool]:
        """Return ``(value, hit)``. ``key=None`` (an uncacheable shape)
        builds fresh and counts a miss."""
        if key is None:
            self.stats["cache_misses"] += 1
            return builder(), False
        with self._mu:
            v = self._d.get(key)
            if v is not None:
                self._d.move_to_end(key)
                self.stats["cache_hits"] += 1
                return v, True
            self.stats["cache_misses"] += 1
            v = self._d[key] = builder()
            gone = []
            while len(self._d) > self.cap:
                gone.append(self._d.popitem(last=False)[1])
                self.stats["cache_evictions"] += 1
        _release(gone)
        return v, False

    def oldest_first(self) -> List[Tuple[Hashable, Any]]:
        """The entries, least recently used first (a snapshot)."""
        with self._mu:
            return list(self._d.items())

    def evict(self, key: Hashable) -> None:
        """Drop ``key`` under budget pressure (counted as an eviction)."""
        with self._mu:
            v = self._d.pop(key, None)
            if v is not None:
                self.stats["cache_evictions"] += 1
        _release([v])

    def discard(self, key: Hashable) -> None:
        """Drop ``key`` (a program whose capture failed)."""
        with self._mu:
            v = self._d.pop(key, None)
        _release([v])

    def clear(self) -> None:
        with self._mu:
            gone = list(self._d.values())
            self._d.clear()
        _release(gone)


def _release(values) -> None:
    """Free what dropped entries hold (a program's graph and buffers): every
    value with a ``release()`` method gets it called, outside the lock."""
    for v in values:
        release = getattr(v, "release", None)
        if release is not None:
            release()
