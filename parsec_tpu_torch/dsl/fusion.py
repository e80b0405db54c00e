"""Region fusion and the persistent program cache, shared by both DSLs.

* :func:`partition_regions` — the fusion pass over a flattened CSR task
  graph: identify *capturable* subgraphs (same-device bodies that are plain
  functions of their inputs, no cross-rank edge — the caller encodes all of
  that in a per-task ``kind``) and group them into **convex regions**. Each
  region later collapses into ONE fused super-task whose body replays the
  region in a valid serialization order; the scheduler handles only the
  un-fusable seams (the PTG lane, ``dsl/ptg/compiler.py``).
* :func:`adaptive_fusion_limits` — the fusion pass's limits, sized by the
  online cost model (``core/costmodel.py``) where it has measured.

* :class:`ExecCache` — the LRU cache of captured programs, shared across
  pool instantiations, with hit/miss/evict counters
  (:data:`CAPTURE_CACHE_STATS`). A second pool of the same DAG shape
  replays a warm program instead of capturing it again — the repeated-DAG
  shape of steady-state serving.
* :func:`device_fingerprint` — the device component of every program key: a
  program captured for one device layout is never replayed on another.
* the MCA parameters ``region_fusion``, ``region_fusion_min`` and
  ``region_fusion_max``, which the PTG lane's fusion pass and a deferred
  DTD capture window (:meth:`GraphCapture.take_ops`) read.

Soundness of the region partition (the condensed graph must stay a DAG —
a cycle between a region and a seam is a deadlock at runtime):

For each capturable kind ``k`` define the *seam depth*
``d_k(t) = [t is not kind k] + max(d_k(pred), default 0)`` over the task
DAG. ``d_k`` is monotone non-decreasing along every edge and strictly
increases across any non-``k`` node. A region is a connected component
(over direct edges) of kind-``k`` tasks with EQUAL ``d_k``. Any path
leaving such a region passes either through a non-``k`` node — after which
every downstream kind-``k`` task has depth > d, so the path can never
re-enter a depth-``d`` region — or through a same-kind, same-depth task,
which by definition of connectivity is in the SAME region. Hence no
condensed cycle. Splitting an oversized region into chunks contiguous in a
global topological order preserves convexity for the same reason: every
escape route is depth-increasing, and direct same-kind edges only run
forward in topo order.
"""

from __future__ import annotations

import collections
import threading
from typing import (Any, Callable, Dict, Hashable, List, Optional, Sequence,
                    Tuple)

import torch

from ..core import costmodel as _cm
from ..utils import mca
from ..utils.counters import Counters

mca.register("region_fusion", True,
             "Fusion pass: capturable subgraphs of a PTG data pool on the "
             "native lane (same-device plain-function bodies, no cross-rank "
             "edge) collapse into ONE fused super-task replaying the region "
             "in a valid serialization order, and a deferred DTD capture "
             "window collapses each maximal run of capturable inserts the "
             "same way; the scheduler handles only the seams. 0 restores "
             "per-task dispatch everywhere", type=bool)
mca.register("region_fusion_min", 2,
             "Minimum run worth fusing: shorter capturable runs stay "
             "per-task (a 1-task 'region' is pure wrapper overhead)",
             type=int)
mca.register("region_fusion_max", 128,
             "Maximum tasks per fused region: larger regions split into "
             "topologically contiguous chunks", type=int)


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


def adaptive_fusion_limits(classes: Sequence[Tuple[str, int, str]],
                           ) -> Tuple[set, int, int]:
    """Consumer (b) of the online cost model: size the fusion pass by
    MEASUREMENT instead of the static knobs.

    ``classes`` lists each capturable class as ``(name, shape_bucket,
    device_key)`` ('cpu' or 'cuda' — the fused flavor is looked up as
    ``<key>_fused``). Returns ``(declined, min_size, max_size)``:

    * ``declined`` — class indices to UN-fuse: the model has measured
      both flavors and the fused per-task cost meets or exceeds the
      unfused per-task cost — fusion's premise (dispatch overhead exceeds
      the region's marginal cost) measurably fails for that class.
    * ``max_size`` — the measured break-even region cap: the largest
      power-of-two band whose per-member first-call cost (the
      ``__region_trace__`` pseudo-class, fed by the compiler timing each
      region program's first call), amortized by the program cache's
      measured reuse ratio, stays below the measured per-task dispatch
      saving. The static ``region_fusion_max`` stays the hard upper
      bound; the model only ever splits SOONER.

    ``min_size`` stays the static knob: the fuse-at-all break-even is
    per-class (handled by ``declined``), not size-dependent once the
    batch amortization is in effect. With the model disabled or cold
    this degrades to exactly the static limits — instantiation never
    blocks on measurement."""
    min_size = int(mca.get("region_fusion_min", 2))
    max_size = int(mca.get("region_fusion_max", 128))
    declined: set = set()
    if not (_cm.enabled() and mca.get("costmodel_fusion", True)):
        return declined, min_size, max_size
    m = _cm.model
    saving = None                # measured per-task dispatch cost avoided
    for ci, (name, bucket, dev) in enumerate(classes):
        if not m.measured(name, bucket, dev):
            continue
        unfused = m.cost(name, bucket, dev)
        if m.measured(name, bucket, dev + "_fused") and \
                m.cost(name, bucket, dev + "_fused") >= unfused:
            declined.add(ci)
            _cm.COSTMODEL_STATS["fusion_declined"] += 1
            continue
        if saving is None or unfused < saving:
            saving = unfused     # conservative: the cheapest class bounds
                                 # what fusion can save per member
    sized = False
    if saving is not None and saving > 0:
        # the break-even comparison RAN on real measurements — a model-
        # derived sizing decision even when it confirms the static cap
        sized = True
        hits = CAPTURE_CACHE_STATS["cache_hits"]
        total = hits + CAPTURE_CACHE_STATS["cache_misses"]
        reuse = (hits / total) if total else 0.0
        cap = max_size
        while cap > min_size:
            per_member = m.region_trace_ns("cpu", cap)
            if per_member is None or per_member * (1.0 - reuse) <= saving:
                break            # unmeasured band: trust the static knob
            # halve only when the model has MEASURED the smaller band
            # cheaper per member: the first-call cost has a fixed
            # per-program floor, so splitting a region doubles the
            # programs and can RAISE the total — without a measured win
            # the split is speculation, and a speculative split re-plans
            # the pool (new flatten key → every region cold again), the
            # oscillation this guard exists to prevent
            band = max(0, (cap // 2).bit_length() - 1)
            if not m.measured(_cm.REGION_TRACE, band, "cpu"):
                break
            half = m.region_trace_ns("cpu", cap // 2)
            if half is None or half >= per_member:
                break
            cap //= 2
        if cap != max_size:
            max_size = max(cap, min_size)
    if declined or sized:
        _cm.COSTMODEL_STATS["fusion_sized"] += 1
    return declined, min_size, max_size


def topo_order(n: int, off: Sequence[int], succs: Sequence[int]) -> List[int]:
    """Kahn topological order of a CSR DAG (the flatten output is a DAG
    by construction: indeg == goals was validated)."""
    indeg = [0] * n
    for s in succs:
        indeg[s] += 1
    q = collections.deque(i for i in range(n) if indeg[i] == 0)
    order: List[int] = []
    while q:
        u = q.popleft()
        order.append(u)
        for k in range(off[u], off[u + 1]):
            s = succs[k]
            indeg[s] -= 1
            if indeg[s] == 0:
                q.append(s)
    return order


def partition_regions(n: int, off: Sequence[int], succs: Sequence[int],
                      kind: Sequence[Optional[Hashable]],
                      min_size: int = 2, max_size: int = 128,
                      order: Optional[List[int]] = None,
                      ) -> List[List[int]]:
    """The fusion pass: group capturable tasks into convex regions.

    ``kind[t]`` is None for a seam (un-fusable) task, else a hashable
    capturability kind ('cpu' / 'dev' — tasks of different kinds never
    share a region: a region runs as ONE program on ONE dispatch path).
    Returns regions as member-id lists in topological order; every
    region has ``min_size <= len <= max_size`` and the condensed graph
    (regions + seams) is acyclic (see the module docstring's argument).
    """
    if n == 0:
        return []
    order = topo_order(n, off, succs) if order is None else order
    kinds_present = {k for k in kind if k is not None}
    if not kinds_present:
        return []
    topo_ix = [0] * n
    for ix, t in enumerate(order):
        topo_ix[t] = ix
    # per-kind seam depth, one topo sweep per kind (<= 2 kinds in
    # practice: 'cpu' and 'dev')
    depth: Dict[Hashable, List[int]] = {}
    for k in kinds_present:
        d = [0] * n
        for u in order:
            base = d[u] + (0 if kind[u] == k else 1)
            for e in range(off[u], off[u + 1]):
                s = succs[e]
                if base > d[s]:
                    d[s] = base
        depth[k] = d
    # union-find over direct same-kind same-depth edges
    parent = list(range(n))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for u in range(n):
        ku = kind[u]
        if ku is None:
            continue
        du = depth[ku][u]
        for e in range(off[u], off[u + 1]):
            s = succs[e]
            if kind[s] == ku and depth[ku][s] == du:
                ru, rs = find(u), find(s)
                if ru != rs:
                    parent[rs] = ru
    groups: Dict[int, List[int]] = {}
    for t in order:                      # members land in topo order
        if kind[t] is None:
            continue
        groups.setdefault(find(t), []).append(t)
    regions: List[List[int]] = []
    for members in groups.values():
        if len(members) < min_size:
            continue
        # topo-contiguous chunking keeps each chunk convex; a tail chunk
        # below min_size folds into its predecessor only while the
        # combined region respects max_size (the knob is a HARD bound on
        # a region program's size), otherwise the tail stays per-task
        for lo in range(0, len(members), max_size):
            chunk = members[lo:lo + max_size]
            if len(chunk) >= min_size:
                regions.append(chunk)
            elif regions and regions[-1][-1] == members[lo - 1] and \
                    len(regions[-1]) + len(chunk) <= max_size:
                regions[-1].extend(chunk)
    # deterministic output order (instantiations must agree with the
    # cached plan): sort by first member's topo position
    regions.sort(key=lambda m: topo_ix[m[0]])
    return regions
