"""pttel: wire-native mesh telemetry — tree-aggregated metric push.

Every rank is observable by PULL (``/metrics`` over HTTP/UDS), but a pull
funnels everything mesh-wide through rank-0 scrapes: O(P) HTTP fetches per
reconciler round. This module is the PUSH half: every ``tel_interval_ms``
each rank ships its counter registry *as deltas* plus its raw sparse
histogram buckets (mergeable by design — :mod:`parsec_tpu_torch.utils.hist`)
one hop UP a configurable-fanout reduction tree riding a dedicated
``TAG_PTTEL`` AM. Interior ranks fold the children's entries into their own
store before forwarding, so each rank sends at most ONE frame and receives
at most ``fanout`` frames per round — O(log P) frames per rank per round
mesh-wide — and rank 0 ends up holding an eventually-consistent rollup of
the whole mesh with per-rank staleness bounds.

Wire format (``TAG_PTTEL {"k": "fold", "e": [entry...]}``): one entry per
origin rank in the sender's subtree, each ``{"r": origin, "seq": n, "ts":
wall-clock, "d": {counter: delta}, "h": {hist: [count, sum_ns,
sparse-buckets]}}``. Frames are idempotent per origin: every origin stamps a
monotonically increasing ``seq`` and :func:`fold_entry` drops ``seq <=
last-applied`` (counted ``pttel.late_drops``), so a replayed frame can never
double-count. Counter *values* are reconstructed by telescoping — the
per-origin cumulative is exactly the sum of its deltas — so gauges
(samplers) survive the delta encoding too; only the mesh-wide SUM excludes
gauge-shaped keys (:func:`gauge_key`, the ``aggregate_counters`` rule:
summing four ranks' p99s prints a number that LOOKS like a latency but
isn't).

Frames ride the comm engine's AM path (``ce.send_am``), beside the native
comm lane's own frames on the same TCP connections.

Consumers: ``/mesh`` on the metrics endpoint (tools/metrics_server.py)
serves :meth:`TelemetryPlane.rollup`; the share reconciler
(serving/reconcile.py) reads the pushed rollup instead of N HTTP fetches
(scrape stays as the fallback when the plane is down);
``tools/live_view.py``'s mesh mode polls one rank-0 endpoint instead of P.

Staleness bound: a rank's entry at rank 0 is at most ``depth * interval``
behind (one hop per round), ``depth <= ceil(log_fanout P)``; each entry
carries its origin wall-clock ``ts`` so the bound is *measured*
(``staleness_s`` per rank in the rollup), not assumed.
"""

from __future__ import annotations

import math
import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Set

from ..utils import mca, output
from ..utils.counters import LaneStats
from .engine import TAG_PTTEL

mca.register("tel_interval_ms", 0,
             "Mesh telemetry push cadence (ms): every interval each rank "
             "sends its counter deltas + sparse histogram buckets one hop "
             "up the fanout-`tel_fanout` reduction tree on TAG_PTTEL; "
             "rank 0 accumulates the mesh rollup served at /mesh. "
             "0 = plane disabled (reconciler falls back to HTTP scrape)",
             type=int)
mca.register("tel_fanout", 2,
             "Reduction-tree fanout: parent(r) = (r-1)//fanout. Higher "
             "fanout = shallower tree (fresher rollup) but more frames "
             "received per interior rank per round", type=int)

#: engagement counters (the honest-fallback contract): exported as
#: ``pttel.*`` by install_native_counters
TEL_STATS = LaneStats(
    rounds=0,        # local push rounds completed
    frames_tx=0,     # frames sent to the parent
    frames_rx=0,     # frames received from children
    folds=0,         # per-origin entries folded into the store
    parked=0,        # frames parked before the plane attached (replayed)
    late_drops=0,    # stale-seq entries dropped (delta idempotence)
    tx_errors=0,     # sends that raised (deltas re-queued, counted)
    ranks_seen=0,    # gauge: origins currently resolved in this store
)


# --------------------------------------------------------------- tree shape
def tel_parent(rank: int, fanout: int) -> Optional[int]:
    """Parent of ``rank`` in the fanout-k reduction tree (None at root)."""
    if rank <= 0:
        return None
    return (rank - 1) // max(1, fanout)


def tel_children(rank: int, nb_ranks: int, fanout: int) -> List[int]:
    """Children of ``rank``: the inverse of :func:`tel_parent`."""
    f = max(1, fanout)
    lo = rank * f + 1
    return list(range(lo, min(lo + f, nb_ranks)))


def tel_depth(nb_ranks: int, fanout: int) -> int:
    """Tree depth = the worst-case hop count (staleness in rounds)."""
    d, r = 0, nb_ranks - 1
    while r > 0:
        r = (r - 1) // max(1, fanout)
        d += 1
    return d


# --------------------------------------------------------------- fold math
def gauge_key(key: str) -> bool:
    """Keys with no meaningful cross-rank SUM (same rule as the fini
    counter aggregation): latency percentiles and clock offsets stay in
    the per-rank columns of the rollup only."""
    return (".hist." in key and not key.endswith(".count")) or \
        key.startswith("comm.clock_")


def fold_entry(store: Dict[int, Dict[str, Any]],
               entry: Dict[str, Any]) -> bool:
    """Fold one wire entry into a per-origin store — the single home of
    the tree-fold invariant (pure: no locks, no counters; the plane and
    the unit tests share it).

    ``store[origin] = {"seq", "ts", "counters", "hists"}`` where
    ``counters`` telescopes the deltas (sum of deltas == origin's latest
    snapshot value) and ``hists`` keeps the latest cumulative sparse
    buckets. Returns False (no-op) for a stale/duplicate ``seq`` — the
    idempotence contract: folding the same entry twice changes nothing.
    """
    r = int(entry["r"])
    st = store.get(r)
    if st is not None and entry["seq"] <= st["seq"]:
        return False
    if st is None:
        st = store[r] = {"seq": 0, "ts": 0.0, "counters": {}, "hists": {}}
    st["seq"] = entry["seq"]
    st["ts"] = entry["ts"]
    cum = st["counters"]
    for k, dv in entry.get("d", {}).items():
        cum[k] = cum.get(k, 0) + dv
    if entry.get("h"):
        st["hists"] = entry["h"]
    return True


def merge_rank_hists(per_rank: List[Dict[str, Any]]) -> Dict[str, list]:
    """Merge sparse histogram snapshots across ranks: counts, sums and
    per-bucket cells add (the histogram registry's merge invariant on the
    sparse wire form). Returns ``{name: [count, sum_ns, [[i, c]...]]}``."""
    out: Dict[str, list] = {}
    for hists in per_rank:
        for name, (count, sum_ns, sparse) in hists.items():
            cur = out.get(name)
            if cur is None:
                cur = out[name] = [0, 0, {}]
            cur[0] += count
            cur[1] += sum_ns
            for i, c in sparse:
                cur[2][i] = cur[2].get(i, 0) + c
    return {n: [c, s, sorted([i, v] for i, v in b.items())]
            for n, (c, s, b) in out.items()}


def mesh_sum(ranks: Dict[int, Dict[str, Any]]) -> Dict[str, float]:
    """The mesh-wide counter SUM over per-rank cumulative stores,
    excluding gauge-shaped keys (:func:`gauge_key`) and non-finite
    cells."""
    total: Dict[str, float] = {}
    for st in ranks.values():
        for k, v in st["counters"].items():
            if isinstance(v, (int, float)) and math.isfinite(v) \
                    and not gauge_key(k):
                total[k] = total.get(k, 0) + v
    return total


# ------------------------------------------------------------------- plane
#: the process's newest live plane (weak), for /mesh and live_view
_current: Optional["weakref.ref[TelemetryPlane]"] = None


def current_plane() -> Optional["TelemetryPlane"]:
    ref = _current
    return ref() if ref is not None else None


class TelemetryPlane:
    """One rank's telemetry pusher + subtree accumulator.

    Built by :class:`~parsec_tpu_torch.comm.remote_dep.RemoteDepEngine`
    when ``--mca tel_interval_ms > 0`` (frames arriving earlier park in the
    engine and replay at attach — the TAG_PTFAB pattern); the push thread
    starts with ``rde.enable()`` and a final flush rides ``rde.fini()`` so
    shutdown counts still reach the root."""

    def __init__(self, rde) -> None:
        self.rde = rde
        self.ce = rde.ce
        self.my_rank = self.ce.my_rank
        self.nb_ranks = self.ce.nb_ranks
        self.interval_s = max(0.005, mca.get("tel_interval_ms", 0) / 1e3)
        self.fanout = max(1, int(mca.get("tel_fanout", 2)))
        self.parent = tel_parent(self.my_rank, self.fanout)
        self.children = tel_children(self.my_rank, self.nb_ranks,
                                     self.fanout)
        self._mu = threading.Lock()
        self._seq = 0
        self._last_sent: Dict[str, float] = {}
        #: origin -> {"seq","ts","counters","hists"} (fold_entry shape)
        self._store: Dict[int, Dict[str, Any]] = {}
        #: origin -> unforwarded delta accumulation (interior ranks)
        self._pending: Dict[int, Dict[str, float]] = {}
        self._dirty: Set[int] = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # lanes visible in the pushed snapshots (idempotent)
        try:
            from ..utils.counters import install_native_counters
            install_native_counters()
        except Exception:  # noqa: BLE001 — partial native: push the rest
            pass
        global _current
        _current = weakref.ref(self)
        output.debug_verbose(1, "pttel",
                             f"telemetry plane up: rank {self.my_rank}/"
                             f"{self.nb_ranks} interval "
                             f"{self.interval_s * 1e3:.0f}ms fanout "
                             f"{self.fanout} parent {self.parent} "
                             f"children {self.children}")

    @classmethod
    def configured(cls) -> bool:
        return mca.get("tel_interval_ms", 0) > 0

    # ------------------------------------------------------------ snapshots
    @staticmethod
    def _snapshot_counters() -> Dict[str, float]:
        """Finite numeric registry values only: a NaN sampler (failing,
        or a clock offset not yet measured) must not poison the
        telescoped cumulative forever (NaN + anything = NaN). The
        ``*.hist.*`` percentile gauges are skipped BEFORE sampling — the
        raw sparse buckets already ride each frame (``"h"``), percentiles
        are derivable at any consumer, and those samplers are the
        registry's most expensive (each cache-missing a full bucket walk
        at exactly this cadence)."""
        from ..utils.counters import counters
        return {k: v for k, v in counters.snapshot(
                    skip=lambda key: ".hist." in key).items()
                if isinstance(v, (int, float)) and math.isfinite(v)}

    @staticmethod
    def _snapshot_hists() -> Dict[str, list]:
        """Latest cumulative sparse buckets (raw, mergeable): hists ride
        whole each round, not as deltas — the bucket arrays are already
        sparse and the merge invariant wants absolute cells."""
        from ..utils.hist import histograms
        out: Dict[str, list] = {}
        for name, d in histograms.snapshot().items():
            out[name] = [d["count"], d["sum_ns"],
                         [[i, c] for i, c in enumerate(d["buckets"]) if c]]
        return out

    # ------------------------------------------------------------- rounds
    def round(self) -> None:
        """One telemetry round: snapshot self, fold into the store, and
        forward every dirty origin (self + folded children) one hop up
        in a single frame."""
        snap = self._snapshot_counters()
        hists = self._snapshot_hists()
        now = time.time()
        entries: List[Dict[str, Any]] = []
        with self._mu:
            self._seq += 1
            delta = {}
            for k, v in snap.items():
                dv = v - self._last_sent.get(k, 0)
                if dv:
                    delta[k] = dv
            self._last_sent = snap
            self._fold_locked({"r": self.my_rank, "seq": self._seq,
                               "ts": now, "d": delta, "h": hists})
            if self.parent is not None:
                for r in sorted(self._dirty):
                    st = self._store[r]
                    entries.append({"r": r, "seq": st["seq"],
                                    "ts": st["ts"],
                                    "d": self._pending.pop(r, {}),
                                    "h": st["hists"]})
                self._dirty.clear()
            TEL_STATS["rounds"] += 1
            TEL_STATS["ranks_seen"] = len(self._store)
        if not entries:
            return
        try:
            self.ce.send_am(TAG_PTTEL, self.parent,
                            {"k": "fold", "e": entries}, None)
            TEL_STATS["frames_tx"] += 1
        except Exception:  # noqa: BLE001 — a dying parent: re-queue deltas
            TEL_STATS["tx_errors"] += 1
            with self._mu:
                for e in entries:
                    p = self._pending.setdefault(e["r"], {})
                    for k, dv in e["d"].items():
                        p[k] = p.get(k, 0) + dv
                    self._dirty.add(e["r"])

    def _fold_locked(self, entry: Dict[str, Any]) -> bool:
        if not fold_entry(self._store, entry):
            TEL_STATS["late_drops"] += 1
            return False
        TEL_STATS["folds"] += 1
        if self.parent is not None:
            p = self._pending.setdefault(int(entry["r"]), {})
            for k, dv in entry.get("d", {}).items():
                p[k] = p.get(k, 0) + dv
        self._dirty.add(int(entry["r"]))
        return True

    def on_frame(self, src: int, hdr: Dict[str, Any]) -> None:
        """TAG_PTTEL delivery (from the rde's progress path)."""
        if hdr.get("k") != "fold":
            return
        TEL_STATS["frames_rx"] += 1
        with self._mu:
            for e in hdr.get("e", ()):
                self._fold_locked(e)

    def flush(self) -> int:
        """One synchronous push round NOW (tests / shutdown); returns
        this rank's new seq so a peer can wait for exactly this state."""
        self.round()
        return self._seq

    def seq_of(self, rank: int) -> int:
        """Last folded seq for ``rank`` (0 = never seen) — the 'did my
        peer's flush land yet' probe."""
        with self._mu:
            st = self._store.get(rank)
            return 0 if st is None else st["seq"]

    # ------------------------------------------------------------- rollup
    def rollup(self) -> Dict[str, Any]:
        """The eventually-consistent mesh view at this rank: per-rank
        cumulative counters + gauges + measured staleness, the gauge-safe
        mesh SUM, and the cross-rank histogram merge. At rank 0 this
        covers the whole mesh; interior ranks see their subtree."""
        now = time.time()
        with self._mu:
            ranks: Dict[int, Dict[str, Any]] = {}
            for r, st in self._store.items():
                ranks[r] = {
                    "seq": st["seq"], "ts": st["ts"],
                    "staleness_s": round(max(0.0, now - st["ts"]), 3),
                    "counters": dict(st["counters"]),
                    "histograms": {n: [v[0], v[1], list(v[2])]
                                   for n, v in st["hists"].items()},
                }
            rounds = TEL_STATS["rounds"]
        return {
            "my_rank": self.my_rank,
            "nb_ranks": self.nb_ranks,
            "fanout": self.fanout,
            "interval_ms": self.interval_s * 1e3,
            "depth": tel_depth(self.nb_ranks, self.fanout),
            "rounds": rounds,
            "ranks": ranks,
            "rollup": mesh_sum(ranks),
            "histograms": merge_rank_hists(
                [st["histograms"] for st in ranks.values()]),
        }

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "TelemetryPlane":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="parsec-pttel")
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.round()
            except Exception as e:  # noqa: BLE001 — telemetry is advisory
                output.debug_verbose(1, "pttel", f"round failed: {e}")

    def stop(self, flush: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        if flush:
            try:
                self.round()   # final deltas reach the root before fini
            except Exception:  # noqa: BLE001 — teardown must proceed
                pass
