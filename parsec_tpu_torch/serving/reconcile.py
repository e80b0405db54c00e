"""Mesh-wide QoS share reconciliation.

Per-rank weighted DRR guarantees shares WITHIN a rank; nothing guarantees
them ACROSS ranks — a tenant draining mostly on rank 3 could take 3x its
global share while staying exactly on-weight everywhere. This module
closes the loop without a global lock anywhere near the hot path:

* rank 0 runs a :class:`ShareReconciler` — a slow control loop (default
  4 Hz) that reads every rank's ``ptfab.served.<tenant>`` counters. With
  the mesh telemetry plane running (:mod:`parsec_tpu_torch.comm.pttel`)
  the readings come out of the PUSHED mesh rollup — zero HTTP fetches per
  round, the tree already delivered every rank's counters to rank 0;
  without it the loop falls back to scraping each rank's ``/metrics``
  endpoint (:func:`parsec_tpu_torch.tools.metrics_server.fetch`). Either
  way a missing rank (stale in the rollup, or a failed fetch) does not
  void the round: the loop reconciles over the reporting ranks
  (``reconcile.partial_rounds``) and skips only the missing ranks' weight
  nudges — their cumulative counters make the next delta span both
  rounds;
* each round it computes the MEASURED global share of every tenant over
  the last window (served deltas summed across ranks), compares against
  the target share from the global weights, and nudges a per-tenant
  weight multiplier: ``m *= (target / measured) ** gain`` (clamped — a
  cold tenant must not explode its weight);
* the nudged weights quantize to integer DRR weights (scale 16) and ride
  one ``TAG_PTFAB {"k": "weights"}`` AM to every rank, where the fabric
  applies them through ``Plane.set_weight`` — weights bind at the next
  DRR round top-up, so convergence is smooth, not steppy;
* a consumer of the online cost model loop: the nudge exponent itself
  ADAPTS to the measured convergence error instead of staying the fixed
  0.6 — an error that grew since the last round means the loop overshot
  (damp the gain), an error that stays large and barely shrinks means it
  converges too slowly (raise it). Gated by ``--mca costmodel_reconcile``
  and clamped to [0.1, 1.5]; every nudge counts
  ``costmodel.gain_adapted``.

Convergence caveats: shares only bind while every tenant keeps every
rank's drain backlogged (DRR serves an idle tenant at its arrival rate,
as within one rank), and the loop measures SERVED tasks — heterogeneous
task costs reconcile task-shares, not cpu-shares.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

from ..utils import output
from ..utils.counters import LaneStats
from .fabric import FAB_STATS, ServingFabric

#: exported as ``reconcile.*`` by install_native_counters
RECONCILE_STATS = LaneStats(
    push_rounds=0,      # rounds fed by the pttel mesh rollup (0 fetches)
    scrape_rounds=0,    # rounds that fell back to per-rank HTTP
    http_fetches=0,     # individual /metrics GETs issued (fallback only)
    partial_rounds=0,   # rounds reconciled with >= 1 rank missing
    missing_ranks=0,    # cumulative missing-rank observations
)


class ShareReconciler:
    """Rank-0 control loop converging measured per-tenant global shares
    to the global QoS weights by nudging per-rank local DRR weights."""

    #: integer-weight quantization: multiplier 1.0 -> DRR weight
    #: base_weight * scale stays exact for the common small weights.
    #: CAVEAT: a pool's weight binds only while its backlog exceeds
    #: weight * plane-quantum, so scale * quantum should stay well under
    #: the admission windows — serving meshes pair a small
    #: --mca sched_quantum with a small scale.
    SCALE = 16

    #: a round whose total served delta is below this carries no usable
    #: share signal (a 0-delta tenant would read as "starved" and get a
    #: runaway boost): skip the nudge, keep the baseline
    MIN_WINDOW_TASKS = 32

    #: a rank whose rollup entry is staler than this many telemetry
    #: intervals counts as missing for the round (push mode): nudging on
    #: a frozen snapshot would mis-read a live tenant as starved
    STALE_INTERVALS = 8.0

    def __init__(self, fabric: ServingFabric, endpoints: List[str],
                 weights: Dict[str, float], *, period: float = 0.25,
                 gain: float = 0.6, max_mult: float = 16.0,
                 scale: Optional[int] = None, tel: Any = "auto") -> None:
        self.fabric = fabric
        self.endpoints = list(endpoints)   # rank-indexed /metrics addrs
        self.weights = dict(weights)       # tenant -> global weight
        self.period = period
        self.gain = gain
        self.max_mult = max_mult
        self.scale = scale if scale is not None else self.SCALE
        #: "auto" = discover the telemetry plane through fabric.rde per
        #: round (it attaches after the reconciler in some harnesses);
        #: None = HTTP only; a TelemetryPlane pins the push source
        self.tel = tel
        self._mult = {t: 1.0 for t in weights}       # nudged multiplier
        #: per-rank served-at-last-round; a missing rank KEEPS its old
        #: entry so its next delta spans the gap (cumulative counters)
        self._last: Optional[Dict[int, Dict[str, int]]] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.rounds = 0
        self.last_err_pct: Optional[float] = None
        self.last_mode: Optional[str] = None     # "push" | "scrape"
        self.converged_round: Optional[int] = None  # first round <= 15%
        self._prev_err: Optional[float] = None   # gain scheduling state

    # ------------------------------------------------------------ scraping
    def _telemetry(self):
        if self.tel == "auto":
            return getattr(getattr(self.fabric, "rde", None),
                           "telemetry", None)
        return self.tel or None

    def _served_of(self, counters: Dict[str, Any]) -> Dict[str, int]:
        return {t: int(counters.get(f"ptfab.served.{t}", 0) or 0)
                for t in self.weights}

    def _from_push(self, tel) -> Optional[
            Tuple[Dict[int, Dict[str, int]], Set[int]]]:
        """Read the round out of the pushed mesh rollup: zero network
        traffic here — the tree already delivered every rank's counters.
        A rank absent from the rollup (or staler than STALE_INTERVALS
        telemetry rounds) counts as missing for this round."""
        roll = tel.rollup()
        ranks = roll.get("ranks", {})
        bound = max(0.25, self.STALE_INTERVALS * tel.interval_s)
        per_rank: Dict[int, Dict[str, int]] = {}
        missing: Set[int] = set()
        for r in range(self.fabric.nb_ranks):
            ent = ranks.get(r)
            if ent is None or ent.get("staleness_s", bound) > bound:
                missing.add(r)
                continue
            per_rank[r] = self._served_of(ent.get("counters", {}))
        if not per_rank:
            return None           # no subtree landed yet: let HTTP try
        RECONCILE_STATS["push_rounds"] += 1
        self.last_mode = "push"
        return per_rank, missing

    def _from_http(self) -> Optional[
            Tuple[Dict[int, Dict[str, int]], Set[int]]]:
        """Fallback: per-rank /metrics GETs. A failed endpoint does not
        void the round — it joins the missing set and only its nudges are
        skipped (the partial-round contract)."""
        from ..tools.metrics_server import fetch
        per_rank: Dict[int, Dict[str, int]] = {}
        missing: Set[int] = set()
        for r, ep in enumerate(self.endpoints):
            try:
                RECONCILE_STATS["http_fetches"] += 1
                per_rank[r] = self._served_of(fetch(ep)["counters"])
            except Exception:  # noqa: BLE001 — scrape that rank next round
                missing.add(r)
        if not per_rank:
            return None
        RECONCILE_STATS["scrape_rounds"] += 1
        self.last_mode = "scrape"
        return per_rank, missing

    def _scrape(self):
        """The round's readings: the pushed rollup when the telemetry
        plane runs, per-rank HTTP otherwise. Returns ``(per_rank,
        missing)`` — or a flat ``{tenant: total}`` dict from a
        monkeypatched scrape, which :meth:`step` normalizes."""
        tel = self._telemetry()
        if tel is not None:
            got = self._from_push(tel)
            if got is not None:
                return got
        return self._from_http()

    # ------------------------------------------------------------- rounds
    def step(self) -> Optional[float]:
        """One reconciliation round; returns the max share error (pct)
        over the window, or None when the window carried no service."""
        got = self._scrape()
        if got is None:
            return None           # _last unchanged: cumulative counters
                                  # make the next delta span both rounds
        if isinstance(got, dict):
            # a flat {tenant: mesh total} scrape: model it as a single
            # pseudo-rank so the math is unchanged
            per_rank: Dict[int, Dict[str, int]] = {
                0: {t: int(got.get(t, 0) or 0) for t in self.weights}}
            missing: Set[int] = set()
        else:
            per_rank, missing = got
        if missing:
            RECONCILE_STATS["partial_rounds"] += 1
            RECONCILE_STATS["missing_ranks"] += len(missing)
        last = self._last or {}
        # missing ranks keep their old entry: the cumulative counters
        # make their next delta span the gap instead of losing it
        self._last = {**last, **per_rank}
        common = [r for r in per_rank if r in last]
        if not common:
            return None
        delta = {t: 0 for t in self.weights}
        for r in common:
            cur, prev = per_rank[r], last[r]
            for t in delta:
                delta[t] += max(0, cur.get(t, 0) - prev.get(t, 0))
        total = sum(delta.values())
        tot_w = sum(self.weights.values())
        if total < self.MIN_WINDOW_TASKS or tot_w <= 0:
            return None
        err_max = 0.0
        new_w: Dict[str, int] = {}
        for t, w in self.weights.items():
            target = w / tot_w
            measured = delta[t] / total
            if measured > 0:
                err = abs(measured - target) / target * 100.0
                err_max = max(err_max, err)
                nudge = (target / measured) ** self.gain
                # clamp the per-round nudge AND the cumulative multiplier
                nudge = min(2.0, max(0.5, nudge))
                self._mult[t] = min(self.max_mult,
                                    max(1.0 / self.max_mult,
                                        self._mult[t] * nudge))
            else:
                # a starved tenant: open its weight decisively (measured
                # share 0 has no finite ratio)
                err_max = max(err_max, 100.0)
                self._mult[t] = min(self.max_mult, self._mult[t] * 2.0)
            new_w[t] = max(1, int(round(w * self._mult[t] * self.scale)))
        self.rounds += 1
        self.last_err_pct = round(err_max, 1)
        if self.converged_round is None and err_max <= 15.0:
            self.converged_round = self.rounds
        self._adapt_gain(err_max)
        FAB_STATS["reconcile_rounds"] += 1
        FAB_STATS["share_err_pct"] = self.last_err_pct
        self._broadcast(new_w, self.last_err_pct, skip=missing)
        return err_max

    def _adapt_gain(self, err: float) -> None:
        """The cost model's reconciler consumer: the nudge exponent tracks
        MEASURED convergence error round to round. Error grew >5% over the
        last round → the loop overshot (the clamped multiplier oscillates
        around the target): damp the gain by 0.7. Error still large (>5%)
        and shrinking by less than 30% → too timid: raise it by 1.15.
        Clamped to [0.1, 1.5] — above ~1 the pure-ratio controller is
        already at the edge of ringing, 0.1 still converges, just slowly.
        One float compare per 4 Hz round: nowhere near any hot path."""
        from ..utils import mca
        if not mca.get("costmodel_reconcile", True):
            self._prev_err = err
            return
        prev, self._prev_err = self._prev_err, err
        if prev is None:
            return
        g = self.gain
        if err > prev * 1.05:
            g *= 0.7
        elif err > 5.0 and err > prev * 0.7:
            g *= 1.15
        g = min(1.5, max(0.1, g))
        if g != self.gain:
            self.gain = g
            from ..core.costmodel import COSTMODEL_STATS
            COSTMODEL_STATS["gain_adapted"] += 1

    def _broadcast(self, weights: Dict[str, int], err_pct: float,
                   skip: Iterable[int] = ()) -> None:
        fab = self.fabric
        skip = set(skip)
        # apply locally first (rank 0 serves too), then AM the peers;
        # ranks missing from this round's readings are skipped — their
        # share was not measured, so a nudge would mis-steer them
        for t, w in weights.items():
            fab.set_weight(t, w)
        if fab.rde is None:
            return
        from ..comm.engine import TAG_PTFAB
        hdr = {"k": "weights", "w": weights, "err": err_pct}
        for r in range(fab.nb_ranks):
            if r == fab.my_rank or r in fab._dead or r in skip:
                continue
            try:
                fab.rde.ce.send_am(TAG_PTFAB, r, hdr, None)
            except Exception:  # noqa: BLE001 — a dying peer reconciles 0x
                pass

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "ShareReconciler":
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="ptfab-reconcile")
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.period):
            try:
                self.step()
            except Exception as e:  # noqa: BLE001 — advisory loop
                output.debug_verbose(1, "ptfab", f"reconcile round: {e}")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
