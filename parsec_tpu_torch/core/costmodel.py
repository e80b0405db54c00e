"""Online cost models — the measurement→decision loop.

The runtime measures what its lanes do (the execution lane's batch-
amortized exec clock, the device lane's dispatch→retire windows, the
coherency table's stage-ins, the program cache's hit accounting).
:class:`CostModel` turns those measurements into per-``(task class, shape
bucket, device)`` EWMA execute-cost estimates and feeds three consumers:

* **device placement** (``dsl/ptg/compiler.py _ptexec_place_classes``): a
  CUDA-bodied class with a CPU twin is placed per instantiation by measured
  throughput — the device-side observation covers dispatch→retire wall
  time, so the coherency table's stage-in cost and the lane's poll cadence
  are priced in. User ``time_estimate`` hooks seed the cold-start prior
  instead of declining lane eligibility.
* **fusion sizing** (``dsl/fusion.py adaptive_fusion_limits``): fuse a
  class only while its measured per-task dispatch cost exceeds the fused
  region's per-task cost, and split oversized regions at the measured
  break-even band instead of the static ``region_fusion_max``.
* **reconciler gain** (``serving/reconcile.py``): the clamped share
  multiplier's exponent adapts to measured convergence error.

Feeding discipline: **no new hot-path instrumentation**. CPU-lane
observations ride the execution lane's batch clock — ``csrc/ptexec.cpp``
divides each batch's wall time across the batch and, when a cost row table
is bound (``Graph.cost_bind``), adds the same amortized per-task cost into a
per-row (count, sum) accumulator. Rows fold into this model when a lane
graph finishes (``Context._cost_fold``). Device-lane observations
accumulate in the dispatch/poll closures (manager thread, no lock) and fold
at the same moment. Decisions are made at instantiation boundaries, never
per task; their cost is counted in ``COSTMODEL_STATS["decision_ns"]``.

Keying: ``(class name, shape bucket, device key)``. The shape bucket is a
log4 bucket of the pool's dominant tile byte size (tiles within 4x share a
cost regime; :func:`shape_bucket`). Device keys are ``"cpu"``, ``"cuda"``
and the fused variants ``"cpu_fused"`` / ``"cuda_fused"`` (per-task cost
INSIDE a fused region — what fusion sizing compares against the unfused
cost). Two pseudo classes carry non-execute observations through the same
machinery: ``"__stage_in__"`` (host-to-device stage-in, bucketed by
transfer size) and ``"__region_trace__"`` (the first call of a region
program per member, bucketed by log2 region size band).

Persistence rides ``--mca costmodel_persist <path>`` (JSON) keyed by
:func:`~parsec_tpu_torch.dsl.fusion.device_fingerprint` — the same key that
scopes the program cache, so a restarted process starts warm; a stale
fingerprint discards the file (``persist_stale``) rather than mis-place on
other hardware.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ..utils import mca, output
from ..utils.counters import LaneStats

mca.register("costmodel", True,
             "Arm the online cost models: per-(class, shape-bucket, "
             "device) EWMA execute costs folded from the native lanes' "
             "measurements when a lane graph finishes. 0 disables every "
             "adaptive consumer at once (placement, fusion sizing, "
             "reconciler gain) and "
             "skips the C-side row accumulator", type=bool)
mca.register("costmodel_alpha", 0.25,
             "EWMA smoothing factor per FOLD batch (not per task): "
             "new_mean*alpha + old*(1-alpha). Higher adapts faster to "
             "regime changes, lower resists noise", type=float)
mca.register("costmodel_min_count", 8,
             "Observations before a key counts as MEASURED: below this "
             "the model answers with the cold-start prior (a user "
             "time_estimate hook, when the class declares one) and "
             "decisions stay on the static heuristic")
mca.register("costmodel_placement", True,
             "Consumer (a): adaptive lane-side best-device selection — "
             "a CUDA-bodied class is placed per-instantiation by measured "
             "throughput (dispatch→retire, stage-in priced in) instead "
             "of the static has-a-device-body rule. 0 restores the "
             "static heuristic while the model keeps learning", type=bool)
mca.register("costmodel_fusion", True,
             "Consumer (b): adaptive fusion sizing — fuse only while "
             "measured per-task dispatch overhead beats the fused "
             "region's marginal cost; split at the measured break-even "
             "band instead of region_fusion_max. 0 restores the static "
             "knobs", type=bool)
mca.register("costmodel_reconcile", True,
             "Consumer (c): the share reconciler's gain adapts to "
             "measured convergence error (damp on overshoot, boost on "
             "slow convergence) instead of the fixed exponent", type=bool)
mca.register("costmodel_persist", "",
             "Persist the learned cost model to this JSON path at "
             "Context.fini and load it on first use — keyed by "
             "device_fingerprint() like the program cache, so a "
             "restarted process starts warm (a stale fingerprint "
             "discards the file). Empty disables persistence")

#: the model's counters. ``decision_ns`` is the cumulative wall time of
#: every instantiation-boundary decision block. ``placements_diverged``
#: counts class placements where the adaptive choice differed from the
#: static has-a-device-body heuristic.
COSTMODEL_STATS = LaneStats(
    keys=0,                  # distinct (class, bucket, device) keys live
    observations=0,          # fold batches absorbed into EWMAs
    folds=0,                 # lane detach folds (C rows + device obs)
    decisions=0,             # instantiation-boundary decision blocks
    decision_ns=0,           # cumulative decision wall time
    placements_adaptive=0,   # class-placements decided by measurement
    placements_explore=0,    # cold keys probed once to learn the twin
    placements_diverged=0,   # adaptive choice != static heuristic
    fusion_sized=0,          # fusion passes with model-derived limits
    fusion_declined=0,       # classes un-fused by measured break-even
    priors_seeded=0,         # time_estimate hooks folded as priors
    gain_adapted=0,          # reconciler gain nudges
    persist_loads=0, persist_saves=0, persist_stale=0)


def shape_bucket(nbytes: int) -> int:
    """Log4 bucket of a tile/transfer byte size: sizes within 4x share
    a bucket (and hence a cost regime). 0 for unknown/empty sizes —
    still a stable key. Monotone: bigger never buckets lower."""
    if nbytes <= 0:
        return 0
    return (int(nbytes).bit_length() - 1) // 2


#: pseudo classes riding the (class, bucket, device) machinery
STAGE_IN = "__stage_in__"
REGION_TRACE = "__region_trace__"


class CostModel:
    """Process-wide online cost model: ``(class, bucket, device) ->
    [ewma_ns, count, prior_ns]`` under one lock. Every entry point is
    cheap and lock-scoped — callers sit at fold/decision boundaries,
    never in a per-task loop."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        # key -> [ewma_ns, count, prior_ns-or-None]
        self._m: Dict[Tuple[str, int, str], List] = {}
        self._explored: set = set()
        self._loaded = False

    # ---------------------------------------------------------- observing
    def observe(self, cls: str, bucket: int, dev: str, mean_ns: float,
                n: int = 1) -> None:
        """Fold one batch observation (mean cost over ``n`` tasks) into
        the key's EWMA. The smoothing step is per FOLD, weighted so one
        giant lane fold converges like the many small folds it stands
        for: alpha_eff = 1 - (1-alpha)^n, capped at n>=32."""
        if n <= 0 or mean_ns < 0:
            return
        alpha = float(mca.get("costmodel_alpha", 0.25))
        a_eff = 1.0 - (1.0 - alpha) ** min(int(n), 32)
        key = (cls, int(bucket), dev)
        with self._mu:
            ent = self._m.get(key)
            if ent is None:
                self._m[key] = [float(mean_ns), int(n), None]
                COSTMODEL_STATS["keys"] = len(self._m)
            elif ent[1] == 0:
                # prior-only entry: the first MEASUREMENT initializes the
                # EWMA outright (blending from the 0.0 placeholder would
                # bias every early estimate low)
                ent[0] = float(mean_ns)
                ent[1] = int(n)
            else:
                ent[0] += a_eff * (float(mean_ns) - ent[0])
                ent[1] += int(n)
            COSTMODEL_STATS["observations"] += 1

    def seed_prior(self, cls: str, bucket: int, dev: str,
                   prior_ns: float) -> None:
        """Install a cold-start prior (a user ``time_estimate`` hook's
        answer, in ns). Never overwrites measurements; re-seeding only
        updates the prior slot."""
        key = (cls, int(bucket), dev)
        with self._mu:
            ent = self._m.get(key)
            if ent is None:
                self._m[key] = [0.0, 0, float(prior_ns)]
                COSTMODEL_STATS["keys"] = len(self._m)
            else:
                ent[2] = float(prior_ns)
            COSTMODEL_STATS["priors_seeded"] += 1

    def fold_pairs(self, items: Iterable[Tuple[Tuple[str, int, str],
                                               int, int]]) -> None:
        """Fold ``((cls, bucket, dev), count, sum_ns)`` rows — the C
        accumulator's ``cost_snapshot()`` joined with the lane's row
        metadata, and the device closures' local accumulation dicts.
        Called at lane detach (the histogram registry's lifecycle)."""
        any_row = False
        for key, cnt, sum_ns in items:
            if cnt > 0:
                any_row = True
                self.observe(key[0], key[1], key[2], sum_ns / cnt, cnt)
        if any_row:
            COSTMODEL_STATS["folds"] += 1

    # ----------------------------------------------------------- querying
    def cost(self, cls: str, bucket: int, dev: str) -> Optional[float]:
        """Best cost estimate in ns, or None when the model knows
        nothing: a MEASURED key (count >= costmodel_min_count) answers
        its EWMA; else the nearest measured bucket of the same (class,
        device) answers (4x-wide buckets — the neighbor is the right
        order of magnitude); else the prior."""
        min_count = int(mca.get("costmodel_min_count", 8))
        key = (cls, int(bucket), dev)
        with self._mu:
            ent = self._m.get(key)
            if ent is not None and ent[1] >= min_count:
                return ent[0]
            # nearest measured bucket fallback
            best = None
            for (c, b, d), e in self._m.items():
                if c == cls and d == dev and e[1] >= min_count:
                    dist = abs(b - int(bucket))
                    if best is None or dist < best[0]:
                        best = (dist, e[0])
            if best is not None:
                return best[1]
            if ent is not None and ent[2] is not None:
                return ent[2]
        return None

    def measured(self, cls: str, bucket: int, dev: str) -> bool:
        """True when the EXACT key has enough observations to trust."""
        with self._mu:
            ent = self._m.get((cls, int(bucket), dev))
            return ent is not None and \
                ent[1] >= int(mca.get("costmodel_min_count", 8))

    def begin_explore(self, cls: str, bucket: int, dev: str) -> bool:
        """One-shot exploration ticket for a cold key: the first caller
        gets True (place the class there once so the model learns the
        twin's cost), every later caller False."""
        key = (cls, int(bucket), dev)
        with self._mu:
            if key in self._explored:
                return False
            self._explored.add(key)
        COSTMODEL_STATS["placements_explore"] += 1
        return True

    def count(self, cls: str, bucket: int, dev: str) -> int:
        with self._mu:
            ent = self._m.get((cls, int(bucket), dev))
            return 0 if ent is None else ent[1]

    def snapshot(self) -> Dict[Tuple[str, int, str], Tuple[float, int,
                                                           Optional[float]]]:
        with self._mu:
            return {k: (v[0], v[1], v[2]) for k, v in self._m.items()}

    def reset(self) -> None:
        """Drop every entry and exploration ticket (bench/test
        isolation). Counters are the caller's to snapshot/delta."""
        with self._mu:
            self._m.clear()
            self._explored.clear()
            COSTMODEL_STATS["keys"] = 0

    # -------------------------------------------------------- pseudo keys
    def note_stage_in(self, dev: str, nbytes: int, ns: int) -> None:
        """One H2D stage-in observation (accumulated by the device
        dispatch closure, folded at detach via fold_pairs in practice —
        this direct entry serves tests and the interpreted path)."""
        self.observe(STAGE_IN, shape_bucket(nbytes), dev, ns, 1)

    def stage_in_ns(self, dev: str, nbytes: int) -> Optional[float]:
        return self.cost(STAGE_IN, shape_bucket(nbytes), dev)

    def note_region_trace(self, dev: str, n_members: int, ns: int) -> None:
        """One first-call observation of a region program: per-MEMBER
        cost, bucketed by the log2 region-size band (the per-member cost of
        a region's first call by region size is the curve fusion sizing
        reads back through :func:`region_trace_ns`)."""
        if n_members <= 0:
            return
        band = max(0, int(n_members).bit_length() - 1)
        self.observe(REGION_TRACE, band, dev, ns / n_members, 1)

    def region_trace_ns(self, dev: str, n_members: int) -> Optional[float]:
        """Per-member trace cost estimate for a region of this size."""
        band = max(0, int(n_members).bit_length() - 1)
        return self.cost(REGION_TRACE, band, dev)

    # -------------------------------------------------------- persistence
    _PERSIST_VERSION = 1

    def maybe_load(self) -> None:
        """Load the persisted model once per process (first decision
        point calls this). A missing file or a stale device fingerprint
        leaves the model cold — never mis-place on other hardware."""
        with self._mu:
            if self._loaded:
                return
            self._loaded = True
        path = mca.get("costmodel_persist", "") or ""
        if not path or not os.path.exists(path):
            return
        try:
            with open(path, "r", encoding="utf-8") as f:
                blob = json.load(f)
            from ..dsl.fusion import device_fingerprint
            if blob.get("version") != self._PERSIST_VERSION or \
                    blob.get("fingerprint") != list(device_fingerprint()):
                COSTMODEL_STATS["persist_stale"] += 1
                output.debug_verbose(
                    1, "costmodel",
                    f"discarding stale persisted model at {path} "
                    f"(fingerprint mismatch)")
                return
            with self._mu:
                for cls, bucket, dev, ewma, count, prior in \
                        blob.get("entries", ()):
                    self._m.setdefault(
                        (cls, int(bucket), dev),
                        [float(ewma), int(count),
                         None if prior is None else float(prior)])
                COSTMODEL_STATS["keys"] = len(self._m)
            COSTMODEL_STATS["persist_loads"] += 1
        except Exception as e:  # noqa: BLE001 — a warm start is advisory
            output.debug_verbose(1, "costmodel",
                                 f"persisted model load failed: {e}")

    def maybe_save(self) -> None:
        """Persist at Context.fini when ``costmodel_persist`` is set."""
        path = mca.get("costmodel_persist", "") or ""
        if not path:
            return
        try:
            from ..dsl.fusion import device_fingerprint
            with self._mu:
                entries = [[c, b, d, e[0], e[1], e[2]]
                           for (c, b, d), e in self._m.items()]
            blob = {"version": self._PERSIST_VERSION,
                    "fingerprint": list(device_fingerprint()),
                    "entries": entries}
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(blob, f)
            os.replace(tmp, path)
            COSTMODEL_STATS["persist_saves"] += 1
        except Exception as e:  # noqa: BLE001 — persistence is advisory
            output.debug_verbose(1, "costmodel",
                                 f"persisted model save failed: {e}")


def enabled() -> bool:
    """The master switch every consumer checks first."""
    return bool(mca.get("costmodel", True))


#: the process-wide model (the Context/compiler/fusion consumers all
#: feed and read this one instance; tests reset() it)
model = CostModel()


def fold_cost_rows(meta: Sequence[Tuple[str, int, str]],
                   snapshot: Sequence[Tuple[int, int]]) -> None:
    """Join a lane graph's ``cost_snapshot()`` (per-row count/sum from
    the C accumulator) with the row metadata recorded at prepare and
    fold into the model — the detach-time moment (Context._cost_fold)."""
    model.fold_pairs((meta[r], cnt, sum_ns)
                     for r, (cnt, sum_ns) in enumerate(snapshot)
                     if r < len(meta) and meta[r] is not None)
