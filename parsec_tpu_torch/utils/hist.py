"""Native latency histograms: bucket math, summarization, process registry.

The Python half of ``csrc/pthist.h``: the lanes record fixed-bucket log2
(HdrHistogram-style) latency distributions with relaxed atomics — task
execute latency and ready-queue wait in ``ptexec``/``ptdtd``, push->pop
wait in the scheduler plane, dispatch -> retire on the device lane
(``ptdev``). This
module mirrors the bucket scheme, sums snapshots across every live lane
object (plus lanes that already finished — their buckets are accumulated
at detach, like the trace bridge's drop accounting), and summarizes
p50/p99/p999 for the counter registry, ``live_view``, and the
``/metrics`` endpoint (tools/metrics_server.py).

Bucket scheme (must mirror pthist.h): values < 8 ns map exactly to
buckets 0..7; above that the index is ``(exponent, top-3-mantissa-bits)``
— 8 sub-buckets per power of two, ~12.5% relative resolution, 496
buckets total. Percentiles report the bucket midpoint, so their error is
bounded by half a bucket width (~6%).

Cost contract: recording is gated exactly like the in-lane trace rings
(one predictable null branch per site when off) and the armed cost is
amortized/sampled in the hot lanes; ``chip_smoke.py`` reports
``hist_overhead_pct_native`` on the chain shape.
"""

from __future__ import annotations

import struct
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from . import mca

mca.register("hist_enabled", False,
             "Arm the native lanes' latency histograms "
             "(ptexec/ptdtd/ptdev/sched; csrc/pthist.h). Implied by an "
             "active metrics endpoint (--mca metrics_port / metrics_uds) "
             "so /metrics always serves live percentiles", type=bool)

SUB_BITS = 3
SUBS = 1 << SUB_BITS
NBUCKETS = (64 - SUB_BITS + 1) * SUBS          # 496, mirrors pthist.h
_BUCKET_FMT = f"<{NBUCKETS}Q"

#: the histogram names each lane kind exports (hist_snapshot() keys)
HIST_NAMES: Dict[str, Tuple[str, ...]] = {
    "ptexec": ("exec_ns", "ready_wait_ns"),
    # pt_ready_to_done_ns: the per-task lane's ready -> complete (its
    # queue wait in the Python scheduler plus its execution)
    "ptdtd": ("exec_ns", "ready_wait_ns", "pt_ready_to_done_ns"),
    "sched": ("queue_ns",),     # plane push->pop wait
    "ptdev": ("retire_ns",),    # device lane: dispatch -> retire, per task
    # comm lane: rendezvous round trip, send-queue lag of an activation
    "ptcomm": ("rdv_rtt_ns", "act_queue_ns"),
}

#: histograms whose samples grow with the backlog of ready tasks (a DAG's
#: width), not with a stall: a task's whole wait behind the others. The
#: watchdog's p99 trigger leaves them out (a larger DAG is no breach)
BACKLOG_BOUND = frozenset({"ptdtd.pt_ready_to_done_ns"})


def bucket_index(v: int) -> int:
    """Mirror of pthist.h bucket_of() — tested against the C constants."""
    if v < 0:
        v = 0
    if v < SUBS:
        return v
    e = v.bit_length() - 1
    idx = ((e - SUB_BITS + 1) << SUB_BITS) | ((v >> (e - SUB_BITS)) & (SUBS - 1))
    return min(idx, NBUCKETS - 1)


def bucket_lo(i: int) -> int:
    """Smallest value (ns) mapping to bucket ``i``."""
    if i < SUBS:
        return i
    e, m = divmod(i, SUBS)
    return (SUBS + m) << (e - 1)


def bucket_width(i: int) -> int:
    return 1 if i < SUBS else 1 << (i // SUBS - 1)


def bucket_mid(i: int) -> float:
    """The representative value reported for bucket ``i`` (midpoint)."""
    return bucket_lo(i) + bucket_width(i) / 2.0


def decode_buckets(raw: bytes) -> List[int]:
    """The ``hist_snapshot()`` bytes blob -> per-bucket counts."""
    return list(struct.unpack(_BUCKET_FMT, raw))


def percentile(buckets: List[int], q: float,
               total: Optional[int] = None) -> float:
    """The q-quantile (0 < q <= 1) in ns, bucket-midpoint resolution.
    Returns 0.0 for an empty histogram. ``total`` is clamped to the
    bucket mass: a live snapshot copies buckets before the count, so a
    concurrent bump can make the counter exceed the copied cells — an
    unclamped target would then walk off the end and report the top log2
    bucket (~1.7e19 ns) as p999."""
    bsum = sum(buckets)
    total = bsum if total is None else min(total, bsum)
    if total <= 0:
        return 0.0
    target = q * total
    acc = 0
    for i, c in enumerate(buckets):
        acc += c
        if acc >= target:
            return bucket_mid(i)
    return _max_bucket(buckets)


def summarize(buckets: List[int], count: int, sum_ns: int) -> Dict[str, float]:
    """The percentile summary served by /metrics and the counter
    registry (µs — latency numbers humans read)."""
    return {
        "count": count,
        "mean_us": (sum_ns / count / 1e3) if count else 0.0,
        "p50_us": percentile(buckets, 0.50, count) / 1e3,
        "p99_us": percentile(buckets, 0.99, count) / 1e3,
        "p999_us": percentile(buckets, 0.999, count) / 1e3,
        "max_us": _max_bucket(buckets) / 1e3,
    }


def _max_bucket(buckets: List[int]) -> float:
    for i in range(NBUCKETS - 1, -1, -1):
        if buckets[i]:
            return bucket_mid(i)
    return 0.0


class NativeHistograms:
    """Process-wide registry of armed native histogram objects, the
    ``utils/native_trace`` shape: live objects are held strongly for the
    attach window (the C extension types expose no weakrefs) and
    :meth:`detach` — called from the same lifecycle points as the trace
    bridge's detach, so a finished pool's graph is never pinned — folds
    the object's buckets into a per-kind accumulator so /metrics keeps
    reporting completed work."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        # kind -> list of live armed objects (strong refs; see detach)
        self._objs: Dict[str, List[Any]] = {}
        # kind -> name -> [count, sum, buckets] accumulated from detaches
        self._done: Dict[str, Dict[str, list]] = {}
        self._cache: Tuple[float, Optional[Dict[str, Any]]] = (0.0, None)

    # ----------------------------------------------------------- lifecycle
    def attach(self, kind: str, obj: Any) -> bool:
        """Arm ``obj``'s native histograms and track it. Idempotent;
        False when the object predates histograms (older extension)."""
        if not hasattr(obj, "hist_enable"):
            return False
        with self._mu:
            objs = self._objs.setdefault(kind, [])
            if not any(o is obj for o in objs):
                obj.hist_enable()
                objs.append(obj)
            self._cache = (0.0, None)
        return True

    def detach(self, obj: Any) -> None:
        """Fold a finishing object's buckets into the accumulator and
        stop tracking it (its storage may be freed right after)."""
        with self._mu:
            for kind, objs in self._objs.items():
                for i, o in enumerate(objs):
                    if o is obj:
                        try:
                            self._fold_locked(kind, obj.hist_snapshot())
                        except Exception:  # noqa: BLE001 — accounting only
                            pass
                        del objs[i]
                        self._cache = (0.0, None)
                        return

    @staticmethod
    def _merge(acc: Dict[str, list], snap: Dict[str, tuple]) -> None:
        """Fold one ``hist_snapshot()`` result into ``acc`` (the single
        home of the count/sum/per-bucket merge invariant)."""
        for name, (count, sum_ns, raw) in snap.items():
            cur = acc.get(name)
            if cur is None:
                acc[name] = [count, sum_ns, decode_buckets(raw)]
            else:
                cur[0] += count
                cur[1] += sum_ns
                for i, c in enumerate(decode_buckets(raw)):
                    cur[2][i] += c

    def _fold_locked(self, kind: str, snap: Dict[str, tuple]) -> None:
        self._merge(self._done.setdefault(kind, {}), snap)

    # ----------------------------------------------------------- snapshots
    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """``{"<kind>.<hist>": {"count", "sum_ns", "buckets"}}`` summed
        over live + detached objects."""
        out: Dict[str, Dict[str, Any]] = {}
        with self._mu:
            per_kind: Dict[str, Dict[str, list]] = {}
            for kind, acc in self._done.items():
                per_kind[kind] = {n: [v[0], v[1], list(v[2])]
                                  for n, v in acc.items()}
            for kind, objs in self._objs.items():
                for obj in list(objs):
                    try:
                        snap = obj.hist_snapshot()
                    except Exception:  # noqa: BLE001 — torn-down object
                        continue
                    self._merge(per_kind.setdefault(kind, {}), snap)
        for kind, acc in per_kind.items():
            for name, (count, sum_ns, buckets) in acc.items():
                out[f"{kind}.{name}"] = {"count": count, "sum_ns": sum_ns,
                                         "buckets": buckets}
        return out

    def summaries(self, ttl: float = 0.05) -> Dict[str, Dict[str, float]]:
        """Percentile summaries per histogram, TTL-cached: one registry
        sweep samples many ``*.p99_us`` keys and must not pay one full
        bucket walk per key."""
        now = time.monotonic()
        stamp, cached = self._cache
        if cached is not None and now - stamp <= ttl:
            return cached
        out = {name: summarize(d["buckets"], d["count"], d["sum_ns"])
               for name, d in self.snapshot().items()}
        self._cache = (now, out)
        return out

    def reset(self) -> None:
        """Drop accumulated (detached) buckets — bench/test isolation.
        Live objects keep their counts (native buckets never reset)."""
        with self._mu:
            self._done.clear()
            self._cache = (0.0, None)


#: the process-wide registry (Context._hist_attach feeds it)
histograms = NativeHistograms()

_installed = False


def install_hist_counters() -> None:
    """Register ``<kind>.hist.<name>.{count,p50_us,p99_us,p999_us}``
    samplers in the unified counter registry, so live_view, the fini
    aggregation, and /metrics all see latency percentiles under
    canonical names. Idempotent."""
    global _installed
    if _installed:
        return
    from .counters import counters

    def _sampler(key: str, stat: str):
        def sample():
            s = histograms.summaries().get(key)
            return 0 if s is None else s[stat]
        return sample

    for kind, names in HIST_NAMES.items():
        for name in names:
            for stat in ("count", "p50_us", "p99_us", "p999_us"):
                counters.register(f"{kind}.hist.{name}.{stat}",
                                  sampler=_sampler(f"{kind}.{name}", stat))
    _installed = True
