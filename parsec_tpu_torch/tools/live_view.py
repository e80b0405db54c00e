"""Live counter visualization: periodic sampling + rendered time-series.

Re-design of the reference's ``tools/aggregator_visu`` (a demo server
exporting MCA counters plus a matplotlib GUI, ``aggregator.py``): a
background sampler records counters on an interval, and :meth:`render`
draws the series with matplotlib. Headless-friendly (Agg backend) — on a
cluster the PNG lands where a dashboard can poll it, which is the
operations shape of "live GUI".

Three sources:

* **in-process** (default): the unified counter registry of THIS process;
* **cross-process**: pass ``endpoints=[...]`` — one or many rank metrics
  endpoints (``http://127.0.0.1:port`` / ``unix:/path``, served by
  ``tools/metrics_server`` from each rank's Context) — and the sampler
  polls ``/metrics`` over the wire instead, so a real multi-OS-rank run
  reads as one dashboard. With several endpoints the series are prefixed
  ``r<rank>.``; an unreachable endpoint counts into ``poll_errors`` and
  the other ranks keep sampling.
* **mesh**: pass ``mesh_endpoint="http://..."`` — ONE poll of rank 0's
  ``/mesh`` (the pttel tree-aggregated rollup) replaces N per-rank
  fetches: per-rank series (``r<rank>.``) plus the mesh sums (``mesh.``)
  from a single GET, with each rank's push staleness surfaced in
  :meth:`stats` (``mesh_staleness``). A poll while the telemetry plane is
  down counts into ``plane_down``.

Long runs never lose their early history: hitting ``max_samples``
decimates the stored series in half (every other sample dropped, counted
in ``samples_dropped``/``decimations``) instead of silently discarding
new samples, so the series always spans the whole run at a resolution
that degrades gracefully.

Usage::

    from parsec_tpu_torch.tools.live_view import LiveCounterView
    view = LiveCounterView(interval_s=0.05)            # in-process
    view = LiveCounterView(endpoints=["http://127.0.0.1:9130",
                                      "http://127.0.0.1:9131"])
    view.start()
    ... run taskpools ...
    view.stop()
    view.render("counters.png")
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence

from ..utils.counters import counters as default_registry


class LiveCounterView:
    """Sample a CounterRegistry (or remote rank endpoints) on an
    interval; render the series."""

    def __init__(self, registry=None, interval_s: float = 0.1,
                 max_samples: int = 10000,
                 endpoints: Optional[Sequence[str]] = None,
                 mesh_endpoint: Optional[str] = None) -> None:
        self.endpoints = list(endpoints) if endpoints else None
        self.mesh_endpoint = mesh_endpoint
        self.plane_down = 0            # /mesh polls with no plane data
        self.mesh_staleness: Dict[int, float] = {}  # rank -> seconds
        if registry is None and self.endpoints is None \
                and mesh_endpoint is None:
            # default view: make the native lanes visible (ptexec.*,
            # ptdtd.*, trace.* samplers — idempotent registration)
            from ..utils.counters import install_native_counters
            install_native_counters()
        self.registry = registry if registry is not None else default_registry
        self.interval_s = interval_s
        self.max_samples = max(2, max_samples)
        self.times: List[float] = []
        self.series: Dict[str, List[float]] = {}
        self.samples_dropped = 0     # samples discarded by decimation
        self.decimations = 0         # how many times the window halved
        self.poll_errors = 0         # unreachable-endpoint scrapes
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._t0 = None

    # ------------------------------------------------------------- sampling
    def _snapshot_mesh(self) -> Dict[str, float]:
        """One GET of rank 0's /mesh: the whole mesh's per-rank counters
        plus the rollup sums ride a single pushed snapshot — O(1) polls
        regardless of mesh size (the N-fetch mode stays as fallback)."""
        from .metrics_server import fetch
        try:
            m = fetch(self.mesh_endpoint, path="/mesh")
        except Exception:  # noqa: BLE001 — poll again next interval
            self.poll_errors += 1
            return {}
        if m.get("ranks") is None:
            self.plane_down += 1
            return {}
        snap: Dict[str, float] = {}
        staleness: Dict[int, float] = {}
        for r, ent in m["ranks"].items():
            r = int(r)   # JSON object keys arrive as strings
            staleness[r] = float(ent.get("staleness_s") or 0.0)
            for k, v in ent.get("counters", {}).items():
                if isinstance(v, (int, float)):
                    snap[f"r{r}.{k}"] = v
        for k, v in m.get("rollup", {}).items():
            if isinstance(v, (int, float)):
                snap[f"mesh.{k}"] = v
        with self._lock:
            self.mesh_staleness = staleness
        return snap

    def _snapshot(self) -> Dict[str, float]:
        if self.mesh_endpoint is not None:
            return self._snapshot_mesh()
        if self.endpoints is None:
            return {k: v for k, v in self.registry.snapshot().items()
                    if isinstance(v, (int, float))}
        from .metrics_server import fetch
        snap: Dict[str, float] = {}
        many = len(self.endpoints) > 1
        for ep in self.endpoints:
            try:
                m = fetch(ep)
            except Exception:  # noqa: BLE001 — a dead rank must not
                self.poll_errors += 1   # stall the other ranks' series
                continue
            prefix = f"r{m.get('rank', 0)}." if many else ""
            for k, v in m.get("counters", {}).items():
                if isinstance(v, (int, float)):
                    snap[prefix + k] = v
        return snap

    def sample(self) -> None:
        """Record one snapshot (also usable standalone, without start())."""
        snap = self._snapshot()
        now = time.perf_counter()
        with self._lock:
            if self._t0 is None:
                self._t0 = now
            if len(self.times) >= self.max_samples:
                # decimate-in-half: keep every other sample so the series
                # still covers the full run (half resolution) instead of
                # silently freezing at the window edge
                kept = self.times[::2]
                self.samples_dropped += len(self.times) - len(kept)
                self.decimations += 1
                self.times = kept
                for name in self.series:
                    self.series[name] = self.series[name][::2]
            self.times.append(now - self._t0)
            for name, v in snap.items():
                s = self.series.setdefault(name, [0.0] * (len(self.times) - 1))
                s.append(float(v))
            for name, s in self.series.items():
                if len(s) < len(self.times):      # counter appeared late
                    s.extend([s[-1] if s else 0.0] *
                             (len(self.times) - len(s)))

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.sample()

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self.sample()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="parsec-liveview")
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=2.0)
        self._thread = None
        self.sample()

    def stats(self) -> Dict[str, int]:
        """Sampling health: window decimations and endpoint poll errors."""
        with self._lock:
            out = {"samples": len(self.times),
                   "samples_dropped": self.samples_dropped,
                   "decimations": self.decimations,
                   "poll_errors": self.poll_errors}
            if self.mesh_endpoint is not None:
                out["plane_down"] = self.plane_down
                out["mesh_staleness"] = dict(self.mesh_staleness)
            return out

    # ------------------------------------------------------------- rendering
    def active_series(self) -> Dict[str, List[float]]:
        """Counters whose value changed during the observation window."""
        with self._lock:
            return {n: list(s) for n, s in self.series.items()
                    if s and (max(s) != min(s))}

    def render(self, path: str, title: str = "parsec_tpu_torch counters") -> str:
        """Draw the changing counters as time series (PNG/SVG by suffix)."""
        import matplotlib
        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt
        active = self.active_series()
        with self._lock:
            ts = list(self.times)
        fig, ax = plt.subplots(figsize=(9, 4.5))
        if active:
            for name, s in sorted(active.items()):
                ax.plot(ts[:len(s)], s, label=name, linewidth=1.2)
            ax.legend(loc="upper left", fontsize=8)
        else:
            ax.text(0.5, 0.5, "no counter activity", ha="center",
                    transform=ax.transAxes)
        ax.set_xlabel("seconds")
        ax.set_ylabel("count")
        ax.set_title(title)
        fig.tight_layout()
        fig.savefig(path)
        plt.close(fig)
        return path
