"""2-rank serving-fabric harness programs.

Shared by ``tests/test_torch_ptfab.py``, ``tests/test_torch_pttel.py``,
``examples_torch/ex17`` and ``chip_smoke.py`` phase 14, so the acceptance
scenarios — credits on the wire, an antagonist tenant flooding every rank
while a victim tenant's p99 holds, cross-rank shares reconciled to global
weights, the mesh telemetry plane's pushed rollup against each rank's own
counters — are measured by ONE program however they are launched. Lives in
the package (not the test file) because a forked rank must import the
program by module path.

Topology per rank process: a **distributed control context** (the CE mesh
+ native comm lane + TAG_PTFAB plane — what the fabric's credits and
control AMs ride) and a **local serving context** (single-rank, 2 workers)
hosting one plane-bound DTD taskpool per tenant — the serving-tier shape
where each rank runs its own pool instances and the GATEWAY, not a
distributed task graph, spreads the requests. Both are CPU contexts in
:func:`fabric_2rank_program`, :func:`pttel_2rank_program` and
:func:`reclaim_2rank_program`;
:func:`card_serving_2rank_program` serves card work from a card context.

Latency is measured on the SERVING rank per tenant: the ingest handler
stamps arrival, the (single, batch-lane-eligible) body fn pops the stamp —
queue wait + execution under the local plane's arbitration, which is
exactly what tenant isolation protects. Stamps and bodies share one
process, so the clock is coherent.

Bodies are BLAS work with the GIL released, on one BLAS thread per rank
process (:func:`pin_blas_threads`). A body of ``work`` elements dotted is
ONE ``np.dot`` of two n x n float64 matrices with n³ = ``work``: the flop
count of the same number of elements dotted (2 per element). On one
thread that keeps the body times the tuning contracts below are stated
in: ~20 us for the antagonist's 500k, ~1 ms for the share tenants' 25M,
~3 ms for the victim's 75M. The reference's harness burns ``work`` / 500k
dots over a 500k-element vector instead, which takes those times only
spread over many BLAS threads: at OpenBLAS's default thread count the
idle threads spin, and two ranks take most of an eight-core host; on one
thread each dot reads its 4 MB from memory, and the victim's body alone
then takes about as long as the 1/35 s between its probes, so the
victim saturates its rank and both p99s measure a growing queue.
:func:`body_ms` times both forms.
"""

from __future__ import annotations

import ctypes
import os
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

#: set_num_threads entry points of the OpenBLAS builds numpy ships with
_BLAS_SET_THREADS = ("scipy_openblas_set_num_threads64_",
                     "scipy_openblas_set_num_threads",
                     "openblas_set_num_threads64_",
                     "openblas_set_num_threads")


def pin_blas_threads(n: int = 1) -> Optional[str]:
    """Set the thread count of the BLAS numpy loaded in this process;
    returns the entry point that took it, or None when none was found
    (numpy's BLAS is not an OpenBLAS, or not on Linux)."""
    np.dot(np.ones(2), np.ones(2))          # the BLAS library is loaded
    try:
        with open(f"/proc/{os.getpid()}/maps") as f:
            paths = {line.split()[-1] for line in f
                     if "blas" in line.split()[-1].lower()}
    except OSError:
        return None
    for path in sorted(paths):
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            continue
        for name in _BLAS_SET_THREADS:
            fn = getattr(lib, name, None)
            if fn is not None:
                fn(int(n))
                return name
    return None


def burn_operand(work: int) -> np.ndarray:
    """The n x n matrix a body of ``work`` elements dotted multiplies by
    itself (n³ = ``work``)."""
    n = max(1, round(int(work) ** (1 / 3)))
    return np.random.default_rng(n).standard_normal((n, n))


def body_ms(work: int, n: int = 5) -> Dict[str, float]:
    """Median wall milliseconds of one body of ``work`` elements dotted at
    the BLAS thread count in force: as this harness burns it (``product``)
    and as the reference's harness does (``passes``: ``work`` / 500k dots
    over a 500k-element vector)."""
    m, v = burn_operand(work), np.arange(500_000.0)
    reps = max(1, int(work) // 500_000)

    def passes():
        for _ in range(reps):
            np.dot(v, v)

    out = {}
    for name, fn in (("product", lambda: np.dot(m, m)), ("passes", passes)):
        fn()
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = round(float(np.median(times)), 3)
    return out


class _TenantHost:
    """One served tenant on one rank: pool, stamps, latencies.

    ``work`` is the elements dotted per body, burned as ONE ``np.dot`` of
    two n x n matrices (n³ = ``work``) with the GIL released — bodies stay
    honest wall-clock under thread contention instead of measuring GIL
    queueing."""

    def __init__(self, ctx, name: str, window: int, work: int,
                 weight: int = 1) -> None:
        from ..dsl.dtd import READ, DTDTaskpool
        self.name = name
        self.READ = READ
        self.tp = DTDTaskpool(ctx, f"srv-{name}")
        self.tp.admission_window = window
        self.tp.qos_weight = weight
        self.tiles = [self.tp.tile_new((2, 2)) for _ in range(8)]
        self.stamps: "deque[int]" = deque()
        self.lats_ns: List[int] = []
        self.inserted = 0
        self.sheds = 0
        burn = burn_operand(work)
        stamps, lats = self.stamps, self.lats_ns

        def body(x, _b=burn, _s=stamps, _l=lats):
            try:
                t0 = _s.popleft()
            except IndexError:
                t0 = None
            np.dot(_b, _b)
            if t0 is not None:
                _l.append(time.perf_counter_ns() - t0)
            return None

        self.body = body
        # warm-up insert: arms the batch lane + plane registration so
        # tp._sched_pool exists before fabric.serve reads it
        self.tp.insert_task(body, (self.tiles[0], READ), jit=False,
                            name=name)
        self.tp.wait(timeout=60)

    def ingest(self, payload, src) -> None:
        # nowait at the handler: the credit pre-gated this arrival, so an
        # overshoot is only an inbox-race transient — shed it (counted)
        # rather than block the fabric thread behind a full window
        from ..dsl.dtd import AdmissionBackpressure
        try:
            self.tp.insert_task(self.body,
                                (self.tiles[self.inserted % 8], self.READ),
                                jit=False, name=self.name, nowait=True)
        except AdmissionBackpressure:
            self.sheds += 1
            return
        self.stamps.append(time.perf_counter_ns())
        self.inserted += 1

    def served(self, plane) -> int:
        h = self.tp._sched_pool
        return 0 if h is None else plane.pool_stats(h)["served"]


def _p99_us(lats_ns: List[int]) -> Optional[float]:
    if not lats_ns:
        return None
    return round(float(np.percentile(np.asarray(lats_ns), 99)) / 1e3, 1)


def fabric_2rank_program(rank, ce, *, isolation_s: float = 2.0,
                         loaded_s: float = 2.5, shares_s: float = 3.0,
                         window_victim: int = 64, window_ant: int = 8,
                         victim_hz: float = 35.0,
                         work_victim: int = 75_000_000,
                         work_ant: int = 500_000, victim_weight: int = 4,
                         window_shares: int = 1024,
                         work_shares: int = 25_000_000,
                         global_weights=(2.0, 1.0),
                         run_shares: bool = True) -> Dict:
    """The acceptance program. Tenants: ``tv`` (victim) and ``ta``
    (antagonist). Phase 1: victim probes alone (baseline p99). Phase 2:
    the antagonist floods EVERY rank through the gateway while the
    victim keeps its fixed rate (loaded p99 + backpressure evidence).
    Phase 3 (optional): both tenants flood while the rank-0 reconciler
    converges cross-rank shares to the global weights.

    Tuning contract (isolation): the victim body (~3 ms of GIL-released
    BLAS) DOMINATES the worst-case antagonist burst ahead of
    it. The burst bound is NOT just window_ant: nowait admission reads
    plane inflight, which updates at batch FLUSH, so up to flush_n
    (= dtd_window_size // 2) specs ride ahead of the window check — the
    harness pins dtd_window_size to 64 (flush_n 32), giving a worst-case
    burst of ~(32 + 8) x 20 us << the victim body. The antagonist still
    saturates (tiny window, arrival > service), so rejects flow.

    Tuning contract (shares): DRR weights bind only on pools whose
    backlog exceeds BOTH weight x quantum and the drain's pop cap
    (Context._dtd_drain pops 256 — a smaller backlog is simply drained
    whole, making served track ARRIVAL). Phase 3 therefore floods two
    DEDICATED tenants with ~1 ms equal-cost bodies behind big windows
    (1024), pinned dtd window_size out of the way, so the plane's
    arbitration — nudged by the reconciler — is what the measured
    shares reflect."""
    import sys
    import threading

    body_default = body_ms(work_victim)
    blas = pin_blas_threads(1)
    # GIL re-acquire after each GIL-released BLAS pass must not wait a
    # full default 5 ms switch interval behind the flood/control threads
    sys.setswitchinterval(5e-4)
    from ..comm.remote_dep import RemoteDepEngine
    from ..core.context import Context
    from ..serving.fabric import FAB_STATS, ServingFabric
    from ..serving.gateway import IngestGateway
    from ..serving.reconcile import ShareReconciler
    from ..tools.metrics_server import MetricsServer
    from ..utils import mca

    # small flush threshold (see the tuning contract above), a small DRR
    # quantum (weights must bind on window-bounded backlogs), and the
    # DEDICATED rde progress thread (this context has no workers to
    # drive TAG_PTFAB AM delivery implicitly)
    mca.set("dtd_window_size", 64)
    mca.set("sched_quantum", 4)
    mca.set("comm_thread", True)
    nb_ranks = ce.nb_ranks
    ctx_d = Context(nb_cores=1, device="cpu", my_rank=rank,
                    nb_ranks=nb_ranks)
    rde = RemoteDepEngine(ctx_d, ce)
    lane = rde.native
    if lane is None:
        ce.sync()
        ctx_d.fini()
        ce.fini()
        return {"fabric": False, "reason": "native comm lane down"}
    # start the CONTROL context now: comm.enable() spawns the rde
    # progress thread, which is what delivers TAG_PTFAB AMs (no
    # distributed taskpool ever registers here to do it implicitly)
    ctx_d.start()
    # nb_cores=2 = ONE background worker thread (streams[0] is the
    # master, driven only inside wait): the single-worker drain keeps
    # the DRR arbitration model exact on a 2-core CI host
    ctx_l = Context(nb_cores=2, device="cpu")
    plane = ctx_l.sched_plane
    if plane is None:
        ce.sync()
        ctx_l.fini()
        ctx_d.fini()
        ce.fini()
        return {"fabric": False, "reason": "scheduler plane down"}

    fab_before = FAB_STATS.snapshot()
    fab = ServingFabric(lane.comm, plane, rank, nb_ranks, rde=rde,
                        lane=lane)
    tv = _TenantHost(ctx_l, "tv", window_victim, work_victim,
                     weight=victim_weight)
    ta = _TenantHost(ctx_l, "ta", window_ant, work_ant)
    fab.serve("tv", handler=tv.ingest, taskpool=tv.tp)
    fab.serve("ta", handler=ta.ingest, taskpool=ta.tp)
    ctx_l.start()                      # the serving worker drains from here
    ms = MetricsServer(rank=rank, nb_ranks=nb_ranks, port=0).start()
    fab.announce_endpoint(ms.endpoint)
    gw = IngestGateway(fab)
    ce.sync()
    # one replenish round has certainly run by now (5 ms cadence); the
    # first submits may still stall briefly until grants land — counted

    out: Dict = {"fabric": True, "rank": rank, "blas_threads_set": blas,
                 "victim_body_ms": {"default_threads": body_default,
                                    "one_thread": body_ms(work_victim)}}
    cpu0 = time.process_time()

    # ---- phase 1: victim alone --------------------------------------
    def victim_probe(seconds: float) -> int:
        n, t_end = 0, time.monotonic() + seconds
        period = 1.0 / victim_hz
        nxt = time.monotonic()
        while time.monotonic() < t_end:
            gw.submit("tv", {"n": n})
            n += 1
            nxt += period
            time.sleep(max(0.0, nxt - time.monotonic()))
        return n

    # BOTH ranks probe: twice the p99 samples, and rank asymmetry (the
    # probe thread's own CPU cost) averages out of the merged bound
    out["victim_probes_base"] = victim_probe(isolation_s)
    ce.sync()
    # settle: let queued victim tasks finish before snapshotting
    tv.tp.wait(timeout=60)
    base_lats = list(tv.lats_ns)
    tv.lats_ns.clear()
    out["victim_p99_us_unloaded"] = _p99_us(base_lats)
    out["victim_lats_base_ns"] = base_lats
    ce.sync()

    # ---- phase 2: antagonist floods every rank ----------------------
    stop = threading.Event()
    rejects = [0]

    def antagonist() -> None:
        from ..dsl.dtd import AdmissionBackpressure
        n = 0
        while not stop.is_set():
            try:
                gw.submit("ta", {"n": n}, nowait=True)
                n += 1
            except AdmissionBackpressure:
                rejects[0] += 1
                time.sleep(2e-4)
            except (RuntimeError, TimeoutError):
                break

    flood = threading.Thread(target=antagonist, daemon=True,
                             name="ptfab-antagonist")
    flood.start()
    out["victim_probes_load"] = victim_probe(loaded_s)
    stop.set()
    flood.join(timeout=10)
    ce.sync()
    tv.tp.wait(timeout=120)
    load_lats = list(tv.lats_ns)
    tv.lats_ns.clear()
    out["victim_p99_us_loaded"] = _p99_us(load_lats)
    out["victim_lats_load_ns"] = load_lats
    out["antagonist_rejects"] = rejects[0]
    out["antagonist_served"] = ta.served(plane)
    ce.sync()

    # ---- phase 3: share reconciliation under dual flood -------------
    # dedicated tenants (see the shares tuning contract): equal ~1 ms
    # bodies, big windows so the backlog exceeds the drain's pop cap and
    # the plane's (reconciler-nudged) arbitration is what shares measure
    hosts = {"tv": tv, "ta": ta}
    if run_shares:
        sv = _TenantHost(ctx_l, "sv", window_shares, work_shares)
        sa = _TenantHost(ctx_l, "sa", window_shares, work_shares)
        for h in (sv, sa):
            h.tp.window_size = 1 << 20     # the dtd inserter-drain stall
                                           # must not cap the backlog
            fab.serve(h.name, handler=h.ingest, taskpool=h.tp)
        hosts.update({"sv": sv, "sa": sa})
        ce.sync()
        rec = None
        if rank == 0:
            deadline = time.monotonic() + 15
            while len(fab.endpoints) < nb_ranks and \
                    time.monotonic() < deadline:
                time.sleep(5e-3)
            eps = [fab.endpoints[r] for r in sorted(fab.endpoints)]
            rec = ShareReconciler(
                fab, eps, {"sv": global_weights[0],
                           "sa": global_weights[1]},
                period=0.25, gain=0.6, scale=4).start()
        stop2 = threading.Event()

        def flood_tenant(name: str) -> None:
            from ..dsl.dtd import AdmissionBackpressure
            n = 0
            while not stop2.is_set():
                try:
                    gw.submit(name, {"n": n}, nowait=True)
                    n += 1
                except AdmissionBackpressure:
                    time.sleep(2e-4)
                except (RuntimeError, TimeoutError):
                    break

        floods = [threading.Thread(target=flood_tenant, args=(t,),
                                   daemon=True) for t in ("sv", "sa")]
        for th in floods:
            th.start()
        # measurement window = the SECOND half, after the reconciler has
        # had rounds to bite; synchronized by ce.sync on both edges
        time.sleep(shares_s / 2)
        ce.sync()
        mid = {"sv": sv.served(plane), "sa": sa.served(plane)}
        time.sleep(shares_s / 2)
        ce.sync()
        end = {"sv": sv.served(plane), "sa": sa.served(plane)}
        stop2.set()
        for th in floods:
            th.join(timeout=10)
        if rec is not None:
            rec.stop()
            out["reconcile_rounds"] = rec.rounds
            out["share_err_pct_last"] = rec.last_err_pct
        out["shares_window"] = {t: end[t] - mid[t] for t in end}
        out["weight_adjusts"] = plane.stats().get("weight_adjusts", 0)
        out["weights_now"] = {
            h.name: plane.pool_stats(h.tp._sched_pool)["weight"]
            if h.tp._sched_pool is not None else None
            for h in (sv, sa)}
        ce.sync()

    # ---- teardown + evidence ----------------------------------------
    # the fabric stops FIRST (after the sync above proved every rank
    # quit producing): a straggler gateway insert delivered after
    # tp.close() would be an insert into a closed pool
    fab.fini()
    for host in hosts.values():
        host.tp.wait(timeout=120)
        host.tp.close()
    ctx_l.wait(timeout=120)
    out["cpu_s"] = round(time.process_time() - cpu0, 2)
    s = lane.comm.stats()
    out["wire"] = {k: s[k] for k in
                   ("creds_granted_tx", "creds_granted_rx", "creds_spent",
                    "creds_returned_tx", "creds_reclaimed",
                    "cred_frames_tx", "cred_frames_rx", "frame_errors",
                    "acts_tx", "acts_rx")}
    out["fab_stats"] = FAB_STATS.delta(fab_before)
    out["routed"] = dict(gw.routed)
    out["sheds"] = {h.name: h.sheds for h in hosts.values()}
    out["ingested"] = {h.name: h.inserted for h in hosts.values()}
    out["wall_s"] = round(isolation_s + loaded_s +
                          (shares_s if run_shares else 0.0), 2)
    ce.sync()
    ms.stop()
    ctx_l.fini()
    ctx_d.fini()
    ce.fini()
    return out


#: the counters the 2-rank acceptance program compares, rollup against
#: each rank's own registry: what every tenant's plane pool served
SERVED_KEYS = ("ptfab.served.",)
#: the card leg's: its tenant is a fabric-owned KIND_EXT pool whose
#: requests run in the handler and retire through ``done``, never popped
#: from the plane, so its ``ptfab.served.gemm`` stays 0 (as in the
#: reference); the routed inserts each rank sent and received count them
CARD_SERVED_KEYS = ("ptfab.served.", "ptfab.remote_inserts_")


def _served_counters(keys=SERVED_KEYS,
                     nonzero: bool = False) -> Dict[str, float]:
    """This process's registry values of the ``keys`` families (its own
    truth); with ``nonzero``, only the cells that ever left 0 (a counter
    that never moved sends no delta, so the rollup has no cell for it)."""
    from ..utils.counters import counters
    return {k: v for k, v in counters.snapshot().items()
            if k.startswith(keys) and (v or not nonzero)}


def _settled_rollup(tel, nb_ranks: int, interval_ms: int,
                    keys=SERVED_KEYS, timeout: float = 15.0) -> Dict:
    """Rank 0, every rank quiesced and flushed: wait until the pushed
    rollup's columns of the ``keys`` families cover every rank and stop
    moving (the background pusher keeps folding), then report both the
    per-rank columns and the gauge-safe mesh sums."""
    def served_view():
        roll = tel.rollup()
        return {r: {k: v for k, v in ent["counters"].items()
                    if k.startswith(keys)}
                for r, ent in roll["ranks"].items()}
    deadline = time.monotonic() + timeout
    prev = None
    while time.monotonic() < deadline:
        cur = served_view()
        if len(cur) == nb_ranks and cur == prev:
            break
        prev = cur
        time.sleep(max(0.1, 3 * interval_ms / 1e3))
    roll = tel.rollup()
    return {"rollup_served": {k: v for k, v in roll["rollup"].items()
                              if k.startswith(keys)},
            "per_rank_served": served_view(),
            "staleness_s": {r: ent["staleness_s"]
                            for r, ent in roll["ranks"].items()},
            "ranks_seen": sorted(roll["ranks"]),
            "depth": roll["depth"]}


def pttel_2rank_program(rank, ce, *, load_s: float = 1.2,
                        tel_interval_ms: int = 25,
                        watchdog_stall_ms: int = 500,
                        stall: bool = False,
                        flight_dir: str = "") -> Dict:
    """The mesh telemetry plane's acceptance program (2 OS ranks): the
    pttel push plane under real serving load.

    Both ranks serve two tenants and feed them through the gateway for
    ``load_s``; the telemetry plane pushes counter deltas up the tree the
    whole time. After quiescing, rank 0 waits for the pushed rollup to
    settle and reports BOTH views of every ``ptfab.served.*`` counter — the
    rolled-up value and each rank's own registry value travels back in the
    per-rank results — so the caller can assert the tree-aggregated numbers
    equal the per-rank truth exactly. Rank 0 also runs push-mode reconciler
    rounds and reports the ``reconcile.*`` deltas (the zero-HTTP-fetch
    contract).

    With ``stall=True`` rank 1 injects a never-drained KIND_EXT plane pool
    under its (already armed) watchdog and waits for detection: exactly
    one attributed flight record must land in ``flight_dir``. Rank 0's
    watchdog runs the whole time WITHOUT an injected stall — its clean
    ``watchdog.*`` counters are the zero-false-positive evidence under real
    load. Both contexts of a rank are CPU contexts; bodies are one
    ``np.dot`` on one BLAS thread (:func:`pin_blas_threads`)."""
    import glob

    pin_blas_threads(1)
    from ..comm.pttel import TEL_STATS
    from ..comm.remote_dep import RemoteDepEngine
    from ..core.context import Context
    from ..core.watchdog import WATCHDOG_STATS
    from ..dsl.dtd import AdmissionBackpressure
    from ..serving.fabric import ServingFabric
    from ..serving.gateway import IngestGateway
    from ..serving.reconcile import RECONCILE_STATS, ShareReconciler
    from ..tools.metrics_server import MetricsServer
    from ..utils import mca

    mca.set("dtd_window_size", 64)
    mca.set("sched_quantum", 4)
    mca.set("comm_thread", True)
    mca.set("tel_interval_ms", tel_interval_ms)
    mca.set("tel_fanout", 2)
    mca.set("watchdog_stall_ms", watchdog_stall_ms)
    if flight_dir:
        mca.set("flight_dir", flight_dir)
    nb_ranks = ce.nb_ranks
    ctx_d = Context(nb_cores=1, device="cpu", my_rank=rank,
                    nb_ranks=nb_ranks)
    rde = RemoteDepEngine(ctx_d, ce)
    lane = rde.native
    tel = rde.telemetry
    if lane is None or tel is None:
        ce.sync()
        ctx_d.fini()
        ce.fini()
        return {"telemetry": False,
                "reason": "native comm lane down" if lane is None
                else "telemetry plane not built"}
    ctx_d.start()                       # rde progress + telemetry pusher up
    ctx_l = Context(nb_cores=2, device="cpu")   # watchdog arms (mca above)
    plane = ctx_l.sched_plane
    if plane is None:
        ce.sync()
        ctx_l.fini()
        ctx_d.fini()
        ce.fini()
        return {"telemetry": False, "reason": "scheduler plane down"}
    fab = ServingFabric(lane.comm, plane, rank, nb_ranks, rde=rde,
                        lane=lane)
    tv = _TenantHost(ctx_l, "tv", 256, 1_000_000, weight=2)
    ta = _TenantHost(ctx_l, "ta", 256, 500_000)
    fab.serve("tv", handler=tv.ingest, taskpool=tv.tp)
    fab.serve("ta", handler=ta.ingest, taskpool=ta.tp)
    ctx_l.start()
    ms = MetricsServer(rank=rank, nb_ranks=nb_ranks, port=0).start()
    fab.announce_endpoint(ms.endpoint)
    gw = IngestGateway(fab)
    rec_before = RECONCILE_STATS.snapshot()
    ce.sync()

    out: Dict = {"telemetry": True, "rank": rank}

    # ---- load phase: both tenants, modest rate, every rank ----------
    t_end = time.monotonic() + load_s
    n = 0
    while time.monotonic() < t_end:
        for t in ("tv", "ta"):
            try:
                gw.submit(t, {"n": n}, nowait=True)
            except AdmissionBackpressure:
                pass
            except (RuntimeError, TimeoutError):
                break
        n += 1
        time.sleep(2e-3)
    ce.sync()
    for host in (tv, ta):
        host.tp.wait(timeout=120)

    # ---- push-mode reconciler rounds (rank 0) -----------------------
    # the serve counters are frozen now (load done), so the interesting
    # assertions are mechanical: rounds ran off the pushed rollup with
    # ZERO per-round HTTP fetches
    if rank == 0:
        deadline = time.monotonic() + 15
        while len(fab.endpoints) < nb_ranks and \
                time.monotonic() < deadline:
            time.sleep(5e-3)
        eps = [fab.endpoints[r] for r in sorted(fab.endpoints)]
        rec = ShareReconciler(fab, eps, {"tv": 2.0, "ta": 1.0},
                              period=0.05, tel="auto")
        for _ in range(6):
            rec.step()
            time.sleep(max(0.06, 2 * tel_interval_ms / 1e3))
        out["reconcile"] = RECONCILE_STATS.delta(rec_before)
        out["reconcile_mode"] = rec.last_mode
    ce.sync()

    # ---- quiesced rollup-vs-truth comparison ------------------------
    out["served_local"] = _served_counters()
    tel.flush()
    if rank == 0:
        out.update(_settled_rollup(tel, nb_ranks, tel_interval_ms))
    ce.sync()

    # ---- forced stall (rank 1 only, when asked) ---------------------
    wd = ctx_l.watchdog
    out["watchdog_armed"] = wd is not None
    if stall and rank == 1 and wd is not None:
        before = WATCHDOG_STATS.snapshot()
        h = plane.register_pool("stall-inject", plane.KIND_EXT,
                                weight=1, window=0)
        if h >= 0:
            plane.admit(h, 4)           # held work that never drains
        t0 = time.monotonic()
        deadline = t0 + 4 * watchdog_stall_ms / 1e3
        while WATCHDOG_STATS["pool_stalls"] <= before["pool_stalls"] \
                and time.monotonic() < deadline:
            time.sleep(watchdog_stall_ms / 1e3 / 20)
        detected_ms = round((time.monotonic() - t0) * 1e3, 1)
        # the counter ticks BEFORE the watchdog thread finishes writing
        # the dump: give the file its own (bounded) wait
        nrec = 0
        while flight_dir and time.monotonic() < deadline + 2.0:
            nrec = len(glob.glob(f"{flight_dir}/flight-r*-*.json"))
            if nrec:
                break
            time.sleep(0.02)
        out["stall"] = {
            "detected_ms": detected_ms,
            "watchdog": WATCHDOG_STATS.delta(before),
            "flight_records": nrec,
        }
        if h >= 0:
            plane.unregister_pool(h)
    ce.sync()

    # ---- teardown + evidence ----------------------------------------
    fab.fini()
    for host in (tv, ta):
        host.tp.wait(timeout=120)
        host.tp.close()
    ctx_l.wait(timeout=120)
    s = lane.comm.stats()
    out["frame_errors"] = s["frame_errors"]
    out["tel_stats"] = TEL_STATS.snapshot()
    out["watchdog_stats"] = WATCHDOG_STATS.snapshot()
    ce.sync()
    ms.stop()
    ctx_l.fini()
    ctx_d.fini()
    ce.fini()
    return out


def reclaim_2rank_program(rank, ce, *, window: int = 32) -> Dict:
    """Peer-death containment, with REAL processes: rank 0 serves a
    windowed tenant, grants credits, then dies mid-window (hard
    ``os._exit`` from a timer — no BYE, no teardown); rank 1 must
    observe reclaim — spendable balance zeroed, a blocking acquire
    RAISES instead of hanging — with no leaked window. (The in-process
    variant in tests/test_torch_ptfab.py covers the target-side ledger
    release.)"""
    import threading

    from ..comm.remote_dep import RemoteDepEngine
    from ..core.context import Context
    from ..serving.fabric import ServingFabric, tenant_id_for

    ctx_d = Context(nb_cores=1, device="cpu", my_rank=rank,
                    nb_ranks=ce.nb_ranks)
    rde = RemoteDepEngine(ctx_d, ce)
    lane = rde.native
    if lane is None:
        ce.sync()
        ctx_d.fini()
        ce.fini()
        return {"fabric": False}
    ctx_l = Context(nb_cores=1, device="cpu")
    fab = ServingFabric(lane.comm, ctx_l.sched_plane, rank, ce.nb_ranks,
                        rde=rde, lane=lane)
    if rank == 0:
        # serve + grant, then report the result and die WITHOUT teardown
        # shortly after (the timer fires once the return value is safely
        # on the parent's queue, which a loaded host can take most of a
        # second to flush): mid-window death, credits outstanding
        fab.serve("tx", handler=lambda p, s: None, window=window,
                  weight=1)
        ce.sync()                         # rank 1 sees us up
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            s = lane.comm.stats()
            if s["creds_granted_tx"] > 0 and s["out_pending"] == 0:
                break
            time.sleep(2e-3)
        time.sleep(0.2)                   # grants definitely on the wire
        granted = lane.comm.stats()["creds_granted_tx"]
        threading.Timer(3.0, os._exit, args=(0,)).start()
        return {"fabric": True, "role": "target", "granted": granted}
    # rank 1: the inserter
    ce.sync()
    deadline = time.monotonic() + 30
    while fab.avail(0, "tx") <= 0 and time.monotonic() < deadline:
        time.sleep(2e-3)
    avail_before = fab.avail(0, "tx")
    # spend a few locally while the peer is alive or dying — spends
    # against a positive balance never block and never touch the wire
    spent = 0
    while spent < min(4, avail_before) and fab.comm.cred_take(
            0, fab._pool_id("tx"), tenant_id_for("tx"), 1):
        spent += 1
    # a blocking acquire that can NEVER be satisfied must raise once the
    # death is detected (containment), not hang to its timeout
    t0 = time.monotonic()
    try:
        fab.acquire(0, "tx", n=10**6, timeout=60)
        outcome = "acquired"
    except RuntimeError:
        outcome = "raised"
    except TimeoutError:
        outcome = "timeout"
    waited = time.monotonic() - t0
    out = {"fabric": True, "role": "inserter",
           "avail_before": avail_before, "spent": spent,
           "outcome": outcome, "waited_s": round(waited, 2),
           "avail_after": fab.avail(0, "tx"),
           "dead": sorted(fab._dead)}
    fab.fini()
    ctx_l.fini()
    # the dead peer makes polite ctx_d/ce teardown moot; the parent
    # reaps this rank after it reports
    return out


def card_serving_2rank_program(rank, ce, *, requests: int = 64,
                               window: int = 16, ts: int = 512,
                               kt: int = 32, device: str = "cuda",
                               seed: int = 0,
                               tel_interval_ms: int = 0) -> Dict:
    """The fabric serving card work: rank 0 serves tenant ``gemm`` from a
    CARD control context (a context with the CUDA device module, whose
    scheduler plane is up), rank 1 sends ``requests`` requests through an
    :class:`~parsec_tpu_torch.serving.gateway.IngestGateway`.

    Rank 0 comes up through :meth:`ServingFabric.attach` on its control
    context and serves the tenant through a fabric-owned ``KIND_EXT``
    plane pool (``serve(tenant, handler=..., window=...)``, no taskpool):
    each routed request's handler inserts one bf16 ``GEMM_K`` task (C
    ``ts``², ``kt`` steps: the ``gemm_chain`` kernel on a card) into a DTD
    pool of a second card context, and the main thread retires each
    finished task through :meth:`ServingFabric.done`, which reopens the
    window the replenisher grants credits from. Rank 1 spends one credit a
    request and stalls (counted) when the balance runs out.

    With ``tel_interval_ms`` > 0 the mesh telemetry plane pushes while the
    requests are served: once every request is retired, each rank reports
    its own nonzero :data:`CARD_SERVED_KEYS` values (``served_local``),
    rank 0 waits for the pushed rollup to settle and reports it beside them,
    and runs reconciler rounds off the rollup (``reconcile``,
    ``reconcile_mode``), which must make no HTTP fetch.

    ``device="cpu"`` rehearses it on the CPU with the CUDA device module
    over the CPU (``--mca device_cuda_over_cpu``), at cut sizes."""
    import torch

    pin_blas_threads(1)
    from ..comm.remote_dep import RemoteDepEngine
    from ..core.context import Context
    from ..core.task import DEV_CUDA
    from ..data.matrix import collection_from_numpy
    from ..dsl.dtd import AFFINITY, READ, RW, DTDTaskpool
    from ..ops import cuda_kernels as K
    from ..ops.gemm import _gemm_chain_body
    from ..serving.fabric import FAB_STATS, ServingFabric
    from ..serving.gateway import IngestGateway
    from ..serving.reconcile import RECONCILE_STATS, ShareReconciler
    from ..utils import mca

    mca.set("comm_thread", True)
    mca.set("device_load_balance_allow_cpu", False)
    mca.set("tel_interval_ms", tel_interval_ms)
    serving = rank == 0
    if serving and device == "cpu":
        mca.set("device_cuda_over_cpu", True)
    elif serving:
        # two card contexts in this process beside the caller's on the one
        # card: each gets a tile budget of its own
        mca.set("device_cuda_max_bytes", 2 << 30)
    ctx_d = Context(nb_cores=1, device=device if serving else "cpu",
                    my_rank=rank, nb_ranks=ce.nb_ranks)
    tel = RemoteDepEngine(ctx_d, ce).telemetry
    ctx_d.start()
    fab_before = FAB_STATS.snapshot()
    fab = ServingFabric.attach(ctx_d)
    out: Dict = {
        "rank": rank, "fabric": fab is not None,
        "card_context": any(d.type & DEV_CUDA
                            for d in ctx_d.devices.devices),
        "plane": ctx_d.sched_plane is not None,
        "telemetry": tel is not None}

    def telemetry_settle() -> None:
        """Both ranks, every request retired: push this rank's served
        counts, and at rank 0 read them back out of the settled rollup and
        run reconciler rounds off it (two barriers)."""
        out["served_local"] = _served_counters(CARD_SERVED_KEYS,
                                               nonzero=True)
        tel.flush()
        ce.sync()
        if rank == 0:
            rec_before = RECONCILE_STATS.snapshot()
            rec = ShareReconciler(fab, [], {"gemm": 1.0}, period=0.05,
                                  tel="auto")
            for _ in range(4):
                rec.step()
                time.sleep(max(0.06, 2 * tel_interval_ms / 1e3))
            out["reconcile"] = RECONCILE_STATS.delta(rec_before)
            out["reconcile_mode"] = rec.last_mode
            out.update(_settled_rollup(tel, ce.nb_ranks, tel_interval_ms,
                                       CARD_SERVED_KEYS))
        ce.sync()

    if fab is None:
        # the other rank's barriers
        for _ in range(5 if tel is not None else 3):
            ce.sync()
        ctx_d.fini()
        ce.fini()
        return out
    if serving:
        ctx_l = Context(nb_cores=2, device=device)
        tp = DTDTaskpool(ctx_l, "card-gemm")
        # small integers: every float32 partial sum is exact, so the
        # per-step bf16 rounding is deterministic and the served tiles
        # must equal the plain chain of the same tiles bit for bit
        rng = np.random.default_rng(seed)
        a = rng.integers(-4, 5, (ts, ts * kt)).astype(np.float32)
        b = rng.integers(-4, 5, (ts * kt, ts)).astype(np.float32)
        A = collection_from_numpy("A", a, ts, ts, dtype=torch.bfloat16)
        B = collection_from_numpy("B", b, ts, ts, dtype=torch.bfloat16)
        C = collection_from_numpy(
            "C", np.zeros((ts, ts * requests), np.float32), ts, ts,
            dtype=torch.bfloat16)
        gemm_k = _gemm_chain_body(kt)
        ab = [(tp.tile_of(A, 0, k), READ) for k in range(kt)] + \
            [(tp.tile_of(B, k, 0), READ) for k in range(kt)]
        arrivals: List[float] = []

        def handler(payload, src) -> None:
            arrivals.append(time.perf_counter())
            tp.insert_task(gemm_k, (tp.tile_of(C, 0, int(payload["i"])),
                                    RW | AFFINITY), *ab, name="GEMM_K")

        launches0 = K.gemm_chain.launches
        routes0 = dict(K.gemm_chain.launches_by_route)
        fab.serve("gemm", handler=handler, window=window)
        ctx_l.start()
        ce.sync()                         # the gateway may submit now
        retired, t_last = 0, None
        deadline = time.monotonic() + 300
        while retired < requests and time.monotonic() < deadline:
            done = tp.executed
            if done > retired:
                fab.done("gemm", done - retired)
                retired, t_last = done, time.perf_counter()
            time.sleep(2e-4)
        tp.wait(timeout=60)
        tp.close()
        ctx_l.wait(timeout=60)
        if device != "cpu":
            torch.cuda.synchronize()
        t = fab.tenant("gemm")
        pool = fab.plane.pool_stats(t.handle)
        a16 = torch.from_numpy(a).to(torch.bfloat16)
        b16 = torch.from_numpy(b).to(torch.bfloat16)
        tiles = torch.from_numpy(C.to_dense()).to(torch.bfloat16)
        tiles = tiles.reshape(ts, requests, ts).transpose(0, 1)
        dev = torch.device(device)
        plain = K.gemm_chain_plain(
            torch.zeros(ts, ts, dtype=torch.bfloat16, device=dev),
            a16.reshape(ts, kt, ts).transpose(0, 1).contiguous().to(dev),
            b16.reshape(kt, ts, ts).contiguous().to(dev)).cpu()
        # the same bf16 tiles' product in float32
        ref = torch.matmul(a16.float(), b16.float())
        err = (tiles[-1].float() - ref).abs()
        out.update({
            "role": "server", "served": retired,
            "launches": K.gemm_chain.launches - launches0,
            "launches_by_route": {
                r: n - routes0[r]
                for r, n in K.gemm_chain.launches_by_route.items()},
            "served_per_s": round(retired / (t_last - arrivals[0]), 2)
            if retired and t_last and t_last > arrivals[0] else None,
            "pool_inflight": pool.get("inflight"),
            "pool_window": pool.get("window"),
            "tiles_equal_plain": bool(all(torch.equal(x, plain)
                                          for x in tiles)),
            "max_err_rel": float(err.max() / ref.abs().max()),
            "norm_err_rel": float(err.norm() / ref.norm()),
            "plain_max_err_rel": float((plain.float() - ref).abs().max()
                                       / ref.abs().max())})
        ce.sync()                         # every request retired
        if tel is not None:
            telemetry_settle()
        fab.fini()
        ctx_l.fini()
    else:
        gw = IngestGateway(fab, ranks=[0])
        ce.sync()
        t0 = time.perf_counter()
        for i in range(requests):
            gw.submit("gemm", {"i": i}, timeout=120)
        out["submit_s"] = round(time.perf_counter() - t0, 4)
        out["routed"] = dict(gw.routed)
        ce.sync()
        if tel is not None:
            telemetry_settle()
        s = fab.comm_stats()
        out["wire"] = {k: s.get(k, 0) for k in
                       ("creds_granted_rx", "creds_spent",
                        "cred_frames_rx", "frame_errors")}
        fab.fini()
    out["fab_stats"] = FAB_STATS.delta(fab_before)
    if serving:
        s = fab.comm.stats()
        out["wire"] = {k: s.get(k, 0) for k in
                       ("creds_granted_tx", "cred_frames_tx",
                        "frame_errors")}
    ce.sync()
    ctx_d.fini()
    ce.fini()
    return out
