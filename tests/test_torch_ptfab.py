"""The port's cross-rank serving fabric (``parsec_tpu_torch/serving/``): the
reference's ``tests/test_ptfab.py`` on the port's extensions and CPU
contexts, and cross-checks through both packages.

Four layers, mirroring how the fabric is built:

* **wire protocol units** — two ``_ptcomm.Comm`` objects joined by a
  socketpair, pumped synchronously: the K_CRED frame codec (grants,
  returns, reclaim idempotence, wire counters, EV_FAB trace points) and
  the ptsched remote-window/set_weight entries;
* **fabric harness** — in-process ServingFabric pairs driven by
  :meth:`step`: replenishment from retire-driven headroom,
  ``AdmissionBackpressure`` nowait -> retry semantics, credit reclaim on
  peer death without a hang or a leaked window, and headroom-aware
  gateway routing across a 3-rank mesh;
* **2-OS-rank legs** — the acceptance program
  (:mod:`parsec_tpu_torch.serving.harness`): antagonist flood vs victim
  p99, cross-rank share reconciliation, real-process peer death;
* **observability** — ptfab.* counters through the counter registry.

Cross-checks: the same in-process scenario through both packages (equal
FAB_STATS deltas, wire counters and routing decisions); on a context with
an accelerator device module (the port's CUDA module over the CPU, the
reference's TPU module on JAX's CPU) the plane is up, two weighted PTG
pools drain in the same DRR order, and ``ServingFabric.attach`` comes up
in both.

Program functions live in ``parsec_tpu_torch.serving.harness`` so a
forked rank can import them. Every multiprocess job holds the port's job
lock; none takes the reference package's, whose own jobs wait for it
inside their time limits.
"""

import functools
import socket
import struct
import time

import numpy as np
import pytest

from parsec_tpu_torch import native as native_mod
from parsec_tpu_torch.comm.tcp import run_distributed_procs

_ptcomm = native_mod.load_ptcomm()
_ptsched = native_mod.load_ptsched()

POOL, TEN = 4242, 7


def _pair():
    a, b = socket.socketpair()
    c0 = _ptcomm.Comm(0, 2)
    c1 = _ptcomm.Comm(1, 2)
    c0.add_peer_fd(1, a.fileno())
    c1.add_peer_fd(0, b.fileno())
    return c0, c1, a, b


def _pump(*comms, iters=3):
    for _ in range(iters):
        for c in comms:
            c.pump(2)


# ----------------------------------------------------------- wire protocol

def test_cred_grant_take_return_roundtrip():
    c0, c1, a, b = _pair()
    c0.cred_grant(1, POOL, TEN, 16)
    assert c0.cred_outstanding(1, POOL, TEN) == 16
    _pump(c0, c1)
    assert c1.cred_avail(0, POOL, TEN) == 16
    # spends are LOCAL: no new frames cross the wire
    frames_before = c0.stats()["cred_frames_tx"]
    assert c1.cred_take(0, POOL, TEN, 10)
    assert not c1.cred_take(0, POOL, TEN, 10)     # balance 6 < 10
    assert c1.cred_take(0, POOL, TEN)             # default n=1
    _pump(c0, c1)
    assert c0.stats()["cred_frames_tx"] == frames_before
    # return the remainder; the granting side's ledger shrinks
    assert c1.cred_return(0, POOL, TEN, 100) == 5
    _pump(c1, c0)
    assert c0.cred_outstanding(1, POOL, TEN) == 11   # 16 - 5 returned
    s0, s1 = c0.stats(), c1.stats()
    assert s0["creds_granted_tx"] == 16 and s1["creds_granted_rx"] == 16
    assert s1["creds_spent"] == 11
    assert s1["creds_returned_tx"] == 5 and s0["creds_returned_rx"] == 5
    assert s0["frame_errors"] == s1["frame_errors"] == 0
    c0.stop(); c1.stop(); a.close(); b.close()


def test_cred_reclaim_idempotent_and_consume_floor():
    c0, c1, a, b = _pair()
    c0.cred_grant(1, POOL, TEN, 8)
    c0.cred_grant(1, POOL + 1, TEN, 4)
    _pump(c0, c1)
    # an arrival consumes from the outstanding ledger, flooring at 0
    assert c0.cred_consume(1, POOL, TEN, 3) == 3
    assert c0.cred_consume(1, POOL, TEN, 100) == 5
    assert c0.cred_consume(1, POOL, TEN, 1) == 0
    rec, dropped = c0.cred_reclaim(1)
    assert sorted(rec) == [(POOL + 1, TEN, 4)]
    assert dropped == 0
    assert c0.cred_reclaim(1) == ([], 0)          # idempotent
    # the inserter side drops its unspendable balance on ITS reclaim
    assert c1.cred_take(0, POOL, TEN, 2)
    rec1, dropped1 = c1.cred_reclaim(0)
    assert rec1 == [] and dropped1 == 6 + 4       # 8-2 spent + 4
    assert c1.cred_avail(0, POOL, TEN) == 0
    c0.stop(); c1.stop(); a.close(); b.close()


def test_cred_frame_traced_and_malformed_contained():
    """EV_FAB points record on both ends; a malformed K_CRED (nonzero
    body / zero count) is counted and contained."""
    c0, c1, a, b = _pair()
    c0.trace_enable(4096)
    c1.trace_enable(4096)
    c0.cred_grant(1, POOL, TEN, 3)
    _pump(c0, c1)
    c1.cred_return(0, POOL, TEN, 1)
    _pump(c1, c0)

    def _keys(comm):
        evs = []
        for _ring, blob in comm.trace_drain():
            for off in range(0, len(blob), 24):
                t, i, k, f = struct.unpack_from("<qqII", blob, off)
                evs.append((k, i))
        return evs

    ev0, ev1 = _keys(c0), _keys(c1)
    assert (_ptcomm.EV_FAB_CRED_TX, 3) in ev0      # grant out
    assert (_ptcomm.EV_FAB_CRED_RX, 3) in ev1      # grant in
    assert (_ptcomm.EV_FAB_CRED_TX, -1) in ev1     # return out (negative)
    assert (_ptcomm.EV_FAB_CRED_RX, -1) in ev0
    # malformed: a K_CRED with a body / a zero count
    hdr = struct.Struct("<IBBHIIQ")
    a.sendall(hdr.pack(0, 1, 0, 0, 0, 0, 0x7074636F6D6D0001))  # hello
    a.sendall(hdr.pack(4, 8, 0, 0, POOL, TEN, 5) + b"oops")
    a.sendall(hdr.pack(0, 8, 0, 0, POOL, TEN, 0))
    time.sleep(0.05)
    c1.pump(4)
    s1 = c1.stats()
    assert s1["frame_errors"] == 2
    assert c1.cred_avail(0, POOL, TEN) == 2        # 3 - 1 returned, no junk
    c0.stop(); c1.stop(); a.close(); b.close()


# --------------------------------------------------- plane remote windows

def test_plane_remote_window_shares_budget():
    ps = _ptsched
    pl = ps.Plane(nworkers=1)
    h = pl.register_pool(ext_id=1, kind=ps.KIND_EXT, window=10)
    assert pl.headroom(h) == 10
    pl.admit(h, 4)
    pl.remote_grant(h, 3)
    assert pl.headroom(h) == 3
    assert not pl.over_window(h)
    pl.remote_grant(h, 4)                 # 4 + 7 > 10
    assert pl.over_window(h) and pl.headroom(h) == 0
    pl.remote_release(h, 100)             # floors at 0, never negative
    assert pl.remote_granted(h) == 0 and pl.headroom(h) == 6
    assert pl.pool_stats(h)["remote_granted"] == 0
    hu = pl.register_pool(ext_id=2, kind=ps.KIND_EXT)
    assert pl.headroom(hu) == -1          # unlimited sentinel


def test_plane_set_weight_binds_on_next_round():
    ps = _ptsched
    pl = ps.Plane(nworkers=1, policy=ps.POLICY_WDRR, quantum=64)
    a = pl.register_pool(ext_id=1, kind=ps.KIND_EXT, weight=1)
    b = pl.register_pool(ext_id=2, kind=ps.KIND_EXT, weight=1)
    pl.set_weight(a, 3)
    assert pl.pool_stats(a)["weight"] == 3
    assert pl.stats()["weight_adjusts"] == 1
    served = {a: 0, b: 0}
    nxt = {a: 0, b: 0}
    for h in (a, b):
        pl.push(h, list(range(4096)))
        nxt[h] = 4096
    for _ in range(300):
        for p, _t in pl.pop(worker=0, kind=ps.KIND_EXT, cap=64):
            served[p] += 1
        for h in (a, b):
            q = pl.queued(h)
            if q < 2048:
                pl.push(h, list(range(nxt[h], nxt[h] + 4096 - q)))
                nxt[h] += 4096 - q
    ratio = served[a] / max(1, served[b])
    assert abs(ratio - 3.0) / 3.0 < 0.25, (served, ratio)


# ------------------------------------------------------- fabric harness

def _mk_fabrics(nranks=2, windows=None, weight=1, pkg=None):
    """nranks in-process fabrics joined by socketpair meshes, each with
    its own SchedPlane; fabric i serves tenant 'T' iff windows[i] is
    not None. ``pkg`` is the package (the port by default). Returns
    (fabrics, comms, socks)."""
    import importlib
    pkg = pkg or "parsec_tpu_torch"
    ptcomm = importlib.import_module(f"{pkg}.native").load_ptcomm()
    ptsched = importlib.import_module(f"{pkg}.native").load_ptsched()
    SchedPlane = importlib.import_module(f"{pkg}.core.sched_plane").SchedPlane
    ServingFabric = importlib.import_module(f"{pkg}.serving").ServingFabric
    comms = [ptcomm.Comm(r, nranks) for r in range(nranks)]
    socks = []
    for i in range(nranks):
        for j in range(i + 1, nranks):
            a, b = socket.socketpair()
            comms[i].add_peer_fd(j, a.fileno())
            comms[j].add_peer_fd(i, b.fileno())
            socks += [a, b]
    fabs = []
    for r in range(nranks):
        sp = SchedPlane(ptsched, 1, "wdrr")
        fab = ServingFabric(comms[r], sp, r, nranks, replenish=False)
        fabs.append(fab)
    for r, fab in enumerate(fabs):
        fab.insert_transport = functools.partial(
            lambda dst, hdr, payload, _src: fabs[dst].on_fab(
                _src, hdr, payload), _src=r)
        w = windows[r] if windows else None
        if w is not None:
            fab.serve("T", handler=lambda p, src: None, window=w,
                      weight=weight)
    return fabs, comms, socks


def _step_all(fabs, comms, rounds=3):
    for _ in range(rounds):
        for fab in fabs:
            fab.step()
        _pump(*comms)


def _teardown(fabs, comms, socks):
    for f in fabs:
        f.fini()
    for c in comms:
        c.stop()
    for s in socks:
        try:
            s.close()
        except OSError:
            pass


def test_fabric_nowait_reject_then_retry_succeeds():
    """The nowait -> retry contract end to end: exhaust the remote
    balance, see AdmissionBackpressure + the reject counter, let the
    target retire work (headroom reopens, replenishment grants), then
    the SAME nowait acquire succeeds."""
    from parsec_tpu_torch.dsl.dtd import AdmissionBackpressure
    from parsec_tpu_torch.serving.fabric import FAB_STATS
    fabs, comms, socks = _mk_fabrics(2, windows=[8, None])
    f0, f1 = fabs
    try:
        _step_all(fabs, comms)
        line = f1.avail(0, "T")
        assert line > 0
        for _ in range(line):             # drain the whole balance
            f1.acquire(0, "T", nowait=True)
        before = FAB_STATS.snapshot()
        with pytest.raises(AdmissionBackpressure):
            f1.acquire(0, "T", nowait=True)
        assert FAB_STATS.delta(before)["remote_rejects"] == 1
        # simulate the spends arriving + completing at the target: the
        # window reopens, the replenisher re-grants, the retry succeeds
        for _ in range(line):
            f0.on_fab(1, {"k": "insert", "t": "T"}, None)
        f0.done("T", line)
        _step_all(fabs, comms)
        assert f1.avail(0, "T") > 0
        f1.acquire(0, "T", nowait=True)   # the retry
        # zero hot-path round trips: spends outnumber credit frames
        s1 = comms[1].stats()
        assert s1["creds_spent"] > s1["cred_frames_rx"] > 0
    finally:
        _teardown(fabs, comms, socks)


def test_fabric_peer_death_reclaims_without_hang_or_leak():
    """The target dies mid-window. Inserter side — the balance is dropped
    and a BLOCKING acquire raises promptly (no hang). Target side
    (symmetric death) — outstanding grants release their window
    reservation (no leaked window: headroom returns to full)."""
    fabs, comms, socks = _mk_fabrics(2, windows=[16, None])
    f0, f1 = fabs
    try:
        _step_all(fabs, comms)
        t = f0.tenant("T")
        assert f1.avail(0, "T") > 0
        granted = f0.plane.plane.remote_granted(t.handle)
        assert granted > 0
        # kill the link from under both ends (the mid-window death):
        # shutdown, not close — the Comm holds a dup of the fd, and only
        # shutdown() tears the CONNECTION down across every dup
        for s in socks:
            s.shutdown(socket.SHUT_RDWR)
            s.close()
        _pump(*comms)                      # EOF -> broken peer
        assert 1 in comms[0].stats()["broken_peers"]
        # inserter: blocking acquire must RAISE once death is seen
        t0 = time.monotonic()
        with pytest.raises(RuntimeError):
            f1.acquire(0, "T", n=10**6, timeout=30)
        assert time.monotonic() - t0 < 5, "acquire hung on a dead peer"
        assert f1.avail(0, "T") == 0
        # target: reclaim releases the reservation — no leaked window
        f0.step()
        assert f0.plane.plane.remote_granted(t.handle) == 0
        assert f0.plane.headroom(t.handle) == 16
        assert f0.comm_stats()["creds_reclaimed"] == granted
        # idempotent: another round reclaims nothing more
        f0.step()
        assert f0.comm_stats()["creds_reclaimed"] == granted
    finally:
        _teardown(fabs, comms, socks)


def test_gateway_routes_by_advertised_headroom():
    """3-rank mesh: ranks 0+1 serve tenant T (small vs large window),
    rank 2 is a pure gateway. Routing follows the credit balances —
    most inserts land on the roomy rank — and when EVERY balance is
    exhausted the gateway raises under nowait."""
    from parsec_tpu_torch.dsl.dtd import AdmissionBackpressure
    from parsec_tpu_torch.serving import IngestGateway
    fabs, comms, socks = _mk_fabrics(3, windows=[4, 64, None])
    f0, f1, f2 = fabs
    try:
        _step_all(fabs, comms)
        gw = IngestGateway(f2, ranks=[0, 1])
        assert gw.headroom_of(1, "T") > gw.headroom_of(0, "T") > 0
        landed = []
        f0.tenant("T").handler = lambda p, src: landed.append(0)
        f1.tenant("T").handler = lambda p, src: landed.append(1)
        total = gw.headroom_of(0, "T") + gw.headroom_of(1, "T")
        for i in range(total):
            gw.submit("T", {"i": i}, nowait=True)
        # every advertised credit spent, nothing retired or replenished
        # yet: the NEXT nowait submit is hard backpressure
        with pytest.raises(AdmissionBackpressure):
            gw.submit("T", {"i": -1}, nowait=True)
        _step_all(fabs, comms)             # deliver the insert AMs
        assert len(landed) == total
        assert landed.count(1) > landed.count(0) > 0, landed
        assert sum(gw.routed.values()) == total
    finally:
        _teardown(fabs, comms, socks)


def _fabric_scenario(pkg):
    """One deterministic in-process scenario on ``pkg``'s fabric, driven
    by step(): a 3-rank mesh (windows 4 and 64, rank 2 a pure gateway),
    submits until every balance is spent, a rejected submit, retires on
    both serving ranks, replenishment, more submits, a blocking acquire
    satisfied by replenishment, and a returned balance. Returns the
    FAB_STATS delta, every rank's credit counters, the routing decisions
    and the landed inserts."""
    import importlib
    serving = importlib.import_module(f"{pkg}.serving")
    backpressure = importlib.import_module(f"{pkg}.dsl.dtd") \
        .AdmissionBackpressure
    before = serving.FAB_STATS.snapshot()
    fabs, comms, socks = _mk_fabrics(3, windows=[4, 64, None], pkg=pkg)
    f0, f1, f2 = fabs
    landed = []
    try:
        f0.tenant("T").handler = lambda p, src: landed.append((0, p["i"]))
        f1.tenant("T").handler = lambda p, src: landed.append((1, p["i"]))
        _step_all(fabs, comms)
        gw = serving.IngestGateway(f2, ranks=[0, 1])
        decisions, rejects, i = [], 0, 0
        retired = {0: 0, 1: 0}
        for _round in range(3):
            while True:
                try:
                    decisions.append(gw.submit("T", {"i": i}, nowait=True))
                    i += 1
                except backpressure:
                    rejects += 1
                    break
            _step_all(fabs, comms)       # deliver the inserts
            for r, f in ((0, f0), (1, f1)):
                n = sum(1 for x in landed if x[0] == r)
                f.done("T", n - retired[r])
                retired[r] = n
            _step_all(fabs, comms)       # replenish
        f2.acquire(1, "T", n=2)
        returned = f2.release(1, "T", 3)
        _step_all(fabs, comms)
        keys = ("creds_granted_tx", "creds_granted_rx", "creds_spent",
                "creds_returned_tx", "creds_returned_rx",
                "creds_reclaimed", "cred_frames_tx", "cred_frames_rx",
                "frame_errors")
        wire = [{k: c.stats()[k] for k in keys} for c in comms]
        headrooms = [f0.headroom("T"), f1.headroom("T")]
        return {"fab": serving.FAB_STATS.delta(before), "wire": wire,
                "decisions": decisions, "rejects": rejects,
                "landed": sorted(landed), "returned": returned,
                "headrooms": headrooms, "routed": dict(gw.routed)}
    finally:
        _teardown(fabs, comms, socks)


def test_fabric_scenario_matches_the_reference():
    """The same step()-driven scenario through both packages: equal
    FAB_STATS deltas, equal C-side credit counters on every rank, equal
    gateway routing decisions and landed inserts."""
    ref = _fabric_scenario("parsec_tpu")
    port = _fabric_scenario("parsec_tpu_torch")
    assert port["decisions"] and port["rejects"] == 3
    assert port["wire"][2]["creds_spent"] > 0
    assert port == ref


# ----------------------------------------------------------- 2-OS-rank legs

def test_two_rank_antagonist_isolation_and_shares():
    """The acceptance scenario with real processes: the antagonist
    floods both ranks through the gateway; the victim's p99 stays
    within 2x of its unloaded p99; remote backpressure engaged with
    zero hot-path round trips (spends local, verified by wire
    counters); and the reconciled cross-rank shares converge within
    25% of the global 2:1 weights.

    The p99 leg is LOAD-SENSITIVE (a p99 over ~200 samples is near
    max-of-samples, and OS scheduling noise can hit the two phases
    asymmetrically), so it follows the bounded-retry discipline: a
    systematic isolation failure violates the bound on EVERY attempt; a
    host-load flap does not survive three."""
    from parsec_tpu_torch.serving.harness import fabric_2rank_program
    attempts = []
    for attempt in range(3):
        res = run_distributed_procs(
            2, functools.partial(fabric_2rank_program), timeout=300)
        for r in res:
            assert r.get("fabric"), r.get("reason")
            assert r["blas_threads_set"] is not None
        # --- these hold on EVERY attempt (engagement, not timing) ---
        # the antagonist actually flooded and actually hit the wall
        assert sum(r["antagonist_rejects"] for r in res) > 0
        assert sum(r["antagonist_served"] for r in res) > 0
        # zero hot-path round trips: spends dwarf credit frames
        for r in res:
            w = r["wire"]
            assert w["creds_spent"] > 0
            assert w["cred_frames_rx"] < \
                w["creds_spent"] + w["creds_granted_rx"]
            assert w["frame_errors"] == 0
        assert sum(r["wire"]["creds_granted_tx"] for r in res) > 0
        # cross-rank share convergence (measured over the second half)
        sv = sum(r["shares_window"]["sv"] for r in res)
        sa = sum(r["shares_window"]["sa"] for r in res)
        assert sv > 0 and sa > 0
        ratio = sv / sa
        assert abs(ratio - 2.0) / 2.0 < 0.25, \
            f"cross-rank shares {sv}:{sa} (ratio {ratio:.2f}) vs " \
            f"weights 2:1"
        assert res[0]["reconcile_rounds"] > 0
        for r in res:
            assert r["weight_adjusts"] > 0   # nudges on BOTH ranks
        # --- the load-sensitive p99 bound (bounded retry) ---
        base = [x for r in res for x in r["victim_lats_base_ns"]]
        load = [x for r in res for x in r["victim_lats_load_ns"]]
        assert len(base) > 40 and len(load) > 40, \
            (len(base), len(load))
        p99b = float(np.percentile(np.asarray(base), 99))
        p99l = float(np.percentile(np.asarray(load), 99))
        attempts.append((p99b, p99l))
        if p99l <= 2.0 * p99b:
            return
    assert False, \
        "victim p99 moved past 2x of unloaded on every attempt: " + \
        ", ".join(f"{b / 1e3:.0f}us -> {l / 1e3:.0f}us"
                  for b, l in attempts)


def test_reference_program_on_one_blas_thread_queues_its_victim(
        monkeypatch):
    """Why the port's bodies are matrix products: the reference's own
    acceptance program, with numpy's BLAS held to one thread a rank (as
    the port's ranks pin it), keeps its victim waiting past the 1/35 s
    between its probes at p99 before any antagonist floods. Each of its
    victim's bodies, 150 dots over a 500k-element vector, then takes about
    that interval, so the victim saturates its rank and a p99 bound on it
    measures a growing queue rather than isolation; the port keeps the
    reference's ~3 ms body on one thread by burning the same flops as one
    product. The reference's ranks run through its own process launcher
    (without its job lock, as this file's other jobs)."""
    from parsec_tpu.comm import tcp as ref_tcp
    from parsec_tpu.serving.harness import fabric_2rank_program as ref_prog
    monkeypatch.setenv("OPENBLAS_NUM_THREADS", "1")   # the spawned ranks'
    res = ref_tcp._run_distributed_procs_once(
        2, functools.partial(ref_prog, run_shares=False), timeout=300)
    assert all(r.get("fabric") for r in res), [r.get("reason") for r in res]
    base = [x for r in res for x in r["victim_lats_base_ns"]]
    assert len(base) > 40, len(base)
    p99b = float(np.percentile(np.asarray(base), 99))
    print(f"the reference's program on one BLAS thread: victim p99 "
          f"unloaded {p99b / 1e6:.1f} ms ({len(base)} probes), loaded "
          f"{[r['victim_p99_us_loaded'] for r in res]} us by rank")
    assert p99b > 1e9 / 35, \
        f"the reference's victim p99 unloaded {p99b / 1e6:.1f} ms"


def test_two_rank_target_death_reclaims():
    """Real-process peer death: the serving rank hard-exits mid-window;
    the inserter's blocking acquire raises promptly (no hang) and its
    balance is reclaimed."""
    from parsec_tpu_torch.serving.harness import reclaim_2rank_program
    res = run_distributed_procs(
        2, functools.partial(reclaim_2rank_program), timeout=240)
    target, inserter = res
    assert target.get("fabric") and inserter.get("fabric")
    assert target["granted"] > 0
    assert inserter["avail_before"] > 0
    assert inserter["outcome"] == "raised", inserter
    assert inserter["waited_s"] < 30, inserter
    assert inserter["avail_after"] == 0
    assert 0 in inserter["dead"]


# ------------------------------------------ the plane on a card context

_DRR_SRC = ("%global NT\n%global LOG\n%global TAG\n"
            "T(i)\n  i = 0 .. NT-1\nBODY\n  LOG.append(TAG)\nEND\n")


def _drr_runs(pkg):
    """Two PTG pools (weights 3 and 1, 2000 independent tasks each) on one
    worker of a context with an accelerator device module: the runs of
    the order their bodies ran in."""
    import importlib
    pt = importlib.import_module(pkg)
    mca = importlib.import_module(f"{pkg}.utils.mca")
    compile_ptg = importlib.import_module(
        f"{pkg}.dsl.ptg.compiler").compile_ptg
    card = "device_cuda_over_cpu" if pkg == "parsec_tpu_torch" \
        else "device_tpu_over_cpu"
    mca.set(card, True)
    mca.set("ptg_agglomerate", False)
    try:
        ctx = pt.Context(nb_cores=1, **(
            {"device": "cpu"} if pkg == "parsec_tpu_torch" else {}))
        try:
            kinds = {type(d).__name__ for d in ctx.devices.devices}
            assert kinds & {"CUDADevice", "TPUDevice"}, kinds
            assert ctx.sched_plane is not None
            log = []
            prog = compile_ptg(_DRR_SRC, "drr")
            for tag, w in (("a", 3), ("b", 1)):
                tp = prog.instantiate(
                    ctx, globals={"NT": 2000, "LOG": log, "TAG": tag},
                    collections={}, name=f"drr-{tag}")
                tp.qos_weight = w
                ctx.add_taskpool(tp)
            ctx.wait(timeout=120)
        finally:
            ctx.fini()
    finally:
        mca.params.unset(card)
        mca.params.unset("ptg_agglomerate")
    runs = []
    for t in log:
        if runs and runs[-1][0] == t:
            runs[-1][1] += 1
        else:
            runs.append([t, 1])
    return runs


def test_weighted_ptg_pools_drain_in_the_references_drr_order_on_a_card_context():
    """A context with an accelerator device module has a scheduler plane,
    and two weighted PTG pools bind to it: they drain in the same DRR
    order through both packages — weight 3 served three quanta for each
    of weight 1's while both are backlogged."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    port = _drr_runs("parsec_tpu_torch")
    ref = _drr_runs("parsec_tpu")
    assert port == ref
    assert port[:4] == [["a", 768], ["b", 256], ["a", 768], ["b", 256]]


def _attach_ranks(pkg):
    """Two TCP ranks as threads of this process, each on a context with an
    accelerator device module, attached through ServingFabric.attach: rank
    0 serves tenant T, rank 1 routes 6 requests to it through a gateway.
    Returns each rank's outcome."""
    import importlib
    import threading
    pt = importlib.import_module(pkg)
    mca = importlib.import_module(f"{pkg}.utils.mca")
    tcp = importlib.import_module(f"{pkg}.comm.tcp")
    RemoteDepEngine = importlib.import_module(
        f"{pkg}.comm.remote_dep").RemoteDepEngine
    serving = importlib.import_module(f"{pkg}.serving")
    card = "device_cuda_over_cpu" if pkg == "parsec_tpu_torch" \
        else "device_tpu_over_cpu"
    kw = {"device": "cpu"} if pkg == "parsec_tpu_torch" else {}
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    rdv = ("127.0.0.1", s.getsockname()[1])
    s.close()
    out = [{}, {}]

    def rank(r):
        ce = tcp.TCPCE(r, 2, rdv)
        ctx = pt.Context(nb_cores=1, my_rank=r, nb_ranks=2, **kw)
        RemoteDepEngine(ctx, ce)
        ctx.start()
        fab = serving.ServingFabric.attach(ctx)
        o = out[r]
        o.update(devices=sorted(type(d).__name__
                                for d in ctx.devices.devices),
                 plane=ctx.sched_plane is not None, up=fab is not None)
        got = []
        if fab is not None and r == 0:
            fab.serve("T", handler=lambda p, src: got.append(p["i"]),
                      window=4)
        ce.sync()
        if fab is not None and r == 1:
            gw = serving.IngestGateway(fab, ranks=[0])
            o["routed"] = [gw.submit("T", {"i": i}, timeout=60)
                           for i in range(6)]
        if fab is not None and r == 0:
            retired, deadline = 0, time.monotonic() + 60
            while len(got) < 6 and time.monotonic() < deadline:
                if len(got) > retired:
                    fab.done("T", len(got) - retired)
                    retired = len(got)
                time.sleep(1e-3)
            o["got"] = sorted(got)
        ce.sync()
        if fab is not None:
            fab.fini()
        ctx.fini()
        ce.fini()

    mca.set(card, True)
    mca.set("comm_thread", True)
    before = serving.FAB_STATS.snapshot()
    try:
        threads = [threading.Thread(target=rank, args=(r,), daemon=True)
                   for r in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        mca.params.unset(card)
        mca.params.unset("comm_thread")
    d = serving.FAB_STATS.delta(before)
    return out, {k: d[k] for k in ("fabrics_up", "fabrics_unavailable",
                                   "tenants_served", "remote_inserts_tx",
                                   "remote_inserts_rx")}


def test_fabric_attaches_on_a_card_context_in_both_packages():
    """ServingFabric.attach comes up on a context with an accelerator
    device module (the port's CUDA module over the CPU, the reference's
    TPU module on JAX's CPU) — its plane is up — and a gateway routes
    requests to it, with the same outcome in both packages."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    port, port_fab = _attach_ranks("parsec_tpu_torch")
    ref, ref_fab = _attach_ranks("parsec_tpu")
    assert port_fab == ref_fab == {
        "fabrics_up": 2, "fabrics_unavailable": 0, "tenants_served": 1,
        "remote_inserts_tx": 6, "remote_inserts_rx": 6}
    assert "CUDADevice" in port[0]["devices"]
    assert "TPUDevice" in ref[0]["devices"]
    for res in (port, ref):
        assert all(r["plane"] and r["up"] for r in res), res
        assert res[0]["got"] == list(range(6))
        assert res[1]["routed"] == [0] * 6
    strip = [{k: v for k, v in r.items() if k != "devices"} for r in port]
    assert strip == [{k: v for k, v in r.items() if k != "devices"}
                     for r in ref]


# ------------------------------------------------------------ observability

def test_ptfab_counters_exported():
    from parsec_tpu_torch.utils.counters import (counters,
                                                 install_native_counters)
    install_native_counters()
    snap = counters.snapshot()
    for key in ("ptfab.credits_granted", "ptfab.credits_spent",
                "ptfab.credits_reclaimed", "ptfab.remote_stalls",
                "ptfab.remote_rejects", "ptfab.reconcile_rounds",
                "ptfab.share_err_pct", "ptfab.fabrics_up",
                "reconcile.scrape_rounds", "costmodel.gain_adapted"):
        assert key in snap, key


def test_served_counter_registers_per_tenant():
    from parsec_tpu_torch.core.sched_plane import SchedPlane
    from parsec_tpu_torch.serving import ServingFabric
    from parsec_tpu_torch.utils.counters import counters
    c = _ptcomm.Comm(0, 2)
    sp = SchedPlane(_ptsched, 1, "wdrr")
    fab = ServingFabric(c, sp, 0, 2, replenish=False)
    try:
        fab.serve("acct-42", handler=lambda p, s: None, window=4)
        assert counters.read("ptfab.served.acct-42") == 0
        h = fab.tenant("acct-42").handle
        sp.plane.push(h, [1, 2, 3])
        while sp.plane.pop(worker=0, kind=_ptsched.KIND_EXT, cap=8):
            pass
        assert counters.read("ptfab.served.acct-42") == 3
    finally:
        fab.fini()
        c.stop()


def test_chip_smoke_serving_phase_rehearses_on_the_cpu(monkeypatch):
    """Phase 14 of ``chip_smoke.py`` — (a) the wire and plane units, (b)
    the 2-rank acceptance program with the reference's bounds, (c) the
    peer-death leg, (d) the card leg with the CUDA device module over the
    CPU — with every gate that does not need the card, (b) at cut
    durations and (d) at a cut tile size."""
    import chip_smoke as CS

    import parsec_tpu_torch as ptt
    monkeypatch.setattr(CS, "FAB_KW", dict(isolation_s=1.5, loaded_s=1.5,
                                           shares_s=2.0))
    monkeypatch.setattr(CS, "FAB_CARD_KW", dict(requests=16, window=8,
                                                ts=128))
    card = CS.serving_fabric(ptt, "cpu", device="cpu")
    assert card["served"] == 16 and card["launches"] == 0
    assert card["tiles_equal_plain"] and card["card_context"]
