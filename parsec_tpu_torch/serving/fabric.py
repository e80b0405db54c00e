"""The cross-rank serving fabric.

A multi-tenant control plane layered on the native comm lane (ptcomm) and
the scheduler plane (ptsched): the per-rank QoS weights, admission windows
and backpressure of the plane made to span the ranks. Three cooperating
pieces live in this package:

* **credit-based remote admission** (this module): a rank serving a
  tenant grants admission credits to every remote inserter over the wire
  (the ``K_CRED`` frame beside ACTS — layout in ``csrc/ptcomm_iface.h``);
  a remote insert then SPENDS a credit locally (``Comm.cred_take``, one
  map op, zero wire round trips on the hot path) and blocks or raises
  :class:`~parsec_tpu_torch.dsl.dtd.AdmissionBackpressure` when the
  balance is exhausted. Grants are replenished from the target pool's
  retire-driven headroom (``Plane.headroom``: window − inflight −
  remote_granted, so local and remote admission share ONE budget) and
  reclaimed on peer death through ptcomm's containment surface
  (``broken_peers`` + ``cred_reclaim``) — no hung inserter, no leaked
  window.
* **mesh-wide share reconciliation**
  (:mod:`parsec_tpu_torch.serving.reconcile`): a rank-0 control loop
  scraping the per-rank ``/metrics`` served counters and nudging each
  rank's local DRR weights through ``Plane.set_weight`` — no global lock
  anywhere near the hot path.
* **headroom-aware ingest gateway**
  (:mod:`parsec_tpu_torch.serving.gateway`): load-balances inserts across
  ranks by the credits it already holds — the advertised admission
  headroom — so a loaded rank sheds ingest to its peers without a probe.

The fabric is the CONTROL plane: credits gate insertion, the inserted
work itself rides whatever lane its pool rides (a card context's DTD
pool runs its tasks on the card). Engagement is counted (``FAB_STATS``),
declines are honest, and every wire counter exports as ``ptfab.*``
through the counter registry.
"""

from __future__ import annotations

import threading
import time
import zlib
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import weakref

from ..utils import mca, output
from ..utils.counters import LaneStats

mca.register("fab_enabled", True,
             "Arm the cross-rank serving fabric (ptfab) when a native "
             "comm lane and a scheduler plane are both up; 0 keeps "
             "admission rank-local", type=bool)
mca.register("fab_credit_line", 0,
             "Per-(tenant, peer) credit line the replenisher maintains: "
             "grants top each remote inserter's spendable balance back "
             "up to this many credits as the target pool retires work. "
             "0 = auto: window // (2 * npeers) for bounded pools (half "
             "the window is reserved for remote ingest), 64 for "
             "unlimited pools", type=int)
mca.register("fab_replenish_ms", 5.0,
             "Cadence of the fabric's replenish/containment round "
             "(credit top-ups, inbox drain, dead-peer reclaim)",
             type=float)
mca.register("fab_acquire_timeout", 30.0,
             "Seconds a BLOCKING remote acquire waits for credits before "
             "raising (a dead target is detected earlier via reclaim)",
             type=float)

#: engagement + outcome counters (the engagement-counter contract of the
#: lanes). ``share_err_pct`` is a gauge, not a counter: the latest
#: reconciliation round's max per-tenant share error, pushed to every
#: rank with the weight nudges so each /metrics endpoint exports it.
FAB_STATS = LaneStats(fabrics_up=0, fabrics_unavailable=0,
                      tenants_served=0, remote_stalls=0, remote_rejects=0,
                      remote_inserts_tx=0, remote_inserts_rx=0,
                      reconcile_rounds=0, share_err_pct=0,
                      peer_reclaims=0)

#: C-side wire counters exported as ``ptfab.<name>`` (summed across the
#: live fabrics' comm lanes — the ptcomm.* sampler pattern)
FAB_WIRE_KEYS = {"credits_granted": "creds_granted_tx",
                 "credits_received": "creds_granted_rx",
                 "credits_spent": "creds_spent",
                 "credits_returned": "creds_returned_tx",
                 "credits_reclaimed": "creds_reclaimed",
                 "cred_frames_tx": "cred_frames_tx",
                 "cred_frames_rx": "cred_frames_rx"}

_fabrics: "weakref.WeakSet[ServingFabric]" = weakref.WeakSet()


def fab_wire_sampler(comm_key: str):
    """Registry sampler summing one ptcomm credit counter over live
    fabrics (each fabric's lane TTL-caches its stats() snapshot)."""
    def sample():
        total = 0
        for fab in list(_fabrics):
            try:
                total += fab.comm_stats().get(comm_key, 0)
            except Exception:  # noqa: BLE001 — a torn-down fabric reads 0
                pass
        return total
    return sample


def tenant_id_for(name: str) -> int:
    """Rank-consistent tenant ids, the pool_id_for discipline: derived
    from the NAME so every rank keys the same (pool, tenant) ledger."""
    return zlib.crc32(name.encode()) & 0x7FFFFFFF


class _Tenant:
    """One served tenant on this rank: plane identity + ingest handler."""

    __slots__ = ("name", "tid", "pool_id", "handle", "owns_handle",
                 "handler", "taskpool", "credit_line")

    def __init__(self, name: str, tid: int, pool_id: int, handle: int,
                 owns_handle: bool, handler, taskpool, credit_line: int):
        self.name = name
        self.tid = tid
        self.pool_id = pool_id
        self.handle = handle
        self.owns_handle = owns_handle
        self.handler = handler
        self.taskpool = taskpool
        self.credit_line = credit_line


class ServingFabric:
    """One rank's serving fabric: credit ledgers + replenisher + ingest.

    Two construction modes:

    * :meth:`attach` — the production path: built from a live
      distributed :class:`~parsec_tpu_torch.core.context.Context` whose
      native comm lane and scheduler plane are up (declines are counted);
    * direct — the harness path: tests hand a raw ``_ptcomm.Comm`` pair
      (socketpair-pumped) and a plane, drive :meth:`step` manually.
    """

    def __init__(self, comm, plane, my_rank: int, nb_ranks: int, *,
                 rde=None, lane=None, replenish: bool = True) -> None:
        self.comm = comm
        self.plane = plane            # SchedPlane (may be None: no QoS)
        self.my_rank = my_rank
        self.nb_ranks = nb_ranks
        self.rde = rde
        self.lane = lane              # NativeCommLane (stats TTL cache)
        self._tenants: Dict[str, _Tenant] = {}
        self._by_key: Dict[Tuple[int, int], _Tenant] = {}
        #: peers' /metrics endpoints (announce_endpoint exchange): how
        #: the rank-0 reconciler discovers its scrape targets
        self.endpoints: Dict[int, str] = {}
        #: harness-mode insert transport: (dst, hdr, payload) callable
        #: standing in for the CE AM plane when no rde is attached
        self.insert_transport: Optional[Callable] = None
        self._lock = threading.Lock()
        self._inbox: "deque[Tuple[int, Dict, Any]]" = deque()
        self._dead: set = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._up = True
        FAB_STATS["fabrics_up"] += 1
        _fabrics.add(self)
        if rde is not None:
            rde.fab_attach(self)
        if replenish:
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name=f"ptfab-replenish-r{my_rank}")
            self._thread.start()

    # ------------------------------------------------------------ creation
    @classmethod
    def attach(cls, ctx) -> Optional["ServingFabric"]:
        """Build the fabric on a live distributed context, or None with
        the decline COUNTED (lane down, plane down, or mca-disabled)."""
        if not mca.get("fab_enabled", True):
            return None
        rde = getattr(ctx, "comm", None)
        lane = getattr(rde, "native", None) if rde is not None else None
        plane = getattr(ctx, "sched_plane", None)
        if lane is None or plane is None:
            FAB_STATS["fabrics_unavailable"] += 1
            output.debug_verbose(1, "ptfab",
                                 "serving fabric off: "
                                 f"lane={'up' if lane else 'down'} "
                                 f"plane={'up' if plane else 'down'}")
            return None
        fab = cls(lane.comm, plane, ctx.my_rank, ctx.nb_ranks,
                  rde=rde, lane=lane)
        output.debug_verbose(1, "ptfab",
                             f"serving fabric up on rank {ctx.my_rank}")
        return fab

    # ------------------------------------------------------------- tenants
    def serve(self, tenant: str, handler: Optional[Callable] = None, *,
              window: int = 0, weight: int = 1, taskpool=None,
              credit_line: Optional[int] = None) -> None:
        """Serve ``tenant`` on this rank: remote inserters may acquire
        credits against it and route inserts here.

        With ``taskpool`` (a plane-bound DTD pool), admission accounting
        rides the pool's own plane handle — its window/weight are
        authoritative and an arriving insert's reservation converts into
        the pool's normal admit-at-insert. Without one, the fabric
        registers its own plane pool (KIND_EXT) with ``window``/
        ``weight`` and callers retire via :meth:`done`. ``handler(payload,
        src)`` runs each routed insert (from the fabric thread, or
        :meth:`step` in harness mode)."""
        tid = tenant_id_for(tenant)
        pool_id = self._pool_id(tenant, taskpool)
        handle, owns = -1, False
        if taskpool is not None and \
                getattr(taskpool, "_sched_pool", None) is not None:
            handle = taskpool._sched_pool
        elif self.plane is not None:
            h = self.plane.register_pool(f"fab:{tenant}",
                                         self.plane.KIND_EXT,
                                         weight=weight, window=window)
            if h >= 0:
                handle, owns = h, True
        t = _Tenant(tenant, tid, pool_id, handle, owns, handler, taskpool,
                    credit_line if credit_line is not None
                    else mca.get("fab_credit_line", 0))
        with self._lock:
            self._tenants[tenant] = t
            self._by_key[(pool_id, tid)] = t
        FAB_STATS["tenants_served"] += 1
        self._register_served_counter(t)

    @staticmethod
    def _pool_id(tenant: str, taskpool=None) -> int:
        # the wire ledger key is ALWAYS the fabric identity, taskpool-
        # backed or not: both ends derive it from the tenant name alone,
        # so a pure-gateway rank (serving nothing) addresses the same
        # ledger as a serving rank (the rank-consistent-id discipline of
        # NativeCommLane.pool_id_for)
        from ..comm.native import NativeCommLane
        return NativeCommLane.pool_id_for(f"fab:{tenant}")

    def _register_served_counter(self, t: _Tenant) -> None:
        """``ptfab.served.<tenant>`` on /metrics: what the reconciler
        scrapes. Weakly bound — a retired pool handle samples 0."""
        from ..utils.counters import counters
        plane, handle = self.plane, t.handle
        if plane is None or handle < 0:
            return

        def sample():
            try:
                return plane.pool_stats(handle)["served"]
            except Exception:  # noqa: BLE001 — plane torn down
                return 0
        counters.register(f"ptfab.served.{t.name}", sampler=sample)

    def tenant(self, name: str) -> Optional[_Tenant]:
        with self._lock:
            return self._tenants.get(name)

    def set_weight(self, tenant: str, weight: int) -> None:
        t = self.tenant(tenant)
        if t is not None and self.plane is not None and t.handle >= 0:
            self.plane.set_weight(t.handle, int(weight))

    def headroom(self, tenant: str) -> int:
        """LOCAL grantable window room of the tenant's pool (-1 =
        unlimited) — the gateway's self-rank advertisement."""
        t = self.tenant(tenant)
        if t is None or self.plane is None or t.handle < 0:
            return 0
        return self.plane.headroom(t.handle)

    def done(self, tenant: str, n: int = 1) -> None:
        """Retire n routed inserts of a fabric-owned tenant (taskpool-
        backed tenants retire through their pool's own accounting)."""
        t = self.tenant(tenant)
        if t is not None and t.owns_handle and self.plane is not None:
            self.plane.retired(t.handle, n)

    # --------------------------------------------------- inserter side
    def avail(self, dst: int, tenant: str) -> int:
        """Spendable credit balance toward rank ``dst`` — the advertised
        admission headroom, read locally (zero round trips)."""
        t_id = tenant_id_for(tenant)
        return self.comm.cred_avail(
            dst, self._pool_id_remote(tenant), t_id)

    def _pool_id_remote(self, tenant: str) -> int:
        return self._pool_id(tenant)

    def acquire(self, dst: int, tenant: str, n: int = 1,
                nowait: bool = False,
                timeout: Optional[float] = None) -> None:
        """Spend ``n`` admission credits toward rank ``dst`` — LOCALLY.

        The hot path is one C map op (``cred_take``); no wire traffic,
        no round trip. Exhausted balance: ``nowait=True`` raises
        :class:`AdmissionBackpressure` (counted ``remote_rejects``),
        otherwise block-polls until the granting rank's retire-driven
        replenishment lands (counted ``remote_stalls``) — or the peer
        dies, which raises instead of hanging."""
        pool_id, tid = self._pool_id_remote(tenant), tenant_id_for(tenant)
        if self.comm.cred_take(dst, pool_id, tid, n):
            return
        from ..dsl.dtd import AdmissionBackpressure
        if nowait:
            FAB_STATS["remote_rejects"] += 1
            raise AdmissionBackpressure(
                f"rank {dst} admission window exhausted for tenant "
                f"{tenant!r} (no remote credits; retry after the target "
                f"retires work)")
        FAB_STATS["remote_stalls"] += 1
        deadline = time.monotonic() + (
            timeout if timeout is not None
            else mca.get("fab_acquire_timeout", 30.0))
        while not self.comm.cred_take(dst, pool_id, tid, n):
            if dst in self._dead or self._peer_broken(dst):
                self.reclaim_peer(dst)
                raise RuntimeError(
                    f"rank {dst} died while tenant {tenant!r} waited for "
                    f"admission credits (balance reclaimed)")
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"no admission credits from rank {dst} for tenant "
                    f"{tenant!r} within the acquire timeout")
            if self._thread is None:
                self.step()        # harness mode: self-driven progress
            time.sleep(2e-4)

    def release(self, dst: int, tenant: str, n: int) -> int:
        """Hand unspent credits back to the granting rank."""
        return self.comm.cred_return(
            dst, self._pool_id_remote(tenant), tenant_id_for(tenant), n)

    def announce_endpoint(self, endpoint: str) -> None:
        """Tell every peer where this rank's /metrics endpoint lives (so
        the rank-0 reconciler can scrape the mesh without config)."""
        self.endpoints[self.my_rank] = endpoint
        if self.rde is None:
            return
        from ..comm.engine import TAG_PTFAB
        for r in self._peers():
            try:
                self.rde.ce.send_am(TAG_PTFAB, r,
                                    {"k": "endpoint", "ep": endpoint,
                                     "rank": self.my_rank}, None)
            except Exception:  # noqa: BLE001 — peer gone; reclaim later
                pass

    def send_insert(self, dst: int, tenant: str, payload) -> None:
        """Ship one acquired insert to ``dst`` over the CE AM plane (the
        gateway data path; the credit was spent in :meth:`acquire`)."""
        hdr = {"k": "insert", "t": tenant}
        if self.insert_transport is not None:
            self.insert_transport(dst, hdr, payload)
        elif self.rde is not None:
            from ..comm.engine import TAG_PTFAB
            self.rde.ce.send_am(TAG_PTFAB, dst, hdr, payload)
        else:
            raise RuntimeError("send_insert needs a distributed context "
                               "or an insert_transport")
        FAB_STATS["remote_inserts_tx"] += 1

    # ----------------------------------------------------- target side
    def on_fab(self, src: int, hdr: Dict, payload) -> None:
        """TAG_PTFAB dispatch (comm-thread context: park, don't work)."""
        k = hdr.get("k")
        if k == "insert":
            self._inbox.append((src, hdr, payload))
        elif k == "endpoint":
            self.endpoints[hdr.get("rank", src)] = hdr.get("ep")
        elif k == "weights":
            # reconciliation nudge from rank 0: apply to local DRR
            for name, w in (hdr.get("w") or {}).items():
                self.set_weight(name, w)
            err = hdr.get("err")
            if err is not None:
                FAB_STATS["share_err_pct"] = err
        else:
            output.warning(f"ptfab: unknown control kind {k!r} from "
                           f"rank {src}")

    def _drain_inbox(self) -> int:
        n = 0
        while self._inbox:
            try:
                src, hdr, payload = self._inbox.popleft()
            except IndexError:
                break
            with self._lock:
                t = self._tenants.get(hdr["t"])
            if t is None:
                # still consume the spent credit from the outstanding
                # ledger (the ids are pure functions of the name): a
                # dropped insert must not deflate the peer's credit
                # line forever
                try:
                    self.comm.cred_consume(src, self._pool_id(hdr["t"]),
                                           tenant_id_for(hdr["t"]), 1)
                except Exception:  # noqa: BLE001 — bad src rides along
                    pass
                output.warning(
                    f"ptfab: insert for unserved tenant {hdr['t']!r}")
                continue
            # the spent credit converts: outstanding ledger shrinks, the
            # window reservation becomes either real inflight (owned
            # handle) or the pool's own admit-at-insert (taskpool-backed)
            self.comm.cred_consume(src, t.pool_id, t.tid, 1)
            if self.plane is not None and t.handle >= 0:
                self.plane.remote_release(t.handle, 1)
                if t.owns_handle:
                    self.plane.admit(t.handle, 1)
            FAB_STATS["remote_inserts_rx"] += 1
            if t.handler is not None:
                t.handler(payload, src)
            n += 1
        return n

    # ------------------------------------------------- replenish loop
    def _peers(self) -> List[int]:
        return [r for r in range(self.nb_ranks)
                if r != self.my_rank and r not in self._dead]

    def _credit_line(self, t: _Tenant, npeers: int) -> int:
        if t.credit_line > 0:
            return t.credit_line
        if self.plane is not None and t.handle >= 0:
            win = self.plane.pool_stats(t.handle).get("window", 0)
            if win > 0:
                return max(1, int(win) // max(1, 2 * npeers))
        return 64

    def _replenish(self) -> int:
        """One grant round: top each (tenant, peer) spendable balance
        back up toward its credit line, bounded by the pool's live
        headroom — the retire counters ARE the replenishment signal
        (retires shrink inflight, headroom reopens, grants flow)."""
        granted = 0
        peers = self._peers()
        if not peers:
            return 0
        with self._lock:
            tenants = list(self._tenants.values())
        for t in tenants:
            line = self._credit_line(t, len(peers))
            hr = -1
            if self.plane is not None and t.handle >= 0:
                hr = self.plane.headroom(t.handle)
            for r in peers:
                out = self.comm.cred_outstanding(r, t.pool_id, t.tid)
                want = line - out
                if want <= 0:
                    continue
                if hr >= 0:
                    if hr <= 0:
                        break          # window exhausted: later peers
                                       # wait for retires too
                    want = min(want, hr)
                    hr -= want
                if self.plane is not None and t.handle >= 0:
                    self.plane.remote_grant(t.handle, want)
                try:
                    self.comm.cred_grant(r, t.pool_id, t.tid, want)
                except Exception:  # noqa: BLE001 — peer gone mid-round
                    if self.plane is not None and t.handle >= 0:
                        self.plane.remote_release(t.handle, want)
                    continue
                granted += want
        return granted

    def _peer_broken(self, rank: int) -> bool:
        try:
            return rank in self.comm_stats().get("broken_peers", ())
        except Exception:  # noqa: BLE001
            return False

    def _check_dead(self) -> None:
        broken = set()
        try:
            broken |= set(self.comm_stats().get("broken_peers", ()))
        except Exception:  # noqa: BLE001
            pass
        if self.rde is not None:
            broken |= set(getattr(self.rde.ce, "dead_peers", ()) or ())
        for r in broken - self._dead:
            self.reclaim_peer(r)

    def reclaim_peer(self, rank: int) -> int:
        """Peer-death containment: zero both credit ledgers for ``rank``
        and RELEASE the matching window reservations, so the dead
        inserter's unspent grants cannot leak admission room forever.
        Idempotent; returns the outstanding credits reclaimed."""
        if rank in self._dead:
            return 0
        self._dead.add(rank)
        reclaimed, _dropped = self.comm.cred_reclaim(rank)
        total = 0
        for pool_id, tid, n in reclaimed:
            t = self._by_key.get((pool_id, tid))
            if t is not None and self.plane is not None and t.handle >= 0:
                self.plane.remote_release(t.handle, n)
            total += n
        if total or _dropped:
            FAB_STATS["peer_reclaims"] += 1
            output.debug_verbose(1, "ptfab",
                                 f"rank {rank} reclaimed: {total} "
                                 f"outstanding, {_dropped} unspendable")
        return total

    def step(self) -> int:
        """One fabric round (containment -> inbox -> flush -> grants).
        The replenish thread calls this on its cadence; harness-mode
        tests and single-threaded callers call it directly."""
        if not self._up:
            return 0
        self._check_dead()
        n = self._drain_inbox()
        self._flush_tenants()
        n += self._replenish()
        return n

    def _flush_tenants(self) -> None:
        """Flush served taskpools' insert buffers on the fabric cadence:
        a batch-lane pool only flushes at its threshold or when a
        progress loop STARVES, and a serving drain under sustained load
        never starves — a low-rate tenant's gateway inserts would sit
        buffered (invisible to the drain) behind a busy antagonist.
        Bounded staleness (the replenish period) instead."""
        with self._lock:
            pools = [t.taskpool for t in self._tenants.values()
                     if t.taskpool is not None]
        for tp in pools:
            try:
                flush = getattr(tp, "_flush_ready", None)
                if flush is not None:
                    flush()
            except Exception:  # noqa: BLE001 — a closing pool
                pass

    def _loop(self) -> None:
        period = max(0.5e-3, mca.get("fab_replenish_ms", 5.0) / 1e3)
        while not self._stop.wait(period):
            try:
                self.step()
            except Exception as e:  # noqa: BLE001 — the loop must survive
                output.debug_verbose(1, "ptfab", f"replenish round: {e}")

    # ----------------------------------------------------------- stats
    def comm_stats(self) -> Dict[str, Any]:
        if self.lane is not None:
            return self.lane.stats_cached()
        return self.comm.stats()

    def stats_brief(self) -> Dict[str, Any]:
        s = self.comm_stats()
        return {k: s.get(k, 0) for k in
                ("creds_granted_tx", "creds_granted_rx", "creds_spent",
                 "creds_returned_tx", "creds_reclaimed", "frame_errors")}

    # ------------------------------------------------------------- fini
    def fini(self) -> None:
        if not self._up:
            return
        self._up = False
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        with self._lock:
            tenants = list(self._tenants.values())
            self._tenants.clear()
            self._by_key.clear()
        if self.plane is not None:
            for t in tenants:
                if t.owns_handle:
                    self.plane.unregister_pool(t.handle)
        if self.rde is not None and getattr(self.rde, "fabric", None) is self:
            self.rde.fabric = None
