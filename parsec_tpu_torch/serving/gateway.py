"""Headroom-aware ingest gateway.

The front door of the serving mesh: a client stream lands on ANY rank
and the gateway routes each insert to the rank with the most admission
headroom — **without a probe**. The advertisement is the credit balance
the fabric already holds per (rank, tenant): the serving side granted
those credits from its live window headroom, so the local ledger IS a
(slightly stale, strictly safe) view of every peer's capacity. Routing
therefore costs a few C map reads; the insert itself costs one local
credit spend plus one AM — zero admission round trips.

Placement policy per submit: pick the candidate rank with the largest
advertised headroom (self-rank advertises its live plane headroom);
stale-but-positive balances self-correct because each spend decrements
the balance read by the next submit. When EVERY candidate is exhausted,
the gateway blocks for replenishment (the serving tier's bounded-ingest
contract) or raises :class:`AdmissionBackpressure` under ``nowait=True``
— the adversarial-tenant example (examples_torch/ex17_serving_fabric.py)
shows that this is what keeps one flooding tenant from moving another
tenant's p99.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

from ..utils import mca
from .fabric import FAB_STATS, ServingFabric


class IngestGateway:
    """Routes one tenant-tagged insert stream across the mesh by
    advertised admission headroom."""

    def __init__(self, fabric: ServingFabric,
                 ranks: Optional[List[int]] = None) -> None:
        self.fabric = fabric
        #: candidate serving ranks (default: the whole mesh)
        self.ranks = list(ranks) if ranks is not None \
            else list(range(fabric.nb_ranks))
        #: routing outcome counts per rank (observability/tests)
        self.routed: Dict[int, int] = {r: 0 for r in self.ranks}

    # ---------------------------------------------------------- headroom
    def headroom_of(self, rank: int, tenant: str) -> int:
        """The advertised admission headroom of ``rank`` for ``tenant``:
        the local credit balance for peers, the live plane headroom for
        this rank itself (-1 = unlimited, ranked above any balance)."""
        fab = self.fabric
        if rank == fab.my_rank:
            return fab.headroom(tenant)
        if rank in fab._dead:
            return 0
        return fab.avail(rank, tenant)

    def headrooms(self, tenant: str) -> Dict[int, int]:
        return {r: self.headroom_of(r, tenant) for r in self.ranks}

    # ------------------------------------------------------------ routing
    def _pick(self, tenant: str) -> Optional[int]:
        """Largest advertised headroom wins; -1 (unlimited self) beats
        everything; all-zero -> None (backpressure)."""
        best, best_h = None, 0
        for r in self.ranks:
            h = self.headroom_of(r, tenant)
            if h < 0:
                return r
            if h > best_h:
                best, best_h = r, h
        return best

    def submit(self, tenant: str, payload, nowait: bool = False,
               timeout: Optional[float] = None) -> int:
        """Route one insert; returns the rank it landed on.

        Backpressure contract: with every candidate exhausted,
        ``nowait=True`` raises
        :class:`~parsec_tpu_torch.dsl.dtd.AdmissionBackpressure` immediately
        (counted ``ptfab.remote_rejects``) — retry after the mesh
        retires work; otherwise block until any candidate's
        replenishment lands (counted ``ptfab.remote_stalls``)."""
        fab = self.fabric
        deadline = time.monotonic() + (
            timeout if timeout is not None
            else mca.get("fab_acquire_timeout", 30.0))
        stalled = False
        while True:
            r = self._pick(tenant)
            if r is not None:
                if r == fab.my_rank:
                    if self._ingest_local(tenant, payload):
                        self.routed[r] += 1
                        return r
                elif self._ingest_remote(r, tenant, payload):
                    self.routed[r] += 1
                    return r
                continue   # lost the race for that headroom: re-pick
            if nowait:
                from ..dsl.dtd import AdmissionBackpressure
                FAB_STATS["remote_rejects"] += 1
                raise AdmissionBackpressure(
                    f"every serving rank's admission window is exhausted "
                    f"for tenant {tenant!r} (ranks {self.ranks})")
            if not stalled:
                stalled = True
                FAB_STATS["remote_stalls"] += 1
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"no serving rank freed admission room for tenant "
                    f"{tenant!r} within the timeout")
            if fab._thread is None:
                fab.step()             # harness mode: self-driven
            time.sleep(2e-4)

    def _ingest_local(self, tenant: str, payload) -> bool:
        fab = self.fabric
        t = fab.tenant(tenant)
        if t is None:
            return False
        if fab.plane is not None and t.handle >= 0 and \
                fab.plane.over_window(t.handle):
            return False
        if t.owns_handle and fab.plane is not None and t.handle >= 0:
            fab.plane.admit(t.handle, 1)
        if t.handler is not None:
            t.handler(payload, fab.my_rank)
        return True

    def _ingest_remote(self, rank: int, tenant: str, payload) -> bool:
        fab = self.fabric
        if not fab.comm.cred_take(rank, fab._pool_id(tenant),
                                  _tid(tenant), 1):
            return False
        fab.send_insert(rank, tenant, payload)
        return True


def _tid(tenant: str) -> int:
    from .fabric import tenant_id_for
    return tenant_id_for(tenant)


def serve_dtd_tenant(fabric: ServingFabric, tenant: str, taskpool,
                     insert: Callable) -> None:
    """Convenience glue for the common shape: serve ``tenant`` backed by
    a plane-bound DTD ``taskpool``, routing each gateway insert through
    ``insert(payload)`` (which calls ``taskpool.insert_task``); window +
    weight come from the pool's own plane registration."""
    fabric.serve(tenant, handler=lambda payload, src: insert(payload),
                 taskpool=taskpool)
