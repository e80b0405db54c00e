"""Python lifecycle of the native multi-pool scheduler plane.

The C machinery lives in ``csrc/ptsched.h`` (per-worker bounded hot queues,
steal-half work stealing, per-pool overflow heaps, weighted
deficit-round-robin arbitration, admission windows); this module owns the
plane per :class:`~parsec_tpu_torch.core.context.Context`:

* **creation** — :meth:`SchedPlane.maybe_create` arms one plane per
  context when the native module loads AND the selected scheduler module
  maps to a native arbitration flavor
  (:attr:`~parsec_tpu_torch.core.scheduler.SchedulerModule.native_policy`);
  a policy without a native analogue (``ip``) counts an honest
  ``policy_fallback`` and every pool stays on its private ready structure;
* **pool registry** — taskpools register with a QoS weight
  (``tp.qos_weight`` or ``--mca sched_pool_weight``) and an admission
  window (``tp.admission_window`` or ``--mca sched_admission_window``);
  the handle routes their ready tasks through the plane (DTD:
  ``Engine.register_class(..., pool=h)``; PTG: ``Graph.sched_bind``, armed
  when a second lane pool runs beside the first, and served by weighted
  DRR through :meth:`next_ptexec`; the serving fabric: ``KIND_EXT`` pools
  it admits and retires itself);
* **admission** — :meth:`over_window` / :meth:`count_stall` back the DTD
  insert path's backpressure (``insert_task(..., nowait=)``); the fabric's
  remote-window entries (:meth:`headroom`, :meth:`remote_grant`, ...)
  share one window between local and remote inserters;
* **counters** — the live planes' C-side stats as ``sched.*`` samplers of
  the counter registry (:func:`plane_counter_sampler`).
"""

from __future__ import annotations

import threading
import time
import weakref
import zlib
from typing import Dict, Optional

from ..utils import mca, output
from ..utils.counters import Counters

mca.register("sched_native", True,
             "Arm the native multi-pool scheduler plane (ptsched) when "
             "the selected scheduler module has a native arbitration "
             "flavor; 0 keeps every engine on its private ready structure",
             type=bool)
mca.register("sched_pool_weight", 1,
             "Default QoS weight of a taskpool on the scheduler plane "
             "(DRR share: a weight-2 pool is served ~2x the tasks of a "
             "weight-1 pool under contention); per-pool override via "
             "tp.qos_weight", type=int)
mca.register("sched_admission_window", 0,
             "Admission soft limit per taskpool (in-flight inserted-but-"
             "not-completed tasks) on the scheduler plane: past it, "
             "insert_task blocks (helping drain) or raises with "
             "nowait=True. 0 = unlimited; per-pool override via "
             "tp.admission_window", type=int)

mca.register("sched_quantum", 256,
             "DRR credit unit of the scheduler plane (tasks per weight "
             "point per round). Weights only bind on pools whose backlog "
             "exceeds weight*quantum, so serving meshes with tight "
             "admission windows (the serving fabric) want a SMALL quantum",
             type=int)

#: engagement counters: ``pools_engaged`` counts pools registered on a
#: plane, ``pools_retired`` the ones that completed and freed their slot,
#: ``policy_fallback`` contexts whose --mca sched flavor has no native
#: analogue, ``plane_unavailable`` contexts whose module did not load
#: (``--mca native_enabled 0``), ``admission_stalls``/
#: ``admission_rejects`` the backpressure outcomes
SCHED_STATS = Counters(pools_engaged=0, pools_retired=0,
                       policy_fallback=0, plane_unavailable=0,
                       admission_stalls=0, admission_rejects=0)

#: the plane's C-side counters exported into the counter registry
#: (``sched.<key>``, summed across live planes). ``admission_stalls`` is
#: not here: SCHED_STATS exports it under the same name with process
#: lifetime (count_stall bumps both), and a live-planes sampler would
#: shadow it — a finished context's stalls would read 0 once its plane is
#: collected.
PLANE_COUNTER_KEYS = ("steals", "steal_visits", "spills", "served",
                      "queued", "pools_live")

_live_planes: "weakref.WeakSet" = weakref.WeakSet()
_live_lock = threading.Lock()


def plane_counter_sampler(key: str):
    """A registry sampler summing one plane stat over live planes (the
    short-TTL snapshot means one registry sweep costs one stats() call per
    plane, not one per counter key)."""
    def sample():
        total = 0
        with _live_lock:
            planes = list(_live_planes)
        for sp in planes:
            try:
                total += sp.stats_cached().get(key, 0)
            except Exception:  # noqa: BLE001 — a torn-down plane
                pass
        return total
    return sample


class SchedPlane:
    """One native scheduler plane bound to one Context."""

    def __init__(self, mod, nworkers: int, policy_name: str) -> None:
        self.mod = mod
        self.policy = policy_name
        self.plane = mod.Plane(
            nworkers=nworkers,
            policy=getattr(mod, f"POLICY_{policy_name.upper()}"),
            quantum=max(1, int(mca.get("sched_quantum", 256))))
        #: the capsule the engines bind through (owns a plane ref)
        self.capsule = self.plane.plane_capsule()
        self.KIND_PTEXEC = mod.KIND_PTEXEC
        self.KIND_PTDTD = mod.KIND_PTDTD
        self.KIND_EXT = mod.KIND_EXT
        self._pools: Dict[int, str] = {}       # handle -> pool name
        self._lock = threading.Lock()
        self._stats_cache: tuple = (0.0, None)  # (stamp, snapshot)
        with _live_lock:
            _live_planes.add(self)

    # ------------------------------------------------------------- creation
    @classmethod
    def maybe_create(cls, context) -> Optional["SchedPlane"]:
        """The context-init gate: native module + native-eligible policy,
        on every context, a card's included (its DTD pools stay off the
        batched lane, but its PTG pools and the serving fabric's pools use
        the plane). Declines are COUNTED (SCHED_STATS), never silent."""
        if not mca.get("sched_native", True):
            return None
        policy = getattr(context.sched, "native_policy", None)
        if policy is None:
            SCHED_STATS["policy_fallback"] += 1
            return None
        from .. import native as native_mod
        mod = native_mod.load_ptsched()
        if mod is None:
            SCHED_STATS["plane_unavailable"] += 1
            return None
        sp = cls(mod, context.nb_cores, policy)
        output.debug_verbose(2, "sched",
                             f"scheduler plane up: policy={policy}, "
                             f"{context.nb_cores} workers")
        return sp

    # ------------------------------------------------------------ pools
    def register_pool(self, name: str, kind: int,
                      weight: Optional[int] = None,
                      window: Optional[int] = None) -> int:
        """Admit a taskpool; returns its plane handle, or -1 when the
        pool table is full (the caller stays on its private structure)."""
        w = weight if weight else mca.get("sched_pool_weight", 1)
        win = window if window is not None \
            else mca.get("sched_admission_window", 0)
        try:
            h = self.plane.register_pool(
                ext_id=zlib.crc32(name.encode()) & 0xFFFFFFFF,
                kind=kind, weight=max(1, int(w)), window=max(0, int(win)))
        except RuntimeError:
            return -1
        with self._lock:
            self._pools[h] = name
        SCHED_STATS["pools_engaged"] += 1
        return h

    def unregister_pool(self, h: Optional[int]) -> None:
        if h is None or h < 0:
            return
        with self._lock:
            known = self._pools.pop(h, None)
        if known is None:
            return          # already freed (idempotent retire paths)
        self.plane.unregister_pool(h)
        SCHED_STATS["pools_retired"] += 1

    def forget_pool(self, h: Optional[int]) -> None:
        """Drop the name mapping for a slot whose NATIVE free belongs to
        someone else (a sched-bound ptexec graph frees its own slot in
        sched_unbind/dealloc — a second native free here could kill an
        unrelated pool that reused the slot)."""
        if h is None or h < 0:
            return
        with self._lock:
            if self._pools.pop(h, None) is not None:
                SCHED_STATS["pools_retired"] += 1

    # ------------------------------------------------------- arbitration
    def next_ptexec(self):
        """DRR pick among registered ptexec pools with queued work:
        (handle, quantum) or None. The context's lane drain uses this to
        choose WHICH graph a worker serves next and for how many credits
        (charge() spends them back)."""
        return self.plane.next_pool(self.KIND_PTEXEC)

    def charge(self, h: int, n: int) -> None:
        self.plane.charge(h, n)

    def queued_total(self) -> int:
        """Ready items across every live pool — the starvation-backoff
        consult: a worker must not park while ANY pool holds spill."""
        return self.plane.queued_kind(self.mod.KIND_ANY)

    # ---------------------------------------------------------- admission
    def over_window(self, h: Optional[int]) -> bool:
        return h is not None and h >= 0 and self.plane.over_window(h)

    def count_stall(self, h: int) -> None:
        self.plane.stall(h)
        SCHED_STATS["admission_stalls"] += 1

    # ------------------------------------------------- serving fabric
    # remote-window reservations and the mid-run QoS weight nudge of the
    # share reconciler (serving/): thin passthroughs to the native plane;
    # the fabric holds handles, not pool names
    def headroom(self, h: Optional[int]) -> int:
        """Grantable window room of pool h (-1 = unlimited)."""
        if h is None or h < 0:
            return 0
        return self.plane.headroom(h)

    def remote_grant(self, h: int, n: int = 1) -> None:
        self.plane.remote_grant(h, n)

    def remote_release(self, h: int, n: int = 1) -> None:
        self.plane.remote_release(h, n)

    def set_weight(self, h: int, weight: int) -> None:
        self.plane.set_weight(h, max(1, int(weight)))

    def admit(self, h: int, n: int = 1) -> None:
        self.plane.admit(h, n)

    def retired(self, h: int, n: int = 1) -> None:
        self.plane.retired(h, n)

    # ------------------------------------------------------------- stats
    def stats(self) -> Dict[str, int]:
        return self.plane.stats()

    def stats_cached(self, ttl: float = 0.02) -> Dict[str, int]:
        """:meth:`stats` behind a short TTL — one registry sweep (six
        ``sched.*`` sampler keys) pays one native stats() call, not six."""
        now = time.monotonic()
        stamp, snap = self._stats_cache
        if snap is None or now - stamp > ttl:
            snap = self.plane.stats()
            self._stats_cache = (now, snap)
        return snap

    def pool_stats(self, h: int) -> Dict[str, int]:
        """One pool's live/queued/inflight/served counts (the watchdog's
        pool rule reads them)."""
        return self.plane.pool_stats(h)
