"""Python lifecycle of the native multi-pool scheduler plane.

The C machinery lives in ``csrc/ptsched.h`` (per-worker bounded hot queues,
steal-half work stealing, per-pool overflow heaps, weighted
deficit-round-robin arbitration, admission windows); this module owns the
plane per :class:`~parsec_tpu_torch.core.context.Context`:

* **creation** — :meth:`SchedPlane.maybe_create` arms one plane per
  context without a CUDA device when the native module loads AND the
  selected scheduler module maps to a native arbitration flavor
  (:attr:`~parsec_tpu_torch.core.scheduler.SchedulerModule.native_policy`);
  a policy without a native analogue (``ip``) counts an honest
  ``policy_fallback`` and every pool stays on its private ready structure;
* **pool registry** — taskpools register with a QoS weight
  (``tp.qos_weight`` or ``--mca sched_pool_weight``) and an admission
  window (``tp.admission_window`` or ``--mca sched_admission_window``);
  the handle routes their ready tasks through the plane (DTD:
  ``Engine.register_class(..., pool=h)``);
* **admission** — :meth:`over_window` / :meth:`count_stall` back the DTD
  insert path's backpressure (``insert_task(..., nowait=)``).
"""

from __future__ import annotations

import threading
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

#: DRR credit unit of the plane (tasks per weight point per round):
#: weights only bind on pools whose backlog exceeds weight * quantum
QUANTUM = 256

#: engagement counters: ``pools_engaged`` counts pools registered on a
#: plane, ``pools_retired`` the ones that completed and freed their slot,
#: ``policy_fallback`` contexts whose --mca sched flavor has no native
#: analogue, ``plane_unavailable`` contexts whose module did not load
#: (``--mca native_enabled 0``), ``card_context`` contexts with a CUDA
#: device (whose DTD pools never take the batched lane the plane drains),
#: ``admission_stalls``/``admission_rejects`` the backpressure outcomes
SCHED_STATS = Counters(pools_engaged=0, pools_retired=0,
                       policy_fallback=0, plane_unavailable=0,
                       card_context=0, admission_stalls=0,
                       admission_rejects=0)


class SchedPlane:
    """One native scheduler plane bound to one Context."""

    def __init__(self, mod, nworkers: int, policy_name: str) -> None:
        self.mod = mod
        self.policy = policy_name
        self.plane = mod.Plane(
            nworkers=nworkers,
            policy=getattr(mod, f"POLICY_{policy_name.upper()}"),
            quantum=QUANTUM)
        #: the capsule the engines bind through (owns a plane ref)
        self.capsule = self.plane.plane_capsule()
        self.KIND_PTDTD = mod.KIND_PTDTD
        self._pools: Dict[int, str] = {}       # handle -> pool name
        self._lock = threading.Lock()

    # ------------------------------------------------------------- creation
    @classmethod
    def maybe_create(cls, context) -> Optional["SchedPlane"]:
        """The context-init gate: native module + native-eligible policy,
        on a context without a CUDA device (only the batched lane of such
        a context drains through the plane). Declines are COUNTED
        (SCHED_STATS), never silent."""
        if not mca.get("sched_native", True):
            return None
        from .task import DEV_CUDA
        if any(d.type & DEV_CUDA for d in context.devices.devices):
            SCHED_STATS["card_context"] += 1
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
