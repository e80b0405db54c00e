"""Termination detection modules.

Re-design of parsec/mca/termdet (interface: parsec/mca/termdet/termdet.h:99-314).
A termdet module *monitors* a taskpool and decides when it is complete, i.e.
when ``nb_tasks == 0 and nb_pending_actions == 0`` holds globally.

Modules (same set as the reference):

* :class:`LocalTermdet` — counter-based, single-process-correct; the default,
  installed by ``Context.add_taskpool`` when the DSL didn't pick one
  (ref: parsec/scheduling.c:879-884, parsec/mca/termdet/local/).
* :class:`FourCounterTermdet` — Dijkstra/Mattern four-counter global detection
  over the comm engine (ref: parsec/mca/termdet/fourcounter/
  termdet_fourcounter.h:14-18); registered lazily by the comm layer since it
  needs a message tag.
* :class:`UserTriggerTermdet` — a designated task declares termination
  (ref: parsec/mca/termdet/user_trigger/).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

from ..utils import mca, output
from .task import Taskpool

mca.register("termdet", "local", "Termination detection module (local|fourcounter|user_trigger)")

# monitor states (ref: termdet.h parsec_termdet_taskpool_state_t)
TERMDET_NOT_READY = 0
TERMDET_BUSY = 1
TERMDET_IDLE = 2
TERMDET_TERMINATED = 3


class TermdetModule:
    """Module interface (ref: termdet.h:99-314)."""

    name = "base"

    def monitor_taskpool(self, tp: Taskpool) -> None:
        tp.termdet = self
        self._on_monitor(tp)

    def _on_monitor(self, tp: Taskpool) -> None:
        raise NotImplementedError

    def taskpool_state_changed(self, tp: Taskpool) -> None:
        """Called whenever nb_tasks / nb_pending_actions may have hit zero."""
        raise NotImplementedError

    def taskpool_ready(self, tp: Taskpool) -> None:
        """The DSL finished seeding startup tasks; detection may begin.

        Mirrors parsec_termdet_open_ready: completion must not be declared
        before this (avoids the startup race where counters are transiently 0).
        """
        raise NotImplementedError

    # message hook for distributed variants (ref: termdet fourcounter msg tag)
    def incoming_message(self, tp: Taskpool, src: int, payload: bytes) -> None:
        pass


class LocalTermdet(TermdetModule):
    """Counter-based local termination (ref: parsec/mca/termdet/local/)."""

    name = "local"

    def __init__(self) -> None:
        self._state: Dict[int, int] = {}
        self._lock = threading.Lock()

    def _on_monitor(self, tp: Taskpool) -> None:
        with self._lock:
            self._state[tp.taskpool_id] = TERMDET_NOT_READY

    def taskpool_ready(self, tp: Taskpool) -> None:
        with self._lock:
            self._state[tp.taskpool_id] = TERMDET_BUSY
        self.taskpool_state_changed(tp)

    def taskpool_state_changed(self, tp: Taskpool) -> None:
        declare = False
        with self._lock:
            st = self._state.get(tp.taskpool_id, TERMDET_NOT_READY)
            if st in (TERMDET_NOT_READY, TERMDET_TERMINATED):
                return
            if tp.nb_tasks == 0 and tp.nb_pending_actions == 0:
                self._state[tp.taskpool_id] = TERMDET_TERMINATED
                declare = True
        if declare:
            output.debug_verbose(3, "termdet", f"taskpool {tp.taskpool_id} terminated (local)")
            tp._declare_complete()


class UserTriggerTermdet(TermdetModule):
    """A single designated task declares the end (ref: termdet/user_trigger/)."""

    name = "user_trigger"

    def __init__(self) -> None:
        self._done: Dict[int, bool] = {}
        self._lock = threading.Lock()

    def _on_monitor(self, tp: Taskpool) -> None:
        with self._lock:
            self._done[tp.taskpool_id] = False

    def taskpool_ready(self, tp: Taskpool) -> None:
        pass

    def trigger(self, tp: Taskpool) -> None:
        with self._lock:
            if self._done.get(tp.taskpool_id):
                return
            self._done[tp.taskpool_id] = True
        tp._declare_complete()

    def taskpool_state_changed(self, tp: Taskpool) -> None:
        pass  # only the explicit trigger terminates


class FourCounterTermdet(TermdetModule):
    """Dijkstra/Mattern four-counter global termination detection.

    Ref: parsec/mca/termdet/fourcounter/termdet_fourcounter.h:14-18. Each rank
    tracks (sent, received) message counters; rank 0 circulates UP/DOWN waves:
    when every rank is locally idle and the global sum of sent == received over
    two consecutive waves, termination is declared and broadcast.

    The actual wave exchange rides the comm engine's termdet tag; this class
    implements the counting logic and is driven by
    :mod:`parsec_tpu_torch.comm.remote_dep`.
    """

    name = "fourcounter"

    def __init__(self, comm=None) -> None:
        self.comm = comm
        self._lock = threading.Lock()
        self._ready: Dict[int, bool] = {}
        self._msg_sent: Dict[int, int] = {}
        self._msg_recv: Dict[int, int] = {}
        self._terminated: Dict[int, bool] = {}

    def attach_comm(self, comm) -> None:
        self.comm = comm

    def _on_monitor(self, tp: Taskpool) -> None:
        with self._lock:
            self._ready[tp.taskpool_id] = False
            self._msg_sent.setdefault(tp.taskpool_id, 0)
            self._msg_recv.setdefault(tp.taskpool_id, 0)
            self._terminated[tp.taskpool_id] = False

    def taskpool_ready(self, tp: Taskpool) -> None:
        with self._lock:
            self._ready[tp.taskpool_id] = True
        self.taskpool_state_changed(tp)

    def message_sent(self, tp: Taskpool, n: int = 1) -> None:
        with self._lock:
            self._msg_sent[tp.taskpool_id] = self._msg_sent.get(tp.taskpool_id, 0) + n

    def message_received(self, tp: Taskpool, n: int = 1) -> None:
        with self._lock:
            self._msg_recv[tp.taskpool_id] = self._msg_recv.get(tp.taskpool_id, 0) + n

    def counters(self, tp: Taskpool):
        with self._lock:
            return (self._msg_sent.get(tp.taskpool_id, 0),
                    self._msg_recv.get(tp.taskpool_id, 0))

    def locally_idle(self, tp: Taskpool) -> bool:
        return (self._ready.get(tp.taskpool_id, False)
                and tp.nb_tasks == 0 and tp.nb_pending_actions == 0)

    def taskpool_state_changed(self, tp: Taskpool) -> None:
        # local idleness only *enables* a wave; the comm layer drives waves.
        if self.comm is not None and self.locally_idle(tp):
            self.comm.termdet_local_idle(tp)

    def declare_terminated(self, tp: Taskpool) -> None:
        with self._lock:
            if self._terminated.get(tp.taskpool_id):
                return
            self._terminated[tp.taskpool_id] = True
        tp._declare_complete()


_modules: Dict[str, Callable[[], TermdetModule]] = {
    "local": LocalTermdet,
    "user_trigger": UserTriggerTermdet,
    "fourcounter": FourCounterTermdet,
}


def create(name: Optional[str] = None) -> TermdetModule:
    name = name or mca.get("termdet", "local")
    if name not in _modules:
        output.fatal(f"unknown termdet module {name!r} (have: {sorted(_modules)})")
    return _modules[name]()
