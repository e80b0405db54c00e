"""PINS: performance instrumentation callback chain.

Re-design of parsec/mca/pins (events: parsec/mca/pins/pins.h:26-55). Modules
register callbacks per lifecycle event; the runtime fires them at the same
points the reference does (e.g. EXEC_BEGIN/END inside __parsec_execute,
scheduling.c:185-192). Fan-out is a simple chain per event, like the
reference's linked callback lists.
"""

from __future__ import annotations

import threading
import weakref
from typing import Callable, Dict, List

from ..utils import mca

mca.register(
    "pins_paranoid", False,
    "Full-fidelity instrumentation: force instrumented pools OFF the "
    "native DTD engine so every task pays the per-task Python PINS cycle "
    "(every callback fires per task, including the PREPARE_INPUT pair). "
    "Default off: the native engine stays engaged under PINS and fires "
    "the core lifecycle events itself", type=bool)


# Event names (ref: PINS_FLAG enum, parsec/mca/pins/pins.h:26-55)
SELECT_BEGIN = "select_begin"
SELECT_END = "select_end"
PREPARE_INPUT_BEGIN = "prepare_input_begin"
PREPARE_INPUT_END = "prepare_input_end"
RELEASE_DEPS_BEGIN = "release_deps_begin"
RELEASE_DEPS_END = "release_deps_end"
ACTIVATE_CB_BEGIN = "activate_cb_begin"
ACTIVATE_CB_END = "activate_cb_end"
DATA_FLUSH_BEGIN = "data_flush_begin"
DATA_FLUSH_END = "data_flush_end"
EXEC_BEGIN = "exec_begin"
EXEC_END = "exec_end"
COMPLETE_EXEC_BEGIN = "complete_exec_begin"
COMPLETE_EXEC_END = "complete_exec_end"
SCHEDULE_BEGIN = "schedule_begin"
SCHEDULE_END = "schedule_end"

ALL_EVENTS = [
    SELECT_BEGIN, SELECT_END, PREPARE_INPUT_BEGIN, PREPARE_INPUT_END,
    RELEASE_DEPS_BEGIN, RELEASE_DEPS_END, ACTIVATE_CB_BEGIN, ACTIVATE_CB_END,
    DATA_FLUSH_BEGIN, DATA_FLUSH_END, EXEC_BEGIN, EXEC_END,
    COMPLETE_EXEC_BEGIN, COMPLETE_EXEC_END, SCHEDULE_BEGIN, SCHEDULE_END,
]


class PinsManager:
    """Per-context PINS registry (ref: PARSEC_PINS_INIT, parsec/parsec.c:845)."""

    def __init__(self) -> None:
        self._chains: Dict[str, List[Callable]] = {e: [] for e in ALL_EVENTS}
        self._lock = threading.Lock()
        self.enabled = False
        #: True when instrumentation must eject pools from the native
        #: engine (``enabled`` and ``--mca pins_paranoid 1``). This — not
        #: ``enabled`` — is what the lane-eligibility gates consult, so
        #: plain instrumentation keeps the hot path native. Cached as a
        #: plain attribute because the DTD per-task progress path reads it
        #: per task; recomputed when a callback registers (the only way
        #: ``enabled`` flips) and when the mca param changes.
        self.paranoid = False
        ref = weakref.ref(self)

        def _recompute(_value=None, _ref=ref):
            m = _ref()
            if m is not None:
                m.paranoid = m.enabled and mca.get("pins_paranoid", False)

        self._recompute_paranoid = _recompute
        mca.params.on_change("pins_paranoid", _recompute)
        _recompute()

    def register(self, event: str, cb: Callable) -> None:
        """PARSEC_PINS_REGISTER: prepend cb to the event chain."""
        with self._lock:
            self._chains[event].insert(0, cb)
            self.enabled = True
        self._recompute_paranoid()

    def unregister(self, event: str, cb: Callable) -> None:
        with self._lock:
            try:
                self._chains[event].remove(cb)
            except ValueError:
                pass
            self.enabled = any(self._chains.values())
        self._recompute_paranoid()

    def fire(self, event: str, stream, task, extra=None) -> None:
        """PARSEC_PINS(...) macro equivalent; no-op when nothing registered."""
        if not self.enabled:
            return
        for cb in self._chains[event]:
            cb(stream, task, extra)
