"""Taskpool composition.

Re-design of parsec/compound.c (parsec_compose): chain taskpools so that
each starts only when the previous one completed; the compound itself is a
taskpool that can be enqueued, waited on, and composed further.

A DTD taskpool enqueues itself when it is made and runs its tasks as they
are inserted, so a DTD stage after the first is given as a callable that
builds (and closes) the pool when its turn comes; the first stage may be a
DTD pool already made, composed before it is closed.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional, Union

from .task import Taskpool


class CompoundTaskpool(Taskpool):
    """Sequential composition (ref: parsec_compound_taskpool_t)."""

    def __init__(self, *taskpools: Taskpool, name: str = "compound") -> None:
        super().__init__(name)
        self._stages: List[Union[Taskpool, Callable[[], Taskpool]]] = list(taskpools)
        self._stage_idx = -1
        self._current: Optional[Taskpool] = None

    def add(self, tp: Union[Taskpool, Callable[[], Taskpool]]) -> "CompoundTaskpool":
        """Append a stage; a callable is materialized lazily at stage start
        (needed when a stage's structure depends on a previous stage's
        output)."""
        self._stages.append(tp)
        return self

    # -- lifecycle --------------------------------------------------------------

    def _advance(self) -> None:
        self._stage_idx += 1
        if self._stage_idx >= len(self._stages):
            self._current = None
            self.addto_nb_pending_actions(-1)
            return
        stage = self._stages[self._stage_idx]
        tp = stage() if callable(stage) else stage
        self._current = tp
        prev_cb = tp.on_complete
        once = threading.Lock()

        def next_stage():
            if once.acquire(blocking=False):
                self._advance()

        def chained(_tp, _prev=prev_cb):
            if _prev is not None:
                _prev(_tp)
            next_stage()

        tp.on_complete = chained
        if tp.context is None:
            self.context.add_taskpool(tp)
        elif tp.completed:
            # a pool that enqueued itself (DTD) and finished before the
            # chain was attached
            next_stage()


def compose(ctx, *taskpools: Taskpool, name: str = "compound") -> CompoundTaskpool:
    """parsec_compose: build and enqueue the sequential composition."""
    comp = CompoundTaskpool(*taskpools, name=name)
    # hold the completion before the termdet can observe empty counters
    comp.addto_nb_pending_actions(1)
    ctx.add_taskpool(comp)
    comp._advance()
    return comp
