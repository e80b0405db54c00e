"""Engagement counters of the lanes (``PTDTD_STATS``, ``SCHED_STATS``, the
program cache's): a plain dict underneath, so the hot paths keep their
``stats[key] += 1`` shape, with the lifecycle helpers tests and gates read
them through."""

from __future__ import annotations

from typing import Dict


class Counters(dict):
    """A dict of named counters with ``snapshot``/``delta``/``reset``."""

    def snapshot(self) -> Dict[str, int]:
        """A point-in-time copy (compare with :meth:`delta`)."""
        return dict(self)

    def delta(self, snap: Dict[str, int]) -> Dict[str, int]:
        """Per-key change since a :meth:`snapshot`."""
        return {k: v - snap.get(k, 0) for k, v in self.items()}

    def reset(self) -> None:
        """Zero every counter."""
        for k in self:
            self[k] = 0


#: the engagement-counter dict of the native lanes (``PTEXEC_STATS``): the
#: reference's name for the same helper
LaneStats = Counters
