"""Info registry: named slots attached to runtime objects.

Re-design of parsec/class/info.h: components register named info slots
(process-wide ids); any runtime object carrying an :class:`InfoBag` can then
store per-object values in those slots (the reference uses this for
DSL/tool extensions hanging state off taskpools and streams).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional


class InfoRegistry:
    """Process-wide slot-name → id registry (ref: parsec_info_register)."""

    def __init__(self) -> None:
        self._ids: Dict[str, int] = {}
        self._lock = threading.Lock()

    def register(self, name: str) -> int:
        with self._lock:
            iid = self._ids.get(name)
            if iid is None:
                iid = len(self._ids)
                self._ids[name] = iid
            return iid

    def lookup(self, name: str) -> Optional[int]:
        return self._ids.get(name)

    def unregister(self, name: str) -> None:
        with self._lock:
            self._ids.pop(name, None)


registry = InfoRegistry()


class InfoBag:
    """Per-object slot storage (ref: parsec_info_object_array)."""

    __slots__ = ("_vals",)

    def __init__(self) -> None:
        self._vals: List[Any] = []

    def set(self, info_id: int, value: Any) -> None:
        if info_id >= len(self._vals):
            self._vals.extend([None] * (info_id + 1 - len(self._vals)))
        self._vals[info_id] = value

    def get(self, info_id: int, default: Any = None) -> Any:
        if info_id < len(self._vals):
            v = self._vals[info_id]
            return default if v is None else v
        return default
