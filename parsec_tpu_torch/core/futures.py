"""Futures and datacopy futures.

Re-design of parsec/class/parsec_future.c + parsec_datacopy_future.c: a
count-down future whose value is produced once and consumed by many, with
chained callbacks, plus the datacopy flavor used by the reshape engine
("reshape promises", parsec/parsec_reshape.c): the value is a DataCopy
produced lazily by a *trigger* the first time someone requests it, possibly
through a datatype/layout conversion.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional


class Future:
    """Single-assignment future (ref: parsec_base_future_t)."""

    def __init__(self) -> None:
        self._event = threading.Event()
        self._value: Any = None
        self._cbs: List[Callable[[Any], None]] = []
        self._lock = threading.Lock()

    @property
    def ready(self) -> bool:
        return self._event.is_set()

    def set(self, value: Any) -> None:
        with self._lock:
            if self._event.is_set():
                raise RuntimeError("future already completed")
            self._value = value
            self._event.set()
            cbs, self._cbs = self._cbs, []
        for cb in cbs:
            cb(value)

    def get(self, timeout: Optional[float] = None, progress=None) -> Any:
        """Blocking get; ``progress`` (if given) is pumped while waiting so a
        single-threaded runtime can fulfil its own futures."""
        if progress is not None:
            import time
            deadline = None if timeout is None else time.monotonic() + timeout
            while not self._event.is_set():
                progress()
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError("future timed out")
        elif not self._event.wait(timeout):
            raise TimeoutError("future timed out")
        return self._value

    def on_ready(self, cb: Callable[[Any], None]) -> None:
        with self._lock:
            if not self._event.is_set():
                self._cbs.append(cb)
                return
        cb(self._value)


class CountdownFuture(Future):
    """Completes after N contributions (ref: parsec_countable_future_t)."""

    def __init__(self, count: int, combine: Optional[Callable[[Any, Any], Any]] = None) -> None:
        super().__init__()
        self._count = count
        self._acc: Any = None
        self._combine = combine

    def contribute(self, value: Any = None) -> None:
        fire = False
        with self._lock:
            if self._combine is not None:
                self._acc = value if self._acc is None else self._combine(self._acc, value)
            self._count -= 1
            fire = self._count == 0
        if fire:
            self.set(self._acc)


class DataCopyFuture(Future):
    """A future DataCopy produced on demand by a trigger — the reshape
    promise (ref: parsec/class/parsec_datacopy_future.c).

    ``trigger(src_copy, spec) -> DataCopy`` runs at most once, on the first
    ``request()``; later consumers share the same converted copy and each
    ``release()`` drops one reference.
    """

    def __init__(self, src_copy, spec: Any,
                 trigger: Callable[[Any, Any], Any]) -> None:
        super().__init__()
        self.src_copy = src_copy
        self.spec = spec
        self._trigger = trigger
        self._triggered = False

    def request(self):
        """First caller runs the conversion; everyone gets the same copy."""
        run = False
        with self._lock:
            if not self._triggered:
                self._triggered = True
                run = True
        if run:
            self.set(self._trigger(self.src_copy, self.spec))
        return self.get()

    def release(self) -> None:
        if self.ready:
            copy = self.get()
            if hasattr(copy, "release"):
                copy.release()
