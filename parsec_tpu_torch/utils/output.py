"""Verbosity-leveled debug/warn/fatal output.

Re-design of parsec/utils/debug.c + parsec/utils/output.c: multi-stream output
with per-stream prefixes, a global verbosity knob (MCA ``debug_verbose``), and
``warning/inform/fatal`` severities. Also hosts the in-memory *debug history*
ring analogous to PARSEC_DEBUG_HISTORY (parsec/utils/debug.h:41-60): the last N
critical runtime events are kept in a ring, dumpable on deadlock.
"""

from __future__ import annotations

import collections
import os
import sys
import threading
import time
from typing import Deque, Tuple

from . import mca

mca.register("debug_verbose", 0, "Global debug verbosity (0=off .. 10=noisiest)", type=int)
mca.register("debug_history_size", 4096, "Entries kept in the in-memory debug history ring", type=int)

_lock = threading.Lock()
_history: Deque[Tuple[float, str, str]] = collections.deque(maxlen=4096)


def _emit(level: str, msg: str) -> None:
    with _lock:
        sys.stderr.write(f"[parsec-tpu:{os.getpid()}:{level}] {msg}\n")


def debug_verbose(level: int, subsystem: str, msg: str) -> None:
    """parsec_debug_verbose equivalent: print only when verbosity >= level."""
    history_add(subsystem, msg)
    if mca.get("debug_verbose", 0) >= level:
        _emit(f"D{level}:{subsystem}", msg)


def inform(msg: str) -> None:
    _emit("info", msg)


def warning(msg: str) -> None:
    _emit("warn", msg)


def fatal(msg: str) -> None:
    """parsec_fatal: print and raise (the reference aborts; we raise)."""
    _emit("fatal", msg)
    raise RuntimeError(msg)


def history_add(subsystem: str, msg: str) -> None:
    """PARSEC_DEBUG_HISTORY ring append (parsec/utils/debug.h:41-60)."""
    _history.append((time.monotonic(), subsystem, msg))


def history_dump(limit: int = 200) -> str:
    """Dump the tail of the debug-history ring (gdb helper in the reference)."""
    with _lock:
        items = list(_history)[-limit:]
    return "\n".join(f"{t:.6f} [{s}] {m}" for t, s, m in items)
