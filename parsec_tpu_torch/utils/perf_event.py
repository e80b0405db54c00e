"""Linux hardware performance counters via raw perf_event_open.

The PAPI role (ref: parsec/mca/pins/papi/ — the reference samples PMU
counters around task lifecycle events through libpapi). No PAPI exists in
this stack, so the syscall is issued directly through ctypes: self-process,
user-space-only counting needs no privileges at perf_event_paranoid <= 2.

Degrades gracefully everywhere it cannot work (seccomp-filtered
containers, non-Linux, PMU-less VMs): :func:`available` probes once and
the PINS module becomes a no-op, mirroring how the reference builds the
papi module only when libpapi is found (CMake feature probe).
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
from typing import Dict, Optional, Sequence, Tuple

_SYS_perf_event_open = {"x86_64": 298, "aarch64": 241}.get(os.uname().machine)

_PERF_TYPE_HARDWARE = 0
#: PERF_COUNT_HW_* ids (linux/perf_event.h)
EVENTS: Dict[str, int] = {
    "cycles": 0,
    "instructions": 1,
    "cache_references": 2,
    "cache_misses": 3,
    "branch_instructions": 4,
    "branch_misses": 5,
}

# ioctls (linux/perf_event.h): _IO('$', 0..2)
_PERF_IOC_ENABLE = 0x2400
_PERF_IOC_DISABLE = 0x2401
_PERF_IOC_RESET = 0x2403

_ATTR_SIZE = 128          # PERF_ATTR_SIZE_VER7


def _attr_bytes(config: int) -> bytes:
    """A perf_event_attr for plain counting: disabled at open,
    exclude_kernel | exclude_hv (bits 5 and 6 of the flags word)."""
    flags = (1 << 0) | (1 << 5) | (1 << 6)    # disabled, excl_kernel, excl_hv
    return struct.pack(
        "IIQQQQ",
        _PERF_TYPE_HARDWARE,   # type
        _ATTR_SIZE,            # size
        config,                # config
        0,                     # sample_period/freq
        0,                     # sample_type
        0,                     # read_format
    ) + struct.pack("Q", flags) + b"\x00" * (_ATTR_SIZE - 48)


_libc = None


def _open_event(config: int) -> int:
    """fd for a self-process, any-cpu counter; raises OSError."""
    global _libc
    if _SYS_perf_event_open is None:
        raise OSError("unsupported architecture for perf_event_open")
    if _libc is None:
        _libc = ctypes.CDLL(None, use_errno=True)
    buf = ctypes.create_string_buffer(_attr_bytes(config), _ATTR_SIZE)
    fd = _libc.syscall(_SYS_perf_event_open, buf, 0, -1, -1, 0)
    if fd < 0:
        e = ctypes.get_errno()
        raise OSError(e, f"perf_event_open failed: {os.strerror(e)}")
    return fd


class HWCounterSet:
    """A group of hardware counters read together.

    >>> hw = HWCounterSet(("cycles", "instructions"))
    >>> hw.start(); ...work...; delta = hw.read()
    """

    def __init__(self, events: Sequence[str] = ("cycles", "instructions")):
        self.events: Tuple[str, ...] = tuple(events)
        self._fds = []
        try:
            for name in self.events:
                self._fds.append(_open_event(EVENTS[name]))
        except OSError:
            self.close()
            raise
        self._lock = threading.Lock()

    def start(self) -> None:
        import fcntl
        for fd in self._fds:
            fcntl.ioctl(fd, _PERF_IOC_RESET, 0)
            fcntl.ioctl(fd, _PERF_IOC_ENABLE, 0)

    def read(self) -> Dict[str, int]:
        out = {}
        for name, fd in zip(self.events, self._fds):
            out[name] = struct.unpack("q", os.read(fd, 8))[0]
        return out

    def stop(self) -> Dict[str, int]:
        import fcntl
        vals = self.read()
        for fd in self._fds:
            fcntl.ioctl(fd, _PERF_IOC_DISABLE, 0)
        return vals

    def close(self) -> None:
        for fd in self._fds:
            try:
                os.close(fd)
            except OSError:
                pass
        self._fds = []

    def __del__(self):  # pragma: no cover - interpreter shutdown
        self.close()


_avail: Optional[bool] = None


def available() -> bool:
    """One cached probe: can this process count its own cycles?"""
    global _avail
    if _avail is None:
        try:
            hw = HWCounterSet(("cycles",))
            hw.start()
            hw.stop()
            hw.close()
            _avail = True
        except Exception:  # noqa: BLE001 — seccomp/EPERM/ENOENT/arch
            _avail = False
    return _avail
