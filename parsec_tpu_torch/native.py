"""The native host lanes: the DTD engine, the PTG execution lane, the
scheduler plane, the device lane and the comm lane as CPython extensions
built from the package's own C++ (``csrc/ptdtd.cpp``, ``csrc/ptexec.cpp``,
``csrc/ptsched.cpp``, ``csrc/ptdev.cpp``, ``csrc/ptcomm.cpp``), and the
native core (``csrc/ptcore.cpp``: the dependency table and the zone
allocator) as a plain C library
bound with ctypes.

They run on the host, beside the card, so they are built with the host C++
compiler (``$CXX``, else ``c++``) and the flags
``-O3 -fPIC -std=c++17 -Wall -pthread -shared -I<Python include>``, not with
``nvcc``: these files hold no device code. The build happens at first use
into ``parsec_tpu_torch/build/`` under a name that holds a digest of the
source, of every header it includes, of the compiler and of the flags, so an
edit builds anew; a file lock lets concurrent processes (pytest workers)
build once, and ``os.replace`` publishes a finished file atomically.

Why CPython extensions and not ctypes: the engine is called once per task
on the insert and completion paths, where a ctypes call (about 2 us) would
cost more than the work; a C-extension method call costs about 0.2 us. The
dependency table keeps ctypes, as the reference does: its work per call (a
hash and a probe under a lock) is what it was measured against.

While ``--mca native_enabled`` is on (the default) a failed build or load
raises with the compiler's messages; nothing falls back to the Python
engine behind the caller's back. ``--mca native_enabled 0`` selects the
Python engine explicitly (the loaders then return None).
"""

from __future__ import annotations

import fcntl
import hashlib
import importlib.util
import os
import re
import shlex
import subprocess
import sysconfig
import tempfile
import threading
from typing import Dict, List, Optional, Tuple

from .utils import mca, output

mca.register("native_enabled", True,
             "Use the native C++ lanes (the DTD engine, the PTG execution "
             "lane, the scheduler plane and the dependency table); 0 "
             "selects the Python engines", type=bool)

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread", "-shared")

_lock = threading.Lock()
_mods: Dict[str, object] = {}
#: the compiler's messages (its warnings) for each extension this process built
build_log: Dict[str, str] = {}

_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def cxx() -> List[str]:
    """The host C++ compiler command: ``$CXX`` (split like a shell word
    list), else ``c++``."""
    return shlex.split(os.environ.get("CXX") or "c++")


def _flags() -> List[str]:
    return [*CXX_FLAGS, "-I" + sysconfig.get_paths()["include"]]


def _sources(path: str, seen=None) -> list:
    """``path`` and every file it includes with ``#include "..."`` (found
    beside it), recursively, each once."""
    seen = [] if seen is None else seen
    if path not in seen:
        seen.append(path)
        with open(path, "rb") as f:
            for inc in _INCLUDE.findall(f.read()):
                _sources(os.path.join(os.path.dirname(path), inc.decode()),
                         seen)
    return seen


def extension_path(stem: str) -> str:
    """Where :func:`build` puts the shared library of ``csrc/<stem>.cpp``."""
    h = hashlib.sha256(" ".join(cxx() + _flags()).encode())
    for path in _sources(os.path.join(CSRC_DIR, f"{stem}.cpp")):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"_{stem}-{h.hexdigest()[:16]}"
                        + sysconfig.get_config_var("EXT_SUFFIX"))


def build(stem: str) -> str:
    """Compile ``csrc/<stem>.cpp`` into a shared library (a CPython
    extension, or the plain C library of ``ptcore``; once per content of
    the source, its headers, the compiler and the flags) and return its
    path. Raises with the compiler's messages when it fails."""
    so = extension_path(stem)
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f".{stem}.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)      # one build across processes
        try:
            if os.path.exists(so):
                return so
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                cmd = cxx() + _flags() + [
                    "-o", tmp, os.path.join(CSRC_DIR, f"{stem}.cpp")]
                try:
                    proc = subprocess.run(cmd, capture_output=True,
                                          text=True)
                except OSError as e:
                    raise RuntimeError(f"building {stem}: cannot run "
                                       f"{cmd[0]!r}: {e}") from e
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"building {stem} failed ({shlex.join(cmd)}):\n"
                        f"{proc.stderr}")
                os.replace(tmp, so)     # all or nothing for other readers
                build_log[stem] = proc.stderr
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)
    return so


def _load(stem: str):
    """The extension module ``parsec_tpu_torch._<stem>``, built and loaded
    once per process; None when ``--mca native_enabled 0``."""
    if not mca.get("native_enabled", True):
        return None
    mod = _mods.get(stem)
    if mod is not None:
        return mod
    with _lock:
        mod = _mods.get(stem)
        if mod is None:
            so = build(stem)
            spec = importlib.util.spec_from_file_location(
                f"parsec_tpu_torch._{stem}", so)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _mods[stem] = mod
            output.debug_verbose(1, "native", f"_{stem} loaded from {so}")
    return mod


def load_ptdtd():
    """The DTD dependency engine (``csrc/ptdtd.cpp``): the per-task lane
    (insert/activate/complete) and the batched lane (register_class/
    insert_many/drain_ready) over one chain state; None when
    ``--mca native_enabled 0``."""
    return _load("ptdtd")


def load_ptsched():
    """The multi-pool scheduler plane (``csrc/ptsched.cpp``): per-worker
    hot queues with steal-half, per-pool overflow heaps, weighted deficit
    round robin and admission windows; None when ``--mca native_enabled
    0``."""
    return _load("ptsched")


def load_ptexec():
    """The PTG execution lane (``csrc/ptexec.cpp``): the generic task FSM
    (dependency-count decrement, ready detect, batched dispatch, successor
    release, and in data mode the slot retire protocol) over a flattened
    successor table, with the GIL dropped across the walk; None when
    ``--mca native_enabled 0``."""
    return _load("ptexec")


def load_ptcomm():
    """The native communication lane (``csrc/ptcomm.cpp``): one funneled
    progress thread over the mesh's TCP fds and same-host shared-memory
    rings, binary activation/data/rendezvous frames, and GIL-free ingest
    into the PTG lane's graphs; None when ``--mca native_enabled 0``."""
    return _load("ptcomm")


def load_ptdev():
    """The device lane (``csrc/ptdev.cpp``): the per-device ``Lane`` (a
    lock-free pending queue fed by the engines, one manager thread that
    dispatches and polls through Python callbacks under the GIL, and the
    GIL-free retire into the engines) and the ``CohTable`` (the coherency
    and residency table); None when ``--mca native_enabled 0``."""
    return _load("ptdev")


_core = None
_KEY_MAX = 16


def load_core():
    """The native core (``csrc/ptcore.cpp``) as a ctypes library with its
    dependency-table signatures set, built at first use; None when
    ``--mca native_enabled 0``. A failed build raises."""
    global _core
    if not mca.get("native_enabled", True):
        return None
    if _core is not None:
        return _core
    import ctypes
    with _lock:
        if _core is None:
            lib = ctypes.CDLL(build("ptcore"))
            lib.pt_dep_table_create.restype = ctypes.c_void_p
            lib.pt_dep_table_create.argtypes = [ctypes.c_uint64]
            lib.pt_dep_table_destroy.argtypes = [ctypes.c_void_p]
            lib.pt_dep_table_size.restype = ctypes.c_int64
            lib.pt_dep_table_size.argtypes = [ctypes.c_void_p]
            lib.pt_dep_table_update.restype = ctypes.c_int32
            lib.pt_dep_table_update.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int32]
            lib.pt_dep_table_get.restype = ctypes.c_int64
            lib.pt_dep_table_get.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int32]
            lib.pt_zone_create.restype = ctypes.c_void_p
            lib.pt_zone_create.argtypes = [ctypes.c_int64, ctypes.c_int64]
            lib.pt_zone_destroy.argtypes = [ctypes.c_void_p]
            lib.pt_zone_alloc.restype = ctypes.c_int64
            lib.pt_zone_alloc.argtypes = [ctypes.c_void_p, ctypes.c_int64]
            lib.pt_zone_free.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                         ctypes.c_int64]
            lib.pt_zone_stats.argtypes = [ctypes.c_void_p,
                                          ctypes.POINTER(ctypes.c_int64)]
            _core = lib
            output.debug_verbose(1, "native", "ptcore loaded")
    return _core


class NativeDepTable:
    """Dependency tracker for int-tuple keys (mask or counter mode), the
    ``parsec_update_deps_with_mask`` role behind ``Taskpool.update_deps``."""

    __slots__ = ("_t", "_lib")

    def __init__(self, capacity: int = 1 << 16) -> None:
        self._lib = load_core()
        if self._lib is None:
            raise RuntimeError("the native core is off (--mca "
                               "native_enabled 0)")
        self._t = self._lib.pt_dep_table_create(capacity)
        if not self._t:
            raise MemoryError("pt_dep_table_create failed")

    @staticmethod
    def key_ok(key) -> bool:
        if isinstance(key, int):
            return True
        return (isinstance(key, tuple) and len(key) <= _KEY_MAX
                and all(isinstance(k, int) for k in key))

    @staticmethod
    def _pack(key) -> Tuple[object, int]:
        # a fresh array per call: update() runs concurrently on worker
        # threads, and a shared buffer would race before the C side copies it
        import ctypes
        if isinstance(key, int):
            return (ctypes.c_int64 * 1)(key), 1
        return (ctypes.c_int64 * len(key))(*key), len(key)

    def update(self, key, contribution: int, goal: Optional[int],
               count_mode: bool) -> bool:
        buf, klen = self._pack(key)
        rc = self._lib.pt_dep_table_update(
            self._t, buf, klen, contribution, -1 if goal is None else goal,
            1 if count_mode else 0)
        if rc < 0:
            raise RuntimeError(f"native dep table error {rc}")
        return rc == 1

    def get(self, key) -> int:
        buf, klen = self._pack(key)
        return self._lib.pt_dep_table_get(self._t, buf, klen)

    def __len__(self) -> int:
        return self._lib.pt_dep_table_size(self._t)

    def __del__(self) -> None:
        try:
            if self._t and self._lib:
                self._lib.pt_dep_table_destroy(self._t)
        except Exception:  # noqa: BLE001 - interpreter shutdown
            pass


class NativeZone:
    """The native zone allocator (``csrc/ptcore.cpp`` ``pt_zone_*``): the
    first-fit, coalescing offset allocator of
    :class:`~parsec_tpu_torch.utils.zone_malloc.ZoneMalloc` in C++, over
    ``total_bytes`` in ``unit``-byte segments. ``alloc`` returns a byte
    offset, or None when no hole fits."""

    __slots__ = ("_z", "_lib")

    def __init__(self, total_bytes: int, unit: int = 1 << 20) -> None:
        self._lib = load_core()
        if self._lib is None:
            raise RuntimeError("the native core is off (--mca "
                               "native_enabled 0)")
        self._z = self._lib.pt_zone_create(total_bytes, unit)
        if not self._z:
            raise MemoryError("pt_zone_create failed")

    def alloc(self, nbytes: int) -> Optional[int]:
        off = self._lib.pt_zone_alloc(self._z, nbytes)
        return None if off < 0 else off

    def free(self, offset: int, nbytes: int) -> None:
        self._lib.pt_zone_free(self._z, offset, nbytes)

    def stats(self) -> dict:
        import ctypes
        out = (ctypes.c_int64 * 4)()
        self._lib.pt_zone_stats(self._z, out)
        return {"free_bytes": out[0], "in_use_bytes": out[1],
                "hwm_bytes": out[2], "largest_hole_bytes": out[3]}

    def __del__(self) -> None:
        try:
            if self._z and self._lib:
                self._lib.pt_zone_destroy(self._z)
        except Exception:  # noqa: BLE001 - interpreter shutdown
            pass
