"""The native host lanes: the DTD engine and the scheduler plane as CPython
extensions built from the package's own C++ (``csrc/ptdtd.cpp``,
``csrc/ptsched.cpp``).

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
cost more than the work; a C-extension method call costs about 0.2 us.

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
from typing import Dict, List

from .utils import mca, output

mca.register("native_enabled", True,
             "Use the native C++ lanes (the DTD engine and the scheduler "
             "plane); 0 selects the Python engine", type=bool)

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
    """Where :func:`build` puts the extension of ``csrc/<stem>.cpp``."""
    h = hashlib.sha256(" ".join(cxx() + _flags()).encode())
    for path in _sources(os.path.join(CSRC_DIR, f"{stem}.cpp")):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"_{stem}-{h.hexdigest()[:16]}"
                        + sysconfig.get_config_var("EXT_SUFFIX"))


def build(stem: str) -> str:
    """Compile ``csrc/<stem>.cpp`` into a CPython extension (once per
    content of the source, its headers, the compiler and the flags) and
    return its path. Raises with the compiler's messages when it fails."""
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
