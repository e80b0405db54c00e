"""Backend health decision: a subprocess probe under a hard timeout.

A wedged accelerator transport can hang the FIRST in-process touch of the
device forever, and a later in-process timeout cannot undo an
initialization already in flight. So whether the card answers is decided by
a THROWAWAY subprocess under a hard timeout (``torch.cuda.device_count()``
there), before a context touches CUDA in this process.

The probe reports and caches; it never moves a context. A context that
asked for the card (:class:`~parsec_tpu_torch.core.context.Context`'s
default) after a failed probe raises with the probe's reason; only the
caller's ``device="cpu"`` runs on the CPU.

The wedged case pays the full timeout, so the decision is shared across
processes through a small TTL'd cache file: a test suite, an example run,
or an N-rank launch pays the probe once per TTL window, not once per
process.

Ref: PaRSEC trusts its device query to return promptly
(``parsec/mca/device/cuda/device_cuda_module.c:45`` simply counts CUDA
devices); probing-for-health in a child process is this runtime's
addition.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from typing import Optional, Tuple

from ..utils import mca, output

mca.register("device_discovery_timeout_s", 45,
             "Give up on accelerator discovery after this many seconds",
             type=int)
mca.register("device_probe_cache_ttl_s", 300,
             "Reuse a backend-health probe result this many seconds "
             "(0 disables the cross-process cache)", type=int)
mca.register("device_probe_failure_ttl_s", 120,
             "Reuse a FAILED probe result this many seconds — shorter than "
             "the healthy TTL so a transient failure cannot report a "
             "healthy card as missing for long", type=int)

#: set by a launcher after ITS single probe: ranks skip re-probing and
#: report the CPU
ENV_FORCE_CPU = "PARSEC_TPU_TORCH_FORCE_CPU"

_decision: Optional[Tuple[str, int]] = None   # (platform, device_count)
#: why the decision is not "cuda" ("" when it is)
_reason = ""
_lock = threading.Lock()

_PROBE_SRC = ("import torch; n = torch.cuda.device_count() "
              "if torch.cuda.is_available() else 0; "
              "print('cuda' if n else 'cpu', n)")


def _cache_path() -> str:
    uid = getattr(os, "getuid", lambda: 0)()
    return os.path.join(tempfile.gettempdir(),
                        f"parsec_tpu_torch_cuda_probe_{uid}.json")


def _read_cache() -> Optional[Tuple[str, int, str]]:
    ttl = mca.get("device_probe_cache_ttl_s", 300)
    if ttl <= 0:
        return None
    try:
        with open(_cache_path()) as f:
            rec = json.load(f)
        # failed probes expire sooner: a transient failure must not report
        # a healthy host's card as missing for the full healthy-TTL window
        if rec["platform"] != "cuda":
            ttl = min(ttl, mca.get("device_probe_failure_ttl_s", 120))
        if time.time() - rec["time"] <= ttl:
            return rec["platform"], int(rec["count"]), rec.get("reason", "")
    except (OSError, ValueError, KeyError, TypeError):
        pass
    return None


def _write_cache(platform: str, count: int, reason: str) -> None:
    if mca.get("device_probe_cache_ttl_s", 300) <= 0:
        return
    try:
        fd, tmp = tempfile.mkstemp(dir=tempfile.gettempdir(),
                                   prefix="parsec_tpu_torch_cuda_probe_")
        with os.fdopen(fd, "w") as f:
            json.dump({"platform": platform, "count": count,
                       "reason": reason, "time": time.time()}, f)
        os.replace(tmp, _cache_path())   # atomic vs concurrent probers
    except OSError as e:
        output.debug_verbose(1, "device", f"probe cache not written: {e}")


def _probe_single_flight() -> Tuple[str, int, str]:
    """Cache read → probe → cache write, serialized across processes on a
    lock file: two cold-starting processes racing for the card would
    otherwise each spawn a probe child. The loser of the lock re-reads the
    winner's fresh record instead of probing."""
    cached = _read_cache()
    if cached is not None:
        return cached
    import fcntl
    lock_fd = os.open(_cache_path() + ".lock", os.O_CREAT | os.O_RDWR, 0o644)
    try:
        fcntl.flock(lock_fd, fcntl.LOCK_EX)
        cached = _read_cache()        # the lock's previous holder may have
        if cached is None:            # just written the answer
            cached = _subprocess_probe(
                float(mca.get("device_discovery_timeout_s", 45)))
            _write_cache(*cached)
        return cached
    finally:
        os.close(lock_fd)             # releases the flock


def _subprocess_probe(timeout: float) -> Tuple[str, int, str]:
    """(platform, count, reason) from a throwaway process: ("cuda", n, "")
    when it counts n >= 1 cards, else ("cpu", 0, why)."""
    try:
        p = subprocess.run([sys.executable, "-c", _PROBE_SRC],
                           capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        why = (f"the CUDA probe timed out after {timeout:.0f} s: the card "
               f"does not answer")
        output.warning(why)
        return "cpu", 0, why
    except OSError as e:
        return "cpu", 0, f"the CUDA probe could not start: {e}"
    if p.returncode != 0 or not p.stdout.strip():
        tail = (p.stderr.strip().splitlines() or ["no output"])[-1]
        return "cpu", 0, f"the CUDA probe exited {p.returncode}: {tail}"
    platform, count = p.stdout.strip().splitlines()[-1].split()
    if platform != "cuda":
        return "cpu", 0, "the CUDA probe found no card"
    return "cuda", int(count), ""


def decide_backend() -> Tuple[str, int]:
    """Whether this process has a CUDA card: ``("cuda", count)`` or
    ``("cpu", 0)``, decided once per process (by the cross-process cache or
    a subprocess probe) and reported by :func:`reason` when it is not
    "cuda". ``PARSEC_TPU_TORCH_FORCE_CPU=1`` decides "cpu" without a probe.
    Safe to call from anywhere; a later call is an in-process hit."""
    global _decision, _reason
    with _lock:
        if _decision is not None:
            return _decision
        if os.environ.get(ENV_FORCE_CPU) == "1":
            _decision, _reason = ("cpu", 0), f"{ENV_FORCE_CPU}=1"
            return _decision
        platform, count, why = _probe_single_flight()
        _decision, _reason = (platform, count), why
        return _decision


def reason() -> str:
    """Why the decision is not "cuda" ("" when it is, or before one)."""
    return _reason


def reset_for_tests() -> None:
    """Drop the in-process decision and the cache file (test isolation)."""
    global _decision, _reason
    with _lock:
        _decision, _reason = None, ""
    try:
        os.remove(_cache_path())
    except OSError:
        pass
