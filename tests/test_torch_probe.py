"""The backend probe (device/probe.py) of the port.

The reference's tests (tests/test_probe.py) adapted to what the port
probes: a throwaway interpreter counts CUDA cards under a timeout, the
decision is cached in process and across processes (a file of the port's
own), an environment variable forces the CPU answer, and the probe never
moves a context: a context that asked for the card after a failed probe
raises with the probe's reason.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from parsec_tpu.device import probe as ref_probe
from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.device import cuda as cuda_mod
from parsec_tpu_torch.device import probe
from parsec_tpu_torch.utils import mca


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """Every test gets its own cache directory and no decision."""
    monkeypatch.setattr(probe.tempfile, "gettempdir", lambda: str(tmp_path))
    monkeypatch.delenv(probe.ENV_FORCE_CPU, raising=False)
    probe.reset_for_tests()
    yield
    probe.reset_for_tests()


def _fake_probe(monkeypatch, result):
    calls = []

    def fake(timeout):
        calls.append(timeout)
        return result
    monkeypatch.setattr(probe, "_subprocess_probe", fake)
    return calls


def test_force_cpu_env(monkeypatch):
    calls = _fake_probe(monkeypatch, ("cuda", 1, ""))
    monkeypatch.setenv(probe.ENV_FORCE_CPU, "1")
    assert probe.decide_backend() == ("cpu", 0)
    assert probe.reason() == f"{probe.ENV_FORCE_CPU}=1"
    assert calls == []


def test_decision_is_cached_in_process(monkeypatch):
    calls = _fake_probe(monkeypatch, ("cuda", 2, ""))
    d1 = probe.decide_backend()
    d2 = probe.decide_backend()
    assert d1 is d2 and d1 == ("cuda", 2) and probe.reason() == ""
    assert len(calls) == 1
    assert calls[0] == float(mca.get("device_discovery_timeout_s", 45))


def test_cache_file_roundtrip():
    probe._write_cache("cuda", 4, "")
    assert probe._read_cache() == ("cuda", 4, "")
    rec = json.load(open(probe._cache_path()))
    assert rec["platform"] == "cuda" and rec["count"] == 4


def test_cache_file_is_the_ports_own(tmp_path):
    """The reference caches its TPU decision ("tpu"/"cpu") in a file of its
    own; the port's CUDA decision must never read or overwrite it."""
    uid = getattr(os, "getuid", lambda: 0)()
    assert os.path.basename(probe._cache_path()) != \
        f"parsec_tpu_probe_{uid}.json"
    assert os.path.basename(probe._cache_path()) != \
        os.path.basename(ref_probe._cache_path())
    (tmp_path / f"parsec_tpu_probe_{uid}.json").write_text(json.dumps(
        {"platform": "tpu", "count": 4, "time": 1e18}))
    assert probe._read_cache() is None


def test_cache_ttl_expiry():
    probe._write_cache("cuda", 4, "")
    rec = json.load(open(probe._cache_path()))
    rec["time"] -= 10_000            # age far past any sane TTL
    json.dump(rec, open(probe._cache_path(), "w"))
    assert probe._read_cache() is None


def test_failed_probe_expires_sooner():
    probe._write_cache("cpu", 0, "the CUDA probe found no card")
    rec = json.load(open(probe._cache_path()))
    rec["time"] -= mca.get("device_probe_failure_ttl_s", 120) + 1
    json.dump(rec, open(probe._cache_path(), "w"))
    assert probe._read_cache() is None
    probe._write_cache("cuda", 1, "")
    rec = json.load(open(probe._cache_path()))
    rec["time"] -= mca.get("device_probe_failure_ttl_s", 120) + 1
    json.dump(rec, open(probe._cache_path(), "w"))
    assert probe._read_cache() == ("cuda", 1, "")


def test_a_second_process_reads_the_cache(monkeypatch):
    """Cache hit: a decision written by one process (here: the file) is a
    later process's answer, with no probe."""
    calls = _fake_probe(monkeypatch, ("cpu", 0, "unused"))
    probe._write_cache("cuda", 3, "")
    assert probe.decide_backend() == ("cuda", 3)
    assert calls == []


def test_subprocess_probe_real_interpreter():
    """The probe's throwaway interpreter and its parsing work end to end:
    it answers what this process's torch sees."""
    want = ("cuda", torch.cuda.device_count()) if torch.cuda.is_available() \
        else ("cpu", 0)
    platform, count, why = probe._subprocess_probe(120.0)
    assert (platform, count) == want
    assert (why == "") == (platform == "cuda")
    p = subprocess.run([sys.executable, "-c", probe._PROBE_SRC],
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0
    assert p.stdout.split() == [want[0], str(want[1])]


def test_a_probe_that_hangs_or_fails_reports_why(monkeypatch):
    def hang(*a, **kw):
        raise subprocess.TimeoutExpired(cmd="probe", timeout=kw["timeout"])
    monkeypatch.setattr(probe.subprocess, "run", hang)
    platform, count, why = probe._subprocess_probe(3.0)
    assert (platform, count) == ("cpu", 0) and "timed out after 3 s" in why

    def fail(*a, **kw):
        return subprocess.CompletedProcess(a, 1, "", "RuntimeError: boom\n")
    monkeypatch.setattr(probe.subprocess, "run", fail)
    platform, _count, why = probe._subprocess_probe(3.0)
    assert platform == "cpu" and why.endswith("RuntimeError: boom")


def test_discover_calls_probe_and_raises_with_its_reason(monkeypatch):
    """Device discovery for a card asks the probe first; a failed probe
    does not move the context to the CPU: discovery raises with the
    probe's reason."""
    calls = _fake_probe(monkeypatch, ("cpu", 0, "the CUDA probe exited 1: "
                                      "no driver"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(RuntimeError, match="backend probe decided 'cpu': "
                                           "the CUDA probe exited 1: no "
                                           "driver"):
        cuda_mod.discover_cuda_devices(torch.device("cuda"))
    assert len(calls) == 1
    # the CPU context never probes
    probe.reset_for_tests()
    ctx = Context(nb_cores=1, device="cpu")
    ctx.fini()
    assert len(calls) == 1


def test_context_on_the_card_never_falls_back_to_the_cpu():
    """Without a card, ``Context()`` (the card by default) raises: neither
    the probe nor discovery hands back a CPU context."""
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        Context(nb_cores=1)
