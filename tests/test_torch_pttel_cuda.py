"""Card-only tests of the mesh telemetry plane and the package's entry
points: ``python -m parsec_tpu_torch --devices`` on a card context, and the
card serving leg (a card control context serving ``gemm_chain`` requests)
with the telemetry plane pushing.

Every test here carries the ``cuda`` marker and skips without a CUDA card.
The file imports neither JAX nor the reference package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_pttel_cuda.py
"""

import functools
import os
import subprocess
import sys

import pytest
import torch

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def test_cli_devices_lists_the_cuda_module():
    _need_card()
    out = subprocess.run([sys.executable, "-m", "parsec_tpu_torch",
                          "--devices"], cwd=ROOT, capture_output=True,
                         text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert any(line.startswith("0: cpu") for line in lines), lines
    assert any("cuda(0)" in line and line.endswith("on cuda:0")
               for line in lines), lines


def test_card_serving_leg_with_the_plane_on_the_card():
    """A card control context serves 16 bf16 GEMM_K requests (C 256², kt
    32) while the plane pushes every 25 ms: one ``gemm_chain`` launch a
    request, every C tile the plain chain's bit for bit, rank 0's rollup of
    the served and routed-insert counters equal to each rank's own, and
    the reconciler's rounds read from it with no HTTP fetch."""
    _need_card()
    from parsec_tpu_torch.comm.tcp import run_distributed_procs
    from parsec_tpu_torch.serving.harness import card_serving_2rank_program
    server, client = run_distributed_procs(
        2, functools.partial(card_serving_2rank_program, requests=16,
                             window=8, ts=256, tel_interval_ms=25),
        timeout=300)
    assert server["card_context"] and server["telemetry"]
    assert server["served"] == 16 and server["launches"] == 16
    assert server["tiles_equal_plain"]
    assert server["per_rank_served"] == {0: server["served_local"],
                                         1: client["served_local"]}
    assert server["per_rank_served"][0]["ptfab.remote_inserts_rx"] == 16
    assert server["reconcile_mode"] == "push"
    assert server["reconcile"]["push_rounds"] > 0
    assert server["reconcile"]["http_fetches"] == 0
    assert server["wire"]["frame_errors"] == 0
    assert client["wire"]["frame_errors"] == 0
