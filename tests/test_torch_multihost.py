"""Multi-controller rank groups on the port (the reference's
``tests/test_multihost.py``) and the rank pool's failure handling.

``run_multicontroller(2, worker, devices_per_proc=4)`` starts 2 "hosts" x 4
ranks, each rank its own interpreter with torchrun's local-rank
environment, joined into one gloo group: the LM train step over the global
(dp, tp) mesh, the per-rank input feed, a DCP checkpoint of the sharded
state, the ep all-to-all, the GPipe ring and the sequence ring all cross
the "hosts". Every rank reports the same losses, which equal one
8-rank "host"'s and the reference's on its 8-device mesh. Then a rank
that raises, aborts or hangs fails its job with every rank's status and
output, quickly, and the pool comes back."""

import os
import re
import time

import numpy as np
import pytest

import _torch_mesh_jobs as J
from parsec_tpu_torch.parallel import compat
from parsec_tpu_torch.parallel.multihost import (RankFailure, RankPool,
                                                 cpu_collectives_available,
                                                 run_multicontroller)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_multihost_worker.py")
JOB_S = 150.0


def _losses(out: str):
    m = re.search(r"MHLOSS pid=\d+ host=\d+ local=\d+ losses=([\d.,-]+)",
                  out)
    assert m, f"no MHLOSS line in:\n{out[-1200:]}"
    return [float(v) for v in m.group(1).split(",")]


def test_two_controller_global_mesh_lm_train_step():
    assert cpu_collectives_available()
    outs = run_multicontroller(2, WORKER, devices_per_proc=4,
                               timeout=JOB_S, device_type="cpu")
    assert len(outs) == 8
    l0 = _losses(outs[0])
    for o in outs[1:]:
        # every rank observes the SAME replicated losses
        np.testing.assert_allclose(_losses(o), l0, rtol=1e-6, atol=1e-6)
    assert l0[-1] < l0[0]
    # the torchrun environment: 2 hosts of local ranks 0..3
    hosts = sorted(re.search(r"host=(\d+) local=(\d+)", o).groups()
                   for o in outs)
    assert hosts == [(str(h), str(l)) for h in range(2) for l in range(4)]
    spans = sorted(re.search(r"MHRING pid=\d+ err=[\d.e+-]+ span=(\d+):(\d+)",
                             o).groups() for o in outs)
    assert spans == sorted((str(8 * i), str(8 * i + 8)) for i in range(8))
    for tag in ("MHCKPT pid=\\d+ step=3 ok=1", "MHMOE pid=", "MHFEED pid=",
                "MHPP pid="):
        assert all(re.search(tag, o) for o in outs), tag
    # one "host" of 8 ranks computes the same numbers
    ref = run_multicontroller(1, WORKER, devices_per_proc=8, timeout=JOB_S,
                              device_type="cpu")
    np.testing.assert_allclose(_losses(ref[0]), l0, rtol=2e-5, atol=2e-5)
    # and so does the reference on its 8-device (dp, tp) mesh
    from parsec_tpu.parallel.model import (ModelConfig, init_lm_params,
                                           make_lm_train_step)
    from parsec_tpu.parallel.multihost import fetch_replicated
    from parsec_tpu.parallel.spmd import make_mesh
    cfg = ModelConfig(vocab_size=64, d_model=32, d_ff=64, n_heads=4,
                      n_layers=2, max_seq=16)
    params = init_lm_params(0, cfg)
    step, place_p, place_t = make_lm_train_step(
        make_mesh(8, axis_names=("dp", "tp")), params=params, lr=0.1)
    params = place_p(params)
    toks = np.random.default_rng(5).integers(0, 64, size=(8, 8)).astype(
        np.int32)
    jl = []
    for _ in range(3):
        params, loss = step(params, place_t(toks[:, :-1]),
                            place_t(toks[:, 1:]))
        jl.append(float(fetch_replicated(loss)))
    np.testing.assert_allclose(l0, jl, rtol=2e-5, atol=2e-5)


def test_a_rank_that_fails_ends_the_multicontroller_job_at_once(tmp_path):
    """A rank script that exits 1 while its peers wait in the group's
    rendezvous fails the job within seconds, with every rank's status."""
    script = tmp_path / "bad.py"
    script.write_text(
        "import os, sys, time\n"
        "if os.environ['RANK'] == '2':\n"
        "    print('rank 2 gives up', flush=True); sys.exit(1)\n"
        "time.sleep(60)\n")
    t = time.monotonic()
    with pytest.raises(RuntimeError) as e:
        run_multicontroller(1, str(script), devices_per_proc=4, timeout=60,
                            device_type="cpu")
    assert time.monotonic() - t < 30
    assert "rank(s) [2] failed" in str(e.value)
    assert "rank 2 exit 1" in str(e.value) and "rank 2 gives up" in \
        str(e.value)


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4, "cpu", timeout=JOB_S)
    yield p
    p.close()


def test_pool_probes_the_collectives_and_keeps_its_ranks(pool):
    first = pool.run(J.rank)
    assert first == [0, 1, 2, 3]
    assert pool.native["cpu"] == dict.fromkeys(compat.OPS, True)
    assert pool.starts == 1
    assert pool.run(J.rank) == first and pool.starts == 1


@pytest.mark.parametrize("how", ["raise", "abort", "hang"])
def test_a_failing_rank_fails_the_job_with_every_ranks_status(pool, how):
    """A rank that raises, dies (a c10d-style abort) or hangs past the
    job's deadline fails the job with each rank's status and output tail,
    long before the suite's limit; the next job gets a new pool."""
    t = time.monotonic()
    err = RankFailure if how != "hang" else TimeoutError
    with pytest.raises(err) as e:
        pool.run(J.misbehave, how, timeout=6.0)
    assert time.monotonic() - t < 20
    msg = str(e.value)
    if how == "raise":
        assert "--- rank 1: raised" in msg and "rank 1 says no" in msg
    elif how == "abort":
        assert "--- rank 1: died, exit -6" in msg
    else:
        assert "--- rank 1: hung" in msg and "job timed out" in msg
    assert msg.count("--- rank ") == 4
    starts = pool.starts
    assert pool.run(J.rank) == [0, 1, 2, 3]
    assert pool.starts == starts + 1


def test_meshes_need_a_card_unless_asked_for_the_cpu(pool):
    """Without a card, a pool and a mesh builder given no device type
    raise; with ``device_type='cpu'`` they run."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        RankPool(2)
    for msg in pool.run(J.default_mesh):
        assert "device_type='cpu'" in msg


def test_chip_smoke_mesh_phase_rehearses_on_the_cpu(monkeypatch, capsys):
    """Phase 16 of ``chip_smoke.py`` on 8 CPU ranks at cut sizes (a vocab
    of 33 over tp = 4, so the uneven split shows): every check of (a)-(e)
    holds and the lines it prints name each collective's route."""
    import torch
    import chip_smoke as CS
    from parsec_tpu_torch.ops import cuda_kernels as K
    monkeypatch.setitem(CS.MESH, "cfg", dict(
        vocab_size=33, d_model=32, d_ff=64, n_heads=4, n_layers=4,
        max_seq=32))
    for k, v in dict(ar_mib=1, train_b=4, train_s=32, attn=(2, 4, 32, 16),
                     pp_b=4, pp_micro=2, moe_t=64, n=64,
                     job_s=JOB_S).items():
        monkeypatch.setitem(CS.MESH, k, v)
    out = CS.meshes(K, torch, "cpu rehearsal", device="cpu")
    text = capsys.readouterr().out
    assert out["routes"] == dict.fromkeys(compat.OPS, "gloo")
    assert "all_reduce taken -> gloo" in text
    assert "split in [6, 9] rows" in text
    assert "mesh phase" in text and "no figure here is a scaling" in text
    assert out["launches"] == 0          # the CPU takes the plain version
