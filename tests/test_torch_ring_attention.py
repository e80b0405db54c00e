"""The reference's sequence-parallel tests (``tests/test_ring_attention.py``)
on the port: ring attention (K/V rotating by ``batch_isend_irecv``, the
online softmax) and Ulysses (all-to-all seq->heads, the flash kernel's
plain version on each rank's heads on the CPU, all-to-all back) on an
8-rank gloo group over CPU tensors, held against the reference's results
on its 8-device CPU mesh and against dense attention, at the reference
tests' tolerances."""

import numpy as np
import pytest

import _torch_mesh_jobs as J
from parsec_tpu.parallel import ring_attention as JR
from parsec_tpu_torch.parallel import ring_attention as RA
from parsec_tpu_torch.parallel.multihost import RankPool

JOB_S = 120.0



@pytest.fixture(scope="module")
def pool():
    p = RankPool(8, "cpu", timeout=JOB_S)
    yield p
    p.close()


def _qkv(B=2, H=8, S=64, D=16, seed=0):
    rng = np.random.default_rng(seed)
    shape = (B, H, S, D)
    return (rng.standard_normal(shape).astype(np.float32) * 0.5,
            rng.standard_normal(shape).astype(np.float32) * 0.5,
            rng.standard_normal(shape).astype(np.float32) * 0.5)


def _check(res, ref, dense, tol, n=8):
    got = res[0]
    np.testing.assert_allclose(got["out"], np.asarray(dense), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(got["out"], np.asarray(ref), rtol=tol,
                               atol=tol)
    # the sequence axis really is sharded over the ring
    assert got["spec"] == (None, None, "sp", None)
    B, H, S, D = got["out"].shape
    assert got["local"] == (B, H, S // n, D)
    assert all(r["out"] is not None for r in res)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_dense(pool, causal):
    q, k, v = _qkv()
    ref = JR.ring_attention(q, k, v, mesh=JR._seq_mesh(), causal=causal)
    dense = RA.dense_attention_reference(q, k, v, causal=causal)
    np.testing.assert_allclose(
        dense.numpy(),
        np.asarray(JR.dense_attention_reference(q, k, v, causal=causal)),
        rtol=2e-5, atol=2e-5)
    res = pool.run(J.attention, "ring", 8, q, k, v, causal)
    _check(res, ref, dense, 2e-4)
    assert res[0]["kernel_launches"] == 0


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_attention_matches_dense(pool, causal):
    q, k, v = _qkv()
    ref = JR.ulysses_attention(q, k, v, mesh=JR._seq_mesh(), causal=causal)
    dense = RA.dense_attention_reference(q, k, v, causal=causal)
    res = pool.run(J.attention, "ulysses", 8, q, k, v, causal)
    _check(res, ref, dense, 2e-4)


def test_ring_attention_long_sequence_blockwise_memory(pool):
    """A longer sequence still matches: every rank only ever holds
    O(S/P x S/P) score blocks (no global S x S materialization)."""
    q, k, v = _qkv(B=1, H=2, S=256, D=8, seed=3)
    ref = JR.ring_attention(q, k, v, causal=True)
    dense = RA.dense_attention_reference(q, k, v, causal=True)
    _check(pool.run(J.attention, "ring", 8, q, k, v, True), ref, dense,
           3e-4)
