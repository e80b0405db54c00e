"""The reference's pipeline (pp) and expert-parallel (ep) tests
(``tests/test_pipeline_moe.py``) on the port: GPipe over an 8-rank ``pp``
mesh (activations hop by ``batch_isend_irecv``) and the routed MoE over an
8-rank ``ep`` mesh (dispatch and combine by all-to-all), each on a gloo
group over CPU tensors, held against the reference's results on its
8-device CPU mesh and against the single-device references, at the
reference tests' tolerances."""

import numpy as np
import pytest

import _torch_mesh_jobs as J
from parsec_tpu.parallel import moe as JMoE
from parsec_tpu.parallel import pipeline as JPP
from parsec_tpu_torch.parallel import moe as MoE
from parsec_tpu_torch.parallel import pipeline as PP
from parsec_tpu_torch.parallel.multihost import RankPool

JOB_S = 120.0
N = 8


@pytest.fixture(scope="module")
def pool():
    p = RankPool(N, "cpu", timeout=JOB_S)
    yield p
    p.close()


def _t(params):
    import torch
    return {k: torch.from_numpy(np.asarray(v)) for k, v in params.items()}


def test_pipeline_matches_sequential(pool):
    d, n_micro, B = 16, 6, 4
    params = PP.init_pipeline_params(0, N, d)
    jparams = JPP.init_pipeline_params(0, N, d)
    np.testing.assert_array_equal(params["w"], jparams["w"])
    rng = np.random.default_rng(2)
    x = rng.standard_normal((n_micro, B, d)).astype(np.float32)
    ref = np.stack([np.asarray(JPP.reference_forward(jparams, x[i]))
                    for i in range(n_micro)])
    jout = np.asarray(JPP.pipeline_forward(jparams, x,
                                           mesh=JPP.make_pp_mesh()))
    for out in pool.run(J.pipeline, N, params, x):
        np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(out, jout, rtol=2e-5, atol=2e-5)
    seq = np.stack([PP.reference_forward(params, x[i]).numpy()
                    for i in range(n_micro)])
    np.testing.assert_allclose(seq, ref, rtol=2e-5, atol=2e-5)


def test_pipeline_single_microbatch(pool):
    params = PP.init_pipeline_params(1, N, 8)
    x = np.ones((1, 2, 8), np.float32)
    ref = np.asarray(JPP.reference_forward(params, x[0]))
    out = pool.run(J.pipeline, N, params, x)[0]
    np.testing.assert_allclose(out[0], ref, rtol=2e-5, atol=2e-5)


def _moe(pool, params, x, **kw):
    return pool.run(J.moe, N, params, x, kw)


@pytest.mark.parametrize("experts_per_dev", [1, 2])
def test_moe_matches_dense(pool, experts_per_dev):
    E, D, F = N * experts_per_dev, 16, 32
    T = 8 * N
    params = MoE.init_moe_params(0, E, D, F)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((T, D)).astype(np.float32)
    # capacity = local token count: nothing can drop, so the expert-
    # parallel result equals the dense routed computation
    ref = np.asarray(JMoE.dense_reference(params, x))
    jout = np.asarray(JMoE.moe_forward(params, x, mesh=JMoE.make_ep_mesh()))
    out, spec = _moe(pool, params, x)[0]
    assert spec == ("ep", None)
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(out, jout, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(
        MoE.dense_reference(_t(params), __import__("torch").from_numpy(x)
                            ).numpy(), ref, rtol=2e-4, atol=2e-5)


def test_moe_capacity_drops_tokens(pool):
    """Tokens past an expert's capacity are dropped (contribute zero) —
    the Switch/GShard overflow semantics, not an error."""
    D = 8
    params = MoE.init_moe_params(3, N, D, 16)
    # route EVERY token to the same expert by biasing the router
    params["router"] = np.zeros_like(params["router"])
    params["router"][0, 0] = 100.0
    x = np.ones((4 * N, D), np.float32)
    out, _ = _moe(pool, params, x, capacity=1)[0]
    # per source rank only ONE token fits expert 0's buffer slice
    nonzero_rows = np.abs(out).sum(axis=1) > 1e-9
    assert nonzero_rows.sum() == N, nonzero_rows
    jout = np.asarray(JMoE.moe_forward(params, x, mesh=JMoE.make_ep_mesh(),
                                       capacity=1))
    np.testing.assert_allclose(out, jout, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("k", [2, 3])
def test_moe_topk_matches_dense(pool, k):
    """Top-k routing with no-drop capacity equals the dense top-k routed
    computation (gates renormalized over the k winners)."""
    E, D, F = N, 16, 32
    T = 8 * N
    params = MoE.init_moe_params(11, E, D, F)
    rng = np.random.default_rng(13)
    x = rng.standard_normal((T, D)).astype(np.float32)
    out, aux, dropped, _ = _moe(pool, params, x, k=k, return_aux=True)[0]
    ref = np.asarray(JMoE.dense_reference(params, x, k=k))
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-5)
    assert dropped == 0.0
    # Switch aux loss: >= 1 always, == 1 only under perfect balance
    assert aux >= 1.0 - 1e-4
    _, jaux = JMoE.moe_forward(params, x, mesh=JMoE.make_ep_mesh(), k=k,
                               return_aux=True)
    np.testing.assert_allclose(aux, float(jaux["aux_loss"]), rtol=1e-5)


def test_moe_topk_capacity_factor_counts_drops(pool):
    """A tight capacity drops overflow (token, choice) pairs, the count is
    reported globally, and first choices beat second choices for slots
    (choice-major priority)."""
    D = 8
    params = MoE.init_moe_params(3, N, D, 16)
    params["router"] = np.zeros_like(params["router"])
    params["router"][0, 0] = 10.0
    params["router"][0, 1] = 5.0
    x = np.ones((4 * N, D), np.float32)
    out, _, dropped, _ = _moe(pool, params, x, k=2, capacity=1,
                              return_aux=True)[0]
    # per source rank: 4 tokens * 2 choices = 8 routed pairs, 2 kept
    assert dropped == 6.0 * N
    nonzero_rows = np.abs(out).sum(axis=1) > 1e-9
    assert nonzero_rows.sum() == N, nonzero_rows
    out2, _, dropped2, _ = _moe(pool, params, x, k=2,
                                capacity_factor=float(N),
                                return_aux=True)[0]
    assert dropped2 == 0.0
    ref = np.asarray(JMoE.dense_reference(params, x, k=2))
    np.testing.assert_allclose(out2, ref, rtol=2e-4, atol=2e-5)


def test_moe_aux_loss_balance_signal(pool):
    """The aux loss separates balanced from collapsed routing: uniform
    logits sit near 1, a router that sends everything to one expert is
    driven toward E."""
    D = 8
    T = 8 * N
    x = np.ones((T, D), np.float32)
    balanced = MoE.init_moe_params(0, N, D, 16)
    balanced["router"] = np.zeros_like(balanced["router"])
    aux_b = _moe(pool, balanced, x, return_aux=True)[0][1]
    collapsed = MoE.init_moe_params(0, N, D, 16)
    collapsed["router"] = np.zeros_like(collapsed["router"])
    collapsed["router"][0, 0] = 100.0
    aux_c = _moe(pool, collapsed, x, return_aux=True)[0][1]
    assert abs(aux_b - 1.0) < 0.2
    assert aux_c > 0.9 * N
    _, jc = JMoE.moe_forward(collapsed, x, mesh=JMoE.make_ep_mesh(),
                             return_aux=True)
    np.testing.assert_allclose(aux_c, float(jc["aux_loss"]), rtol=1e-5)
