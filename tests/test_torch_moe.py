"""The port's MoE layer and MoE-LM against the reference, on the CPU.

The reference's expert-parallel layer runs on a one-device ``ep`` mesh
(``make_ep_mesh(1)``), the expert group the port takes; the same numpy
parameters (``init_moe_params`` / ``init_lm_moe_params`` of either package,
bit-identical) and numpy inputs go through both. Tolerances: outputs rtol
2e-4, atol 2e-5; aux loss 1e-6; drop counts and dropped rows equal.
"""

import jax
import numpy as np
import pytest
import torch

from parsec_tpu.parallel import model as JM
from parsec_tpu.parallel import moe as JMoE
from parsec_tpu_torch.parallel import model as TM
from parsec_tpu_torch.parallel import moe as TMoE

CPU = torch.device("cpu")


def _t(tree):
    return TM.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                                device="cpu")


def _ep1():
    return JMoE.make_ep_mesh(1)


def test_init_moe_params_are_bit_identical():
    for args in ((0, 4, 16, 32), (3, 8, 8, 16)):
        ref, port = JMoE.init_moe_params(*args), TMoE.init_moe_params(*args)
        for name in ("router", "w1", "w2"):
            np.testing.assert_array_equal(port[name], ref[name])
    cfg = dict(vocab_size=32, d_model=16, d_ff=32, n_heads=2, n_layers=2,
               max_seq=8)
    ref = JM.init_lm_moe_params(5, JM.ModelConfig(**cfg), n_experts=4)
    port = TM.init_lm_moe_params(5, TM.ModelConfig(**cfg), n_experts=4)
    assert jax.tree_util.tree_structure(ref) == \
        jax.tree_util.tree_structure(port)
    for a, b in zip(jax.tree_util.tree_leaves(ref),
                    jax.tree_util.tree_leaves(port)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_dense_reference_and_no_drop_forward_match_reference(k):
    """test_pipeline_moe's MoE checks on a one-device expert group: the
    no-drop forward equals the dense routed computation, both equal the
    reference's, nothing dropped, and the aux loss (>= 1) within 1e-6."""
    E, D, F = 4, 16, 32
    params = JMoE.init_moe_params(11, E, D, F)
    x = np.random.default_rng(13).standard_normal((16, D)).astype(np.float32)
    tp = {n: torch.from_numpy(v) for n, v in params.items()}
    tx = torch.from_numpy(x)
    ref_dense = np.asarray(JMoE.dense_reference(params, x, k=k))
    dense = TMoE.dense_reference(tp, tx, k=k)
    np.testing.assert_allclose(dense.numpy(), ref_dense, rtol=2e-4, atol=2e-5)
    ref_out, ref_aux = JMoE.moe_forward(params, x, mesh=_ep1(), k=k,
                                        return_aux=True)
    out, aux = TMoE.moe_forward(tp, tx, mesh=CPU, k=k, return_aux=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(out.numpy(), dense.numpy(), rtol=2e-4,
                               atol=2e-5)
    assert float(aux["dropped"]) == float(ref_aux["dropped"]) == 0.0
    assert abs(float(aux["aux_loss"]) - float(ref_aux["aux_loss"])) < 1e-6
    assert float(aux["aux_loss"]) >= 1.0 - 1e-4


def test_moe_capacity_drops_tokens():
    """capacity=1 with every token routed to expert 0: one token kept, the
    same row as the reference's, the others contribute zero."""
    D = 8
    params = JMoE.init_moe_params(3, 2, D, 16)
    params["router"] = np.zeros_like(params["router"])
    params["router"][0, 0] = 100.0
    x = np.ones((4, D), np.float32)
    x[:, 0] += np.arange(4, dtype=np.float32)      # distinct rows
    tp = {n: torch.from_numpy(v) for n, v in params.items()}
    ref, ref_aux = JMoE.moe_forward(params, x, mesh=_ep1(), capacity=1,
                                    return_aux=True)
    out, aux = TMoE.moe_forward(tp, torch.from_numpy(x), capacity=1,
                                return_aux=True)
    kept = np.abs(out.numpy()).sum(axis=1) > 1e-9
    ref_kept = np.abs(np.asarray(ref)).sum(axis=1) > 1e-9
    assert kept.sum() == 1 and (kept == ref_kept).all(), (kept, ref_kept)
    assert float(aux["dropped"]) == float(ref_aux["dropped"]) == 3.0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-5)


def test_moe_topk_capacity_factor_counts_drops():
    """test_pipeline_moe's choice-major priority with one device: expert 0
    takes one first choice, expert 1 one second choice, 6 of 8 routed pairs
    drop; a generous capacity factor drops nothing and matches dense."""
    D = 8
    params = JMoE.init_moe_params(3, 2, D, 16)
    params["router"] = np.zeros_like(params["router"])
    params["router"][0, 0] = 10.0
    params["router"][0, 1] = 5.0
    x = np.ones((4, D), np.float32)
    tp = {n: torch.from_numpy(v) for n, v in params.items()}
    tx = torch.from_numpy(x)
    out, aux = TMoE.moe_forward(tp, tx, k=2, capacity=1, return_aux=True)
    ref, ref_aux = JMoE.moe_forward(params, x, mesh=_ep1(), k=2, capacity=1,
                                    return_aux=True)
    assert float(aux["dropped"]) == float(ref_aux["dropped"]) == 6.0
    kept = np.abs(out.numpy()).sum(axis=1) > 1e-9
    assert kept.sum() == 1
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-5)
    out2, aux2 = TMoE.moe_forward(tp, tx, k=2, capacity_factor=2.0,
                                  return_aux=True)
    assert float(aux2["dropped"]) == 0.0
    np.testing.assert_allclose(out2.numpy(),
                               TMoE.dense_reference(tp, tx, k=2).numpy(),
                               rtol=2e-4, atol=2e-5)


def test_moe_capacity_factor_drops_the_reference_rows():
    """A tight capacity factor on random routing: the same (token, choice)
    pairs drop as in the reference (equal counts, equal outputs row by
    row, rows touched by a drop included)."""
    E, D = 4, 16
    params = JMoE.init_moe_params(21, E, D, 32)
    x = np.random.default_rng(22).standard_normal((32, D)).astype(np.float32)
    tp = {n: torch.from_numpy(v) for n, v in params.items()}
    out, aux = TMoE.moe_forward(tp, torch.from_numpy(x), k=2,
                                capacity_factor=0.5, return_aux=True)
    ref, ref_aux = JMoE.moe_forward(params, x, mesh=_ep1(), k=2,
                                    capacity_factor=0.5, return_aux=True)
    assert float(aux["dropped"]) == float(ref_aux["dropped"]) > 0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-5)


def test_moe_aux_loss_balance_signal():
    D, T, E = 8, 16, 4
    x = torch.ones((T, D))
    bal = {n: torch.from_numpy(v)
           for n, v in TMoE.init_moe_params(0, E, D, 16).items()}
    bal["router"] = torch.zeros_like(bal["router"])
    _, aux_b = TMoE.moe_forward(bal, x, return_aux=True)
    col = dict(bal, router=bal["router"].clone())
    col["router"][0, 0] = 100.0
    _, aux_c = TMoE.moe_forward(col, x, return_aux=True)
    assert abs(float(aux_b["aux_loss"]) - 1.0) < 0.2
    assert float(aux_c["aux_loss"]) > 0.9 * E


# ------------------------------------------------------------------- MoE-LM

MOE_CFG = dict(vocab_size=64, d_model=32, d_ff=64, n_heads=4, n_layers=2,
               max_seq=16)


def test_lm_moe_apply_matches_reference():
    """lm_moe_apply with return_aux, dense (mesh=None) and on the one-device
    expert group, against the reference's dense path: logits within rtol
    2e-4, atol 2e-5, aux loss within 1e-6, no drops; k=1 routes
    differently."""
    tree = JM.init_lm_moe_params(0, JM.ModelConfig(**MOE_CFG), n_experts=4)
    toks = (np.arange(64, dtype=np.int32).reshape(8, 8) * 7) % 64
    ref, ref_aux = JM.lm_moe_apply(tree, toks, k=2, return_aux=True)
    p = _t(tree)
    for mesh in (None, CPU):
        out, aux = TM.lm_moe_apply(p, toks, k=2, mesh=mesh, return_aux=True)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                                   rtol=2e-4, atol=2e-5)
        assert abs(float(aux["aux_loss"]) - float(ref_aux["aux_loss"])) < 1e-6
        assert float(aux["dropped"]) == 0.0
    top1 = TM.lm_moe_apply(p, toks, k=1)
    assert (top1 - out).abs().max() > 1e-6
    # lm_apply takes MoE parameters too (their FFNs routed top-2, densely)
    np.testing.assert_allclose(TM.lm_apply(p, toks).numpy(), np.asarray(ref),
                               rtol=2e-4, atol=2e-5)


def test_lm_moe_trains():
    """test_model's: SGD through the routing gates and experts on the dense
    routed path lowers the loss in 5 steps, each loss within 1e-4 relative
    of the reference's same steps."""
    cfg = dict(vocab_size=32, d_model=16, d_ff=32, n_heads=2, n_layers=1,
               max_seq=8)
    tree = JM.init_lm_moe_params(1, JM.ModelConfig(**cfg), n_experts=4)
    toks = np.random.default_rng(2).integers(0, 32, size=(4, 8)
                                             ).astype(np.int32)
    tokens, targets = toks[:, :-1], toks[:, 1:]
    jstep = JM.make_lm_moe_train_step(k=2, lr=0.1)
    tstep = TM.make_lm_moe_train_step(k=2, lr=0.1)
    jp, tp = tree, _t(tree)
    ref, got = [], []
    for _ in range(5):
        jp, jl = jstep(jp, tokens, targets)
        tp, tl = tstep(tp, tokens, targets)
        ref.append(float(jl))
        got.append(float(tl))
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    assert got[-1] < got[0], got


def test_make_lm_moe_train_step_expert_group_matches_dense():
    """test_model's ep-against-dense step check with a one-device expert
    group: 3 losses on each path within 2e-4, and both train."""
    cfg = dict(vocab_size=32, d_model=16, d_ff=32, n_heads=2, n_layers=1,
               max_seq=8)
    toks = np.random.default_rng(6).integers(0, 32, size=(2, 8)
                                             ).astype(np.int32)
    tokens, targets = toks[:, :-1], toks[:, 1:]

    def run(mesh):
        p = _t(JM.init_lm_moe_params(5, JM.ModelConfig(**cfg), n_experts=2))
        step = TM.make_lm_moe_train_step(mesh=mesh, k=2, lr=0.1)
        return [float(step(p, tokens, targets)[1]) for _ in range(3)]
    dense, group = run(None), run(CPU)
    np.testing.assert_allclose(group, dense, rtol=2e-4, atol=2e-4)
    assert dense[-1] < dense[0]


def test_lm_moe_seq_length_guard():
    cfg = dict(vocab_size=32, d_model=16, d_ff=32, n_heads=2, n_layers=1,
               max_seq=8)
    p = _t(TM.init_lm_moe_params(0, TM.ModelConfig(**cfg), n_experts=4))
    with pytest.raises(ValueError, match="max_seq"):
        TM.lm_moe_apply(p, np.zeros((2, 16), np.int32))


def test_lm_moe_generate_matches_full_recompute():
    """test_model's: the MoE-LM's KV-cached decode (routed FFN in the
    prefill and in every step) equals the naive loop re-running
    lm_moe_apply per token, and the reference's tokens."""
    cfg = dict(vocab_size=32, d_model=32, d_ff=64, n_heads=4, n_layers=2,
               max_seq=20)
    tree = JM.init_lm_moe_params(12, JM.ModelConfig(**cfg), n_experts=4)
    prompt = np.random.default_rng(12).integers(0, 32, size=(2, 6)
                                                ).astype(np.int32)
    p = _t(tree)
    out = TM.lm_generate(p, prompt, n_tokens=8)          # moe autodetect
    assert tuple(out.shape) == (2, 14)
    np.testing.assert_array_equal(out.numpy()[:, :6], prompt)
    naive = torch.from_numpy(prompt)
    for _ in range(8):
        nxt = TM.lm_moe_apply(p, naive, k=2)[:, -1].argmax(-1)
        naive = torch.cat([naive, nxt.to(naive.dtype)[:, None]], dim=1)
    np.testing.assert_array_equal(out.numpy(), naive.numpy())
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(JM.lm_generate(tree, prompt, n_tokens=8)))


def test_lm_moe_remat_matches_and_guards():
    """test_model's: remat's forward equals the plain one, gradients reach
    the experts through the rematerialized blocks, and remat with
    return_aux is refused."""
    cfg = dict(vocab_size=32, d_model=16, d_ff=32, n_heads=2, n_layers=2,
               max_seq=8)
    p = _t(TM.init_lm_moe_params(7, TM.ModelConfig(**cfg), n_experts=4))
    toks = np.arange(16, dtype=np.int32).reshape(2, 8) % 32
    a = TM.lm_moe_apply(p, toks, k=2)
    b = TM.lm_moe_apply(p, toks, k=2, remat=True)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6, atol=1e-6)
    w1 = p["blocks"][0]["moe"]["w1"].requires_grad_()
    TM.lm_moe_apply(p, toks, k=2, remat=True).sum().backward()
    assert float(w1.grad.abs().max()) > 0
    with pytest.raises(ValueError, match="remat"):
        TM.lm_moe_apply(p, toks, k=2, remat=True, return_aux=True)


@pytest.fixture(scope="module")
def pool():
    """A 4-rank gloo group over CPU tensors for the mesh test below."""
    from parsec_tpu_torch.parallel.multihost import RankPool
    p = RankPool(4, "cpu", timeout=120.0)
    yield p
    p.close()


def test_moe_expert_group_of_more_than_one_device_raises(pool):
    """An expert group given as a plain list of two devices raises (more
    than one device is a DeviceMesh over a rank group); over a 4-rank ep
    mesh the layer runs, top-2, each rank its experts and its tokens,
    equal to the reference's dense routing."""
    import _torch_mesh_jobs as J
    params = TMoE.init_moe_params(0, 4, 8, 16)
    p = {n: torch.from_numpy(v) for n, v in params.items()}
    with pytest.raises(ValueError, match="DeviceMesh over a rank group"):
        TMoE.moe_forward(p, torch.ones(4, 8), mesh=[CPU, CPU])
    x = np.random.default_rng(3).standard_normal((16, 8)).astype(np.float32)
    ref = np.asarray(JMoE.dense_reference(params, x, k=2))
    for y, spec, local in pool.run(J.moe_layer, params, x, 2):
        np.testing.assert_allclose(y, ref, rtol=2e-4, atol=2e-5)
        assert spec == ("ep", None) and local == (4, 8)


def test_language_model_module_holds_moe_parameters():
    """The nn.Module form takes an MoE-LM tree (each block's experts as
    ``moe_router``, ``moe_w1``, ``moe_w2``) and gives the functional
    API's logits and tokens."""
    cfg = TM.ModelConfig(**MOE_CFG)
    tree = TM.init_lm_moe_params(3, cfg, n_experts=4)
    model = TM.LanguageModel(cfg, device="cpu", tree=tree)
    assert {"blocks.0.moe_router", "blocks.1.moe_w2"} <= \
        set(dict(model.named_parameters()))
    p = _t(tree)
    toks = np.arange(16, dtype=np.int32).reshape(2, 8) % 64
    assert torch.equal(model(toks), TM.lm_apply(p, toks))
    assert torch.equal(model.generate(toks[:, :4], 3),
                       TM.lm_generate(p, toks[:, :4], 3))
