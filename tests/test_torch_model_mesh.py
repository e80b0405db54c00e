"""The reference's mesh tests of the LM (``tests/test_model.py``: the
sharded, ring, pipeline and expert-parallel tests, the mesh half of
``test_lm_opt_train_step_adamw_and_checkpoint``,
``test_state_spec_path_matching_beats_shape_collision``) on the port: the
LM over a (dp, tp) mesh (Megatron blocks, the vocab-parallel tied
embedding and cross-entropy, AdamW moments placed like their parameters,
the clip's norm across shards, DCP checkpoints of DTensors), over sp, pp
and ep meshes, each on an 8-rank gloo group over CPU tensors, held against
the reference (JAX, its 8-device CPU mesh or its single-device functions)
at the reference tests' tolerances. A vocabulary that tp does not divide
(33 over tp = 2) splits as ``torch.chunk`` does and still matches."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

import _torch_mesh_jobs as J
from parsec_tpu.parallel import model as JM
from parsec_tpu.parallel.spmd import make_mesh as j_make_mesh
from parsec_tpu_torch.parallel import model as M
from parsec_tpu_torch.parallel import optim as O
from parsec_tpu_torch.parallel.multihost import RankPool

JOB_S = 180.0

CFG = dict(vocab_size=64, d_model=32, d_ff=64, n_heads=4, n_layers=2,
           max_seq=32)


@pytest.fixture(scope="module")
def pool():
    p = RankPool(8, "cpu", timeout=JOB_S)
    yield p
    p.close()


def _tree(seed, **cfg):
    tree = M.init_lm_params(seed, M.ModelConfig(**(cfg or CFG)))
    ref = JM.init_lm_params(seed, JM.ModelConfig(**(cfg or CFG)))
    np.testing.assert_array_equal(tree["embed"], ref["embed"])
    return tree


def _batch(rng, B=4, S=32, V=64):
    toks = rng.integers(0, V, size=(B, S + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


#: the reference's functions, compiled once (eager JAX dispatches op by op)
_loss = jax.jit(JM.lm_loss, static_argnames=("causal",))
_apply = jax.jit(JM.lm_apply)
_moe_apply = jax.jit(JM.lm_moe_apply, static_argnames=("k", "return_aux"))


@jax.jit
def _grad(tree, x, y):
    return jax.grad(JM.lm_loss)(tree, x, y)


def _ref_sgd(tree, x, y, lr):
    return jax.tree_util.tree_map(lambda a, g: a - lr * g, tree,
                                  _grad(tree, x, y))


def test_lm_sharded_step_matches_single_device(pool):
    """dp x tp step == single-device step, and training converges."""
    rng = np.random.default_rng(4)
    tree = _tree(4)
    x, y = _batch(rng)
    got = pool.run(J.lm_sgd, tree, x, y, 0.2, 6)[0]
    ref_loss = float(_loss(tree, x, y))
    assert abs(got["losses"][0] - ref_loss) < 1e-3
    ref_p = _ref_sgd(tree, x, y, 0.2)
    np.testing.assert_allclose(got["w1"],
                               np.asarray(ref_p["blocks"][0]["w1"]),
                               rtol=2e-4, atol=2e-4)
    assert got["losses"][-1] < ref_loss
    # the reference's own sharded step on its 8-device mesh, same losses
    mesh = j_make_mesh(8, axis_names=("dp", "tp"))
    step, place_p, place_t = JM.make_lm_train_step(mesh, lr=0.2,
                                                   params=tree)
    sp = place_p(tree)
    jl = []
    for _ in range(6):
        sp, loss = step(sp, place_t(x), place_t(y))
        jl.append(float(loss))
    np.testing.assert_allclose(got["losses"], jl, rtol=1e-4, atol=1e-4)
    assert got["embed_spec"] == ("tp", None)
    assert got["embed_local"] == (16, 32)


def test_lm_sharded_step_odd_vocab_over_tp2(pool):
    """vocab 33 over tp = 2 splits 17 + 16 rows (DTensor's Shard(0), as
    torch.chunk): the vocab-parallel embedding, head and cross-entropy
    still give the single-device step."""
    cfg = dict(CFG, vocab_size=33)
    tree = _tree(5, **cfg)
    rng = np.random.default_rng(5)
    x, y = _batch(rng, V=33)
    got = pool.run(J.lm_sgd, tree, x, y, 0.2, 3, 4)[0]   # dp 4 x tp 2
    assert got["embed_local"] in ((17, 32), (16, 32))
    assert abs(got["losses"][0] - float(_loss(tree, x, y))) < 1e-3
    ref_p = _ref_sgd(tree, x, y, 0.2)
    np.testing.assert_allclose(got["w1"],
                               np.asarray(ref_p["blocks"][0]["w1"]),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got["embed"], np.asarray(ref_p["embed"]),
                               rtol=2e-4, atol=2e-4)
    assert got["losses"][-1] < got["losses"][0]
    ranks = pool.run(J.lm_sgd, tree, x, y, 0.2, 1, 4)
    assert sorted({r["embed_local"] for r in ranks}) == [(16, 32), (17, 32)]


def test_lm_ring_attention_core_long_seq(pool):
    """Sequence-parallel attention core: the ring over the 8-rank mesh
    matches the dense forward on the same params."""
    cfg = dict(vocab_size=32, d_model=32, d_ff=64, n_heads=4, n_layers=1,
               max_seq=64)
    tree = _tree(5, **cfg)
    x = np.random.default_rng(5).integers(0, 32, size=(2, 64)).astype(
        np.int32)
    ref = np.asarray(_apply(tree, x))
    for out in pool.run(J.lm_ring, tree, x):
        np.testing.assert_allclose(out, ref, rtol=2e-3, atol=2e-3)


def test_lm_train_step_noncausal_flag_is_live(pool):
    """make_lm_train_step(causal=False) must actually train bidirectional:
    its loss differs from the causal step's loss on the same params and
    batch."""
    rng = np.random.default_rng(6)
    tree = _tree(6)
    x, y = _batch(rng)
    lc, lnc = pool.run(J.lm_causal_pair, tree, x, y)[0]
    assert abs(lc - lnc) > 1e-6
    assert abs(lnc - float(_loss(tree, x, y, causal=False))) < 1e-3
    assert abs(lc - float(_loss(tree, x, y))) < 1e-3


def test_lm_opt_train_step_adamw_and_checkpoint(pool, tmp_path):
    """AdamW training over the mesh with sharded moments; checkpoint the
    full training state (DCP, each rank its shards) and resume bit-exact;
    the losses are the reference's mesh step's."""
    rng = np.random.default_rng(7)
    tree = _tree(7)
    x, y = _batch(rng)
    res = pool.run(J.lm_adamw_ckpt, tree, x, y, str(tmp_path / "ckpt"))
    got = res[0]
    assert got["losses"][-1] < got["losses"][0], got["losses"]
    # Adam moments are SHARDED like their params, not replicated
    assert got["mu_spec"] == ("tp", None)
    assert got["nu_w1_spec"] == (None, "tp")
    assert got["step"] == 6 and got["restored"] and got["count"] == 6
    # resuming from the restored state continues identically
    assert got["resumed"][0] == got["resumed"][1]
    np.testing.assert_array_equal(*got["w1"])
    assert all(r["restored"] for r in res)
    mesh = j_make_mesh(8, axis_names=("dp", "tp"))
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(3e-3))
    step, opt, place_p, place_t = JM.make_lm_opt_train_step(mesh, tx, tree)
    sp = place_p(tree)
    jl = []
    for _ in range(6):
        sp, opt, loss = step(sp, opt, place_t(x), place_t(y))
        jl.append(float(loss))
    np.testing.assert_allclose(got["losses"], jl, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("max_norm", [None, 0.05])
def test_lm_opt_first_step_matches_single_rank(pool, max_norm):
    """One AdamW step over (dp, tp) against the port's single-device step
    on the same parameters and batch: with a clip that bites (global norm
    well above 0.05), the norm summed across the tp shards scales the
    update exactly as the whole gradient's does."""
    import torch
    rng = np.random.default_rng(8)
    tree = _tree(8)
    x, y = _batch(rng)
    loss, got = pool.run(J.lm_opt_first_step, tree, x, y, max_norm, 1e-3)[0]
    tx = O.adamw(1e-3) if max_norm is None else \
        O.chain(O.clip_by_global_norm(max_norm), O.adamw(1e-3))
    step, opt, place_p, place_t = M.make_lm_opt_train_step("cpu", tx, tree)
    p, opt, rl = step(place_p(tree), opt, place_t(x), place_t(y))
    assert abs(loss - float(rl)) < 1e-5
    for a, b in zip(O.tree_leaves(got), O.tree_leaves(p)):
        np.testing.assert_allclose(a, b.numpy(), rtol=2e-4, atol=2e-4)
    # the clip bites: an unclipped step lands elsewhere
    if max_norm is not None:
        _, free = pool.run(J.lm_opt_first_step, tree, x, y, None, 1e-3)[0]
        assert np.abs(free["embed"] - got["embed"]).max() > 1e-5
    del torch


def test_state_spec_path_matching_beats_shape_collision(pool):
    """vocab_size == max_seq makes embed and pos the same SHAPE with
    different specs; moment shardings must follow the tree path, so
    embed's Adam moments stay vocab-parallel."""
    cfg = dict(vocab_size=32, d_model=32, d_ff=64, n_heads=4, n_layers=1,
               max_seq=32)
    tree = _tree(0, **cfg)
    assert tree["embed"].shape == tree["pos"].shape
    mu_embed, mu_pos, count, nu_embed = pool.run(J.state_specs, tree)[0]
    assert "tp" in mu_embed and "tp" in nu_embed
    assert "tp" not in mu_pos
    assert count == ()
    # the reference's own answer on its mesh
    mesh = j_make_mesh(8, axis_names=("dp", "tp"))
    ospec = JM._state_spec_like(mesh, JM._lm_param_spec(mesh, "dp", "tp", 1),
                                tree, optax.adam(1e-3).init(tree))
    assert "tp" in str(ospec[0].mu["embed"].spec)
    assert "tp" not in str(ospec[0].mu["pos"].spec)


def test_lm_bf16_compute_trains(pool):
    """bf16 compute with f32 master params and remat over the mesh: the
    masters stay f32 and training converges."""
    rng = np.random.default_rng(12)
    tree = _tree(12)
    x, y = _batch(rng)
    losses, dtype = pool.run(J.lm_bf16_remat, tree, x, y, 8)[0]
    assert dtype == "torch.float32"
    assert losses[-1] < losses[0], losses
    lf32 = float(_loss(tree, x, y))
    assert abs(losses[0] - lf32) < 0.05 * max(1.0, lf32)


def test_lm_pipeline_parallel_forward_matches_dense(pool):
    """LM over pp stages (GPipe microbatch streaming) == lm_apply."""
    rng = np.random.default_rng(14)
    cfg = dict(vocab_size=32, d_model=32, d_ff=64, n_heads=4, n_layers=4,
               max_seq=16)
    tree = _tree(14, **cfg)
    toks = rng.integers(0, 32, size=(8, 16)).astype(np.int32)
    ref = np.asarray(_apply(tree, toks))
    for nP, m in ((2, 4), (4, 2)):
        res = pool.run(J.lm_pp, tree, toks, nP, m)
        assert sum(r is not None for r in res) == nP
        np.testing.assert_allclose(res[0], ref, rtol=2e-4, atol=2e-4,
                                   err_msg=f"pp={nP} micro={m}")
    assert "stages" in pool.run(J.lm_pp, tree, toks, 8, 2)[0]


def test_lm_moe_expert_parallel_matches_dense(pool):
    """Every block's FFN routed through top-2 of 8 experts spread over the
    8-rank ep mesh (all-to-all dispatch) equals the dense routed forward
    under no-drop capacity; the aux loss is the reference's."""
    cfg = JM.ModelConfig(vocab_size=64, d_model=32, d_ff=64, n_heads=4,
                         n_layers=2, max_seq=16)
    tree = jax.tree_util.tree_map(np.asarray,
                                  JM.init_lm_moe_params(0, cfg, n_experts=8))
    toks = (np.arange(64, dtype=np.int32).reshape(8, 8) * 7) % 64
    dense, aux_d = _moe_apply(tree, toks, k=2, return_aux=True)
    for ep, aux_e, dropped in pool.run(J.lm_moe_ep, tree, toks, 2):
        np.testing.assert_allclose(ep, np.asarray(dense), rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(aux_e, float(aux_d["aux_loss"]),
                                   rtol=1e-4)
        assert dropped == 0.0
    assert float(aux_d["aux_loss"]) >= 1.0 - 1e-4


def test_lm_moe_ep_path_jits_and_differentiates(pool):
    """The expert-parallel forward composes under autograd: gradients
    flow through the all-to-all dispatch/combine to the experts, and one
    step reduces the loss; the loss is the reference's."""
    cfg = JM.ModelConfig(vocab_size=32, d_model=16, d_ff=32, n_heads=2,
                         n_layers=1, max_seq=8)
    tree = jax.tree_util.tree_map(np.asarray,
                                  JM.init_lm_moe_params(3, cfg, n_experts=8))
    toks = np.random.default_rng(4).integers(0, 32, size=(8, 8)).astype(
        np.int32)
    for l0, l1, gsum, w1_grad in pool.run(J.lm_moe_ep_grad, tree, toks):
        assert np.isfinite(l0) and gsum > 0
        assert w1_grad > 0
        assert l1 < l0

    @jax.jit
    def ref_loss(p):
        logits = JM.lm_moe_apply(p, toks[:, :-1], k=2)
        logz = jax.scipy.special.logsumexp(logits, axis=-1)
        gold = jnp.take_along_axis(logits, jnp.asarray(toks[:, 1:])[..., None],
                                   axis=-1).squeeze(-1)
        return jnp.mean(logz - gold)
    np.testing.assert_allclose(l0, float(ref_loss(tree)), rtol=1e-4)


def test_make_lm_moe_train_step_ep_matches_dense(pool):
    """The packaged MoE-LM train step: losses on the expert-parallel path
    track the reference's dense-routed path step for step (no-drop
    capacity), and both train."""
    cfg = JM.ModelConfig(vocab_size=32, d_model=16, d_ff=32, n_heads=2,
                         n_layers=1, max_seq=8)
    toks = np.random.default_rng(6).integers(0, 32, size=(8, 8)).astype(
        np.int32)
    tree = jax.tree_util.tree_map(np.asarray,
                                  JM.init_lm_moe_params(5, cfg, n_experts=8))
    step = JM.make_lm_moe_train_step(mesh=None, k=2, lr=0.1)
    p, dense = tree, []
    for _ in range(3):
        p, loss = step(p, toks[:, :-1], toks[:, 1:])
        dense.append(float(loss))
    for ep in pool.run(J.lm_moe_ep, tree, toks, 2, 3, 0.1):
        np.testing.assert_allclose(ep, dense, rtol=2e-4, atol=2e-4)
    assert dense[-1] < dense[0]
