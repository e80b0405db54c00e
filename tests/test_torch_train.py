"""The port's LM training path against the reference model, on the CPU.

One numpy parameter set (``init_lm_params`` of either package: they are
bit-identical) and one numpy batch from a seed go through the reference's
JAX functions (``jax.value_and_grad``, its steps on a one-device mesh,
optax) and the port's torch functions (autograd, its steps,
``torch.optim.AdamW``). The flash core takes the kernel's plain version on
the CPU, under the port's own backward; the kernel's forward under autograd
runs in tests/test_torch_train_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from parsec_tpu.ops import pallas_kernels as PK
from parsec_tpu.parallel import model as JM
from parsec_tpu.parallel import transformer as JT
from parsec_tpu.parallel.spmd import make_mesh
from parsec_tpu_torch.ops import cuda_kernels as K
from parsec_tpu_torch.parallel import model as TM
from parsec_tpu_torch.parallel import optim as O
from parsec_tpu_torch.parallel import transformer as TT
from parsec_tpu_torch.parallel.optim import value_and_grad

# the reference tests' small config (tests/test_model.py)
CFG = dict(vocab_size=64, d_model=32, d_ff=64, n_heads=4, n_layers=2,
           max_seq=32)
CPU = torch.device("cpu")


def _tree(seed, **cfg):
    return TM.init_lm_params(seed, TM.ModelConfig(**(cfg or CFG)))


def _batch(rng, B=4, S=32, V=64):
    toks = rng.integers(0, V, size=(B, S + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _grads(tree, x, y, **kw):
    """The port's (loss, gradient leaves in the reference's leaf order)."""
    p = TM.params_from_numpy(tree, device="cpu")
    loss, _, grads = value_and_grad(lambda q: TM.lm_loss(q, x, y, **kw), p)
    return loss, grads


def _ref_grads(tree, x, y, **kw):
    loss, g = jax.jit(jax.value_and_grad(
        lambda p: JM.lm_loss(p, x, y, **kw)))(tree)
    return float(loss), [np.asarray(a, np.float32)
                         for a in jax.tree_util.tree_leaves(g)]


# ---------------------------------------------------------------- gradients

@pytest.mark.parametrize("case", ["dense", "remat", "flash"])
def test_lm_loss_gradients_match_reference(case):
    """jax.value_and_grad(lm_loss) against the port's lm_loss backward, f32:
    the loss within 1e-6, every leaf within rtol 1e-4, atol 1e-6. The flash
    case holds the port's flash Function (the plain forward and the dense
    expression's backward) to the reference's dense core (its own flash
    core, differentiated, takes the same dense expression)."""
    tree = _tree(11)
    x, y = _batch(np.random.default_rng(11))
    ref_loss, ref = _ref_grads(tree, x, y, remat=case == "remat")
    loss, grads = _grads(
        tree, x, y, remat=case == "remat",
        attention=TT.flash_attention_core if case == "flash" else None)
    assert abs(float(loss) - ref_loss) < 1e-6
    assert len(grads) == len(ref)
    for a, b in zip(ref, grads):
        assert b.dtype == torch.float32 and tuple(b.shape) == a.shape
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-4, atol=1e-6)


def test_lm_bf16_gradients_match_reference():
    """compute_dtype=bf16 under autograd: f32 loss and f32 gradient leaves
    (the masters), within the reference's 5% loss criterion of the f32 loss
    and, as a whole, norm-wise within 2e-2 of the reference's bf16 gradient.
    (Leaf by leaf, the LN and bias leaves differ by up to about 3% between
    JAX's and torch's bf16 rounding at this width, so the norm is taken
    over the whole gradient.)"""
    tree = _tree(12)
    x, y = _batch(np.random.default_rng(12))
    ref_loss, ref = _ref_grads(tree, x, y, compute_dtype=jnp.bfloat16)
    loss, grads = _grads(tree, x, y, compute_dtype=torch.bfloat16)
    assert loss.dtype == torch.float32
    assert all(g.dtype == torch.float32 for g in grads)
    assert abs(float(loss) - ref_loss) < 0.05 * max(1.0, ref_loss)
    num = np.sqrt(sum(np.sum((g.numpy() - a) ** 2)
                      for a, g in zip(ref, grads)))
    den = np.sqrt(sum(np.sum(a ** 2) for a in ref))
    assert num / den < 2e-2, num / den


def test_lm_remat_matches_plain_gradients():
    """test_model's criterion: remat's loss within 1e-6 of the plain one and
    every gradient leaf within rtol 1e-5, atol 1e-6, with either core."""
    tree = _tree(11)
    x, y = _batch(np.random.default_rng(11))
    for core in (None, TT.flash_attention_core):
        l0, g0 = _grads(tree, x, y, attention=core)
        l1, g1 = _grads(tree, x, y, attention=core, remat=True)
        assert float(l0) == pytest.approx(float(l1), abs=1e-6)
        for a, b in zip(g0, g1):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                       atol=1e-6)


def test_lm_bf16_compute_trains():
    """test_model's: bf16 compute with f32 masters, loss f32, gradients
    f32, the forward within 5% of the f32 one, and AdamW with remat and
    bf16 compute lowers the loss in 8 steps (on the one device)."""
    tree = _tree(12)
    x, y = _batch(np.random.default_rng(12))
    p = TM.params_from_numpy(tree, device="cpu")
    lf32 = float(TM.lm_loss(p, x, y))
    lbf16 = TM.lm_loss(p, x, y, compute_dtype=torch.bfloat16)
    assert lbf16.dtype == torch.float32
    assert abs(float(lbf16) - lf32) < 0.05 * max(1.0, lf32)
    step, opt, pp, pt_ = TM.make_lm_opt_train_step(
        CPU, O.adamw(3e-3), tree, remat=True, compute_dtype=torch.bfloat16)
    sp = pp(tree)
    losses = []
    for _ in range(8):
        sp, opt, loss = step(sp, opt, pt_(x), pt_(y))
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses
    assert all(t.dtype == torch.float32 for t in O.tree_leaves(sp))


def test_lm_training_reduces_loss():
    """test_model's: ten plain SGD steps (lr 0.5) lower the loss by 0.1."""
    tree = _tree(1)
    x, y = _batch(np.random.default_rng(1))
    step, place_p, place_t = TM.make_lm_train_step(CPU, lr=0.5, params=tree)
    p = place_p(tree)
    l0 = float(TM.lm_loss(p, x, y))
    for _ in range(10):
        p, _ = step(p, place_t(x), place_t(y))
    l1 = float(TM.lm_loss(p, x, y))
    assert l1 < l0 - 0.1, f"loss did not drop: {l0} -> {l1}"


# ----------------------------------------------------------- flash backward

@pytest.mark.parametrize("causal,q_offset,k_offset,sq,sk", [
    (True, 0, 0, 32, 32), (False, 0, 0, 24, 40), (True, 16, 0, 16, 32),
    (True, 0, 8, 24, 24)])
def test_flash_function_backward_matches_reference(causal, q_offset,
                                                   k_offset, sq, sk):
    """The flash Function's backward (with the plain forward, as on the
    CPU) against jax.grad of the reference's flash_attention, causal,
    non-causal and with offsets (the last case has rows that see no key):
    dq, dk, dv within rtol 1e-4, atol 1e-5 in f32."""
    rng = np.random.default_rng(sq + sk + q_offset)
    q = rng.standard_normal((2, 3, sq, 16)).astype(np.float32)
    k = rng.standard_normal((2, 3, sk, 16)).astype(np.float32)
    v = rng.standard_normal((2, 3, sk, 16)).astype(np.float32)
    g = rng.standard_normal((2, 3, sq, 16)).astype(np.float32)

    def f(q, k, v):
        return jnp.sum(PK.flash_attention(q, k, v, causal=causal,
                                          q_offset=q_offset,
                                          k_offset=k_offset) * g)
    ref = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = K.flash_attention(tq, tk, tv, causal=causal, q_offset=q_offset,
                            k_offset=k_offset)
    assert out.grad_fn is not None and "FlashAttention" in \
        type(out.grad_fn).__name__
    (out * torch.from_numpy(g)).sum().backward()
    for a, b in zip(ref, (tq.grad, tk.grad, tv.grad)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-5)
    # the backward function itself, called directly, gives the same
    dq, dk, dv = K.flash_attention_backward(
        tq.detach(), tk.detach(), tv.detach(), torch.from_numpy(g),
        causal=causal, q_offset=q_offset, k_offset=k_offset)
    for a, b in zip((dq, dk, dv), (tq.grad, tk.grad, tv.grad)):
        assert torch.equal(a, b)


def test_flash_function_bf16_grads_keep_the_input_dtypes():
    """bf16 operands get bf16 gradients, within bf16 rounding of the f32
    gradients of the same values; without grad mode nothing is recorded."""
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 64, 32, generator=gen) for _ in range(3))
    q16, k16, v16 = (t.to(torch.bfloat16).requires_grad_() for t in (q, k, v))
    K.flash_attention(q16, k16, v16, causal=True).float().sum().backward()
    q32, k32, v32 = (t.to(torch.bfloat16).float().requires_grad_()
                     for t in (q, k, v))
    K.flash_attention(q32, k32, v32, causal=True).sum().backward()
    for a, b in ((q16, q32), (k16, k32), (v16, v32)):
        assert a.grad.dtype == torch.bfloat16
        np.testing.assert_allclose(a.grad.float().numpy(), b.grad.numpy(),
                                   rtol=2e-2, atol=2e-2)
    with torch.no_grad():
        assert K.flash_attention(q16, k16, v16).grad_fn is None


# --------------------------------------------------------------------- steps

def test_sgd_steps_match_reference():
    """The reference's make_lm_train_step on a one-device (dp, tp) mesh
    against the port's on the CPU: 10 losses within 1e-4 relative."""
    tree = _tree(4)
    x, y = _batch(np.random.default_rng(4))
    mesh = make_mesh(1, axis_names=("dp", "tp"))
    jstep, jpp, jpt = JM.make_lm_train_step(mesh, lr=0.2, params=tree)
    tstep, tpp, tpt = TM.make_lm_train_step(CPU, lr=0.2, params=tree)
    jp, tp = jpp(tree), tpp(tree)
    jx, jy, tx, ty = jpt(x), jpt(y), tpt(x), tpt(y)
    ref, got = [], []
    for _ in range(10):
        jp, jl = jstep(jp, jx, jy)
        tp, tl = tstep(tp, tx, ty)
        ref.append(float(jl))
        got.append(float(tl))
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    assert got[-1] < got[0]


def test_lm_train_step_noncausal_flag_is_live():
    """test_model's: causal=False trains bidirectionally (its loss differs
    from the causal step's) and matches lm_loss(causal=False)."""
    tree = _tree(6)
    x, y = _batch(np.random.default_rng(6))
    s_c, place_p, place_t = TM.make_lm_train_step(CPU, lr=0.1, params=tree,
                                                  causal=True)
    s_nc, _, _ = TM.make_lm_train_step(CPU, lr=0.1, params=tree,
                                       causal=False)
    _, lc = s_c(place_p(tree), place_t(x), place_t(y))
    _, lnc = s_nc(place_p(tree), place_t(x), place_t(y))
    assert abs(float(lc) - float(lnc)) > 1e-6
    p = TM.params_from_numpy(tree, device="cpu")
    assert abs(float(lnc) - float(TM.lm_loss(p, x, y, causal=False))) < 1e-6


def test_adamw_steps_match_optax():
    """make_lm_opt_train_step with chain(clip_by_global_norm(1.0),
    adamw(3e-3)) against the reference's with the optax chain, on one
    device: 6 losses within 1e-4 relative and the parameters after 6 steps
    within atol 3e-5 (about 1% of one step's largest update, lr 3e-3)."""
    tree = _tree(7)
    x, y = _batch(np.random.default_rng(7))
    mesh = make_mesh(1, axis_names=("dp", "tp"))
    jtx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(3e-3))
    ttx = O.chain(O.clip_by_global_norm(1.0), O.adamw(3e-3))
    jstep, jopt, jpp, jpt = JM.make_lm_opt_train_step(mesh, jtx, tree)
    tstep, topt, tpp, tpt = TM.make_lm_opt_train_step(CPU, ttx, tree)
    jp, tp = jpp(tree), tpp(tree)
    ref, got = [], []
    for _ in range(6):
        jp, jopt, jl = jstep(jp, jopt, jpt(x), jpt(y))
        tp, topt, tl = tstep(tp, topt, tpt(x), tpt(y))
        ref.append(float(jl))
        got.append(float(tl))
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    assert got[-1] < got[0]
    assert int(topt["count"]) == 6
    for a, b in zip(jax.tree_util.tree_leaves(jp), O.tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=3e-5)
    # the moments mirror the parameters, as optax's mu/nu do
    mu = jopt[1][0].mu
    for a, b in zip(jax.tree_util.tree_leaves(mu),
                    O.tree_leaves(topt["mu"])):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-3,
                                   atol=1e-6)


def test_adamw_without_clip_matches_optax():
    """optax.adamw(lr) alone (the reference's bf16 test's transform), with
    remat and bf16 compute on both sides: 4 losses within 1e-2 relative
    (bf16 compute; the f32 chain above holds the update itself)."""
    tree = _tree(12)
    x, y = _batch(np.random.default_rng(12))
    mesh = make_mesh(1, axis_names=("dp", "tp"))
    jstep, jopt, jpp, jpt = JM.make_lm_opt_train_step(
        mesh, optax.adamw(3e-3), tree, remat=True,
        compute_dtype=jnp.bfloat16)
    tstep, topt, tpp, tpt = TM.make_lm_opt_train_step(
        CPU, O.adamw(3e-3), tree, remat=True, compute_dtype=torch.bfloat16)
    jp, tp = jpp(tree), tpp(tree)
    ref, got = [], []
    for _ in range(4):
        jp, jopt, jl = jstep(jp, jopt, jpt(x), jpt(y))
        tp, topt, tl = tstep(tp, topt, tpt(x), tpt(y))
        ref.append(float(jl))
        got.append(float(tl))
    np.testing.assert_allclose(got, ref, rtol=1e-2)


def test_optimizer_transforms_map_optax_defaults():
    tx = O.chain(O.clip_by_global_norm(0.5), O.adamw(1e-3))
    assert (tx.learning_rate, tx.b1, tx.b2, tx.eps, tx.weight_decay,
            tx.max_norm) == (1e-3, 0.9, 0.999, 1e-8, 1e-4, 0.5)
    assert O.chain(O.adamw(2e-3)).max_norm is None
    with pytest.raises(TypeError):
        O.chain(O.adamw(1e-3), O.clip_by_global_norm(1.0))


def test_block_train_step_matches_reference():
    """transformer.make_train_step (one block, MSE, SGD) against the
    reference's on a one-device mesh: 5 losses within 1e-4 relative."""
    rng = np.random.default_rng(9)
    p = TT.init_block_params(3, d_model=32, d_ff=64, n_heads=4)
    x = rng.standard_normal((4, 16, 32)).astype(np.float32)
    y = rng.standard_normal((4, 16, 32)).astype(np.float32)
    mesh = make_mesh(1, axis_names=("dp", "tp"))
    jstep, jpp, jpb = JT.make_train_step(mesh, lr=0.05)
    tstep, tpp, tpb = TT.make_train_step(CPU, lr=0.05)
    jp, tp = jpp(p), tpp(p)
    ref, got = [], []
    for _ in range(5):
        jp, jl = jstep(jp, jpb(x), jpb(y))
        tp, tl = tstep(tp, tpb(x), tpb(y))
        ref.append(float(jl))
        got.append(float(tl))
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    assert got[-1] < got[0]


@pytest.fixture(scope="module")
def pool():
    """A 4-rank gloo group over CPU tensors for the mesh test below."""
    from parsec_tpu_torch.parallel.multihost import RankPool
    p = RankPool(4, "cpu", timeout=120.0)
    yield p
    p.close()


def test_meshes_of_more_than_one_device_raise(pool):
    """More than one device is a DeviceMesh over a rank group: there every
    training entry point runs (each pre-step loss the single-device
    step's), while a plain list of two devices still raises, now with
    where to get a mesh. A one-device placement, in every form, is taken
    as before."""
    import _torch_mesh_jobs as J
    tree = _tree(0)
    two = [torch.device("cpu"), torch.device("cpu")]
    for make in (lambda: TM.make_lm_train_step(two, params=tree),
                 lambda: TM.make_lm_opt_train_step(two, O.adamw(1e-3), tree),
                 lambda: TM.make_lm_moe_train_step(mesh=two),
                 lambda: TT.make_train_step(np.array(two).reshape(1, 2))):
        with pytest.raises(ValueError, match="DeviceMesh over a rank group"):
            make()
    # a one-device placement, in any of its forms, is taken
    for one in (CPU, "cpu", [CPU], np.array([CPU]).reshape(1, 1)):
        TM.make_lm_train_step(one, params=tree)
    # the same entry points on a 4-rank group
    rng = np.random.default_rng(10)
    x, y = _batch(rng)
    bp = TT.init_block_params(3, d_model=32, d_ff=64, n_heads=4)
    bx = rng.standard_normal((4, 8, 32)).astype(np.float32)
    by = rng.standard_normal((4, 8, 32)).astype(np.float32)
    moe = TM.init_lm_moe_params(1, TM.ModelConfig(
        vocab_size=32, d_model=16, d_ff=32, n_heads=2, n_layers=1,
        max_seq=8), n_experts=4)
    toks = rng.integers(0, 32, size=(4, 8)).astype(np.int32)
    got = pool.run(J.entry_points, tree, moe, (bp, bx, by), x, y, toks)
    assert all(g == got[0] for g in got)
    lm = float(TM.lm_loss(TM.params_from_numpy(tree, device="cpu"), x, y))
    np.testing.assert_allclose([got[0]["lm"], got[0]["lm_opt"]], [lm, lm],
                               rtol=1e-5)
    step, pp, px = TT.make_train_step(CPU, lr=0.05)
    np.testing.assert_allclose(
        got[0]["block"], float(step(pp(bp), px(bx), px(by))[1]), rtol=1e-5)
    mstep = TM.make_lm_moe_train_step(mesh=None)
    np.testing.assert_allclose(
        got[0]["moe"], float(mstep(TM.params_from_numpy(moe, device="cpu"),
                                   toks[:, :-1], toks[:, 1:])[1]),
        rtol=1e-5)
