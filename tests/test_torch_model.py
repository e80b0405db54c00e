"""The port's LM serving path against the reference model.

One numpy parameter set (``init_lm_params`` of either package: they are
bit-identical) drives the reference's JAX functions and the port's torch
functions on the CPU, on the same token batches made with numpy from a seed.
The flash core takes the kernel's plain version on the CPU; the kernel
itself runs in tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parsec_tpu.parallel import model as JM
from parsec_tpu.parallel import transformer as JT
from parsec_tpu_torch.ops import cuda_kernels as K
from parsec_tpu_torch.parallel import model as TM
from parsec_tpu_torch.parallel import transformer as TT

# the reference tests' small config (tests/test_model.py)
CFG = dict(vocab_size=64, d_model=32, d_ff=64, n_heads=4, n_layers=2,
           max_seq=32)


def _params(seed, **cfg):
    """(reference params, port params on the CPU) from one numpy tree."""
    tree = TM.init_lm_params(seed, TM.ModelConfig(**cfg))
    return tree, TM.params_from_numpy(tree, device="cpu")


def _batch(rng, B=4, S=32, V=64):
    toks = rng.integers(0, V, size=(B, S + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


@pytest.mark.parametrize("seed,cfg", [
    (0, CFG),
    (8, dict(vocab_size=32, d_model=32, d_ff=64, n_heads=4, n_layers=2,
             max_seq=24)),
    (3, dict(vocab_size=50, d_model=48, d_ff=96, n_heads=3, n_layers=3,
             max_seq=20)),
])
def test_init_params_are_bit_identical(seed, cfg):
    ref = JM.init_lm_params(seed, JM.ModelConfig(**cfg))
    port = TM.init_lm_params(seed, TM.ModelConfig(**cfg))
    assert jax.tree_util.tree_structure(ref) == \
        jax.tree_util.tree_structure(port)
    for a, b in zip(_leaves(ref), _leaves(port)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    blk_ref = JT.init_block_params(seed, cfg["d_model"], cfg["d_ff"],
                                   cfg["n_heads"])
    blk = TT.init_block_params(seed, cfg["d_model"], cfg["d_ff"],
                               cfg["n_heads"])
    assert sorted(blk) == sorted(blk_ref)
    for name in blk:
        np.testing.assert_array_equal(blk[name], blk_ref[name])


def test_params_round_trip_is_bit_exact():
    ref = JM.init_lm_params(1, JM.ModelConfig(**CFG))
    tree = jax.tree_util.tree_map(np.asarray, ref)
    port = TM.params_from_numpy(tree, device="cpu")
    assert sorted(port) == ["blocks", "embed", "lnf_b", "lnf_g", "pos"]
    assert all(isinstance(t, torch.Tensor) and t.dtype == torch.float32
               for t in _leaves(port))
    back = TM.params_to_numpy(port)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    for a, b in zip(_leaves(tree), _leaves(back)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_params_from_numpy_runs_on_the_card_by_default():
    tree = TM.init_lm_params(0, TM.ModelConfig(**CFG))
    if torch.cuda.is_available():
        assert TM.params_from_numpy(tree)["embed"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TM.params_from_numpy(tree)
    bf = TM.params_from_numpy(tree, device="cpu", dtype=torch.bfloat16)
    assert bf["blocks"][0]["wqkv"].dtype == torch.bfloat16


@pytest.mark.parametrize("core", ["dense", "flash", "dense_return_kv",
                                  "noncausal"])
def test_block_apply_matches_reference(core):
    """test_transformer's block (d 64, 2 heads) through both packages."""
    rng = np.random.default_rng(9)
    p = TT.init_block_params(3, d_model=64, d_ff=128, n_heads=2)
    x = rng.standard_normal((2, 64, 64)).astype(np.float32)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    causal = core != "noncausal"
    j_core = JT.flash_attention_core if core == "flash" else None
    t_core = TT.flash_attention_core if core == "flash" else None
    tol = 2e-4 if core == "flash" else 1e-5
    if core == "dense_return_kv":
        ref = JT.block_apply(p, x, causal=True, return_kv=True)
        out = TT.block_apply(tp, torch.from_numpy(x), causal=True,
                             return_kv=True)
        assert len(out) == 3 and out[1].shape == (2, 2, 64, 32)
        for a, b in zip(ref, out):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=tol,
                                       atol=tol)
        return
    ref = JT.block_apply(p, x, causal=causal, attention=j_core)
    out = TT.block_apply(tp, torch.from_numpy(x), causal=causal,
                         attention=t_core)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("core", ["dense", "flash"])
def test_lm_apply_matches_reference(core):
    tree, tp = _params(3, **CFG)
    x, _ = _batch(np.random.default_rng(3))
    j_core = JT.flash_attention_core if core == "flash" else None
    t_core = TT.flash_attention_core if core == "flash" else None
    ref = np.asarray(JM.lm_apply(tree, x, attention=j_core))
    before = K.flash_attention.launches
    out = TM.lm_apply(tp, x, attention=t_core)
    assert K.flash_attention.launches == before      # CPU: plain version
    assert out.dtype == torch.float32 and tuple(out.shape) == (4, 32, 64)
    tol = 2e-4 if core == "flash" else 1e-5
    np.testing.assert_allclose(out.numpy(), ref, rtol=tol, atol=tol)
    # and the flash core agrees with the dense one (test_model's 2e-3)
    dense = TM.lm_apply(tp, x).numpy()
    np.testing.assert_allclose(out.numpy(), dense, rtol=2e-3, atol=2e-3)


def test_lm_loss_matches_reference():
    tree, tp = _params(0, **CFG)
    x, y = _batch(np.random.default_rng(0))
    ref = float(JM.lm_loss(tree, x, y))
    loss = TM.lm_loss(tp, torch.from_numpy(x), torch.from_numpy(y))
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(float(loss) - ref) < 1e-5
    # an untrained model sits near uniform cross-entropy
    assert abs(float(loss) - np.log(64)) < 0.5
    nc = float(TM.lm_loss(tp, x, y, causal=False))
    assert abs(nc - float(JM.lm_loss(tree, x, y, causal=False))) < 1e-5


def test_lm_causality():
    """Changing a future token must not change past logits."""
    _, tp = _params(2, **CFG)
    x, _ = _batch(np.random.default_rng(2), B=1)
    for core in (None, TT.flash_attention_core):
        la = TM.lm_apply(tp, x, attention=core).numpy()
        x2 = x.copy()
        x2[0, -1] = (x2[0, -1] + 1) % 64
        lb = TM.lm_apply(tp, x2, attention=core).numpy()
        np.testing.assert_allclose(la[0, :-1], lb[0, :-1], atol=1e-5)
        assert np.abs(la[0, -1] - lb[0, -1]).max() > 1e-6


@pytest.mark.parametrize("core", ["dense", "flash"])
def test_lm_bf16_compute_matches_reference(core):
    """bf16 blocks, f32 logits: the loss within 5% of the f32 loss (the
    reference's criterion) and of the reference's own bf16 loss."""
    tree, tp = _params(12, **CFG)
    x, y = _batch(np.random.default_rng(12))
    t_core = TT.flash_attention_core if core == "flash" else None
    j_core = JT.flash_attention_core if core == "flash" else None
    lf32 = float(TM.lm_loss(tp, x, y))
    lbf = TM.lm_loss(tp, x, y, attention=t_core,
                     compute_dtype=torch.bfloat16)
    assert lbf.dtype == torch.float32
    assert abs(float(lbf) - lf32) < 0.05 * max(1.0, lf32)
    ref = float(JM.lm_loss(tree, x, y, attention=j_core,
                           compute_dtype=jnp.bfloat16))
    assert abs(float(lbf) - ref) < 0.05 * max(1.0, ref)
    logits = TM.lm_apply(tp, x, compute_dtype=torch.bfloat16)
    assert logits.dtype == torch.float32
    assert tp["blocks"][0]["wqkv"].dtype == torch.float32   # master stays


def _naive_greedy(tp, prompt, n):
    """The full forward re-run per token; also returns each step's top-2
    logit gap, so a near-tie flip would show as one."""
    seq = torch.from_numpy(prompt)
    gaps = []
    for _ in range(n):
        last = TM.lm_apply(tp, seq)[:, -1]
        top2 = torch.topk(last, 2, dim=-1).values
        gaps.append((top2[:, 0] - top2[:, 1]).min().item())
        seq = torch.cat([seq, last.argmax(-1).to(seq.dtype)[:, None]], 1)
    return seq.numpy(), min(gaps)


def test_lm_generate_matches_reference_and_full_recompute():
    """test_model's generate config and seed: the KV-cached decode equals
    the reference's tokens and the port's own naive recompute."""
    cfg = dict(vocab_size=32, d_model=32, d_ff=64, n_heads=4, n_layers=2,
               max_seq=24)
    tree, tp = _params(8, **cfg)
    prompt = np.random.default_rng(8).integers(0, 32, size=(2, 8)
                                               ).astype(np.int32)
    ref = np.asarray(JM.lm_generate(tree, prompt, n_tokens=12))
    out = TM.lm_generate(tp, prompt, n_tokens=12)
    assert out.dtype == torch.int32 and tuple(out.shape) == (2, 20)
    naive, gap = _naive_greedy(tp, prompt, 12)
    assert gap > 1e-4, f"near-tie in the greedy path (gap {gap})"
    np.testing.assert_array_equal(out.numpy()[:, :8], prompt)
    np.testing.assert_array_equal(out.numpy(), naive)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_lm_generate_zero_and_one_token():
    cfg = dict(vocab_size=16, d_model=32, d_ff=64, n_heads=2, n_layers=1,
               max_seq=16)
    tree, tp = _params(10, **cfg)
    prompt = np.arange(4, dtype=np.int32)[None]
    z = TM.lm_generate(tp, prompt, 0)
    np.testing.assert_array_equal(np.asarray(z), prompt)
    one = TM.lm_generate(tp, prompt, 1)
    assert tuple(one.shape) == (1, 5)
    logits = TM.lm_apply(tp, prompt)
    assert int(one[0, 4]) == int(logits[0, -1].argmax())
    np.testing.assert_array_equal(
        one.numpy(), np.asarray(JM.lm_generate(tree, prompt, 1)))


def test_lm_generate_temperature_zero_is_greedy():
    cfg = dict(vocab_size=16, d_model=32, d_ff=64, n_heads=2, n_layers=1,
               max_seq=16)
    tree, tp = _params(13, **cfg)
    prompt = np.arange(4, dtype=np.int32)[None]
    g = TM.lm_generate(tp, prompt, 8)
    t0 = TM.lm_generate(tp, prompt, 8, greedy=False, temperature=0.0)
    assert torch.equal(g, t0)
    np.testing.assert_array_equal(
        g.numpy(), np.asarray(JM.lm_generate(tree, prompt, 8)))


def test_lm_generate_sampling_reproducible_and_bounded():
    cfg = dict(vocab_size=16, d_model=32, d_ff=64, n_heads=2, n_layers=1,
               max_seq=16)
    _, tp = _params(9, **cfg)
    prompt = np.zeros((1, 4), np.int32)

    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return TM.lm_generate(tp, prompt, 8, greedy=False, temperature=1.0,
                              generator=gen)
    a, b = draw(42), draw(42)
    assert torch.equal(a, b)
    assert a.min() >= 0 and a.max() < 16 and tuple(a.shape) == (1, 12)
    # sampling draws from the distribution: some seed leaves the greedy path
    greedy = TM.lm_generate(tp, prompt, 8)
    assert any(not torch.equal(draw(s), greedy) for s in range(8))
    with pytest.raises(ValueError, match="max_seq"):
        TM.lm_generate(tp, prompt, 100)
    with pytest.raises(ValueError, match="max_seq"):
        TM.lm_apply(tp, np.zeros((1, 17), np.int32))


def test_moe_params_and_remat_raise_not_implemented():
    tree = JM.init_lm_moe_params(0, JM.ModelConfig(
        vocab_size=32, d_model=16, d_ff=32, n_heads=2, n_layers=1,
        max_seq=8), n_experts=4)
    tree = jax.tree_util.tree_map(np.asarray, tree)
    moe = TM.params_from_numpy(tree, device="cpu")
    toks = np.zeros((2, 8), np.int32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TM.lm_apply(moe, toks)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TM.lm_generate(moe, toks, 2)
    _, tp = _params(0, **CFG)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TM.lm_apply(tp, toks, remat=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TM.lm_loss(tp, toks, toks, remat=True)


def test_language_model_module_is_the_functional_api():
    cfg = TM.ModelConfig(**CFG)
    model = TM.LanguageModel(cfg, seed=4, device="cpu")
    names = dict(model.named_parameters())
    assert {"embed", "pos", "lnf_g", "lnf_b", "blocks.0.wqkv",
            "blocks.1.b2"} <= set(names)
    assert not any(p.requires_grad for p in model.parameters())
    tree, tp = _params(4, **CFG)
    x, _ = _batch(np.random.default_rng(4))
    assert torch.equal(model(x), TM.lm_apply(tp, x))
    np.testing.assert_allclose(
        model(x, attention=TT.flash_attention_core).numpy(),
        np.asarray(JM.lm_apply(tree, x)), rtol=2e-4, atol=2e-4)
    prompt = x[:2, :6]
    assert torch.equal(model.generate(prompt, 4),
                       TM.lm_generate(tp, prompt, 4))
