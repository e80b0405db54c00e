"""Card-only tests of the training path: the flash kernel under autograd,
gradients through the LM's flash core, the remat recompute, the other
kernels' backward under autograd, the loader's device stage, a checkpoint
resumed on the card and the profiler trace.

Every test here carries the ``cuda`` marker and skips without a CUDA card.
The file imports neither JAX nor the reference package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_train_cuda.py
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from parsec_tpu_torch.data.loader import PrefetchLoader, token_batches
from parsec_tpu_torch.ops import cuda_kernels as K
from parsec_tpu_torch.parallel import model as TM
from parsec_tpu_torch.parallel import optim as O
from parsec_tpu_torch.parallel.optim import value_and_grad
from parsec_tpu_torch.parallel.transformer import (_dense_attention_core,
                                                   flash_attention_core)
from parsec_tpu_torch.utils.model_ckpt import (restore_train_state,
                                               save_train_state)
from parsec_tpu_torch.utils.xla_trace import annotate, xla_trace

pytestmark = pytest.mark.cuda

# a small LM whose heads are 64 wide: the wgmma route in bf16
CFG = TM.ModelConfig(vocab_size=512, d_model=128, d_ff=256, n_heads=2,
                     n_layers=2, max_seq=256)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _rel(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _dense_grads(q, k, v, g, causal, q_offset, k_offset):
    """Autograd of the dense expression in float32 on the same values."""
    q32, k32, v32 = (t.detach().float().requires_grad_() for t in (q, k, v))
    out = K.flash_attention_plain(q32, k32, v32, causal=causal,
                                  q_offset=q_offset, k_offset=k_offset)
    (out * g.float()).sum().backward()
    return q32.grad, k32.grad, v32.grad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,q_offset,k_offset,sq,sk", [
    (True, 0, 0, 512, 512), (False, 0, 0, 384, 512), (True, 256, 0, 256,
                                                      512)])
def test_flash_function_on_the_card_matches_dense_autograd(
        dtype, causal, q_offset, k_offset, sq, sk):
    """Under autograd the wrapper launches the kernel forward (one launch,
    on its route) and its gradients are the dense expression's: float32
    within rtol/atol 1e-4 of float32 autograd of the plain version, bf16
    norm-wise within 2e-2 of it (bf16 results of float32 math)."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn(8, sq, 64, device="cuda", generator=gen).to(dtype)
    k = torch.randn(8, sk, 64, device="cuda", generator=gen).to(dtype)
    v = torch.randn(8, sk, 64, device="cuda", generator=gen).to(dtype)
    g = torch.randn(8, sq, 64, device="cuda", generator=gen).to(dtype)
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    before = K.flash_attention.launches
    route = K.flash_route(dtype, 64, True)
    by_route = K.flash_attention.launches_by_route[route]
    out = K.flash_attention(tq, tk, tv, causal=causal, q_offset=q_offset,
                            k_offset=k_offset)
    assert K.flash_attention.launches == before + 1
    assert K.flash_attention.launches_by_route[route] == by_route + 1
    assert out.grad_fn is not None
    (out * g).sum().backward()
    assert K.flash_attention.launches == before + 1   # no kernel backward
    want = _dense_grads(q, k, v, g, causal, q_offset, k_offset)
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        assert got.dtype == dtype
        if dtype == torch.float32:
            torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
        else:
            assert _rel(got, ref) < 2e-2


def _lm_grads(params, x, y, attention, compute_dtype=None, remat=False):
    return value_and_grad(
        lambda p: TM.lm_loss(p, x, y, attention=attention, remat=remat,
                             compute_dtype=compute_dtype), params)


@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16])
def test_wqkv_gets_gradients_through_the_flash_core(compute_dtype):
    """Through the flash core every block's wqkv gets a gradient (before
    the flash Function it got none on the card) that matches the dense
    core's: f32 norm-wise 1e-4, bf16 2e-2; the loss likewise."""
    _need_card()
    params = TM.params_from_numpy(TM.init_lm_params(0, CFG))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, CFG.vocab_size, (4, 257))).cuda()
    x, y = toks[:, :-1], toks[:, 1:]
    lf, _, gf = _lm_grads(params, x, y, flash_attention_core, compute_dtype)
    ld, _, gd = _lm_grads(params, x, y, _dense_attention_core, compute_dtype)
    tol = 1e-4 if compute_dtype is None else 2e-2
    assert abs(float(lf) - float(ld)) <= tol * abs(float(ld))
    for a, b in zip(gf, gd):
        assert _rel(a, b) < tol
    leaves = O.tree_leaves(params)          # the gradients' order
    for bp in params["blocks"]:
        i = next(j for j, t in enumerate(leaves) if t is bp["wqkv"])
        assert gf[i].norm() > 0


def test_remat_step_recomputes_through_the_kernel():
    """One training step launches the flash kernel once a layer, and twice
    with remat (the recompute in the backward pass); both give the same
    loss and gradients."""
    _need_card()
    params = TM.params_from_numpy(TM.init_lm_params(1, CFG))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, CFG.vocab_size, (2, 129))).cuda()
    x, y = toks[:, :-1], toks[:, 1:]
    counts = []
    results = []
    for remat in (False, True):
        before = K.flash_attention.launches
        results.append(_lm_grads(params, x, y, flash_attention_core,
                                 torch.bfloat16, remat))
        counts.append(K.flash_attention.launches - before)
    assert counts == [CFG.n_layers, 2 * CFG.n_layers], counts
    assert float(results[0][0]) == float(results[1][0])
    for a, b in zip(results[0][2], results[1][2]):
        assert torch.equal(a, b)


def _plain_grads(plain, args, g):
    """Autograd of a plain version in float32 on the same values."""
    leaves = [None if t is None else t.detach().float().requires_grad_()
              for t in args]
    (plain(*leaves).float() * g.float()).sum().backward()
    return [None if t is None else t.grad for t in leaves]


def _kernel_grads(fn, args, g):
    leaves = [None if t is None else t.detach().requires_grad_()
              for t in args]
    (fn(*leaves).float() * g.float()).sum().backward()
    return [None if t is None else t.grad for t in leaves]


@pytest.mark.parametrize("form", ["float32", "bfloat16", "mixed"])
def test_gemm_chain_backward_on_the_card_matches_plain_autograd(form):
    """The chain kernel under autograd on the card: one launch forward, and
    the gradients of C, A and B within 1e-5 (float32) or 1e-2 (bf16, the
    mixed bf16·bf16 -> float32 form too) norm-wise of float32 autograd of
    the plain chain on the same values."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(5)
    ab = torch.float32 if form == "float32" else torch.bfloat16
    cd = torch.bfloat16 if form == "bfloat16" else torch.float32
    c = torch.randn(256, 192, device="cuda", generator=gen).to(cd)
    a = torch.randn(6, 256, 128, device="cuda", generator=gen).to(ab)
    b = torch.randn(6, 128, 192, device="cuda", generator=gen).to(ab)
    g = torch.randn(256, 192, device="cuda", generator=gen)
    before = K.gemm_chain.launches
    got = _kernel_grads(K.gemm_chain, (c, a, b), g)
    assert K.gemm_chain.launches - before == 1
    want = _plain_grads(K.gemm_chain_plain, (c, a, b), g)
    tol = 1e-5 if form == "float32" else 1e-2
    for x, y, t in zip(got, want, (c, a, b)):
        assert x.dtype == t.dtype and x.is_cuda
        assert _rel(x, y) < tol, (form, _rel(x, y))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_backward_on_the_card_matches_plain_autograd(dtype):
    """The blocked matmul kernel under autograd on the card: one launch
    forward, dA and dB within 1e-5 (float32) or 1e-2 (bf16) norm-wise of
    float32 autograd of the plain version."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(6)
    a = torch.randn(256, 512, device="cuda", generator=gen).to(dtype)
    b = torch.randn(512, 128, device="cuda", generator=gen).to(dtype)
    g = torch.randn(256, 128, device="cuda", generator=gen)
    block = (64, 64, 128)
    before = K.matmul.launches
    got = _kernel_grads(lambda x, y: K.matmul(x, y, block), (a, b), g)
    assert K.matmul.launches - before == 1
    want = _plain_grads(lambda x, y: K.matmul_plain(x, y, block), (a, b), g)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for x, y in zip(got, want):
        assert x.dtype == dtype and _rel(x, y) < tol, _rel(x, y)


@pytest.mark.parametrize("halos", ["both", "none"])
def test_stencil1d_backward_on_the_card_matches_plain_autograd(halos):
    """The stencil kernel under autograd on the card: one launch forward,
    dx and the halo tiles' gradients (only the columns the stencil read
    are nonzero) within 1e-6 norm-wise of float32 autograd of the plain
    version."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(4, 4096, device="cuda", generator=gen)
    left = right = None
    if halos == "both":
        left = torch.randn(4, 64, device="cuda", generator=gen)
        right = torch.randn(4, 64, device="cuda", generator=gen)
    g = torch.randn(4, 4096, device="cuda", generator=gen)
    before = K.stencil1d.launches
    got = _kernel_grads(K.stencil1d, (x, left, right), g)
    assert K.stencil1d.launches - before == 1
    want = _plain_grads(K.stencil1d_plain, (x, left, right), g)
    for u, w in zip(got, want):
        if w is None:
            assert u is None
            continue
        assert _rel(u, w) < 1e-6, _rel(u, w)
    if left is not None:
        assert not got[1][:, :-1].any() and not got[2][:, 1:].any()


def test_loader_device_stage_is_ready_on_the_consumer_stream():
    """Batches copied on the loader's side stream are read on a consumer
    stream with no host synchronisation: each batch's values arrive
    intact, pinned sources, card tensors."""
    _need_card()
    corpus = np.arange(5000) % 251
    ref = list(token_batches(corpus, 16, 512, seed=3, n_batches=12))
    consumer = torch.cuda.Stream()
    got = []
    with torch.cuda.stream(consumer):
        for x, y in PrefetchLoader(
                lambda: token_batches(corpus, 16, 512, seed=3,
                                      n_batches=12), device="cuda", ahead=3):
            assert x.device.type == "cuda" and x.dtype == torch.int32
            # work on the consumer stream right away, no synchronise
            got.append(((x.long() * 3 + 1).cpu(), (y.long() - x.long())
                        .cpu()))
    for (x, y), (a, b) in zip(ref, got):
        np.testing.assert_array_equal(a.numpy(), x.astype(np.int64) * 3 + 1)
        np.testing.assert_array_equal(b.numpy(), y.astype(np.int64) - x)
    assert len(got) == 12


def test_checkpoint_resume_on_the_card_is_bit_exact(tmp_path):
    _need_card()
    tree = TM.init_lm_params(2, CFG)
    tx = O.chain(O.clip_by_global_norm(1.0), O.adamw(3e-3))
    step, opt, place_p, place_t = TM.make_lm_opt_train_step(
        None, tx, tree, remat=True, compute_dtype=torch.bfloat16,
        attention=flash_attention_core)
    p = place_p(tree)
    toks = np.random.default_rng(2).integers(0, CFG.vocab_size, (4, 129))
    x, y = place_t(toks[:, :-1]), place_t(toks[:, 1:])
    for _ in range(3):
        p, opt, _ = step(p, opt, x, y)
    path = save_train_state(str(tmp_path / "c"), p, opt, step=3)
    rp, ro, n = restore_train_state(path, like=(p, opt))
    assert n == 3 and rp["embed"].device.type == "cuda"
    a, _, la = step(p, opt, x, y)
    b, _, lb = step(rp, ro, x, y)
    assert float(la) == float(lb)
    for s, t in zip(O.tree_leaves(a), O.tree_leaves(b)):
        assert torch.equal(s, t)


def test_trace_holds_the_kernel_and_the_ranges(tmp_path):
    _need_card()
    params = TM.params_from_numpy(TM.init_lm_params(3, CFG))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, CFG.vocab_size, (2, 129))).cuda()
    logdir = str(tmp_path / "tb")
    with xla_trace(logdir):
        for i in range(2):
            with annotate(f"train::step{i}"):
                _lm_grads(params, toks[:, :-1], toks[:, 1:],
                          flash_attention_core, torch.bfloat16)
    (path,) = glob.glob(os.path.join(logdir, "*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "flash_bf16_wgmma" in e.get("name", "")]
    assert len(kernels) == 2 * CFG.n_layers
    names = {e.get("name") for e in events}
    assert {"train::step0", "train::step1"} <= names
