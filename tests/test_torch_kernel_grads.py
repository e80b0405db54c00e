"""Gradients through ``gemm_chain``, ``matmul`` and ``stencil1d``
(``parsec_tpu_torch/ops/cuda_kernels.py``) held to ``jax.grad`` of the
reference's functions (``parsec_tpu/ops/pallas_kernels.py``, whose Pallas
calls give way to their XLA expressions under a gradient trace) on the
same numpy inputs, made from a seed.

On the CPU each wrapper's autograd Function runs the plain version forward
and its library-call backward (``gemm_chain_backward``,
``matmul_backward``, ``stencil1d_backward``), the backward the card runs
behind the kernels too. Tolerances, relative norm-wise: 1e-5 in float32,
1e-2 in bf16, 1e-6 for the stencil."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parsec_tpu.ops import pallas_kernels as PK
from parsec_tpu_torch.ops import cuda_kernels as K

jax.config.update("jax_platforms", "cpu")

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _rel(got, want) -> float:
    got = got.float().numpy().astype(np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _both(arrays, dtypes, fn_ref, fn_port, weight):
    """(jax.grad of sum(weight * fn_ref), torch grads of the same through
    fn_port) on the arrays rounded to ``dtypes``."""
    jx = [jnp.asarray(a).astype(_JNP[d]) for a, d in zip(arrays, dtypes)]
    w = jnp.asarray(weight)
    ref = jax.grad(lambda *xs: jnp.sum(fn_ref(*xs).astype(jnp.float32) * w),
                   argnums=tuple(range(len(jx))))(*jx)
    tx = [torch.from_numpy(a).to(_TORCH[d]).requires_grad_()
          for a, d in zip(arrays, dtypes)]
    (fn_port(*tx).float() * torch.from_numpy(weight)).sum().backward()
    return ref, [t.grad for t in tx], tx


@pytest.mark.parametrize("form", ["float32", "bfloat16", "mixed"])
def test_gemm_chain_backward_matches_jax_grad(form):
    rng = np.random.default_rng(11)
    kt, m, k, n = 5, 24, 16, 20
    arrays = [rng.standard_normal((m, n), dtype=np.float32),
              rng.standard_normal((kt, m, k), dtype=np.float32),
              rng.standard_normal((kt, k, n), dtype=np.float32)]
    ab = "float32" if form == "float32" else "bfloat16"
    cd = "bfloat16" if form == "bfloat16" else "float32"
    weight = rng.standard_normal((m, n), dtype=np.float32)
    ref, got, tx = _both(arrays, (cd, ab, ab), PK.gemm_chain, K.gemm_chain,
                         weight)
    tol = 1e-5 if form == "float32" else 1e-2
    for r, g, t in zip(ref, got, tx):
        assert g.dtype == t.dtype and g.shape == t.shape
        assert _rel(g, r) < tol, (form, _rel(g, r))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_backward_matches_jax_grad(dtype):
    rng = np.random.default_rng(12)
    arrays = [rng.standard_normal((32, 64), dtype=np.float32),
              rng.standard_normal((64, 48), dtype=np.float32)]
    weight = rng.standard_normal((32, 48), dtype=np.float32)
    block = (16, 16, 16)
    ref, got, tx = _both(arrays, (dtype, dtype),
                         lambda a, b: PK.matmul(a, b, block),
                         lambda a, b: K.matmul(a, b, block), weight)
    tol = 1e-5 if dtype == "float32" else 1e-2
    for r, g, t in zip(ref, got, tx):
        assert g.dtype == t.dtype
        assert _rel(g, r) < tol, (dtype, _rel(g, r))


def test_stencil1d_backward_matches_jax_grad():
    """dx, and the halo tiles' gradients: the reference differentiates its
    halo tiles, of which the stencil reads one column each."""
    rng = np.random.default_rng(13)
    arrays = [rng.standard_normal((3, 40), dtype=np.float32),
              rng.standard_normal((3, 6), dtype=np.float32),
              rng.standard_normal((3, 5), dtype=np.float32)]
    weight = rng.standard_normal((3, 40), dtype=np.float32)
    w = (0.2, 0.5, 0.3)
    ref, got, _ = _both(arrays, ("float32",) * 3,
                        lambda x, lt, rt: PK.stencil1d(x, lt, rt, w),
                        lambda x, lt, rt: K.stencil1d(x, lt, rt, w), weight)
    for r, g in zip(ref, got):
        assert _rel(g, r) < 1e-6, _rel(g, r)
    assert not got[1][:, :-1].any() and not got[2][:, 1:].any()


def test_stencil1d_backward_with_a_boundary_halo():
    """A ``None`` halo (the domain boundary, a zero column) has no
    gradient; dx is the reference's with a zero halo tile."""
    rng = np.random.default_rng(14)
    x = rng.standard_normal((2, 24), dtype=np.float32)
    right = rng.standard_normal((2, 3), dtype=np.float32)
    weight = rng.standard_normal((2, 24), dtype=np.float32)
    zero = np.zeros((2, 1), np.float32)
    ref = jax.grad(lambda a, r: jnp.sum(
        PK.stencil1d(a, jnp.asarray(zero), r) * weight), argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(right))
    tx = torch.from_numpy(x).requires_grad_()
    tr = torch.from_numpy(right).requires_grad_()
    (K.stencil1d(tx, None, tr) * torch.from_numpy(weight)).sum().backward()
    assert _rel(tx.grad, ref[0]) < 1e-6 and _rel(tr.grad, ref[1]) < 1e-6


def test_backward_functions_match_autograd_of_the_plain_versions():
    """The library-call backwards against torch autograd of the plain
    versions, which the CPU forward runs (float32)."""
    gen = torch.Generator().manual_seed(15)
    c = torch.randn(12, 10, generator=gen)
    a = torch.randn(3, 12, 8, generator=gen)
    b = torch.randn(3, 8, 10, generator=gen)
    g = torch.randn(12, 10, generator=gen)
    leaves = [t.clone().requires_grad_() for t in (c, a, b)]
    (K.gemm_chain_plain(*leaves) * g).sum().backward()
    for got, leaf in zip(K.gemm_chain_backward(c, a, b, g), leaves):
        torch.testing.assert_close(got, leaf.grad, rtol=1e-5, atol=1e-5)
    x = torch.randn(3, 30, generator=gen)
    lt = torch.randn(3, 4, generator=gen)
    rt = torch.randn(3, 4, generator=gen)
    gs = torch.randn(3, 30, generator=gen)
    leaves = [t.clone().requires_grad_() for t in (x, lt, rt)]
    (K.stencil1d_plain(*leaves) * gs).sum().backward()
    for got, leaf in zip(K.stencil1d_backward(x, lt, rt, gs), leaves):
        torch.testing.assert_close(got, leaf.grad, rtol=0, atol=1e-6)
