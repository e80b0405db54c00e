"""The port's gemm_chain against the reference Pallas kernel.

The same inputs, made with numpy from a seed, go through the reference's
``gemm_chain`` (Pallas in interpret mode on the CPU) and the port's wrapper,
which takes its plain PyTorch version for CPU tensors. The CUDA kernel itself
runs only on the card: tests/test_torch_cuda.py holds its tests.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parsec_tpu.ops import pallas_kernels as PK
from parsec_tpu_torch.ops import cuda_kernels as K
from parsec_tpu_torch.utils import mca

# (kt, ts_m, ts_k, ts_n): square and rectangular tiles, chains of 1, 3, 20
SHAPES = [(1, 32, 32, 32), (3, 32, 32, 32), (20, 32, 32, 32),
          (3, 16, 48, 32), (20, 32, 16, 48)]


def _inputs(kt, m, k, n, seed):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((m, n)).astype(np.float32)
    a = rng.standard_normal((kt, m, k)).astype(np.float32)
    b = rng.standard_normal((kt, k, n)).astype(np.float32)
    return c, a, b


def _reference(c, a, b, dtype=jnp.float32):
    out = PK.gemm_chain(jnp.asarray(c, dtype), jnp.asarray(a, dtype),
                        jnp.asarray(b, dtype))
    return np.asarray(out.astype(jnp.float32))


def _port(c, a, b, dtype=torch.float32):
    out = K.gemm_chain(*(torch.from_numpy(x).to(dtype) for x in (c, a, b)))
    return out.float().numpy()


@pytest.mark.parametrize("kt,m,k,n", SHAPES)
def test_gemm_chain_f32_matches_pallas(kt, m, k, n):
    c, a, b = _inputs(kt, m, k, n, seed=kt * 100 + m + n)
    np.testing.assert_allclose(_port(c, a, b), _reference(c, a, b),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kt,m,k,n", SHAPES)
def test_gemm_chain_bf16_matches_pallas(kt, m, k, n):
    """bf16 compared in float32: every element within 2 bf16 ulps of the
    largest |C| its chain passes through (the two sum each step in their own
    order, so one step's rounding may land an ulp apart and the running C
    carries the gap on)."""
    c, a, b = _inputs(kt, m, k, n, seed=kt * 100 + m + n + 1)
    got, want = _port(c, a, b, torch.bfloat16), \
        _reference(c, a, b, jnp.bfloat16)
    tol = K.gemm_chain_bf16_tolerance(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (c, a, b))).numpy()
    assert (np.abs(got - want) <= tol).all()


@pytest.mark.parametrize("kt,m,k,n", SHAPES)
def test_gemm_chain_bf16_bit_exact_on_integers(kt, m, k, n):
    """Small integers make every float32 partial sum exact in any order, so
    each step's bf16 rounding is deterministic: the port and the reference
    must agree bit for bit, per-step rounding included."""
    rng = np.random.default_rng(kt + m + k + n)
    c = rng.integers(-8, 9, (m, n)).astype(np.float32)
    a = rng.integers(-4, 5, (kt, m, k)).astype(np.float32)
    b = rng.integers(-4, 5, (kt, k, n)).astype(np.float32)
    np.testing.assert_array_equal(_port(c, a, b, torch.bfloat16),
                                  _reference(c, a, b, jnp.bfloat16))


def test_gemm_chain_bf16_rounds_every_step():
    """C = 256 in bf16 (ulp 2) plus 0.5 per step: each step's add rounds
    back to 256, where a chain rounded once at the end would reach 266."""
    kt, ts = 20, 32
    c = np.full((ts, ts), 256.0, np.float32)
    a = np.full((kt, ts, ts), 1.0 / 64, np.float32)     # dot = 32/64 = 0.5
    b = np.ones((kt, ts, ts), np.float32)
    got = _port(c, a, b, torch.bfloat16)
    np.testing.assert_array_equal(got, _reference(c, a, b, jnp.bfloat16))
    assert (got == 256.0).all()
    np.testing.assert_array_equal(_port(c, a, b), np.full((ts, ts), 266.0))


def test_gemm_chain_cpu_takes_plain_version_without_launch():
    c, a, b = (torch.from_numpy(x) for x in _inputs(3, 16, 16, 16, seed=5))
    before = K.gemm_chain.launches
    out = K.gemm_chain(c, a, b)
    assert K.gemm_chain.launches == before
    torch.testing.assert_close(out, K.gemm_chain_plain(c, a, b))


@pytest.mark.parametrize("case", ["shape", "dtype", "contiguity", "rank"])
def test_gemm_chain_rejects_what_the_kernel_does_not_take(case):
    c, a, b = (torch.from_numpy(x) for x in _inputs(2, 16, 8, 16, seed=6))
    if case == "shape":
        args, exc = (c, a, b[:, :4]), ValueError
    elif case == "dtype":
        args, exc = (c.double(), a.double(), b.double()), TypeError
    elif case == "contiguity":
        args, exc = (c.t(), a, b), ValueError
    else:
        args, exc = (c, a[0], b), ValueError
    with pytest.raises(exc):
        K.gemm_chain(*args)


def test_dot_precision_policy():
    """Every accepted name computes float32 dots at 'highest' (TF32 off);
    an unknown name raises."""
    try:
        for name in ("highest", "high", "default"):
            mca.set("tile_dot_precision", name)
            assert K.dot_precision() == name
            assert torch.backends.cuda.matmul.allow_tf32 is False
            assert torch.backends.cudnn.allow_tf32 is False
        mca.set("tile_dot_precision", "fastest")
        with pytest.raises(ValueError):
            K.dot_precision()
    finally:
        mca.params.unset("tile_dot_precision")
