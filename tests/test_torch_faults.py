"""Cross-checks of two faults the port had against the reference.

* bf16 A and B with a float32 C: the reference takes every tile product in
  float32 (``preferred_element_type=float32``) and its chain kernel takes the
  mixed dtypes; the port rounded the product to bf16 before adding it, and
  its chain refused the mixed dtypes.
* A POTRF tile that is not positive definite: the reference's Cholesky gives
  an all-NaN factor, which spreads through the DAG; the port's gave a finite
  partial factor.

The same numpy inputs go through both packages (the port on the CPU), each
check at the tolerance it states.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parsec_tpu.core.context import Context as RefContext
from parsec_tpu.data.matrix import TwoDimBlockCyclic as RefMatrix
from parsec_tpu.dsl.dtd import DTDTaskpool as RefPool
from parsec_tpu.ops import gemm as RG
from parsec_tpu.ops.potrf import insert_potrf_tasks as ref_insert_potrf
from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.data.matrix import collection_from_numpy
from parsec_tpu_torch.dsl.dtd import DTDTaskpool
from parsec_tpu_torch.ops import gemm as G
from parsec_tpu_torch.ops.potrf import insert_potrf_tasks, make_spd


def _mixed_inputs(kt, ts, seed):
    """C float32, A and B bf16 values (held as float32 numpy arrays, which
    represent them exactly), standard normal."""
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((ts, ts)).astype(np.float32)

    def bf16(shape):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return x.to(torch.bfloat16).float().numpy()
    return c, bf16((kt, ts, ts)), bf16((kt, ts, ts))


def _exact(c, a, b):
    return c.astype(np.float64) + sum(
        a[s].astype(np.float64) @ b[s].astype(np.float64)
        for s in range(a.shape[0]))


def _check_mixed(got, want, exact):
    """Within rtol/atol 1e-5 of the reference and of the f64 product."""
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, exact, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(want, exact, rtol=1e-5, atol=1e-5)


def test_tile_gemm_bf16_operands_f32_c_match_reference():
    """``tile_gemm`` on bf16 A and B with a float32 C, 64 x 64."""
    c, a, b = _mixed_inputs(1, 64, seed=1)
    got = G.tile_gemm(torch.from_numpy(c), torch.from_numpy(a[0]).bfloat16(),
                      torch.from_numpy(b[0]).bfloat16())
    want = RG.tile_gemm(jnp.asarray(c), jnp.asarray(a[0], jnp.bfloat16),
                        jnp.asarray(b[0], jnp.bfloat16))
    _check_mixed(got.numpy(), np.asarray(want), _exact(c, a, b))


@pytest.mark.parametrize("kt", [4, 17])
def test_gemm_k_bf16_operands_f32_c_match_reference(kt):
    """The GEMM_K body of a k-chain of 4 (unrolled dots) and of 17 (the
    chain kernel; Pallas in interpret mode in the reference), 32 x 32
    tiles, bf16 A and B, float32 C."""
    c, a, b = _mixed_inputs(kt, 32, seed=kt)
    got = G._gemm_chain_body(kt)(
        torch.from_numpy(c), *[torch.from_numpy(x).bfloat16() for x in a],
        *[torch.from_numpy(x).bfloat16() for x in b])
    want = RG._gemm_chain_body(kt)(
        jnp.asarray(c), *[jnp.asarray(x, jnp.bfloat16) for x in a],
        *[jnp.asarray(x, jnp.bfloat16) for x in b])
    _check_mixed(got.numpy(), np.asarray(want), _exact(c, a, b))


def test_potrf_dag_with_a_non_spd_tile_nan_masks_match_reference():
    """A 64 x 64 SPD matrix in 16 x 16 tiles whose diagonal tile (2, 2) is
    pulled far below zero: the Schur complement there is not positive
    definite, so POTRF(2) fails. The NaN masks of the two packages agree
    tile by tile (columns 0-1 finite, the failed panel and everything it
    updates NaN), and the finite tiles agree within rtol/atol 1e-5."""
    n, ts = 64, 16
    a = make_spd(n, seed=5)
    a[2 * ts:3 * ts, 2 * ts:3 * ts] -= 100.0 * np.eye(ts, dtype=np.float32)

    ref_ctx = RefContext(nb_cores=1)
    try:
        R = RefMatrix("npd", n, n, ts, ts, P=1, Q=1)
        R.fill(lambda m, k: a[m * ts:(m + 1) * ts, k * ts:(k + 1) * ts])
        tp = RefPool(ref_ctx, "npd")
        ref_insert_potrf(tp, R)
        tp.wait(); tp.close(); ref_ctx.wait()
        want = np.asarray(R.to_dense())
    finally:
        ref_ctx.fini()
    ctx = Context(nb_cores=1, device="cpu")
    try:
        P = collection_from_numpy("npd", a, ts, ts)
        tp = DTDTaskpool(ctx, "npd")
        insert_potrf_tasks(tp, P)
        tp.wait(); tp.close(); ctx.wait()
        got = P.to_dense()
    finally:
        ctx.fini()

    T = n // ts
    masks = {}
    for m in range(T):
        for k in range(m + 1):
            blk = (slice(m * ts, (m + 1) * ts), slice(k * ts, (k + 1) * ts))
            masks[m, k] = np.isnan(want[blk]).any()
            np.testing.assert_array_equal(np.isnan(got[blk]),
                                          np.isnan(want[blk]),
                                          err_msg=f"tile ({m}, {k})")
    assert masks[2, 2] and masks[3, 2] and masks[3, 3]
    assert not any(masks[m, k] for m in range(T) for k in range(min(m + 1, 2)))
    finite = ~np.isnan(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-5,
                               atol=1e-5)
