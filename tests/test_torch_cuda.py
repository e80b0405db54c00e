"""Card-only tests of the port: the hand-written kernel and the CUDA device
module on a real card.

Every test here carries the ``cuda`` marker and skips without a CUDA card
(the kernel has no CPU mode). The file imports neither JAX nor the reference
package, so it runs on a machine that has neither:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.data.matrix import TiledMatrix, collection_from_numpy
from parsec_tpu_torch.device.cuda import CUDADevice
from parsec_tpu_torch.dsl.dtd import DTDTaskpool, RW
from parsec_tpu_torch.ops import cuda_kernels as K
from parsec_tpu_torch.ops.gemm import insert_gemm_tasks
from parsec_tpu_torch.ops.potrf import insert_potrf_tasks, make_spd
from parsec_tpu_torch.utils import mca

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.fixture()
def gctx():
    _need_card()
    mca.set("device_load_balance_allow_cpu", False)
    c = Context(nb_cores=1)
    try:
        yield c
    finally:
        c.fini()
        mca.params.unset("device_load_balance_allow_cpu")


def _dev(ctx) -> CUDADevice:
    return next(d for d in ctx.devices.devices if isinstance(d, CUDADevice))


def _drain(ctx, tp):
    tp.wait(); tp.close(); ctx.wait()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kt,m,k,n", [(17, 256, 128, 512), (32, 96, 64, 40)])
def test_kernel_matches_plain(dtype, kt, m, k, n):
    """Unit-scale random data: float32 within rtol/atol 1e-4; bf16 with at
    most 0.1% of elements beyond 2 ulps of the running peak |C|."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(kt + m)
    s = k ** -0.25
    c = torch.randn(m, n, device="cuda", generator=gen).to(dtype)
    a = (torch.randn(kt, m, k, device="cuda", generator=gen) * s).to(dtype)
    b = (torch.randn(kt, k, n, device="cuda", generator=gen) * s).to(dtype)
    before = K.gemm_chain.launches
    got = K.gemm_chain(c, a, b).float()
    assert K.gemm_chain.launches == before + 1
    want = K.gemm_chain_plain(c, a, b).float()
    torch.cuda.synchronize()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        tol = K.gemm_chain_bf16_tolerance(c, a, b)
        assert ((got - want).abs() > tol).float().mean().item() <= 1e-3


@pytest.mark.parametrize("kt", [17, 32])
def test_kernel_bf16_bit_exact_on_integers(kt):
    """Small integers: every float32 partial sum is exact in any order, so
    the per-step bf16 rounding must agree bit for bit."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(kt)
    m, k, n = 128, 512, 192
    c = torch.randint(-8, 9, (m, n), device="cuda", generator=gen)
    a = torch.randint(-4, 5, (kt, m, k), device="cuda", generator=gen)
    b = torch.randint(-4, 5, (kt, k, n), device="cuda", generator=gen)
    args = [x.to(torch.bfloat16) for x in (c, a, b)]
    assert torch.equal(K.gemm_chain(*args), K.gemm_chain_plain(*args))


def test_kernel_raises_instead_of_falling_back():
    _need_card()
    c = torch.zeros(32, 32, device="cuda")
    a = torch.zeros(2, 32, 32, device="cuda")
    with pytest.raises(ValueError):
        K.gemm_chain(c.t(), a, a)            # non-contiguous
    with pytest.raises(TypeError):
        K.gemm_chain(c.half(), a.half(), a.half())


def test_dtd_gemm_runs_the_kernel_on_the_card(gctx):
    """kt = 32 > 16: each of the 4 GEMM_K tasks launches the kernel once,
    every task executes on the CUDA device, and C matches float64."""
    rng = np.random.default_rng(12)
    a = rng.standard_normal((128, 2048)).astype(np.float32)
    b = rng.standard_normal((2048, 128)).astype(np.float32)
    A = collection_from_numpy("A", a, 64, 64)
    B = collection_from_numpy("B", b, 64, 64)
    C = collection_from_numpy("C", np.zeros((128, 128), np.float32), 64, 64)
    before = K.gemm_chain.launches
    tp = DTDTaskpool(gctx, "gemm")
    n = insert_gemm_tasks(tp, A, B, C, batch_k=True)
    _drain(gctx, tp)
    assert K.gemm_chain.launches - before == n == 4
    assert _dev(gctx).executed_tasks == n
    ref = a.astype(np.float64) @ b
    assert np.abs(C.to_dense() - ref).max() / np.abs(ref).max() < 1e-5


def test_dtd_potrf_on_the_card(gctx):
    spd = make_spd(512, seed=3)
    P = collection_from_numpy("P", spd, 128, 128)
    tp = DTDTaskpool(gctx, "potrf")
    n = insert_potrf_tasks(tp, P)
    _drain(gctx, tp)
    assert _dev(gctx).executed_tasks == n == 20
    L = np.tril(P.to_dense()).astype(np.float64)
    assert np.abs(L @ L.T - spd).max() / np.abs(spd).max() < 1e-5


def test_stage_in_once_then_eviction_writes_back(gctx):
    """On the card: a chain over one tile stages it in once; a budget of one
    tile then evicts it with its newest version written back home."""
    dev = _dev(gctx)
    A = TiledMatrix("AC", 64, 32, 32, 32)
    A.fill(lambda m, n: np.full((32, 32), float(m), np.float32))
    tp = DTDTaskpool(gctx, "chain")
    t0 = tp.tile_of(A, 0, 0)
    for _ in range(4):
        tp.insert_task(lambda x: x + 1.0, (t0, RW))
    _drain(gctx, tp)
    assert dev.transfer_in_bytes == 32 * 32 * 4
    dev.set_budget(32 * 32 * 4)
    tp = DTDTaskpool(gctx, "evict")
    tp.insert_task(lambda x: x * 2.0, (tp.tile_of(A, 1, 0), RW))
    _drain(gctx, tp)
    d0 = A.data_of(0, 0)
    assert dev.evictions >= 1
    assert d0.get_copy(0).version == d0.version
    assert np.allclose(A.to_dense(), np.vstack([np.full((32, 32), 4.0),
                                                np.full((32, 32), 2.0)]))
