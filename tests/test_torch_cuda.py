"""Card-only tests of the port: the hand-written kernels, the CUDA device
module and the LM serving path on a real card.

Every test here carries the ``cuda`` marker and skips without a CUDA card
(the kernel has no CPU mode). The file imports neither JAX nor the reference
package, so it runs on a machine that has neither:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import contextlib
import ctypes
import math
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor

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
from parsec_tpu_torch.parallel import model as TM
from parsec_tpu_torch.parallel.transformer import flash_attention_core
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


# (kt, m, k, n, the route on a 132-SM card): the split route for outputs of
# few 128 x 128 tiles (the DTD GEMM's C 512^2 among them), the tile route
# for 36 tiles, the general route for a row pitch of 36 bytes (bf16) or 72
# bytes (float32)
CHAIN_CASES = [(17, 256, 128, 512, "split"), (32, 96, 64, 40, "split"),
               (17, 512, 512, 512, "split"), (32, 512, 512, 512, "split"),
               (4, 768, 256, 768, "tile"), (5, 64, 64, 18, "general")]


@contextlib.contextmanager
def _counted_on(fn, route):
    """Asserts that the wrapper ``fn`` counted one launch in the block, on
    ``route``."""
    before = dict(fn.launches_by_route), fn.launches
    yield
    assert fn.launches == before[1] + 1
    assert {r: fn.launches_by_route[r] - before[0][r]
            for r in before[0]} == {r: int(r == route) for r in before[0]}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kt,m,k,n,route", CHAIN_CASES)
def test_kernel_matches_plain(dtype, kt, m, k, n, route):
    """Unit-scale random data on every route: float32 within rtol/atol
    1e-4; bf16 with at most 0.1% of elements beyond 2 ulps of the running
    peak |C|. The launch is counted once, on the route the shape takes."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(kt + m)
    s = k ** -0.25
    c = torch.randn(m, n, device="cuda", generator=gen).to(dtype)
    a = (torch.randn(kt, m, k, device="cuda", generator=gen) * s).to(dtype)
    b = (torch.randn(kt, k, n, device="cuda", generator=gen) * s).to(dtype)
    with _counted_on(K.gemm_chain, route):
        got = K.gemm_chain(c, a, b).float()
    want = K.gemm_chain_plain(c, a, b).float()
    torch.cuda.synchronize()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        tol = K.gemm_chain_bf16_tolerance(c, a, b)
        assert ((got - want).abs() > tol).float().mean().item() <= 1e-3


def _integer_chain(kt, m, k, n, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    c = torch.randint(-8, 9, (m, n), device="cuda", generator=gen)
    a = torch.randint(-4, 5, (kt, m, k), device="cuda", generator=gen)
    b = torch.randint(-4, 5, (kt, k, n), device="cuda", generator=gen)
    return [x.to(torch.bfloat16) for x in (c, a, b)]


# the bit-exact cases: both split shapes of the DTD GEMM's tile, the first
# test shape, 36 tiles (tile route), and n = 20 (a 40-byte bf16 pitch)
BIT_EXACT_CASES = [(17, 512, 512, 512, "split"), (32, 512, 512, 512, "split"),
                   (17, 128, 512, 192, "split"), (4, 768, 256, 768, "tile"),
                   (5, 64, 64, 20, "general")]


@pytest.mark.parametrize("kt,m,k,n,route", BIT_EXACT_CASES)
def test_kernel_bf16_bit_exact_on_integers(kt, m, k, n, route):
    """Small integers: every float32 partial sum is exact in any order, so
    the per-step bf16 rounding must agree bit for bit, on every route."""
    _need_card()
    args = _integer_chain(kt, m, k, n, kt)
    with _counted_on(K.gemm_chain, route):
        got = K.gemm_chain(*args)
    assert torch.equal(got, K.gemm_chain_plain(*args))


def test_kernel_refuses_a_route_the_shape_does_not_allow():
    """The C entry point checks the route's preconditions and refuses the
    launch (no silent change of route): the tile route on a 40-byte pitch,
    the split route without scratch."""
    _need_card()
    lib = K._library("gemm_chain")
    c, a, b = _integer_chain(2, 64, 64, 20, 1)
    out = torch.empty_like(c)
    st = torch.cuda.current_stream().cuda_stream
    sms = K._sm_count(c.device)
    assert lib.gemm_chain(c.data_ptr(), a.data_ptr(), b.data_ptr(),
                          out.data_ptr(), None, 2, 64, 64, 20, 1,
                          K.CHAIN_ROUTES["tile"], sms, st) != 0
    c, a, b = _integer_chain(2, 64, 64, 64, 1)
    assert lib.gemm_chain(c.data_ptr(), a.data_ptr(), b.data_ptr(),
                          out.data_ptr(), None, 2, 64, 64, 64, 1,
                          K.CHAIN_ROUTES["split"], sms, st) != 0


# planted faults in the chain's source: (name, [(source text, its
# replacement)], the shape (kt, m, k, n) of the route the fault sits on)
CHAIN_FAULTS = [
    ("phase 2 in reverse step order",
     [("parts[(size_t)(s + q) * nv + v]",
       "parts[(size_t)(kt - 1 - s - q) * nv + v]"),
      ("add_rounded(r, parts[(size_t)s * nv + v]);",
       "add_rounded(r, parts[(size_t)(kt - 1 - s) * nv + v]);")],
     (20, 512, 512, 512)),
    ("phase 2 drops the first step",
     [("    int s = 0;\n    for (; s + BATCH <= kt; s += BATCH) {",
       "    int s = 1;\n    for (; s + BATCH <= kt; s += BATCH) {")],
     (20, 512, 512, 512)),
    ("step product not rounded (tile route)",
     [("const float2 p = __bfloat1622float2(\n"
       "              __floats2bfloat162_rn(acc[2 * j], acc[2 * j + 1]));",
       "const float2 p = make_float2(acc[2 * j], acc[2 * j + 1]);")],
     (4, 768, 256, 768)),
]


@pytest.fixture(scope="module")
def chain_mutants(tmp_path_factory):
    """One library per planted fault, built from a changed copy of the
    chain's source (all nvcc runs at once)."""
    _need_card()
    with open(os.path.join(K.CSRC_DIR, "gemm_chain.cu")) as f:
        src = f.read()
    out = tmp_path_factory.mktemp("chain_mutants")

    def build(i):
        text = src
        for old, new in CHAIN_FAULTS[i][1]:
            assert text.count(old) == 1
            text = text.replace(old, new)
        cu, so = out / f"fault{i}.cu", out / f"fault{i}.so"
        cu.write_text(text)
        subprocess.run([K.nvcc_path(), *K.NVCC_FLAGS, "-o", str(so), str(cu)],
                       check=True, capture_output=True)
        lib = ctypes.CDLL(str(so))
        K._bind("gemm_chain", lib)
        return lib
    with ThreadPoolExecutor(len(CHAIN_FAULTS)) as pool:
        return list(pool.map(build, range(len(CHAIN_FAULTS))))


@pytest.mark.parametrize("fault", range(len(CHAIN_FAULTS)),
                         ids=[f[0] for f in CHAIN_FAULTS])
def test_chain_bit_exact_check_rejects_planted_faults(fault, chain_mutants,
                                                      monkeypatch):
    """The integer bit-exact check of the test above must fail a kernel
    whose phase 2 sums in reverse step order or drops a step, or whose tile
    route skips the step product's rounding. Prints how many elements
    differ (``-s`` shows them)."""
    monkeypatch.setitem(K._libs, "gemm_chain", chain_mutants[fault])
    args = _integer_chain(*CHAIN_FAULTS[fault][2], 7)
    got, want = K.gemm_chain(*args), K.gemm_chain_plain(*args)
    differ = int((got != want).sum())
    print(f"{CHAIN_FAULTS[fault][0]}: {differ} of {got.numel()} elements "
          f"differ from the plain chain")
    assert differ > 0


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


def _dtd_gemm_kt20(native: bool):
    """A 64 x 640 by 640 x 64 bf16 GEMM in 32^2 tiles (kt = 20: the chain
    kernel) on a fresh card context, with the native engine or the Python
    one: (C, tasks, kernel launches, per-task-lane tasks, device-executed
    tasks)."""
    from parsec_tpu_torch.dsl.dtd import PTDTD_STATS
    if not native:
        mca.set("native_enabled", False)
    mca.set("device_load_balance_allow_cpu", False)
    c = Context(nb_cores=1)
    try:
        rng = np.random.default_rng(20)
        mats = [collection_from_numpy(n, d, 32, 32, dtype=torch.bfloat16)
                for n, d in (("A", rng.standard_normal((64, 640))),
                             ("B", rng.standard_normal((640, 64))),
                             ("C", rng.standard_normal((64, 64))))]
        before, stats = K.gemm_chain.launches, PTDTD_STATS.snapshot()
        tp = DTDTaskpool(c, "gemm20")
        n = insert_gemm_tasks(tp, *mats, batch_k=True)
        lane = len(c._dtd_ntasks)
        _drain(c, tp)
        assert c._dtd_ntasks == {}
        assert PTDTD_STATS.delta(stats)["pools_batch"] == 0
        return (mats[2].to_dense(), n, K.gemm_chain.launches - before, lane,
                _dev(c).executed_tasks)
    finally:
        c.fini()
        mca.params.unset("native_enabled")
        mca.params.unset("device_load_balance_allow_cpu")


def test_dtd_gemm_native_lane_equals_python_engine_on_the_card():
    """Every task of the kt = 20 DAG takes the native per-task lane (the
    batched lane stays off on a card context), the chain kernel runs once
    a tile, and C equals the Python engine's bit for bit."""
    _need_card()
    got, n, launches, lane, executed = _dtd_gemm_kt20(True)
    want, n_py, launches_py, lane_py, _ = _dtd_gemm_kt20(False)
    assert n == n_py == 4 and lane == n and lane_py == 0
    assert launches == launches_py == n == executed
    np.testing.assert_array_equal(got, want)


def test_batched_lane_off_on_a_card_context(gctx):
    """Repeat inserts of one body on a card context stay on the per-task
    lane: each returns its task, and the context arms no batched pool."""
    tp = DTDTaskpool(gctx, "nobatch")
    t = tp.tile_new((4, 4))
    t.data.create_copy(0, torch.zeros(4, 4))

    def inc(x):
        return x + 1.0

    tasks = [tp.insert_task(inc, (t, RW)) for _ in range(8)]
    assert all(task is not None and task.nid >= 0 for task in tasks)
    assert tp._neng is not None and not tp._batch_on
    assert gctx._dtd_batch_pools == 0 and gctx.sched_plane is None
    _drain(gctx, tp)
    assert float(t.data.newest_copy().payload.cpu()[0, 0]) == 8.0


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


# (q shape, kv shape, causal, q_offset, k_offset, rows that see no key).
# Head dims 64 and 128 take the wgmma route in bf16 (128-row q blocks,
# 128-key tiles), 16 and 32 the mma route; the d = 64 cases reach every kind
# of key tile: wholly visible, crossing the diagonal (offsets equal or not,
# sq = sk or not), wholly masked, and the ragged end of k.
FLASH_CASES = [
    ((2, 2, 128, 64), (2, 2, 128, 64), False, 0, 0, 0),
    ((3, 200, 64), (3, 200, 64), True, 0, 0, 0),
    ((6, 64, 32), (6, 192, 32), False, 0, 0, 0),
    ((1, 128, 32), (1, 256, 32), True, 128, 0, 0),
    ((1, 128, 32), (1, 128, 32), True, 0, 128, 128),
    ((1, 64, 32), (1, 64, 32), True, 0, 32, 32),
    ((1, 257, 16), (1, 257, 16), True, 0, 0, 0),
    ((2, 4, 16), (2, 4, 16), False, 0, 0, 0),
    ((2, 130, 128), (2, 130, 128), True, 0, 0, 0),
    # the edge cases again at d = 64, on the wgmma route
    ((6, 64, 64), (6, 192, 64), False, 0, 0, 0),
    ((1, 128, 64), (1, 256, 64), True, 128, 0, 0),
    ((1, 128, 64), (1, 128, 64), True, 0, 128, 128),
    ((1, 64, 64), (1, 64, 64), True, 0, 32, 32),
    ((1, 257, 64), (1, 257, 64), True, 0, 0, 0),
    ((2, 4, 64), (2, 4, 64), False, 0, 0, 0),
    ((3, 1, 64), (3, 1, 64), True, 0, 0, 0),
    ((2, 200, 64), (2, 300, 64), True, 100, 0, 0),
    ((1, 192, 64), (1, 160, 64), True, 40, 72, 32),
    ((2, 512, 64), (2, 512, 64), True, 0, 0, 0),
    # d = 128: causal, and ragged at both ends
    ((2, 256, 128), (2, 256, 128), True, 0, 0, 0),
    ((2, 200, 128), (2, 333, 128), False, 0, 0, 0),
]


def _flash_route_of(dtype, d):
    """The route each case must take: float32 on the SIMT cores, bf16 on
    wgmma at head dims 64 and 128 (every case here is 16-byte aligned),
    else on mma.sync."""
    if dtype == torch.float32:
        return "simt"
    return "wgmma" if d in (64, 128) else "mma"


def _flash_inputs(qs, ks, dtype):
    gen = torch.Generator(device="cuda").manual_seed(sum(qs) + sum(ks))
    return tuple(torch.randn(sh, device="cuda", generator=gen).to(dtype)
                 for sh in (qs, ks, ks))


def _flash_holds(got, q, k, v, kw, masked):
    """float32 within the reference's 2e-4 (FMA, no TF32); bf16 with every
    element within ``flash_attention_bf16_tolerance`` (the rounding of P and
    of the output); rows that see no key exactly zero."""
    want = K.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    if q.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    else:
        tol = K.flash_attention_bf16_tolerance(q, k, v, **kw)
        assert ((got.float() - want.float()).abs() <= tol).all()
    if masked:
        assert (got.reshape(-1, *q.shape[-2:])[:, :masked] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qs,ks,causal,q_off,k_off,masked", FLASH_CASES)
def test_flash_kernel_matches_plain(dtype, qs, ks, causal, q_off, k_off,
                                    masked):
    """Every case against the plain version (:func:`_flash_holds`), counted
    once, on the route its dtype and head dim take."""
    _need_card()
    q, k, v = _flash_inputs(qs, ks, dtype)
    kw = dict(causal=causal, q_offset=q_off, k_offset=k_off)
    with _counted_on(K.flash_attention, _flash_route_of(dtype, qs[-1])):
        got = K.flash_attention(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == q.shape
    _flash_holds(got, q, k, v, kw, masked)


def test_flash_cases_cover_every_route():
    routes = {_flash_route_of(dt, qs[-1]) for qs, *_ in FLASH_CASES
              for dt in (torch.float32, torch.bfloat16)}
    assert routes == set(K.FLASH_ROUTES)


@pytest.mark.parametrize("d", [64, 128])
def test_flash_bf16_on_unaligned_bases_takes_the_mma_route(d):
    """TMA needs 16-byte aligned bases: q, k and v that start 2 bytes into
    their buffers go to the mma route and still agree with the plain
    version."""
    _need_card()
    qs, ks, kw = (2, 200, d), (2, 260, d), dict(causal=True, q_offset=60)
    n = [math.prod(qs), math.prod(ks), math.prod(ks)]
    q, k, v = (torch.randn(m + 1, device="cuda").to(torch.bfloat16)[1:]
               .view(sh) for m, sh in zip(n, (qs, ks, ks)))
    assert q.data_ptr() % 16 and k.data_ptr() % 16
    with _counted_on(K.flash_attention, "mma"):
        got = K.flash_attention(q, k, v, **kw)
    _flash_holds(got, q, k, v, kw, 0)


def test_flash_kernel_refuses_a_route_the_operands_do_not_allow():
    """The C entry point checks the route's preconditions and refuses the
    launch (no silent change of route): wgmma at d = 32, on float32 and on
    an unaligned base; mma on float32; simt on bf16."""
    _need_card()
    lib = K._library("flash_attention")
    st = torch.cuda.current_stream().cuda_stream
    R = K.FLASH_ROUTES

    def launch(x, d, dtype, route):
        out = torch.empty_like(x)
        return lib.flash_attention(x.data_ptr(), x.data_ptr(), x.data_ptr(),
                                   out.data_ptr(), 1, 64, 64, d, 1, 0.125, 0,
                                   0, dtype, route, K._sm_count(x.device), st)
    bf = torch.zeros(64 * 64 + 8, device="cuda", dtype=torch.bfloat16)
    f32 = torch.zeros(64 * 64, device="cuda")
    assert launch(bf, 64, 1, R["wgmma"]) == 0
    torch.cuda.synchronize()
    assert launch(bf, 32, 1, R["wgmma"]) != 0
    assert launch(f32, 64, 0, R["wgmma"]) != 0
    assert launch(bf[1:], 64, 1, R["wgmma"]) != 0
    assert launch(f32, 64, 0, R["mma"]) != 0
    assert launch(bf, 64, 1, R["simt"]) != 0


# planted faults in the wgmma kernel: (name, source text, its replacement)
FLASH_FAULTS = [
    ("skip the last key tile",
     "return kend > 0 ? (kend + W_BK - 1) / W_BK : 0;",
     "return kend > 0 ? (kend + W_BK - 1) / W_BK - 1 : 0;"),
    ("no correction of the accumulator",
     "      o[4 * n + 2 * h] *= corr[h];\n"
     "      o[4 * n + 2 * h + 1] *= corr[h];\n", ""),
    ("drop the last key of every tile",
     "const float p = ex2(",
     "const float p = jj == 15 && t == 3 && e == 1 ? 0.f : ex2("),
    ("a diagonal tile taken as wholly visible",
     "(!causal || k_off + k0 + W_BK - 1 <= q_off + wg_row0)", "true"),
]


@pytest.fixture(scope="module")
def flash_mutants(tmp_path_factory):
    """One library per planted fault, built from a changed copy of the
    kernel's source (all nvcc runs at once)."""
    _need_card()
    with open(os.path.join(K.CSRC_DIR, "flash_attention.cu")) as f:
        src = f.read()
    out = tmp_path_factory.mktemp("flash_mutants")

    def build(i):
        _, old, new = FLASH_FAULTS[i]
        assert src.count(old) == 1
        cu, so = out / f"fault{i}.cu", out / f"fault{i}.so"
        cu.write_text(src.replace(old, new))
        subprocess.run([K.nvcc_path(), *K.NVCC_FLAGS, "-o", str(so), str(cu)],
                       check=True, capture_output=True)
        lib = ctypes.CDLL(str(so))
        K._bind("flash_attention", lib)
        return lib
    with ThreadPoolExecutor(len(FLASH_FAULTS)) as pool:
        return list(pool.map(build, range(len(FLASH_FAULTS))))


@pytest.mark.parametrize("fault", range(len(FLASH_FAULTS)),
                         ids=[f[0] for f in FLASH_FAULTS])
def test_flash_bf16_check_rejects_planted_faults(fault, flash_mutants,
                                                 monkeypatch):
    """The bf16 check of the test above must fail a wgmma kernel with a
    planted fault on the d = 64 cases. Prints, per case on the wgmma route,
    the fault's largest error and whether the bound and the reference's
    looser 0.05 see it (``-s`` shows them)."""
    monkeypatch.setitem(K._libs, "flash_attention", flash_mutants[fault])
    rejected = []
    for qs, ks, causal, q_off, k_off, _ in FLASH_CASES:
        if qs[-1] not in (64, 128):
            continue
        q, k, v = _flash_inputs(qs, ks, torch.bfloat16)
        kw = dict(causal=causal, q_offset=q_off, k_offset=k_off)
        want = K.flash_attention_plain(q, k, v, **kw).float()
        with _counted_on(K.flash_attention, "wgmma"):
            got = K.flash_attention(q, k, v, **kw).float()
        err = (got - want).abs()
        bound = bool((err > K.flash_attention_bf16_tolerance(q, k, v, **kw)
                      ).any())
        loose = bool((err > 0.05 + 0.05 * want.abs()).any())
        print(f"{FLASH_FAULTS[fault][0]}: q {qs} kv {ks} causal={causal} "
              f"offsets ({q_off}, {k_off}): max abs err "
              f"{err.max().item():.3e}; rejected by the bound {bound}, by "
              f"rtol/atol 0.05 {loose}")
        if qs[-1] == 64:
            rejected.append(bound)
    assert any(rejected)


def test_flash_kernel_raises_instead_of_falling_back():
    _need_card()
    q = torch.zeros(2, 64, 64, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        K.flash_attention(q[..., :48].contiguous(), q[..., :48].contiguous(),
                          q[..., :48].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        K.flash_attention(q.transpose(1, 2), q, q)
    with pytest.raises(TypeError):
        K.flash_attention(q.half(), q.half(), q.half())


@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16])
def test_lm_flash_core_matches_dense_on_the_card(compute_dtype):
    """Small LM: the flash core launches once per block and agrees with the
    dense core (logits within 2e-3 in f32); in bf16 the loss lies within 5%
    of f32's, and the logits within rtol/atol 0.05 and a norm-wise 0.02 of
    the f32 flash forward's, which a forward with zeroed attention fails."""
    _need_card()
    cfg = TM.ModelConfig(vocab_size=256, d_model=128, d_ff=512, n_heads=2,
                         n_layers=3, max_seq=128)
    params = TM.params_from_numpy(TM.init_lm_params(5, cfg))
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, 256, (2, 129)).astype(np.int64)
                            ).cuda()
    x, y = toks[:, :-1], toks[:, 1:]
    before = K.flash_attention.launches
    if compute_dtype is None:
        got = TM.lm_apply(params, x, attention=flash_attention_core)
        assert K.flash_attention.launches == before + cfg.n_layers
        want = TM.lm_apply(params, x)
        torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)
    else:
        lbf = TM.lm_loss(params, x, y, attention=flash_attention_core,
                         compute_dtype=compute_dtype)
        assert K.flash_attention.launches == before + cfg.n_layers
        lf = float(TM.lm_loss(params, x, y))
        assert abs(float(lbf) - lf) < 0.05 * max(1.0, lf)
        ref = TM.lm_apply(params, x, attention=flash_attention_core)

        def close(core):
            got = TM.lm_apply(params, x, attention=core,
                              compute_dtype=compute_dtype)
            return (bool(((got - ref).abs() <= 0.05 + 0.05 * ref.abs()).all())
                    and ((got - ref).norm() / ref.norm()).item() <= 0.02)
        assert close(flash_attention_core)
        assert not close(lambda q, k, v, causal, scale: torch.zeros_like(q))


def test_lm_generate_on_the_card_matches_full_recompute():
    _need_card()
    cfg = TM.ModelConfig(vocab_size=64, d_model=64, d_ff=128, n_heads=2,
                         n_layers=2, max_seq=32)
    params = TM.params_from_numpy(TM.init_lm_params(8, cfg))
    prompt = torch.arange(16, device="cuda", dtype=torch.int32).reshape(2, 8)
    out = TM.lm_generate(params, prompt, 10)
    assert out.device.type == "cuda" and tuple(out.shape) == (2, 18)
    logits = TM.lm_apply(params, out)
    for t in range(8, 18):
        row = logits[:, t - 1]
        chosen = row.gather(1, out[:, t:t + 1].long()).squeeze(1)
        assert (row.max(-1).values - chosen <= 1e-3).all()


# --- stencil1d and matmul (the stencil / tile-algorithm slice) -------------

# (rows, cols, left/right halo widths; 0 is a null halo)
STENCIL_SHAPES = [(1, 1, 0, 0), (1, 7, 3, 2), (8, 7, 0, 9), (1, 4096, 4096, 4096),
                  (8, 4096, 0, 0), (8, 4099, 5000, 17), (3, 1000, 1, 1)]


def _stencil_operands(rows, cols, lw, rw, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x, left, right = (torch.randn(rows, max(w, 1), device="cuda",
                                  generator=gen).to(dtype)
                      for w in (cols, lw, rw))
    return x, left if lw else None, right if rw else None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,cols,lw,rw", STENCIL_SHAPES)
def test_stencil1d_kernel_matches_plain_bit_for_bit(dtype, rows, cols, lw, rw):
    """Every product and sum rounded in the plain version's order (no FMA
    contraction): bit for bit, null halos, halo tiles wider and narrower
    than x, ragged widths and unaligned row starts included."""
    _need_card()
    x, left, right = _stencil_operands(rows, cols, lw, rw, dtype, rows + cols)
    for w in ((0.25, 0.5, 0.25), (0.3, 0.45, 0.25)):
        before = K.stencil1d.launches
        got = K.stencil1d(x, left, right, w)
        assert K.stencil1d.launches == before + 1
        assert torch.equal(got, K.stencil1d_plain(x, left, right, w))


def test_stencil1d_kernel_at_the_path_width():
    """(1, 2^24) float32 with both halos, the DTD stencil's tile."""
    _need_card()
    x, left, right = _stencil_operands(1, 1 << 24, 1 << 24, 1 << 24,
                                       torch.float32, 24)
    assert torch.equal(K.stencil1d(x, left, right),
                       K.stencil1d_plain(x, left, right))


@pytest.fixture(scope="module")
def stencil_without_right_halo(tmp_path_factory):
    """The stencil kernel built from a copy of its source in which the
    right halo column is dropped (read as zero)."""
    _need_card()
    with open(os.path.join(K.CSRC_DIR, "stencil1d.cu")) as f:
        src = f.read()
    old = "right != nullptr ? E::get(right[(size_t)r * rcols]) : 0.f"
    assert src.count(old) == 1
    out = tmp_path_factory.mktemp("stencil_fault")
    cu, so = out / "fault.cu", out / "fault.so"
    cu.write_text(src.replace(old, "0.f"))
    subprocess.run([K.nvcc_path(), *K.NVCC_FLAGS, "-o", str(so), str(cu)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    K._bind("stencil1d", lib)
    return lib


def test_stencil1d_check_rejects_a_dropped_halo(stencil_without_right_halo,
                                                monkeypatch):
    """The bit-for-bit check sees a kernel that drops the right halo column:
    it passes where there is no right halo and fails where there is one."""
    monkeypatch.setitem(K._libs, "stencil1d", stencil_without_right_halo)
    for rw, same in ((0, True), (64, False)):
        x, left, right = _stencil_operands(2, 64, 64, rw, torch.float32, 5)
        assert torch.equal(K.stencil1d(x, left, right),
                           K.stencil1d_plain(x, left, right)) == same


def test_stencil1d_kernel_raises_instead_of_falling_back():
    _need_card()
    x = torch.zeros(4, 64, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        K.stencil1d(x[:, ::2], None, None)
    with pytest.raises(TypeError):
        K.stencil1d(x.half(), None, None)
    with pytest.raises(TypeError):
        K.stencil1d(x, x.cpu(), None)


# (m, k, n, block, route on a 132-SM card): few output tiles take the split
# route, 1024^2 (64 tiles) the tile route, a 36-byte bf16 / 72-byte
# float32 row pitch the general route
MATMUL_CASES = [(256, 512, 256, (256, 256, 256), "split"),
                (128, 256, 192, (64, 64, 32), "split"),
                (96, 64, 40, (32, 8, 16), "split"),
                (1024, 1024, 1024, (256, 256, 256), "tile"),
                (64, 128, 18, (64, 64, 64), "general")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,block,route", MATMUL_CASES)
def test_matmul_kernel_matches_plain(dtype, m, k, n, block, route):
    """float32 within rtol/atol 1e-4 with A and B scaled by bk^-1/4 (each
    step's product has unit variance); bf16 with at most 0.1% of elements
    beyond 2 ulps of the running peak (gemm_chain's bound, the same
    per-step rounding); bf16 on small integers bit for bit. Each launch is
    counted once, on the route the shape takes."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(m + k + n)
    bk = min(block[2], k)
    s = bk ** -0.25
    a = (torch.randn(m, k, device="cuda", generator=gen) * s).to(dtype)
    b = (torch.randn(k, n, device="cuda", generator=gen) * s).to(dtype)
    with _counted_on(K.matmul, route):
        got = K.matmul(a, b, block).float()
    want = K.matmul_plain(a, b, block).float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        # the chain's view of the same product: C = 0, k/bk steps
        kt = k // bk
        a_st = a.view(m, kt, bk).permute(1, 0, 2).contiguous()
        b_st = b.view(kt, bk, n)
        tol = K.gemm_chain_bf16_tolerance(torch.zeros(m, n, device="cuda",
                                                      dtype=dtype), a_st, b_st)
        assert ((got - want).abs() > tol).float().mean().item() <= 1e-3
        ai = torch.randint(-16, 17, (m, k), device="cuda", generator=gen
                           ).to(dtype)
        bi = torch.randint(-16, 17, (k, n), device="cuda", generator=gen
                           ).to(dtype)
        assert torch.equal(K.matmul(ai, bi, block),
                           K.matmul_plain(ai, bi, block))


def test_matmul_shapes_on_the_card():
    """100x60 by 60x90 (the reference's odd-shape test): the clipped blocks
    divide it, so it launches the kernel, ragged edges masked; 300x256 by
    256x64 (300 % 256) takes the library route and launches nothing."""
    _need_card()
    a = torch.randn(100, 60, device="cuda")
    b = torch.randn(60, 90, device="cuda")
    before = K.matmul.launches
    torch.testing.assert_close(K.matmul(a, b), a @ b, rtol=1e-4, atol=1e-4)
    assert K.matmul.launches == before + 1
    a = torch.randn(300, 256, device="cuda")
    b = torch.randn(256, 64, device="cuda")
    torch.testing.assert_close(K.matmul(a, b), a @ b, rtol=1e-4, atol=1e-4)
    assert K.matmul.launches == before + 1


def test_dtd_stencil1d_launches_once_per_task_on_the_card(gctx):
    """8 tiles x 5 iterations: 40 launches (boundary tiles included), every
    task on the device, bit for bit the plain whole-row iteration."""
    from parsec_tpu_torch.ops.stencil import insert_stencil1d_tasks
    NT, TS, ITERS = 8, 1000, 5
    x0 = torch.randn(1, NT * TS, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(8))
    A = TiledMatrix("SA", 1, NT * TS, 1, TS, device="cuda")
    B = TiledMatrix("SB", 1, NT * TS, 1, TS, device="cuda")
    A.fill(lambda m, n: x0[:, n * TS:(n + 1) * TS])
    B.fill(lambda m, n: torch.zeros(1, TS))
    torch.cuda.synchronize()
    before = K.stencil1d.launches
    tp = DTDTaskpool(gctx, "stencil")
    n = insert_stencil1d_tasks(tp, A, B, ITERS)
    _drain(gctx, tp)
    assert K.stencil1d.launches - before == n == NT * ITERS
    assert _dev(gctx).executed_tasks == n
    out = B if ITERS % 2 else A
    got = torch.cat([out.data_of(0, i).newest_copy().payload
                     for i in range(NT)], dim=1)
    want = x0
    for _ in range(ITERS):
        want = K.stencil1d_plain(want, None, None)
    assert torch.equal(got, want)


def test_dtd_getrf_and_geqrf_on_the_card(gctx):
    from parsec_tpu_torch.ops.geqrf import insert_geqrf_tasks
    from parsec_tpu_torch.ops.getrf import insert_getrf_tasks, make_dd
    a = make_dd(512, seed=4)
    LU = collection_from_numpy("LU", a, 128, 128)
    tp = DTDTaskpool(gctx, "getrf")
    n_lu = insert_getrf_tasks(tp, LU)
    _drain(gctx, tp)
    packed = LU.to_dense().astype(np.float64)
    Lf = np.tril(packed, -1) + np.eye(512)
    assert np.linalg.norm(Lf @ np.triu(packed) - a) / np.linalg.norm(a) < \
        512 * 2.0 ** -24
    q = np.random.default_rng(4).standard_normal((512, 512)).astype(np.float32)
    QR = collection_from_numpy("QR", q, 128, 128)
    tp = DTDTaskpool(gctx, "geqrf")
    n_qr = insert_geqrf_tasks(tp, QR)
    _drain(gctx, tp)
    R = np.triu(QR.to_dense()).astype(np.float64)
    ata = q.astype(np.float64).T @ q
    assert np.linalg.norm(R.T @ R - ata) / np.linalg.norm(ata) < \
        512 * 2.0 ** -24
    assert _dev(gctx).executed_tasks == n_lu + n_qr


def test_cpu_chore_gets_host_tensors_of_device_written_tiles(gctx):
    """A host-code task (jit=False) reading a tile whose newest version a
    device task wrote gets it as a host tensor, and its output lands in the
    host copy as one; the next device task stages that version back in."""
    A = TiledMatrix("HC", 4, 4, 4, 4)
    A.fill(lambda m, n: np.ones((4, 4), np.float32))
    seen = []

    def host_double(x):
        seen.append(x.device.type)
        return x * 2.0

    tp = DTDTaskpool(gctx, "host-chore")
    t = tp.tile_of(A, 0, 0)
    tp.insert_task(lambda x: x + 1.0, (t, RW))            # on the card
    tp.insert_task(host_double, (t, RW), jit=False)       # on the CPU chore
    tp.insert_task(lambda x: x + 3.0, (t, RW))            # on the card
    _drain(gctx, tp)
    assert seen == ["cpu"]
    assert A.data_of(0, 0).get_copy(0).payload.device.type == "cpu"
    assert np.array_equal(A.to_dense(), np.full((4, 4), 7.0))
    assert _dev(gctx).executed_tasks == 2


# --- the mixed chain form and CUDA graph capture (graph-capture slice) -----

# (kt, m, k, n, route) of the mixed form, bf16 A and B with a float32 C:
# the routes follow A's and B's 2-byte pitches
MIXED_CASES = [(17, 512, 512, 512, "split"), (4, 768, 256, 768, "tile"),
               (5, 64, 64, 20, "general")]


@pytest.mark.parametrize("kt,m,k,n,route", MIXED_CASES)
def test_mixed_chain_matches_plain_on_every_route(kt, m, k, n, route):
    """bf16 A and B with a float32 C through a kernel launch (counted on the
    route), within the float32 tolerance of the other kernel tests (rtol/
    atol 1e-4); on small integers, whose float32 sums are exact in any
    order, bit for bit."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(kt * m)
    s = k ** -0.25
    c = torch.randn(m, n, device="cuda", generator=gen)
    a = (torch.randn(kt, m, k, device="cuda", generator=gen) * s).bfloat16()
    b = (torch.randn(kt, k, n, device="cuda", generator=gen) * s).bfloat16()
    with _counted_on(K.gemm_chain, route):
        got = K.gemm_chain(c, a, b)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, K.gemm_chain_plain(c, a, b), rtol=1e-4,
                               atol=1e-4)
    ci, ai, bi = _integer_chain(kt, m, k, n, kt)
    ci = ci.float()
    assert torch.equal(K.gemm_chain(ci, ai, bi), K.gemm_chain_plain(ci, ai, bi))


def _graph_of(fn, *static):
    """``fn(*static)`` warmed once, then captured into a CUDA graph; returns
    (graph, its static output)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*static)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = fn(*static)
    return g, out


def _replays_hold(fn, make, hold, n=2):
    """Capture ``fn`` on the inputs ``make(0)`` and replay it ``n`` times on
    new inputs ``make(i)`` copied into the static ones, each replay's output
    held by ``hold(out, inputs)``. The launch is counted once (at capture):
    replays do not pass through the wrapper."""
    static = make(0)
    g, out = _graph_of(fn, *static)
    for i in range(1, n + 1):
        new = make(i)
        for s, x in zip(static, new):
            if s is not None:
                s.copy_(x)
        g.replay()
        torch.cuda.synchronize()
        hold(out, new)


def _equal_to(plain):
    def hold(out, inputs):
        assert torch.equal(out, plain(*inputs))
    return hold


def test_gemm_chain_replays_in_a_cuda_graph():
    """bf16 on small integers (bit for bit) on the split and tile routes,
    float32 within rtol/atol 1e-4, the mixed form bit for bit on
    integers."""
    _need_card()
    for kt, m, k, n, _ in (CHAIN_CASES[3], CHAIN_CASES[4]):
        def f32(i):
            gen = torch.Generator(device="cuda").manual_seed(200 + i)
            s = k ** -0.25
            return (torch.randn(m, n, device="cuda", generator=gen),
                    torch.randn(kt, m, k, device="cuda", generator=gen) * s,
                    torch.randn(kt, k, n, device="cuda", generator=gen) * s)

        def f32_holds(out, x):
            torch.testing.assert_close(out, K.gemm_chain_plain(*x),
                                       rtol=1e-4, atol=1e-4)

        def mixed(i):
            c, a, b = _integer_chain(kt, m, k, n, 300 + i)
            return c.float(), a, b
        _replays_hold(K.gemm_chain,
                      lambda i: _integer_chain(kt, m, k, n, 100 + i),
                      _equal_to(K.gemm_chain_plain))
        _replays_hold(K.gemm_chain, f32, f32_holds)
        _replays_hold(K.gemm_chain, mixed, _equal_to(K.gemm_chain_plain))


def test_matmul_replays_in_a_cuda_graph():
    _need_card()
    block = (256, 256, 256)

    def ints(i):
        gen = torch.Generator(device="cuda").manual_seed(400 + i)
        return tuple(torch.randint(-16, 17, sh, device="cuda", generator=gen
                                   ).bfloat16()
                     for sh in ((512, 1024), (1024, 256)))
    _replays_hold(lambda a, b: K.matmul(a, b, block), ints,
                  _equal_to(lambda a, b: K.matmul_plain(a, b, block)))


def test_stencil1d_replays_in_a_cuda_graph():
    _need_card()
    _replays_hold(
        K.stencil1d,
        lambda i: _stencil_operands(8, 4099, 5000, 17, torch.float32, 500 + i),
        _equal_to(K.stencil1d_plain))


def test_flash_attention_replays_in_a_cuda_graph():
    """bf16 on the wgmma route, each element within
    ``flash_attention_bf16_tolerance``; float32 within 2e-4."""
    _need_card()
    kw = dict(causal=True, q_offset=0, k_offset=0)
    for dtype in (torch.bfloat16, torch.float32):
        def inputs(i):
            return tuple((t.float() * (1 + 0.25 * i)).to(dtype)
                         for t in _flash_inputs((2, 512, 64), (2, 512, 64),
                                                dtype))
        _replays_hold(lambda q, k, v: K.flash_attention(q, k, v, causal=True),
                      inputs, lambda out, x: _flash_holds(out, *x, kw, 0))


def _gemm_mats(prefix, a, b, ts, dtype):
    return (collection_from_numpy(prefix + "A", a, ts, ts, dtype=dtype),
            collection_from_numpy(prefix + "B", b, ts, ts, dtype=dtype),
            collection_from_numpy(prefix + "C",
                                  np.zeros((a.shape[0], b.shape[1]),
                                           np.float32), ts, ts, dtype=dtype))


@pytest.mark.parametrize("capture", ["inline", "scan"])
def test_captured_dtd_gemm_is_the_scheduled_one_bit_for_bit(gctx, capture):
    """bf16 GEMM of 17 x 17 tiles of 64^2 (kt = 17: every GEMM_K task runs
    the chain kernel): the captured DAG, first run (warm-up + capture) and
    replayed on other collections of the same shape, equals the scheduled
    DAG bit for bit; the replay launches the chain kernel from the graph."""
    from parsec_tpu_torch.dsl import capture as CAP
    rng = np.random.default_rng(17)
    n, ts = 17 * 64, 64
    a = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, n)).astype(np.float32)
    A, B, C = _gemm_mats("s", a, b, ts, torch.bfloat16)
    tp = DTDTaskpool(gctx, "sched")
    insert_gemm_tasks(tp, A, B, C, batch_k=True)
    _drain(gctx, tp)
    want = C.to_dense()
    try:
        for run in ("first", "replay"):
            mats = _gemm_mats(run, a, b, ts, torch.bfloat16)
            tp = DTDTaskpool(gctx, run, capture=capture)
            insert_gemm_tasks(tp, *mats, batch_k=True)
            before = K.gemm_chain.launches
            _drain(gctx, tp)
            assert tp._capture.last_mode == capture
            assert tp._capture.cache_hit == (run == "replay")
            # the warm-up launches the kernel through the wrapper once a
            # task; the capture records it uncounted, the replay launches
            # it from the graph
            assert K.gemm_chain.launches - before == \
                (17 * 17 if run == "first" else 0)
            np.testing.assert_array_equal(mats[2].to_dense(), want)
    finally:
        CAP._program_cache.clear()


@pytest.mark.parametrize("capture", ["inline", "scan"])
def test_captured_potrf_passes_the_256_gate(gctx, capture):
    """The reference benchmark's POTRF 256 gate (64^2 tiles: max|L L^T - A|
    < 1e-2), on the first (captured) run and on a replay."""
    from parsec_tpu_torch.dsl import capture as CAP
    spd = make_spd(256, seed=11)
    try:
        for run in ("first", "replay"):
            P = collection_from_numpy(f"P{run}", spd, 64, 64)
            tp = DTDTaskpool(gctx, run, capture=capture)
            insert_potrf_tasks(tp, P)
            _drain(gctx, tp)
            assert tp._capture.cache_hit == (run == "replay")
            L = np.tril(P.to_dense())
            assert np.abs(L @ L.T - spd).max() < 1e-2
    finally:
        CAP._program_cache.clear()


@pytest.mark.parametrize("capture", ["inline", "scan"])
def test_captured_stencil_replay_is_the_plain_iteration(gctx, capture):
    """The DTD stencil (16 tiles x 8 iterations, 128 tasks) captured: the
    tiles are filled on the caller's stream behind a busy wait and with no
    synchronize, so the execution must order itself after that stream;
    the first DAG (warm-up + capture) and a second one on refilled tiles
    (a replay of the kept graph) are each the plain whole-row iteration
    bit for bit, and the graph holds one stencil kernel node a task."""
    from parsec_tpu_torch.dsl import capture as CAP
    from parsec_tpu_torch.ops.stencil import insert_stencil1d_tasks
    NT, TS, IT = 16, 4096, 8
    x0 = torch.randn(1, NT * TS, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(9))
    want = x0
    for _ in range(IT):
        want = K.stencil1d_plain(want, None, None)
    A = TiledMatrix("CSA", 1, NT * TS, 1, TS, device="cuda")
    B = TiledMatrix("CSB", 1, NT * TS, 1, TS, device="cuda")
    torch.cuda.synchronize()
    try:
        for run in ("first", "replay"):
            torch.cuda._sleep(50_000_000)           # the caller's stream busy
            A.fill(lambda m, n: x0[:, n * TS:(n + 1) * TS].clone())
            B.fill(lambda m, n: torch.zeros(1, TS, device="cuda"))
            tp = DTDTaskpool(gctx, run, capture=capture)
            assert insert_stencil1d_tasks(tp, A, B, IT) == NT * IT
            _drain(gctx, tp)
            assert tp._capture.last_mode == capture
            assert tp._capture.cache_hit == (run == "replay")
            got = torch.cat([A.data_of(0, i).newest_copy().payload
                             for i in range(NT)], dim=1)
            assert torch.equal(got, want)
        nodes = tp._capture.last_program.kernel_nodes()
        assert sum(n for name, n in nodes.items()
                   if "stencil1d_kernel" in name) == NT * IT
    finally:
        CAP._program_cache.clear()


def test_captured_programs_count_against_the_card_and_go_at_fini():
    """A captured program charges its buffers to its card's tile budget;
    the staged tiles are unpinned after the execution; a card over budget
    evicts its older programs; the context's fini releases the rest."""
    _need_card()
    from parsec_tpu_torch.dsl import capture as CAP
    from parsec_tpu_torch.dsl.fusion import CAPTURE_CACHE_STATS
    CAP._program_cache.clear()
    rng = np.random.default_rng(21)
    ctx = Context(nb_cores=1)
    dev = _dev(ctx)
    try:
        progs = []
        for n in (128, 192):                     # two DAG shapes
            a = rng.standard_normal((n, n)).astype(np.float32)
            mats = _gemm_mats(f"m{n}", a, a, 64, torch.float32)
            tp = DTDTaskpool(ctx, f"m{n}", capture="inline")
            insert_gemm_tasks(tp, *mats, batch_k=True)
            _drain(ctx, tp)
            prog = tp._capture.last_program
            progs.append(prog)
            assert prog.dev is dev and prog.charged >= 3 * n * n * 4
            assert all(mats[k].data_of(i, j).get_copy(dev.device_index)
                       .readers == 0 for k in range(3)
                       for i in range(n // 64) for j in range(n // 64))
            if n == 128:
                assert dev.program_bytes == prog.charged
                dev.set_budget(dev._resident_bytes + dev.program_bytes)
        # the second program put the card over budget: the first went
        assert progs[0].released and not progs[1].released
        assert dev.program_bytes == progs[1].charged
        assert CAPTURE_CACHE_STATS["cache_evictions"] >= 1
    finally:
        ctx.fini()
    assert progs[1].released and dev.program_bytes == 0
    assert not any(getattr(p, "dev", None) is dev
                   for _, p in CAP._program_cache.oldest_first())


def test_captured_pool_reads_what_the_scheduler_wrote_and_back(gctx):
    """A scheduled pool, a captured one and a scheduled one again on the
    same collection (small-integer f32 data, every sum exact): each reads
    the one before, so C = 3 A B exactly; every result lands as the CUDA
    device's copy."""
    from parsec_tpu_torch.dsl import capture as CAP
    rng = np.random.default_rng(3)
    a = rng.integers(-4, 5, (128, 1088)).astype(np.float32)
    b = rng.integers(-4, 5, (1088, 128)).astype(np.float32)
    A, B, C = _gemm_mats("o", a, b, 64, torch.float32)
    dev = _dev(gctx)
    try:
        for capture in (False, "inline", False):
            tp = DTDTaskpool(gctx, "order", capture=capture)
            insert_gemm_tasks(tp, A, B, C, batch_k=True)
            _drain(gctx, tp)
            assert C.data_of(0, 0).newest_copy().device_index == \
                dev.device_index
        np.testing.assert_array_equal(C.to_dense(), 3 * (a @ b))
    finally:
        CAP._program_cache.clear()


def test_decode_graph_gives_the_eager_loop_tokens():
    """Greedy generation with the decode step as one replayed CUDA graph
    gives the eager loop's tokens, on the call that captures the graph and
    on a later call that replays the kept graph for every step (another
    prompt of the same shape); sampling registers its generator with the
    graph and is reproducible from its seed."""
    _need_card()
    cfg = TM.ModelConfig(vocab_size=64, d_model=64, d_ff=128, n_heads=2,
                         n_layers=2, max_seq=48)
    params = TM.params_from_numpy(TM.init_lm_params(8, cfg))
    prompt = torch.arange(16, device="cuda", dtype=torch.int32).reshape(2, 8)
    graph = TM.lm_generate(params, prompt, 20)
    eager = TM._generate(params, prompt, 20, True, 1.0, None, graph=False)
    assert torch.equal(graph, eager)
    kept = len(TM._decode_graphs)
    other = (prompt * 3 + 1) % cfg.vocab_size
    again = TM.lm_generate(params, other, 20)
    assert len(TM._decode_graphs) == kept       # the kept graph replayed
    assert torch.equal(again, TM._generate(params, other, 20, True, 1.0,
                                           None, graph=False))

    def sampled():
        g = torch.Generator(device="cuda").manual_seed(3)
        return TM.lm_generate(params, prompt, 20, greedy=False, generator=g)
    s1, s2 = sampled(), sampled()
    assert torch.equal(s1, s2) and tuple(s1.shape) == (2, 28)
    assert int(s1.min()) >= 0 and int(s1.max()) < cfg.vocab_size


@pytest.mark.parametrize("which", ["getrf", "geqrf"])
def test_captured_lu_and_qr_match_the_scheduler(gctx, which):
    """The LU and QR DAGs (in-tile LU loop, triangular solves, cuSOLVER's
    QR) captured inline at 256 x 256 in 64^2 tiles, first run and replay,
    within rtol/atol 1e-4 of the scheduled DAG (QR's R up to each row's
    sign, which cuSOLVER may pick per call)."""
    from parsec_tpu_torch.dsl import capture as CAP
    from parsec_tpu_torch.ops.geqrf import insert_geqrf_tasks
    from parsec_tpu_torch.ops.getrf import insert_getrf_tasks, make_dd
    insert = insert_getrf_tasks if which == "getrf" else insert_geqrf_tasks
    a = make_dd(256, seed=6) if which == "getrf" else \
        np.random.default_rng(6).standard_normal((256, 256)).astype(np.float32)

    def run(capture, tag):
        M = collection_from_numpy(f"{which}{tag}", a, 64, 64)
        tp = DTDTaskpool(gctx, tag, capture=capture)
        insert(tp, M)
        _drain(gctx, tp)
        out = M.to_dense().astype(np.float64)
        return np.abs(np.triu(out)) if which == "geqrf" else out
    want = run(False, "s")
    try:
        for tag in ("first", "replay"):
            np.testing.assert_allclose(run("inline", tag), want, rtol=1e-4,
                                       atol=1e-4)
    finally:
        CAP._program_cache.clear()
