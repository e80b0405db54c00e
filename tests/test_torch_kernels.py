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


# --- the chain's routes and the split's two phases -------------------------

# (kt, m, k, n, lda, a_step, element size, aligned, SMs) -> route
ROUTE_CASES = [
    ((32, 512, 512, 512, 512, 512 * 512, 2, True, 132), "split"),  # DTD GEMM
    ((32, 512, 512, 512, 512, 512 * 512, 4, True, 132), "split"),
    ((1, 512, 512, 512, 512, 512 * 512, 2, True, 132), "tile"),    # one step
    ((4, 768, 256, 768, 256, 768 * 256, 2, True, 132), "tile"),    # 36 tiles
    ((32, 8192, 256, 8192, 8192, 256, 2, True, 132), "tile"),      # matmul
    ((4, 1024, 256, 1024, 1024, 256, 2, True, 132), "tile"),       # 64 tiles
    ((32, 512, 512, 512, 512, 512 * 512, 2, True, 16), "tile"),    # 16 SMs
    ((5, 64, 64, 20, 64, 64 * 64, 2, True, 132), "general"),       # 40 B
    ((5, 64, 64, 20, 64, 64 * 64, 4, True, 132), "split"),         # 80 B
    ((4, 96, 12, 40, 48, 12, 2, True, 132), "general"),            # 24 B step
    ((4, 96, 16, 40, 64, 16, 2, True, 132), "split"),              # 32 B step
    ((32, 512, 512, 512, 512, 512 * 512, 2, False, 132), "general"),
]


@pytest.mark.parametrize("args,route", ROUTE_CASES)
def test_chain_route_is_a_function_of_the_shapes(args, route):
    assert K.chain_route(*args) == route


def split_chain_model(c, a_stack, b_stack, tile=128, order=None):
    """A plain model of the split route. Phase 1: every (output tile, step)
    unit sums its product in float32 and rounds it to C's dtype into a
    scratch tensor (kt, m, n). Phase 2: from C, add the kt products in step
    order (or in ``order``), in C's dtype."""
    kt, m, _ = a_stack.shape
    n = b_stack.shape[2]
    scratch = torch.empty(kt, m, n, dtype=c.dtype)
    for s in range(kt):
        for r0 in range(0, m, tile):
            for c0 in range(0, n, tile):
                scratch[s, r0:r0 + tile, c0:c0 + tile] = torch.matmul(
                    a_stack[s, r0:r0 + tile].float(),
                    b_stack[s, :, c0:c0 + tile].float()).to(c.dtype)
    out = c
    for s in (range(kt) if order is None else order):
        out = out + scratch[s]
    return out


def _chain_operands(kt, m, k, n, seed, integers):
    rng = np.random.default_rng(seed)
    if integers:
        c = rng.integers(-8, 9, (m, n)).astype(np.float32)
        a = rng.integers(-4, 5, (kt, m, k)).astype(np.float32)
        b = rng.integers(-4, 5, (kt, k, n)).astype(np.float32)
    else:
        c, a, b = _inputs(kt, m, k, n, seed)
    return c, a, b


@pytest.mark.parametrize("integers", [True, False], ids=["integers", "random"])
@pytest.mark.parametrize("kt,m,k,n", SHAPES + [(17, 64, 128, 48)])
def test_split_model_equals_plain_bit_for_bit(kt, m, k, n, integers):
    """The two phases compute the chain's function to the bit: rounded step
    products summed from C in step order are the plain chain, on bf16
    integer and random data, with units of 16 x 16 output tiles."""
    c, a, b = (torch.from_numpy(x).to(torch.bfloat16) for x in
               _chain_operands(kt, m, k, n, kt + m + k + n, integers))
    assert torch.equal(split_chain_model(c, a, b, tile=16),
                       K.gemm_chain_plain(c, a, b))


@pytest.mark.parametrize("kt,m,k,n", SHAPES)
def test_split_model_matches_pallas(kt, m, k, n):
    """The split's model against the reference kernel in interpret mode, at
    the tolerances of the tests above: float32 within rtol/atol 1e-4, bf16
    within 2 ulps of the running peak, integers bit for bit."""
    c, a, b = _inputs(kt, m, k, n, seed=kt * 100 + m + n + 2)
    got = split_chain_model(*(torch.from_numpy(x) for x in (c, a, b)),
                            tile=16).numpy()
    np.testing.assert_allclose(got, _reference(c, a, b), rtol=1e-4,
                               atol=1e-4)
    t = [torch.from_numpy(x).to(torch.bfloat16) for x in (c, a, b)]
    got = split_chain_model(*t, tile=16).float().numpy()
    tol = K.gemm_chain_bf16_tolerance(*t).numpy()
    assert (np.abs(got - _reference(c, a, b, jnp.bfloat16)) <= tol).all()
    c, a, b = _chain_operands(kt, m, k, n, kt + m, integers=True)
    t = [torch.from_numpy(x).to(torch.bfloat16) for x in (c, a, b)]
    np.testing.assert_array_equal(
        split_chain_model(*t, tile=16).float().numpy(),
        _reference(c, a, b, jnp.bfloat16))


@pytest.mark.parametrize("order", ["reversed", "pairwise"])
def test_split_phase_two_order_is_the_function(order):
    """On integer data whose running sums pass 256 (where bf16 stops holding
    every integer), phase 2 in another order than the steps' gives other
    bits: the order is part of the function, and the bit-exact check sees
    it."""
    kt, m, k, n = 32, 32, 64, 32
    c, a, b = (torch.from_numpy(x).to(torch.bfloat16) for x in
               _chain_operands(kt, m, k, n, 9, integers=True))
    want = K.gemm_chain_plain(c, a, b)
    assert torch.equal(split_chain_model(c, a, b, tile=16), want)
    if order == "reversed":
        got = split_chain_model(c, a, b, tile=16, order=range(kt - 1, -1, -1))
    else:
        got = split_chain_model(c, a, b, tile=16,
                                order=list(range(0, kt, 2))
                                + list(range(1, kt, 2)))
    assert not torch.equal(got, want)


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


# --- flash_attention's routes ----------------------------------------------

# (dtype, head dim, 16-byte aligned bases) -> route, for every class
FLASH_ROUTE_CASES = [
    *(((torch.float32, d, a), "simt")
      for d in (1, 8, 16, 32, 48, 64, 80, 96, 128, 200, 256)
      for a in (True, False)),
    *(((torch.bfloat16, d, True), "wgmma") for d in (40, 48, 64, 80, 96,
                                                     120, 128)),
    *(((torch.bfloat16, d, False), "mma") for d in (48, 64, 80, 96, 128)),
    # off the wgmma route: d <= 32 and rows that are not a 16-byte multiple
    # (d % 8 != 0: 129 and 130 past 128 as well), up to 256 on mma.sync
    *(((torch.bfloat16, d, a), "mma") for d in (1, 8, 16, 32, 33, 44, 81,
                                                 129, 130, 250)
      for a in (True, False)),
    # past 128 the wgmma kernel built at 256 (TMA zero-fills the columns
    # past d), on aligned bases only
    *(((torch.bfloat16, d, True), "wgmma") for d in (136, 144, 200, 248,
                                                     256)),
    *(((torch.bfloat16, d, False), "mma") for d in (136, 200, 256)),
    # past one 256-column step, either dtype, ragged or not
    *(((dt, d, a), "chunked") for dt in (torch.float32, torch.bfloat16)
      for d in (257, 320, 512, 1000, 1001, 1100) for a in (True, False)),
]


@pytest.mark.parametrize("args,route", FLASH_ROUTE_CASES)
def test_flash_route_is_a_function_of_dtype_head_dim_and_alignment(args,
                                                                   route):
    assert K.flash_route(*args) == route


# --- the build ---------------------------------------------------------------

def test_library_path_covers_the_headers_a_source_includes(tmp_path,
                                                           monkeypatch):
    """An edit to a header that a source includes, directly or through
    another header, moves the source's library to a new path (so a stale
    library is never loaded); an edit to a file it does not include does
    not."""
    monkeypatch.setattr(K, "CSRC_DIR", str(tmp_path))
    (tmp_path / "k.cu").write_text('#include <stdint.h>\n#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "c.cuh").write_text("// c\n")
    first = K.library_path("k")
    (tmp_path / "c.cuh").write_text("// c, edited\n")
    assert K.library_path("k") == first
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    second = K.library_path("k")
    assert second != first
    (tmp_path / "a.cuh").write_text('#pragma once\n #include "b.cuh" \n')
    assert K.library_path("k") not in (first, second)


@pytest.mark.parametrize("name", ["gemm_chain", "flash_attention"])
def test_hopper_sources_share_the_hopper_header(name):
    paths = K._sources(f"{K.CSRC_DIR}/{name}.cu")
    assert [p.rsplit("/", 1)[-1] for p in paths] == [f"{name}.cu",
                                                     "hopper.cuh"]


# --- stencil1d -------------------------------------------------------------

def _stencil_reference(x, left, right, weights, dtype):
    """The reference kernel in interpret mode (pallas_strict: no silent
    XLA fallback). It takes zero tiles where the port takes ``None``."""
    from parsec_tpu.utils import mca as ref_mca
    z = np.zeros_like(x[:, :1])
    left = z if left is None else left
    right = z if right is None else right
    ref_mca.set("pallas_strict", True)
    try:
        out = PK.stencil1d(*(jnp.asarray(v, dtype) for v in (x, left, right)),
                           weights)
    finally:
        ref_mca.params.unset("pallas_strict")
    return np.asarray(out.astype(jnp.float32))


def _stencil_inputs(rows, cols, halos, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, cols)).astype(np.float32)
    if not halos:
        return x, None, None
    return (x, rng.standard_normal((rows, cols)).astype(np.float32),
            rng.standard_normal((rows, cols)).astype(np.float32))


def _stencil_port(x, left, right, weights, dtype):
    t = [None if v is None else torch.from_numpy(v).to(dtype)
         for v in (x, left, right)]
    return K.stencil1d(*t, weights).float().numpy()


STENCIL_CASES = [(1, 64, False), (1, 32, True), (8, 256, False),
                 (8, 256, True), (1, 1, True), (3, 7, False)]
STENCIL_WEIGHTS = [(0.25, 0.5, 0.25), (0.3, 0.45, 0.25)]


@pytest.mark.parametrize("weights", STENCIL_WEIGHTS)
@pytest.mark.parametrize("rows,cols,halos", STENCIL_CASES)
def test_stencil1d_bf16_bit_exact_against_pallas(rows, cols, halos, weights):
    """bf16: the reference rounds its weakly typed weights to bf16 and every
    product and sum to bf16; the port rounds the same values in the same
    order, so the two agree bit for bit."""
    x, left, right = _stencil_inputs(rows, cols, halos, rows + cols)
    np.testing.assert_array_equal(
        _stencil_port(x, left, right, weights, torch.bfloat16),
        _stencil_reference(x, left, right, weights, jnp.bfloat16))


@pytest.mark.parametrize("weights", STENCIL_WEIGHTS)
@pytest.mark.parametrize("rows,cols,halos", STENCIL_CASES)
def test_stencil1d_f32_matches_pallas(rows, cols, halos, weights):
    """float32 within 4 ulps of sum |w_i x_i| per element: the compiled
    interpret-mode kernel may fuse a product into a sum (one rounding fewer
    than the port's op-by-op order), about 1 ulp of that sum."""
    x, left, right = _stencil_inputs(rows, cols, halos, 2 * rows + cols)
    got = _stencil_port(x, left, right, weights, torch.float32)
    want = _stencil_reference(x, left, right, weights, jnp.float32)
    z = np.zeros((rows, 1), np.float32)
    lcol = z if left is None else left[:, -1:]
    rcol = z if right is None else right[:, :1]
    xm = np.concatenate([lcol, x[:, :-1]], axis=1)
    xp = np.concatenate([x[:, 1:], rcol], axis=1)
    w0, w1, w2 = weights
    mag = np.abs(w0 * xm) + np.abs(w1 * x) + np.abs(w2 * xp)
    assert (np.abs(got - want) <= 4 * np.spacing(mag.astype(np.float32))).all()


def test_stencil1d_reference_cases():
    """tests/test_pallas.py's two stencil cases, at their tolerance 1e-5."""
    from parsec_tpu_torch.ops.stencil import reference_stencil1d
    rng = np.random.default_rng(33)
    x = rng.standard_normal((1, 64)).astype(np.float32)
    out = K.stencil1d(torch.from_numpy(x), None, None).numpy()
    np.testing.assert_allclose(out, reference_stencil1d(x, 1), rtol=1e-5,
                               atol=1e-5)
    rng = np.random.default_rng(34)
    x, l, r = (rng.standard_normal((1, 32)).astype(np.float32)
               for _ in range(3))
    out = K.stencil1d(*(torch.from_numpy(v) for v in (x, l, r))).numpy()
    xm = np.concatenate([l[:, -1:], x[:, :-1]], axis=1)
    xp = np.concatenate([x[:, 1:], r[:, :1]], axis=1)
    np.testing.assert_allclose(out, 0.25 * xm + 0.5 * x + 0.25 * xp,
                               rtol=1e-5, atol=1e-5)


def test_stencil1d_takes_halo_edges_of_wider_and_narrower_tiles():
    """The halo columns are left[:, -1] and right[:, 0] whatever the
    neighbours' widths."""
    x = torch.arange(12.0).reshape(2, 6)
    left = torch.full((2, 9), 100.0)
    left[:, -1] = torch.tensor([7.0, 8.0])
    right = torch.tensor([[50.0, 1.0], [60.0, 2.0]])
    out = K.stencil1d(x, left, right, (1.0, 0.0, 0.0))
    assert out[:, 0].tolist() == [7.0, 8.0]
    out = K.stencil1d(x, left, right, (0.0, 0.0, 1.0))
    assert out[:, -1].tolist() == [50.0, 60.0]


def test_stencil1d_cpu_takes_plain_version_without_launch():
    x, l, r = (torch.from_numpy(v) for v in _stencil_inputs(2, 16, True, 1))
    before = K.stencil1d.launches
    out = K.stencil1d(x, l, r)
    assert K.stencil1d.launches == before
    assert torch.equal(out, K.stencil1d_plain(x, l, r))


@pytest.mark.parametrize("case", ["rank", "rows", "dtype", "halo dtype",
                                  "empty"])
def test_stencil1d_rejects_what_the_kernel_does_not_take(case):
    x = torch.zeros(2, 8)
    args, exc = {
        "rank": ((x[0], None, None), ValueError),
        "rows": ((x, torch.zeros(3, 8), None), ValueError),
        "dtype": ((x.double(), None, None), TypeError),
        "halo dtype": ((x, None, torch.zeros(2, 8).bfloat16()), TypeError),
        "empty": ((x[:, :0], None, None), ValueError),
    }[case]
    with pytest.raises(exc):
        K.stencil1d(*args)


# --- blocked matmul --------------------------------------------------------

def _matmul_reference(a, b, block, dtype=jnp.float32):
    from parsec_tpu.utils import mca as ref_mca
    ref_mca.set("pallas_strict", True)
    try:
        out = PK.matmul(jnp.asarray(a, dtype), jnp.asarray(b, dtype),
                        block=block)
    finally:
        ref_mca.params.unset("pallas_strict")
    return np.asarray(out.astype(jnp.float32))


def test_blocked_matmul():
    """tests/test_pallas.py's case: 128x64 by 64x128 in (64, 64, 32) blocks,
    rtol/atol 1e-4 against numpy and against the reference kernel."""
    rng = np.random.default_rng(31)
    a = rng.standard_normal((128, 64)).astype(np.float32)
    b = rng.standard_normal((64, 128)).astype(np.float32)
    out = K.matmul(torch.from_numpy(a), torch.from_numpy(b),
                   block=(64, 64, 32)).numpy()
    np.testing.assert_allclose(out, a @ b, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out, _matmul_reference(a, b, (64, 64, 32)),
                               rtol=1e-4, atol=1e-4)


def test_blocked_matmul_odd_shapes():
    """tests/test_pallas.py's odd shapes, 100x60 by 60x90 with the default
    blocks: clipped to the shape, the blocks divide it (one block), so the
    kernel's semantics apply, as in the reference; rtol/atol 1e-4 against
    numpy and the reference kernel."""
    rng = np.random.default_rng(32)
    a = rng.standard_normal((100, 60)).astype(np.float32)
    b = rng.standard_normal((60, 90)).astype(np.float32)
    out = K.matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(out, a @ b, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out, _matmul_reference(a, b, (256, 256, 256)),
                               rtol=1e-4, atol=1e-4)


def test_blocked_matmul_non_dividing_shapes_take_the_library_route():
    """Shapes the clipped blocks do not divide (300 % 256) take one float32
    torch.matmul and a single rounding, the reference's jnp.dot route: a
    bf16 product on small integers equals the once-rounded exact product."""
    rng = np.random.default_rng(33)
    a = rng.integers(-16, 17, (300, 512)).astype(np.float32)
    b = rng.integers(-16, 17, (512, 64)).astype(np.float32)
    got = K.matmul(torch.from_numpy(a).bfloat16(),
                   torch.from_numpy(b).bfloat16()).float().numpy()
    np.testing.assert_array_equal(
        got, torch.from_numpy(a @ b).bfloat16().float().numpy())
    np.testing.assert_array_equal(
        got, _matmul_reference(a, b, (256, 256, 256), jnp.bfloat16))


@pytest.mark.parametrize("block", [(64, 64, 32), (256, 256, 256),
                                   (32, 64, 16)])
def test_blocked_matmul_bf16_rounds_every_k_block(block):
    """bf16 on small integers (every float32 partial sum exact in any
    order): the output accumulates in bf16, one rounding per bk block, bit
    for bit as the reference kernel does it, and visibly apart from a
    single rounding of the whole product."""
    rng = np.random.default_rng(sum(block))
    a = rng.integers(-16, 17, (128, 512)).astype(np.float32)
    b = rng.integers(-16, 17, (512, 128)).astype(np.float32)
    got = K.matmul(torch.from_numpy(a).bfloat16(),
                   torch.from_numpy(b).bfloat16(), block=block).float().numpy()
    np.testing.assert_array_equal(
        got, _matmul_reference(a, b, block, jnp.bfloat16))
    once = torch.from_numpy(a @ b).bfloat16().float().numpy()
    assert (got != once).any()


def test_matmul_cpu_takes_plain_version_without_launch():
    a, b = torch.randn(64, 32), torch.randn(32, 48)
    before = K.matmul.launches
    out = K.matmul(a, b, block=(32, 16, 8))
    assert K.matmul.launches == before
    assert torch.equal(out, K.matmul_plain(a, b, block=(32, 16, 8)))


@pytest.mark.parametrize("case", ["shape", "dtype", "rank"])
def test_matmul_rejects_what_the_kernel_does_not_take(case):
    a, b = torch.zeros(16, 8), torch.zeros(8, 16)
    args, exc = {
        "shape": ((a, b[:4]), ValueError),
        "dtype": ((a.double(), b.double()), TypeError),
        "rank": ((a[0], b), ValueError),
    }[case]
    with pytest.raises(exc):
        K.matmul(*args)
