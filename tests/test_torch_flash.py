"""The port's flash_attention against the reference Pallas kernel.

The same inputs, made with numpy from a seed, go through the reference's
``flash_attention`` (Pallas in interpret mode on the CPU, or its own dense
routing where it takes one) and the port's wrapper, which takes its plain
PyTorch version for CPU tensors. The cases are the reference's own
(tests/test_pallas.py), at its tolerances: 2e-4 for float32, 0.05 for bf16.
The CUDA kernel itself runs only on the card: tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parsec_tpu.ops import pallas_kernels as PK
from parsec_tpu_torch.ops import cuda_kernels as K


def _dense64(q, k, v, causal=False, q_off=0, k_off=0):
    """float64 numpy truth: guarded softmax, fully masked rows give 0."""
    s = np.einsum("bqd,bkd->bqk", q.astype(np.float64),
                  k.astype(np.float64)) / np.sqrt(q.shape[-1])
    if causal:
        qp = q_off + np.arange(q.shape[1])[:, None]
        kp = k_off + np.arange(k.shape[1])[None, :]
        s = np.where(kp <= qp, s, -np.inf)
    m = s.max(axis=-1, keepdims=True)
    p = np.where(np.isfinite(s), np.exp(s - np.where(np.isfinite(m), m, 0)),
                 0.0)
    a = p / np.maximum(p.sum(axis=-1, keepdims=True), 1e-30)
    return np.einsum("bqk,bkd->bqd", a, v.astype(np.float64))


def _qkv(seed, q_shape, kv_shape=None):
    rng = np.random.default_rng(seed)
    kv_shape = kv_shape or q_shape
    return (rng.standard_normal(q_shape).astype(np.float32),
            rng.standard_normal(kv_shape).astype(np.float32),
            rng.standard_normal(kv_shape).astype(np.float32))


def _ring(part):
    """The reference's ring case: S = 256, q shard [128:) against all of k,
    or q shard [:128) against the k block [128:), which it cannot see."""
    q, k, v = _qkv(37, (1, 256, 32))
    if part == "later_shard":
        return (q[:, 128:], k, v), dict(causal=True, q_offset=128,
                                         k_offset=0)
    return (q[:, :128], k[:, 128:], v[:, 128:]), dict(causal=True,
                                                      q_offset=0,
                                                      k_offset=128)


# name -> (inputs, keyword args, dtype, rows that see no key)
CASES = {
    "matches_dense": lambda: (_qkv(34, (2, 128, 64)),
                              dict(block_q=64, block_k=64), "float32", 0),
    "causal": lambda: (_qkv(35, (1, 128, 32)),
                       dict(causal=True, block_q=32, block_k=32),
                       "float32", 0),
    "bhsd_layout_and_rect_kv": lambda: (
        _qkv(36, (2, 3, 64, 32), (2, 3, 192, 32)),
        dict(block_q=32, block_k=64), "float32", 0),
    "ring_later_shard": lambda: (*_ring("later_shard"), "float32", 0),
    "ring_all_masked_block": lambda: (*_ring("all_masked"), "float32", 128),
    "bf16": lambda: (_qkv(38, (1, 64, 64)), dict(block_q=64, block_k=64),
                     "bfloat16", 0),
    "unaligned_offset_masked_rows": lambda: (
        _qkv(40, (1, 64, 32)),
        dict(causal=True, q_offset=0, k_offset=32, block_q=64, block_k=32),
        "float32", 32),
    "prime_seq": lambda: (_qkv(41, (1, 257, 16)), dict(causal=True),
                          "float32", 0),
    "small_seq": lambda: (_qkv(42, (1, 4, 16)), {}, "float32", 0),
    # head dims the card runs on the next built size's instantiation
    "head_dim_80_causal": lambda: (_qkv(43, (2, 96, 80)), dict(causal=True),
                                   "float32", 0),
    "head_dim_80_bf16": lambda: (_qkv(44, (1, 64, 80)), dict(causal=True),
                                 "bfloat16", 0),
    "head_dim_256_ring": lambda: (_qkv(45, (1, 64, 256), (1, 128, 256)),
                                  dict(causal=True, q_offset=64),
                                  "float32", 0),
    "head_dim_1": lambda: (_qkv(46, (1, 40, 1)), dict(causal=True),
                           "float32", 0),
    # past one 256-column step: the card's chunked route
    "head_dim_320_causal": lambda: (_qkv(47, (1, 48, 320), (1, 80, 320)),
                                    dict(causal=True, q_offset=32),
                                    "float32", 0),
    "head_dim_320_bf16": lambda: (_qkv(48, (1, 40, 320)), dict(causal=True),
                                  "bfloat16", 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_attention_matches_pallas(case):
    (q, k, v), kw, dtype, masked_rows = CASES[case]()
    tol = 2e-4 if dtype == "float32" else 0.05
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    ref = PK.flash_attention(jq, jk, jv, **kw)
    assert ref.dtype == jdt
    # the bf16 values both packages see, widened exactly to float32
    q, k, v = (np.array(x, np.float32) for x in (jq, jk, jv))
    tdt = getattr(torch, dtype)
    out = K.flash_attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                            **kw)
    assert out.dtype == tdt and tuple(out.shape) == q.shape
    got = out.float().numpy()
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)
    three = lambda x: x.reshape((-1,) + x.shape[-2:])   # noqa: E731
    truth = _dense64(three(q), three(k), three(v), kw.get("causal", False),
                     kw.get("q_offset", 0), kw.get("k_offset", 0))
    np.testing.assert_allclose(three(got), truth, rtol=tol, atol=tol)
    if dtype == "bfloat16":
        # the bound the card's bf16 kernel is held to also holds the
        # reference (float32 P) against the plain version
        bound = K.flash_attention_bf16_tolerance(
            *(torch.from_numpy(x) for x in (q, k, v)),
            **{n: kw[n] for n in ("causal", "q_offset", "k_offset")
               if n in kw}).numpy()
        assert np.all(np.abs(got - np.asarray(ref, np.float32)) <= bound)
    if masked_rows:
        # rows that see no key are exactly zero (not uniform attention)
        assert np.all(three(got)[:, :masked_rows] == 0.0)
        assert np.all(np.abs(three(np.asarray(ref, np.float32))
                             [:, :masked_rows]) < 1e-6)


def test_flash_attention_cpu_takes_plain_version_without_launch():
    q, k, v = (torch.from_numpy(x) for x in _qkv(5, (2, 2, 16, 16)))
    before = K.flash_attention.launches
    out = K.flash_attention(q, k, v, causal=True)
    assert K.flash_attention.launches == before
    torch.testing.assert_close(
        out, K.flash_attention_plain(q, k, v, causal=True), rtol=0, atol=0)


@pytest.mark.parametrize("block_q,block_k", [(8, 8), (16, 64), (256, 512)])
def test_flash_attention_block_sizes_change_nothing(block_q, block_k):
    q, k, v = (torch.from_numpy(x) for x in _qkv(6, (3, 40, 32), (3, 24, 32)))
    want = K.flash_attention(q, k, v, causal=True, q_offset=8)
    got = K.flash_attention(q, k, v, causal=True, q_offset=8,
                            block_q=block_q, block_k=block_k)
    assert torch.equal(got, want)


def test_flash_attention_scale_and_offsets_match_float64():
    """An explicit scale and offsets on both sides, sk != sq."""
    q, k, v = _qkv(7, (2, 24, 16), (2, 40, 16))
    out = K.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                            causal=True, scale=0.5, q_offset=30,
                            k_offset=12).numpy()
    # _dense64 scales by 1/sqrt(16): q * 2 makes that 0.5
    ref = _dense64(q * 2.0, k, v, causal=True, q_off=30, k_off=12)
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)


def _tiled_bf16(q, k, v, causal, q_off, k_off, fault=None, route="mma"):
    """The card kernel's bf16 arithmetic on ``route``, written out densely:
    q blocks of 64 rows (mma) or 128 (wgmma), each visiting key tiles of as
    many keys up to the last key its last row sees; per tile the online
    softmax in float32, P rounded to bf16 for P·V, l summing the unrounded
    weights. The mma route scores in base e (scores times the scale, exp);
    the wgmma route keeps the scores unscaled and weighs them by
    2^(s·c - m·c), c = scale·log2(e) as one float32 constant, with the
    guard at the row (a row whose max is still NEG takes 0 as reference),
    and masks only the tiles that cross the diagonal or the ragged end of
    k. ``fault`` plants one of the faults the bf16
    check must see, as the card tests plant it in that route's source."""
    qf, kf, vf = q.float(), k.float(), v.float()
    sq, sk, d = q.shape[-2], k.shape[-2], q.shape[-1]
    if route == "mma":
        bq = bk = 64
        s_all = torch.matmul(qf, kf.transpose(1, 2)) / np.sqrt(d)
        exp = torch.exp
    else:
        bq = bk = 128
        c = torch.tensor(np.log2(np.e) / np.sqrt(d), dtype=torch.float32)
        s_all = torch.matmul(qf, kf.transpose(1, 2))
    keep = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        keep = (k_off + torch.arange(sk))[None, :] <= \
            (q_off + torch.arange(sq))[:, None]
    neg = -1e30
    out = torch.zeros(q.shape[0], sq, d)
    for r0 in range(0, sq, bq):
        r1 = min(r0 + bq, sq)
        kend = min(sk, q_off + r1 - k_off) if causal else sk
        starts = list(range(0, max(kend, 0), bk))
        if fault == "skip_last_tile":
            starts = starts[:-1]
        m = torch.full((q.shape[0], r1 - r0, 1), neg)
        l = torch.zeros_like(m)
        o = torch.zeros(q.shape[0], r1 - r0, d)
        for k0 in starts:
            k1 = min(k0 + bk, sk)
            kp = keep[r0:r1, k0:k1]
            if fault == "diagonal_unmasked" and k0 + bk <= sk:
                kp = torch.ones_like(kp)
            last = (torch.arange(k0, k1) % bk == bk - 1)[None, :]
            if fault == "drop_key" and route == "mma":
                kp = kp & ~last
            s = s_all[:, r0:r1, k0:k1].masked_fill(~kp, neg)
            mx = torch.maximum(m, s.amax(-1, keepdim=True))
            if route == "mma":
                corr = exp(m - mx)
                p = torch.where(s > 0.5 * neg, exp(s - mx), 0.0)
            else:
                corr = torch.exp2((m - mx) * c)
                ref = torch.where(mx > 0.5 * neg, mx * c, 0.0)
                p = torch.exp2(s * c - ref)
            if fault == "drop_key" and route == "wgmma":
                p = p.masked_fill(last, 0.0)
            l = l * corr + p.sum(-1, keepdim=True)
            o = (o if fault == "no_correction" else o * corr) + torch.matmul(
                p.bfloat16().float(), vf[:, k0:k1])
            m = mx
        out[:, r0:r1] = o / l.clamp_min(1e-30)
    return out.bfloat16()


# (q shape, kv shape, causal, q_offset, k_offset)
_BOUND_CASES = {
    "causal": ((2, 200, 64), (2, 200, 64), True, 0, 0),
    "q_shorter_than_kv": ((3, 64, 32), (3, 192, 32), False, 0, 0),
    "ring_later_shard": ((1, 128, 32), (1, 256, 32), True, 128, 0),
    "all_masked_block": ((1, 128, 32), (1, 128, 32), True, 0, 128),
    "unaligned_offset": ((1, 64, 32), (1, 64, 32), True, 0, 32),
    "small_seq": ((1, 4, 16), (1, 4, 16), False, 0, 0),
    "head_dim_128_offsets": ((2, 300, 128), (2, 333, 128), True, 100, 60),
    "head_dim_80": ((2, 200, 80), (2, 260, 80), True, 60, 0),
}


def _bound_case(case, fault=None, route="mma"):
    """(kernel arithmetic, plain version, bf16 bound) for a case."""
    qs, ks, causal, q_off, k_off = _BOUND_CASES[case]
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _qkv(9, qs, ks))
    kw = dict(causal=causal, q_offset=q_off, k_offset=k_off)
    return (_tiled_bf16(q, k, v, causal, q_off, k_off, fault, route).float(),
            K.flash_attention_plain(q, k, v, **kw).float(),
            K.flash_attention_bf16_tolerance(q, k, v, **kw))


@pytest.mark.parametrize("case", sorted(_BOUND_CASES))
def test_flash_bf16_tolerance_bounds_the_kernels_rounding(case):
    """Every element of the kernel's bf16 arithmetic lies within the bound
    of the plain version; rows that see no key get a bound of exactly 0."""
    got, want, bound = _bound_case(case)
    assert ((got - want).abs() <= bound).all()
    if case in ("all_masked_block", "unaligned_offset"):
        assert (bound[:, :32] == 0).all() and (got[:, :32] == 0).all()


@pytest.mark.parametrize("case", sorted(_BOUND_CASES))
def test_flash_bf16_tolerance_bounds_the_wgmma_routes_rounding(case):
    """The same on the wgmma route's arithmetic: 128-key tiles, base 2
    with the scale folded into one float32 constant, masking only where a
    tile crosses the diagonal or the end of k."""
    got, want, bound = _bound_case(case, route="wgmma")
    assert ((got - want).abs() <= bound).all()
    if case in ("all_masked_block", "unaligned_offset"):
        assert (bound[:, :32] == 0).all() and (got[:, :32] == 0).all()


@pytest.mark.parametrize("fault", ["skip_last_tile", "no_correction",
                                   "drop_key"])
@pytest.mark.parametrize("case", ["causal", "q_shorter_than_kv"])
def test_flash_bf16_tolerance_sees_planted_faults(case, fault):
    got, want, bound = _bound_case(case, fault)
    assert ((got - want).abs() > bound).any()


@pytest.mark.parametrize("fault", ["skip_last_tile", "no_correction",
                                   "drop_key", "diagonal_unmasked"])
@pytest.mark.parametrize("case", ["causal", "ring_later_shard",
                                  "head_dim_128_offsets"])
def test_flash_bf16_tolerance_sees_planted_faults_on_the_wgmma_route(case,
                                                                     fault):
    got, want, bound = _bound_case(case, fault, route="wgmma")
    assert ((got - want).abs() > bound).any()


@pytest.mark.parametrize("case", ["kv_shapes", "head_dims", "batch",
                                  "dtype_mix", "float64", "empty_seq",
                                  "rank"])
def test_flash_attention_rejects_what_it_does_not_take(case):
    q, k, v = (torch.from_numpy(x) for x in _qkv(8, (2, 8, 16)))
    args, exc = {
        "kv_shapes": ((q, k, v[:, :4]), ValueError),
        "head_dims": ((q, k[..., :8], v[..., :8]), ValueError),
        "batch": ((q, k[:1], v[:1]), ValueError),
        "dtype_mix": ((q, k.bfloat16(), v), TypeError),
        "float64": ((q.double(), k.double(), v.double()), TypeError),
        "empty_seq": ((q[:, :0], k, v), ValueError),
        "rank": ((q[0, 0], k, v), ValueError),
    }[case]
    with pytest.raises(exc):
        K.flash_attention(*args)
