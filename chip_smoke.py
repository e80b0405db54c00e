#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``parsec_tpu_torch``) on one card.

    python3 chip_smoke.py

Builds the hand-written kernels from ``parsec_tpu_torch/csrc`` with nvcc (one
nvcc per source, all started together), holds each against its plain
PyTorch version, then drives the port's main paths through the entry points
a user calls:

* the DTD tiled GEMM (bf16, N = 16384 in 512 x 512 tiles, so every GEMM_K
  task runs the ``gemm_chain`` kernel over a k-chain of 32) and the DTD tiled
  Cholesky (f32, N = 8192 in 256 x 256 tiles), with the 256-size
  correctness gates of the reference benchmark;
* the LM serving path at GPT-2 small's published widths (vocab 50257,
  d_model 768, 12 heads, d_ff 3072, 12 layers, max_seq 1024; random weights
  from a seed): a prefill/scoring forward of 8 x 1024 tokens through the
  ``flash_attention`` kernel (f32 against the dense core, then bf16 timed
  and its logits held to the f32 ones), and KV-cached greedy generation of
  64 tokens for 4 and for 32 prompts of 128 (the eager decode loop's step
  time at two batch sizes).

Every phase that fails ends the run with a nonzero exit code.

Output: one line per measurement, then the card's name and power limit as
nvidia-smi gives them, then ``{"kernels": [...]}`` (one entry per ported
kernel: launches on the main path, error against the plain version, times
and bound), and last ``{"ok": true, "device": {...}}``.

Needs one CUDA card; exits nonzero without one.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

GEMM_N, GEMM_TS = 16384, 512         # kt = 32: every GEMM_K task hits the kernel
POTRF_N, POTRF_TS = GEMM_N // 2, GEMM_TS // 2
REPS = 2

# GPT-2 small (openai-community/gpt2 config.json: n_embd 768, n_head 12,
# n_layer 12, n_positions 1024, vocab 50257; n_inner null = 4 * n_embd)
GPT2_SMALL = dict(vocab_size=50257, d_model=768, d_ff=3072, n_heads=12,
                  n_layers=12, max_seq=1024)
LM_BATCH, LM_SEQ = 8, 1024                 # prefill / scoring batch
GEN_BATCHES, GEN_PROMPT, GEN_TOKENS = (4, 32), 128, 64
# bf16 logits against f32: every element within rtol/atol LOGIT_TOL, and
# the norm-wise relative error within LOGIT_NORM_TOL; a forward with zeroed
# attention must fail both
LOGIT_TOL, LOGIT_NORM_TOL = 0.05, 0.02


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


PROFILE_WINDOW = "chip_smoke::window"


def device_profile(torch, run) -> tuple:
    """One ``run()`` under torch.profiler: (busy, window, by_name). ``busy``
    is the device's busy time (the union of its kernel and copy intervals,
    so overlapping and nested events count once), ``window`` the run's wall
    time on the trace's own clock (from its start to the end of the
    synchronize after it), both in ms; ``by_name`` is device ms by kernel
    name. (0.0, 0.0, {}) when the trace holds no device events. Raises when
    busy exceeds the window: the measurement would be at fault."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(PROFILE_WINDOW):
            run()
            torch.cuda.synchronize()
    spans, by_name, window = [], {}, 0.0
    for ev in prof.events():
        t0, t1 = ev.time_range.start, ev.time_range.end
        if ev.name == PROFILE_WINDOW:
            # the host range, and its annotation on the device's rows
            if ev.device_type != DeviceType.CUDA:
                window = (t1 - t0) / 1e3
            continue
        if ev.device_type != DeviceType.CUDA:
            continue
        spans.append((t0, t1))
        by_name[ev.name] = by_name.get(ev.name, 0.0) + (t1 - t0) / 1e3
    busy_us, reach = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        busy_us += max(0.0, t1 - max(t0, reach))
        reach = max(reach, t1)
    if not spans:
        return 0.0, 0.0, {}
    if busy_us / 1e3 > window:
        raise AssertionError(f"device busy {busy_us / 1e3:.3f} ms exceeds the "
                             f"profiled window {window:.3f} ms")
    return busy_us / 1e3, window, by_name


def idle_line(what: str, busy_ms: float, window_ms: float) -> str:
    if not busy_ms:
        return f"{what} under torch.profiler: device busy not measured (no " \
               "device events in the trace)"
    return (f"{what} under torch.profiler: device busy {busy_ms:.3f} ms of "
            f"the profiled run's {window_ms:.3f} ms -> idle share "
            f"{1.0 - busy_ms / window_ms:.4f}")


def slope(run, lo: int = 1, hi: int = 3) -> tuple:
    """Seconds per DAG from the slope of hi vs lo DAGs in one pool (fixed
    costs cancel); returns (slope, t_lo, t_hi)."""
    t_lo = min(run(lo) for _ in range(REPS))
    t_hi = min(run(hi) for _ in range(REPS))
    return (t_hi - t_lo) / (hi - lo), t_lo, t_hi


def check_gemm_chain(K, torch, dtype, kt, m, k, n, gen) -> float:
    """Kernel vs plain on the card; returns the max abs error or raises.

    float32: unit-normal C, A and B scaled by k**-0.25 each (every step's
    product has unit variance, so C stays at unit scale), within rtol and
    atol 1e-4 (the reference's own gemm_chain test).

    bf16, twice. First on small integers, where every float32 partial sum
    is exact in any order: the per-step rounding is then deterministic and
    kernel and plain must agree bit for bit. Then on unit-normal data, where
    the two sum each step in different orders: a step's bf16 rounding may
    then land one ulp apart, and the running C carries such a gap on as a
    random walk, so at most 0.1% of the elements may lie beyond 2 bf16 ulps
    of the largest |C| their chain passed through."""
    name = str(dtype).replace("torch.", "")
    s = k ** -0.25
    c = torch.randn(m, n, device="cuda", generator=gen).to(dtype)
    a = (torch.randn(kt, m, k, device="cuda", generator=gen) * s).to(dtype)
    b = (torch.randn(kt, k, n, device="cuda", generator=gen) * s).to(dtype)
    err = (K.gemm_chain(c, a, b).float()
           - K.gemm_chain_plain(c, a, b).float()).abs()
    if dtype == torch.float32:
        want = K.gemm_chain_plain(c, a, b).float()
        bad = int((err > 1e-4 + 1e-4 * want.abs()).sum())
        ok = bad == 0
    else:
        bad = int((err > K.gemm_chain_bf16_tolerance(c, a, b)).sum())
        ok = bad <= 1e-3 * err.numel()
        ints = [torch.randint(lo, hi, shape, device="cuda", generator=gen
                              ).to(dtype)
                for lo, hi, shape in ((-8, 9, (m, n)), (-4, 5, (kt, m, k)),
                                      (-4, 5, (kt, k, n)))]
        exact = torch.equal(K.gemm_chain(*ints), K.gemm_chain_plain(*ints))
        ok = ok and exact
        log(f"kernel check gemm_chain {name} kt={kt} C {m}x{n} k={k}, "
            f"integer data: {'bit-exact' if exact else 'DIFFERS'}")
    torch.cuda.synchronize()
    log(f"kernel check gemm_chain {name} kt={kt} C {m}x{n} k={k}: "
        f"max abs err {err.max().item():.3e}, {bad} of {err.numel()} "
        f"elements beyond tolerance")
    if not ok:
        raise AssertionError(f"gemm_chain {name} kt={kt} ({m},{k},{n}) "
                             f"disagrees with its plain version")
    return err.max().item()


# (q shape, kv shape, causal, q_offset, k_offset, rows that see no key)
FLASH_CASES = {
    "non-causal": ((2, 128, 64), (2, 128, 64), False, 0, 0, 0),
    "causal LM shape": ((96, 1024, 64), (96, 1024, 64), True, 0, 0, 0),
    "q shorter than kv": ((6, 64, 32), (6, 192, 32), False, 0, 0, 0),
    "ring offset": ((1, 128, 32), (1, 256, 32), True, 128, 0, 0),
    "all-masked block": ((1, 128, 32), (1, 128, 32), True, 0, 128, 128),
    "unaligned offset": ((1, 64, 32), (1, 64, 32), True, 0, 32, 32),
    "S=257 causal": ((1, 257, 16), (1, 257, 16), True, 0, 0, 0),
    "S=4": ((1, 4, 16), (1, 4, 16), False, 0, 0, 0),
    "head_dim 128": ((4, 256, 128), (4, 256, 128), True, 0, 0, 0),
}


def check_flash(K, torch, gen) -> None:
    """Kernel vs plain on the card for every case: float32 within rtol/atol
    2e-4 (the reference's own flash tolerance); bf16 with every element
    within ``flash_attention_bf16_tolerance`` (the rounding of P and of the
    output, about 4e-3 of the weighted |v| plus 8e-3 of |out|); rows that
    see no key exactly 0."""
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        for case, (qs, ks, causal, q_off, k_off, masked) in \
                FLASH_CASES.items():
            q, k, v = (torch.randn(sh, device="cuda", generator=gen
                                   ).to(dtype) for sh in (qs, ks, ks))
            kw = dict(causal=causal, q_offset=q_off, k_offset=k_off)
            got = K.flash_attention(q, k, v, **kw).float()
            want = K.flash_attention_plain(q, k, v, **kw).float()
            err = (got - want).abs()
            if dtype == torch.float32:
                tol = 2e-4 + 2e-4 * want.abs()
            else:
                tol = K.flash_attention_bf16_tolerance(q, k, v, **kw)
            bad = int((err > tol).sum())
            worst = (err / tol).nan_to_num(0.0, posinf=float("inf")
                                           ).max().item()
            zero = bool((got[:, :masked] == 0).all()) if masked else True
            log(f"kernel check flash_attention {name} {case} q {qs} kv {ks}"
                f" causal={causal} offsets ({q_off}, {k_off}): max abs err "
                f"{err.max().item():.3e}, max err/tolerance {worst:.3f}, "
                f"{bad} beyond"
                + (f", first {masked} rows exactly 0: {zero}" if masked
                   else ""))
            if bad or not zero:
                raise AssertionError(f"flash_attention {name} {case} "
                                     f"disagrees with its plain version")
    torch.cuda.synchronize()


def medians_in_turns(torch, fns, rounds: int = 6, warmup: int = 1) -> list:
    """Median time of one call of each of ``fns`` (CUDA events around the
    call, so device idle gaps inside it count), the functions run in turns
    (a b, b a, a b, ...) so that a drift of the shared host hits each alike;
    ``rounds`` timed calls of each after ``warmup``."""
    for fn in fns:
        for _ in range(warmup):
            fn()
    times = [[] for _ in fns]
    for r in range(rounds):
        for i in (range(len(fns)) if r % 2 == 0 else
                  reversed(range(len(fns)))):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fns[i]()
            end.record()
            torch.cuda.synchronize()
            times[i].append(start.elapsed_time(end))
    return [float(np.median(t)) for t in times]


def lm_serving(K, torch) -> int:
    """The LM serving path at GPT-2 small width; returns the flash kernel's
    launches on it. Raises when a check fails."""
    import torch.nn.functional as F
    from parsec_tpu_torch.parallel import model as M
    from parsec_tpu_torch.parallel.transformer import flash_attention_core

    cfg = M.ModelConfig(**GPT2_SMALL)
    t0 = time.perf_counter()
    params = M.params_from_numpy(M.init_lm_params(0, cfg))
    n_params = sum(t.numel() for t in
                   [params["embed"], params["pos"], params["lnf_g"],
                    params["lnf_b"]]
                   + [t for bp in params["blocks"] for t in bp.values()])
    log(f"LM GPT-2 small width {GPT2_SMALL}: {n_params} parameters (f32), "
        f"init + upload {time.perf_counter() - t0:.3f} s")
    B, S, L = LM_BATCH, LM_SEQ, cfg.n_layers
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + 1))
                            ).cuda()
    x, y = toks[:, :-1], toks[:, 1:]
    torch.cuda.reset_peak_memory_stats()
    K.flash_attention.launches = 0
    with torch.inference_mode():
        # 1. f32 forward: flash core against dense core
        got = M.lm_apply(params, x, attention=flash_attention_core)
        if K.flash_attention.launches != L:
            raise AssertionError(f"f32 forward launched the flash kernel "
                                 f"{K.flash_attention.launches} times, not {L}")
        want = M.lm_apply(params, x)
        err = (got - want).abs()
        bad = int((err > 2e-3 + 2e-3 * want.abs()).sum())
        finite = bool(torch.isfinite(got).all())
        log(f"LM f32 B={B} S={S}: flash-core logits {tuple(got.shape)} vs "
            f"dense core: max abs err {err.max().item():.3e}, {bad} beyond "
            f"rtol/atol 2e-3, finite {finite}")
        if bad or not finite:
            raise AssertionError("flash-core logits disagree with the dense "
                                 "core at GPT-2 small width")
        logits_f32 = got
        del want, err
        loss_f32 = float(M.lm_loss(params, x, y))

        # 2. bf16 serving forward through the kernel, timed in turns with
        # the same forward on the library's attention (the yardstick)
        def fwd(core=flash_attention_core):
            return M.lm_apply(params, x, attention=core,
                              compute_dtype=torch.bfloat16)

        def sdpa_core(q, k, v, causal, scale):
            # contiguous, as the flash core passes them: strided q/k/v
            # would steer the library off its fused kernels
            return F.scaled_dot_product_attention(
                q.contiguous(), k.contiguous(), v.contiguous(),
                is_causal=causal, scale=scale)
        before = K.flash_attention.launches
        rounds = 6
        fwd_ms, sdpa_ms = medians_in_turns(
            torch, [fwd, lambda: fwd(sdpa_core)], rounds=rounds)
        if K.flash_attention.launches - before != L * (1 + rounds):
            raise AssertionError("bf16 forwards did not launch the flash "
                                 f"kernel {L} times each")
        loss_bf16 = float(M.lm_loss(params, x, y, attention=flash_attention_core,
                                    compute_dtype=torch.bfloat16))
        log(f"LM bf16 forward (flash core) B={B} S={S}: median "
            f"{fwd_ms:.3f} ms -> {B * S / fwd_ms * 1e3:.1f} prefill tokens/s;"
            f" loss bf16 {loss_bf16:.6f} vs f32 {loss_f32:.6f}")
        log(f"yardstick, in turns with it: the same bf16 forward with "
            f"scaled_dot_product_attention as the core: median "
            f"{sdpa_ms:.3f} ms -> {B * S / sdpa_ms * 1e3:.1f} prefill "
            f"tokens/s")
        if not abs(loss_bf16 - loss_f32) < 0.05 * max(1.0, loss_f32):
            raise AssertionError("bf16 loss is not within 5% of the f32 loss")

        # the bf16 logits, element by element, against the f32 flash
        # forward's; the same check must reject a forward whose attention
        # outputs zeros, so that it sees what the kernel contributes
        def zero_core(q, k, v, causal, scale):
            return torch.zeros_like(q)
        before = K.flash_attention.launches
        dev_bf16 = logits_check(torch, fwd(), logits_f32)
        dev_zero = logits_check(torch, fwd(zero_core), logits_f32)
        if K.flash_attention.launches - before != L:
            raise AssertionError("the checked bf16 forward did not launch the "
                                 f"flash kernel {L} times")
        log(f"LM bf16 logits vs f32 flash logits: {dev_bf16[0]} of "
            f"{logits_f32.numel()} beyond rtol/atol {LOGIT_TOL}, max abs err "
            f"{dev_bf16[1]:.3e}, norm-wise {dev_bf16[2]:.3e} (limit "
            f"{LOGIT_NORM_TOL}); with zeroed attention: {dev_zero[0]} beyond,"
            f" max abs err {dev_zero[1]:.3e}, norm-wise {dev_zero[2]:.3e}")
        if dev_bf16[0] or not dev_bf16[2] <= LOGIT_NORM_TOL:
            raise AssertionError("bf16 logits disagree with the f32 logits")
        if not (dev_zero[0] and dev_zero[2] > LOGIT_NORM_TOL):
            raise AssertionError("the logits check passes a forward with "
                                 "zeroed attention: it cannot see the kernel")
        del logits_f32

        busy_ms, window_ms, by_name = device_profile(torch, fwd)
        log(idle_line("LM bf16 forward", busy_ms, window_ms)
            + f" (unprofiled median {fwd_ms:.3f} ms)")
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
            log(f"  device {ms:8.3f} ms  {name[:100]}")
        launches = K.flash_attention.launches

        # 3. KV-cached greedy generation (f32): a probe of the eager decode
        # loop's host dispatch, at two batch sizes
        prompts = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (max(GEN_BATCHES), GEN_PROMPT))).cuda()
        for gen_batch in GEN_BATCHES:
            greedy_decode(M, torch, params, cfg, n_params,
                          prompts[:gen_batch].contiguous())
    log(f"LM phase peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    del params
    torch.cuda.empty_cache()
    return launches


def logits_check(torch, got, want) -> tuple:
    """(elements beyond rtol/atol LOGIT_TOL, max abs error, norm-wise
    relative error ||got - want|| / ||want||) of ``got`` against ``want``."""
    err = (got - want).abs()
    beyond = int((err > LOGIT_TOL + LOGIT_TOL * want.abs()).sum())
    return (beyond, err.max().item(),
            ((got - want).norm() / want.norm()).item())


def greedy_decode(M, torch, params, cfg, n_params, prompt) -> None:
    """Times ``lm_generate`` on ``prompt`` and holds its tokens to a full
    f32 recompute; raises when a chosen token is not its row's maximum."""
    B, P, L = prompt.shape[0], prompt.shape[1], cfg.n_layers

    def gen_s(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = M.lm_generate(params, prompt, n)
        torch.cuda.synchronize()
        return time.perf_counter() - t, out
    gen_s(2)                                     # warm
    t1 = min(gen_s(1)[0] for _ in range(2))
    tn, out = gen_s(GEN_TOKENS)
    step_ms = (tn - t1) / (GEN_TOKENS - 1) * 1e3
    # a decode step reads every f32 weight but the position table, and the
    # caches at their full length, at least once
    dh = cfg.d_model // cfg.n_heads
    step_bytes = 4 * (n_params - params["pos"].numel()
                      + 2 * L * B * cfg.n_heads * (P + GEN_TOKENS) * dh)
    step_bound_ms = step_bytes / PEAK_BYTES_PER_S * 1e3
    log(f"LM greedy generate f32 B={B} prompt {P} + {GEN_TOKENS} tokens: "
        f"{tn:.3f} s (prefill + 1 token {t1:.3f} s) -> {step_ms:.3f} ms per "
        f"decode step, {B / step_ms * 1e3:.1f} decode tokens/s; bound "
        f"{step_bound_ms:.4f} ms per step ({step_bytes / 1e6:.1f} MB read) "
        f"-> {B / step_bound_ms * 1e3:.1f} tokens/s")
    logits = M.lm_apply(params, out)
    rows = logits[:, P - 1:-1]                   # predicts out[:, P:]
    chosen = rows.gather(-1, out[:, P:, None].long()).squeeze(-1)
    gap = (rows.max(-1).values - chosen).max().item()
    log(f"LM generate check against a full f32 recompute of "
        f"{tuple(out.shape)}: chosen logit at most {gap:.3e} below its row "
        f"max (limit 1e-3)")
    if tuple(out.shape) != (B, P + GEN_TOKENS) or not gap <= 1e-3 or \
            not torch.equal(out[:, :P], prompt):
        raise AssertionError("KV-cached decode disagrees with the full "
                             "recompute")


def flash_entry(K, torch, gen, launches: int) -> dict:
    """The flash kernel at the LM path's shape, (96, 1024, 64) bf16 causal:
    error against plain, times, bound."""
    import torch.nn.functional as F
    bh, s, d = LM_BATCH * GPT2_SMALL["n_heads"], LM_SEQ, 64
    q, k, v = (torch.randn(bh, s, d, device="cuda", generator=gen
                           ).to(torch.bfloat16) for _ in range(3))
    max_err = (K.flash_attention(q, k, v, causal=True).float()
               - K.flash_attention_plain(q, k, v, causal=True).float()
               ).abs().max().item()
    kernel_ms = cuda_time_ms(lambda: K.flash_attention(q, k, v, causal=True))
    plain_ms = cuda_time_ms(
        lambda: K.flash_attention_plain(q, k, v, causal=True), iters=5)
    q4, k4, v4 = (t.view(LM_BATCH, GPT2_SMALL["n_heads"], s, d)
                  for t in (q, k, v))
    library_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True))
    nbytes = 4 * bh * s * d * q.element_size()
    ops = 4.0 * d * bh * (s * (s + 1) / 2)      # q.k and p.v on the triangle
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S["bfloat16"] * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    log(f"flash_attention bf16 ({bh}, {s}, {d}) causal: kernel "
        f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"scaled_dot_product_attention {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}) -> {ops / kernel_ms / 1e9:.1f} "
        f"TFLOP/s")
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "parsec_tpu_torch/csrc/flash_attention.cu",
        "replaces": "parsec_tpu/ops/pallas_kernels.py:329",
        "launches": launches,
        "max_abs_err": max_err,
        "max_err": max_err,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    import parsec_tpu_torch as ptt
    from parsec_tpu_torch.data.matrix import collection_from_numpy
    from parsec_tpu_torch.device.cuda import CUDADevice
    from parsec_tpu_torch.ops import cuda_kernels as K
    from parsec_tpu_torch.ops.gemm import gemm_flops, insert_gemm_tasks
    from parsec_tpu_torch.ops.potrf import (insert_potrf_tasks, make_spd,
                                            potrf_flops)

    # ---- 1. device record -----------------------------------------------
    smi = smi_line()
    nvcc = subprocess.run([K.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{nvcc[-1]}")
    log(f"card: {smi}")

    # ---- 2. kernel check ------------------------------------------------
    t0 = time.perf_counter()
    names = ("gemm_chain", "flash_attention")
    with ThreadPoolExecutor(len(names)) as pool:   # one nvcc per source
        list(pool.map(K.build, names))
    log(f"built {', '.join(names)} in {time.perf_counter() - t0:.3f} s")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for kt, m, k, n in ((17, 512, 512, 512), (32, 512, 512, 512),
                            (32, 256, 128, 512)):
            check_gemm_chain(K, torch, dtype, kt, m, k, n, gen)
    check_flash(K, torch, gen)

    # ---- 3. scheduled DTD GEMM at full width (the main path) ------------
    ptt.mca.set("device_load_balance_allow_cpu", False)
    ctx = ptt.Context(nb_cores=1)
    dev = next(d for d in ctx.devices.devices if isinstance(d, CUDADevice))
    N, TS = GEMM_N, GEMM_TS
    rng = np.random.default_rng(42)
    a_host = rng.standard_normal((N, N), dtype=np.float32)
    b_host = rng.standard_normal((N, N), dtype=np.float32)
    A = collection_from_numpy("A", a_host, TS, TS, dtype=torch.bfloat16)
    B = collection_from_numpy("B", b_host, TS, TS, dtype=torch.bfloat16)
    C = collection_from_numpy("C", np.zeros((N, N), np.float32), TS, TS,
                              dtype=torch.bfloat16)
    kt = N // TS
    counts = {"dags": 0, "inserted": 0, "insert_s": {}}

    def run_dags(n_dags: int) -> float:
        tp = ptt.DTDTaskpool(ctx, "gemm")
        t = time.perf_counter()
        for _ in range(n_dags):
            counts["inserted"] += insert_gemm_tasks(tp, A, B, C, batch_k=True)
        counts["insert_s"].setdefault(n_dags, []).append(
            time.perf_counter() - t)
        tp.wait()
        tp.close()
        ctx.wait()
        torch.cuda.synchronize()
        counts["dags"] += n_dags
        return time.perf_counter() - t

    K.gemm_chain.launches = 0
    executed0 = dev.executed_tasks
    t_warm = run_dags(1)            # stages the tiles in
    gemm_s, t_lo, t_hi = slope(run_dags)
    launches = K.gemm_chain.launches
    executed = dev.executed_tasks - executed0
    tiles = (N // TS) ** 2
    log(f"DTD GEMM bf16 N={N} TS={TS} kt={kt}: warm {t_warm:.3f} s, "
        f"T1 {t_lo:.3f} s, T3 {t_hi:.3f} s, slope {gemm_s * 1e3:.1f} ms/DAG "
        f"-> {gemm_flops(N, N, N) / 1e9 / gemm_s:.1f} GFLOP/s")
    log(f"gemm_chain launches {launches} over {counts['dags']} DAGs "
        f"({launches / counts['dags']:.0f}/DAG), device executed {executed} "
        f"of {counts['inserted']} inserted tasks")
    if launches != tiles * counts["dags"]:
        raise AssertionError(f"gemm_chain launched {launches} times, "
                             f"expected {tiles} per DAG")
    if executed != counts["inserted"]:
        raise AssertionError("not every task ran on the CUDA device")
    # one DAG (1024 tasks) fits the insert window: its insertion runs alone,
    # before tp.wait() drains the ready queue (with 3 DAGs the window
    # stalls interleave insertion and execution)
    ins = min(counts["insert_s"][1])
    log(f"DTD GEMM breakdown: insertion {ins * 1e3:.1f} ms of the one-DAG "
        f"run's {t_lo * 1e3:.1f} ms; the card waits during it")
    log(idle_line("DTD GEMM one DAG",
                  *device_profile(torch, lambda: run_dags(1))[:2]))
    a_dev = torch.from_numpy(a_host).to("cuda", torch.bfloat16)
    b_dev = torch.from_numpy(b_host).to("cuda", torch.bfloat16)
    mm_ms = cuda_time_ms(lambda: torch.matmul(a_dev, b_dev), iters=5)
    log(f"yardstick torch.matmul bf16 {N}^3: {mm_ms:.3f} ms -> "
        f"{gemm_flops(N, N, N) / 1e6 / mm_ms:.1f} GFLOP/s")
    del a_dev, b_dev, a_host, b_host, A, B, C

    # ---- 4. correctness gates -------------------------------------------
    rng = np.random.default_rng(3)
    ga = rng.standard_normal((256, 2048)).astype(np.float32)
    gb = rng.standard_normal((2048, 256)).astype(np.float32)
    GA = collection_from_numpy("GA", ga, 64, 64)
    GB = collection_from_numpy("GB", gb, 64, 64)
    GC = collection_from_numpy("GC", np.zeros((256, 256), np.float32), 64, 64)
    before = K.gemm_chain.launches
    tp = ptt.DTDTaskpool(ctx, "gemm-kt32")
    insert_gemm_tasks(tp, GA, GB, GC, batch_k=True)
    tp.wait(); tp.close(); ctx.wait()
    ref = ga.astype(np.float64) @ gb.astype(np.float64)
    rel = np.abs(GC.to_dense() - ref).max() / np.abs(ref).max()
    log(f"gate f32 GEMM 256x2048x256 (64^2 tiles, kt=32, "
        f"{K.gemm_chain.launches - before} kernel launches): "
        f"max err / max |ref| = {rel:.3e}")
    if rel >= 1e-5 or K.gemm_chain.launches - before != 16:
        raise AssertionError("f32 kt=32 GEMM gate failed")

    a256 = rng.standard_normal((256, 256)).astype(np.float32)
    b256 = rng.standard_normal((256, 256)).astype(np.float32)
    As = collection_from_numpy("As", a256, 64, 64)
    Bs = collection_from_numpy("Bs", b256, 64, 64)
    Cs = collection_from_numpy("Cs", np.zeros((256, 256), np.float32), 64, 64)
    tp = ptt.DTDTaskpool(ctx, "gemm-check")
    insert_gemm_tasks(tp, As, Bs, Cs, batch_k=True)
    tp.wait(); tp.close(); ctx.wait()
    err = np.abs(Cs.to_dense() - a256 @ b256).max()
    log(f"gate GEMM 256 (64^2 tiles): max err {err:.2e}")
    if err >= 1e-2:
        raise AssertionError(f"GEMM 256 gate failed: {err}")

    spd_s = make_spd(256, seed=11)
    Ps = collection_from_numpy("Ps", spd_s, 64, 64)
    tp = ptt.DTDTaskpool(ctx, "potrf-check")
    insert_potrf_tasks(tp, Ps)
    tp.wait(); tp.close(); ctx.wait()
    Ls = np.tril(Ps.to_dense())
    perr = np.abs(Ls @ Ls.T - spd_s).max()
    log(f"gate POTRF 256 (64^2 tiles): max err {perr:.2e}")
    if perr >= 1e-2:
        raise AssertionError(f"POTRF 256 gate failed: {perr}")

    # ---- 5. scheduled DTD POTRF -----------------------------------------
    pN, pTS = POTRF_N, POTRF_TS
    spd = make_spd(pN, seed=7)
    spd_t = torch.from_numpy(spd)
    Pm = collection_from_numpy("Pbench", spd, pTS, pTS)
    ptasks = {"n": 0}

    def run_potrf(n_dags: int) -> float:
        """Repeated in-place factorizations in one pool: WAW chains
        serialize the reps (refactoring a factor is numerical nonsense, but
        op count and dataflow are identical)."""
        Pm.fill(lambda m, k: spd_t[m * pTS:(m + 1) * pTS,
                                   k * pTS:(k + 1) * pTS])
        tp = ptt.DTDTaskpool(ctx, "potrf")
        t = time.perf_counter()
        for _ in range(n_dags):
            ptasks["n"] = insert_potrf_tasks(tp, Pm)
        tp.wait(); tp.close(); ctx.wait()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    run_potrf(1)
    L = torch.from_numpy(Pm.to_dense()).to("cuda", torch.float64).tril()
    A64 = spd_t.to("cuda", torch.float64)
    resid = ((L @ L.mT - A64).abs().max() / A64.abs().max()).item()
    log(f"POTRF f32 N={pN} TS={pTS}: {ptasks['n']} tasks/DAG, "
        f"max|LL^T - A| / max|A| = {resid:.3e}")
    if not resid < 1e-5:
        raise AssertionError(f"POTRF residual check failed: {resid}")
    del L, A64
    potrf_s, p_lo, p_hi = slope(run_potrf)
    spd_dev = spd_t.to("cuda")
    chol_ms = cuda_time_ms(lambda: torch.linalg.cholesky_ex(spd_dev), iters=5)
    log(f"DTD POTRF f32 N={pN} TS={pTS}: T1 {p_lo:.3f} s, T3 {p_hi:.3f} s, "
        f"slope {potrf_s * 1e3:.1f} ms/DAG -> "
        f"{potrf_flops(pN) / 1e9 / potrf_s:.1f} GFLOP/s "
        f"(yardstick torch.linalg.cholesky_ex: {chol_ms:.3f} ms)")
    del spd_dev
    ctx.fini()

    # ---- 6. LM serving at GPT-2 small width ----------------------------
    flash_launches = lm_serving(K, torch)

    # ---- 7. kernel line at the main paths' shapes -----------------------
    kt, m, k, n = GEMM_N // GEMM_TS, GEMM_TS, GEMM_TS, GEMM_TS
    bf16 = torch.bfloat16
    c = torch.randn(m, n, device="cuda", generator=gen).to(bf16)
    a = torch.randn(kt, m, k, device="cuda", generator=gen).to(bf16)
    b = torch.randn(kt, k, n, device="cuda", generator=gen).to(bf16)
    max_err = (K.gemm_chain(c, a, b).float()
               - K.gemm_chain_plain(c, a, b).float()).abs().max().item()
    kernel_ms = cuda_time_ms(lambda: K.gemm_chain(c, a, b))
    plain_ms = cuda_time_ms(lambda: K.gemm_chain_plain(c, a, b))
    a_cat = a.permute(1, 0, 2).reshape(m, kt * k)   # [A0 A1 ... ]
    b_cat = b.reshape(kt * k, n)                    # [B0; B1; ...]
    library_ms = cuda_time_ms(lambda: torch.addmm(c, a_cat, b_cat))
    nbytes = (kt * (m * k + k * n) + 2 * m * n) * c.element_size()
    ops = 2.0 * kt * m * k * n
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S["bfloat16"] * 1e3
    bound_ms = max(t_bytes, t_ops)
    log(f"gemm_chain bf16 C {m}^2 kt={kt}: kernel {kernel_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, torch.addmm {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({'bytes' if t_bytes >= t_ops else 'operations'})"
        f" -> {ops / kernel_ms / 1e6:.1f} GFLOP/s")
    kernels = [{
        "name": "gemm_chain",
        "route": "cuda",
        "source": "parsec_tpu_torch/csrc/gemm_chain.cu",
        "replaces": "parsec_tpu/ops/pallas_kernels.py:157",
        "launches": launches,
        "max_abs_err": max_err,
        "max_err": max_err,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
    }, flash_entry(K, torch, gen, flash_launches)]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
