#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``parsec_tpu_torch``) on one card.

    python3 chip_smoke.py

Builds the hand-written kernels from ``parsec_tpu_torch/csrc`` with nvcc (one
nvcc per source, all started together; a build whose wgmmas ptxas
serialised fails the run), checks with ``cuobjdump -sass`` that the chain's
bf16 kernel and the flash kernel's wgmma route run on Hopper's tensor-core
and TMA instructions (HGMMA, UTMALDG), holds each kernel against its plain
PyTorch version (``gemm_chain`` on its tile, split and general routes,
``flash_attention`` on its wgmma, mma and simt routes), then drives the
port's main paths through the entry points a user calls:

* the DTD tiled GEMM (bf16, N = 16384 in 512 x 512 tiles, so every GEMM_K
  task runs the ``gemm_chain`` kernel over a k-chain of 32, on its split
  route; the device time a task is split into the chain's two phases and
  the ``torch.stack`` copies) and the DTD tiled
  Cholesky (f32, N = 8192 in 256 x 256 tiles), with the 256-size
  correctness gates of the reference benchmark. Both DAGs run through the
  native DTD engine's per-task lane (``csrc/ptdtd.cpp``, built with the
  host C++ compiler beside the kernels), every task checked to have taken
  it, in turns with the Python engine (``--mca native_enabled 0``): both
  engines' slopes, the GEMM's C and the factor equal bit for bit between
  them, and the host time of a GEMM task split by phase (insertion,
  select, ready handling, stage-in, submit, epilog and release) from the
  PINS events, with the slopes with PINS on;
* the DTD 1D Jacobi stencil (f32, N = 2^28 points in 16 tiles of 2^24, 8
  iterations: every task runs the ``stencil1d`` kernel, 128 launches a DAG),
  held bit for bit to the plain whole-row iteration; the DTD tiled LU
  (getrf, no pivoting) and QR (geqrf) at N = 8192 in 256 x 256 tiles, each
  held to its backward-error gate, which must also reject a copy of the DAG
  with one trailing update left out; the apps (merge sort, all2all,
  pingpong, haar tree, generalized reductions) on the card, against numpy;
* the LM serving path at GPT-2 small's published widths (vocab 50257,
  d_model 768, 12 heads, d_ff 3072, 12 layers, max_seq 1024; random weights
  from a seed): a prefill/scoring forward of 8 x 1024 tokens through the
  ``flash_attention`` kernel (f32 against the dense core on the simt route,
  then bf16 on the wgmma route, timed, profiled and its logits held to the
  f32 ones), and KV-cached greedy generation of
  64 tokens for 4 and for 32 prompts of 128 (the decode step as one CUDA
  graph and as the eager loop, at two batch sizes);
* the blocked ``matmul`` entry point at bf16 8192^3 and f32 4096^3;
* the same DTD paths captured (``DTDTaskpool(..., capture=...)``): the
  GEMM DAG as one CUDA graph (inline) and as the scan interpreter (what
  ``capture=True`` picks for its 1024 tasks), each bit for bit the
  scheduled DAG, the POTRF DAG under scan (its residual), the stencil DAG
  (first run and replay each bit for bit the plain iteration) and the
  256-size gates in capture mode; each timed by its slope beside the
  scheduled one, with its capture time and its device busy share; the
  chain and stencil kernels' launches from the replayed graphs counted as
  the graph's kernel nodes times its replays; and the LM's decode step as
  one replayed graph (kept across calls), in turns with the eager loop, at
  64 tokens and at 4.

Every phase that fails ends the run with a nonzero exit code.

Output: one line per measurement, then the card's name and power limit as
nvidia-smi gives them, then ``{"kernels": [...]}`` (one entry per ported
kernel: launches on the main path, error against the plain version, times
and bound; the chain's entry counts the native lane's scheduled DAGs and
the replays, with each engine's count, PINS on and off, beside it under
``launches_by_lane``; flash's entry also its profiled device time, its
launches by route, the mma route's times in turns with it and a float32
sub-entry), and last ``{"ok": true, "device": {...}}``.

Needs one CUDA card; exits nonzero without one.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import sysconfig
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

GEMM_N, GEMM_TS = 16384, 512         # kt = 32: every GEMM_K task hits the kernel
POTRF_N, POTRF_TS = GEMM_N // 2, GEMM_TS // 2
REPS = 2
# the reference benchmark's stencil leg (2^22 points, 2^18 tiles, 8
# iterations) with both sizes scaled by 64: the same 16 tiles x 8
# iterations = 128 tasks a DAG, on 1 GiB arrays
STENCIL_N, STENCIL_TS, STENCIL_ITERS = 1 << 28, 1 << 24, 8
LU_N, LU_TS = POTRF_N, POTRF_TS              # getrf and geqrf: POTRF's shape
MATMUL_N, MATMUL_F32_N = 8192, 4096

# GPT-2 small (openai-community/gpt2 config.json: n_embd 768, n_head 12,
# n_layer 12, n_positions 1024, vocab 50257; n_inner null = 4 * n_embd)
GPT2_SMALL = dict(vocab_size=50257, d_model=768, d_ff=3072, n_heads=12,
                  n_layers=12, max_seq=1024)
LM_BATCH, LM_SEQ = 8, 1024                 # prefill / scoring batch
GEN_BATCHES, GEN_PROMPT, GEN_TOKENS, GEN_SHORT = (4, 32), 128, 64, 4
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
    return device_profile_counts(torch, run)[:3]


def device_profile_counts(torch, run) -> tuple:
    """:func:`device_profile` and, fourth, the number of device events by
    kernel name (the launches the trace holds, a replayed CUDA graph's
    kernels among them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(PROFILE_WINDOW):
            run()
            torch.cuda.synchronize()
    spans, by_name, counts, window = [], {}, {}, 0.0
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
        counts[ev.name] = counts.get(ev.name, 0) + 1
    busy_us, reach = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        busy_us += max(0.0, t1 - max(t0, reach))
        reach = max(reach, t1)
    if not spans:
        return 0.0, 0.0, {}, {}
    if busy_us / 1e3 > window:
        raise AssertionError(f"device busy {busy_us / 1e3:.3f} ms exceeds the "
                             f"profiled window {window:.3f} ms")
    return busy_us / 1e3, window, by_name, counts


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


@contextlib.contextmanager
def dtd_engine(ptt, native: bool):
    """Pools whose first insert runs in the block take the native DTD
    engine (``native``, the default) or the Python one (``--mca
    native_enabled 0``)."""
    if not native:
        ptt.mca.set("native_enabled", False)
    try:
        yield
    finally:
        ptt.mca.params.unset("native_enabled")


def engine_name(native: bool) -> str:
    return "native lane" if native else "Python engine"


def check_lane(tp, ctx, before: dict, n: int, native: bool,
               what: str) -> None:
    """Raises unless all ``n`` tasks of the pool ``tp`` took the engine
    asked for: on the native per-task lane, the PTDTD_STATS delta since
    ``before`` counts every one of them and the id->task map is empty
    again; on the Python engine, none."""
    from parsec_tpu_torch.dsl.dtd import PTDTD_STATS
    d = PTDTD_STATS.delta(before)
    if native:
        ok = (tp._neng is not None and not tp._batch_on
              and d["tasks_native"] == n and d["tasks_batched"] == 0
              and not ctx._dtd_ntasks)
    else:
        ok = tp._neng is None and d["tasks_native"] == 0
    if not ok:
        raise AssertionError(
            f"{what}: the {engine_name(native)} did not take all {n} tasks "
            f"(PTDTD_STATS delta {d}, {len(ctx._dtd_ntasks)} tasks left "
            f"in the engine's map)")


def slopes_in_turns(run, engines=(True, False), lo: int = 1,
                    hi: int = 3) -> dict:
    """:func:`slope` for each engine, their runs in turns (so both see the
    same card and host state): {native: (slope, t_lo, t_hi)}."""
    t = {e: ([], []) for e in engines}
    for _ in range(REPS):
        for e in engines:
            t[e][0].append(run(lo, e))
            t[e][1].append(run(hi, e))
    return {e: ((min(h) - min(l_)) / (hi - lo), min(l_), min(h))
            for e, (l_, h) in t.items()}


class HostSplit:
    """Exclusive host time of a DAG by phase, from the port's PINS events
    (``core/pins.py``): scheduler select (SELECT), ready handling (the
    SCHEDULE pushes of ready tasks and the DTD prepare_input,
    PREPARE_INPUT), the chore hook (EXEC), and epilog plus release (the
    device module's epilog, COMPLETE_EXEC and RELEASE_DEPS); inside the
    hook and the device polls, stage-in (the device module's input
    gathering: version checks, host-to-device copies, pins) and submit
    (the body: the stacks and the chain launch) are timed by wrapping
    those two calls; insertion is the insert loop. Time goes to the
    innermost open phase, so nested phases (an epilog inside a hook's
    device poll, a push inside a release) count once; what no phase holds
    is the progress loop's own (device polls, backoff, waiting for the
    card)."""

    PHASES = ("insert", "select", "ready", "stage-in", "submit", "hook",
              "epilog+release")

    def __init__(self, pins_mod, ctx, dev) -> None:
        self.ctx = ctx
        self.acc = dict.fromkeys(self.PHASES, 0)
        self.stack, self.mark = [], 0
        self.cbs, self.wrapped = [], []
        P = pins_mod
        for begin, end, phase in (
                (P.SELECT_BEGIN, P.SELECT_END, "select"),
                (P.SCHEDULE_BEGIN, P.SCHEDULE_END, "ready"),
                (P.PREPARE_INPUT_BEGIN, P.PREPARE_INPUT_END, "ready"),
                (P.EXEC_BEGIN, P.EXEC_END, "hook"),
                (P.COMPLETE_EXEC_BEGIN, P.COMPLETE_EXEC_END,
                 "epilog+release"),
                (P.RELEASE_DEPS_BEGIN, P.RELEASE_DEPS_END,
                 "epilog+release")):
            for ev, cb in ((begin, lambda s, t, x, p=phase: self.push(p)),
                           (end, lambda s, t, x: self.pop())):
                ctx.pins.register(ev, cb)
                self.cbs.append((ev, cb))
        self.wrap(dev, "_gather_inputs", "stage-in")
        self.wrap(dev, "_epilog", "epilog+release")

    def push(self, phase: str) -> None:
        now = time.perf_counter_ns()
        if self.stack:
            self.acc[self.stack[-1]] += now - self.mark
        self.stack.append(phase)
        self.mark = now

    def pop(self) -> None:
        now = time.perf_counter_ns()
        if self.stack:
            self.acc[self.stack.pop()] += now - self.mark
        self.mark = now

    def wrap(self, obj, name: str, phase: str) -> None:
        orig = getattr(obj, name)

        def timed(*args, **kw):
            self.push(phase)
            try:
                return orig(*args, **kw)
            finally:
                self.pop()
        setattr(obj, name, timed)
        self.wrapped.append((obj, name))

    def reset(self) -> None:
        self.acc = dict.fromkeys(self.PHASES, 0)
        self.stack = []

    def line(self, what: str, wall_s: float, ntasks: int) -> str:
        per = {p: ns / 1e3 / ntasks for p, ns in self.acc.items()}
        held = sum(per.values())
        wall = wall_s * 1e6 / ntasks
        return (f"{what} host split a task (us, exclusive): " + ", ".join(
            f"{p} {v:.1f}" for p, v in per.items()) + f"; phases {held:.1f} "
            f"of the DAG's {wall:.1f} a task, loop and wait {wall - held:.1f}")

    def detach(self) -> None:
        for ev, cb in self.cbs:
            self.ctx.pins.unregister(ev, cb)
        for obj, name in self.wrapped:
            delattr(obj, name)
        self.cbs, self.wrapped = [], []


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
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    route = K.chain_route(kt, m, k, n, k, m * k, 4 if name == "float32" else 2,
                          True, sms)
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
        log(f"kernel check gemm_chain {name} kt={kt} C {m}x{n} k={k} "
            f"({route} route), integer data: "
            f"{'bit-exact' if exact else 'DIFFERS'}")
    torch.cuda.synchronize()
    log(f"kernel check gemm_chain {name} kt={kt} C {m}x{n} k={k} ({route} "
        f"route): "
        f"max abs err {err.max().item():.3e}, {bad} of {err.numel()} "
        f"elements beyond tolerance")
    if not ok:
        raise AssertionError(f"gemm_chain {name} kt={kt} ({m},{k},{n}) "
                             f"disagrees with its plain version")
    return err.max().item()


# (q shape, kv shape, causal, q_offset, k_offset, rows that see no key);
# bf16 takes the wgmma route at head dims 64 and 128, the mma route at 16
# and 32, float32 the simt route
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
    "q shorter than kv d=64": ((6, 64, 64), (6, 192, 64), False, 0, 0, 0),
    "ring offset d=64": ((1, 128, 64), (1, 256, 64), True, 128, 0, 0),
    "all-masked block d=64": ((1, 128, 64), (1, 128, 64), True, 0, 128, 128),
    "unaligned offset d=64": ((1, 64, 64), (1, 64, 64), True, 0, 32, 32),
    "S=257 causal d=64": ((1, 257, 64), (1, 257, 64), True, 0, 0, 0),
    "S=4 d=64": ((1, 4, 64), (1, 4, 64), False, 0, 0, 0),
    "sq=sk=1 d=64": ((3, 1, 64), (3, 1, 64), True, 0, 0, 0),
    "offsets and sq != sk d=64": ((2, 192, 64), (2, 160, 64), True, 40, 72,
                                  32),
    "ragged d=128": ((2, 200, 128), (2, 333, 128), False, 0, 0, 0),
}


def check_flash(K, torch, gen) -> None:
    """Kernel vs plain on the card for every case: float32 within rtol/atol
    2e-4 (the reference's own flash tolerance); bf16 with every element
    within ``flash_attention_bf16_tolerance`` (the rounding of P and of the
    output, about 4e-3 of the weighted |v| plus 8e-3 of |out|); rows that
    see no key exactly 0. Each launch must take the route that
    :func:`flash_route` gives its dtype and head dim, and the cases must
    reach all three routes."""
    routes = set()
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        for case, (qs, ks, causal, q_off, k_off, masked) in \
                FLASH_CASES.items():
            q, k, v = (torch.randn(sh, device="cuda", generator=gen
                                   ).to(dtype) for sh in (qs, ks, ks))
            kw = dict(causal=causal, q_offset=q_off, k_offset=k_off)
            route = K.flash_route(dtype, qs[-1], True)
            before = K.flash_attention.launches_by_route[route]
            got = K.flash_attention(q, k, v, **kw).float()
            if K.flash_attention.launches_by_route[route] != before + 1:
                raise AssertionError(f"flash_attention {name} {case} did not "
                                     f"take the {route} route")
            routes.add(route)
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
                f" causal={causal} offsets ({q_off}, {k_off}), {route} "
                f"route: max abs err {err.max().item():.3e}, max "
                f"err/tolerance {worst:.3f}, {bad} beyond"
                + (f", first {masked} rows exactly 0: {zero}" if masked
                   else ""))
            if bad or not zero:
                raise AssertionError(f"flash_attention {name} {case} "
                                     f"disagrees with its plain version")
    torch.cuda.synchronize()
    if routes != set(K.FLASH_ROUTES):
        raise AssertionError(f"the flash checks reached only {routes}")


def check_stencil1d(K, torch, gen) -> None:
    """Kernel vs plain on the card, bit for bit in float32 and bf16 (every
    product and sum rounded in the same order): rows 1 and 8; widths 1, 7,
    4096 and 2^24; null halos, real halos of x's width, and a left halo
    wider and a right one narrower than x."""
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        for rows in (1, 8):
            for cols in (1, 7, 4096, 1 << 24):
                x = torch.randn(rows, cols, device="cuda", generator=gen
                                ).to(dtype)
                halos = {
                    "null halos": (None, None),
                    "real halos": tuple(torch.randn(
                        rows, cols, device="cuda", generator=gen).to(dtype)
                        for _ in range(2)),
                    "wide left, narrow right": (
                        torch.randn(rows, cols + 5, device="cuda",
                                    generator=gen).to(dtype),
                        torch.randn(rows, max(1, cols // 2), device="cuda",
                                    generator=gen).to(dtype)),
                }
                for case, (left, right) in halos.items():
                    for w in ((0.25, 0.5, 0.25), (0.3, 0.45, 0.25)):
                        got = K.stencil1d(x, left, right, w)
                        want = K.stencil1d_plain(x, left, right, w)
                        if not torch.equal(got, want):
                            err = (got.float() - want.float()).abs().max()
                            raise AssertionError(
                                f"stencil1d {name} ({rows}, {cols}) {case} "
                                f"weights {w} differs from its plain version "
                                f"(max abs err {err.item():.3e})")
                del x, halos
        log(f"kernel check stencil1d {name}: rows 1 and 8 x widths 1, 7, "
            f"4096, 2^24 x (null halos, real halos, wide left / narrow "
            f"right) x 2 weight sets: all bit-exact")
    torch.cuda.synchronize()


def hold_matmul(K, torch, a, b, got, block, gen, label: str) -> float:
    """Hold ``got`` = K.matmul(a, b, block) against the plain version; raise
    when it disagrees, else return the max abs error. float32: within
    rtol/atol 1e-4. bf16: at most 0.1% of the elements beyond 2 bf16 ulps of
    the running peak (gemm_chain's bound: the same per-step rounding), and
    bit for bit on small-integer operands of the same shape (every float32
    partial sum exact, so each step's rounding is deterministic)."""
    m, k = a.shape
    n = b.shape[1]
    want = K.matmul_plain(a, b, block).float()
    err = (got.float() - want).abs()
    exact = None
    if a.dtype == torch.float32:
        bad = int((err > 1e-4 + 1e-4 * want.abs()).sum())
        ok = bad == 0
    else:
        bk = min(block[2], k)
        kt = k // bk
        del want
        tol = K.gemm_chain_bf16_tolerance(
            torch.zeros(m, n, device="cuda", dtype=a.dtype),
            a.view(m, kt, bk).permute(1, 0, 2).contiguous(),
            b.view(kt, bk, n))
        bad = int((err > tol).sum())
        del tol
        ai = torch.randint(-16, 17, (m, k), device="cuda",
                           generator=gen).to(a.dtype)
        bi = torch.randint(-16, 17, (k, n), device="cuda",
                           generator=gen).to(a.dtype)
        exact = torch.equal(K.matmul(ai, bi, block),
                            K.matmul_plain(ai, bi, block))
        ok = bad <= 1e-3 * err.numel() and exact
    max_err = err.max().item()
    log(f"{label} ({m}, {k}) x ({k}, {n}) block {block}: max abs err "
        f"{max_err:.3e}, {bad} of {err.numel()} beyond tolerance"
        + ("" if exact is None else
           f"; integer data {'bit-exact' if exact else 'DIFFERS'}"))
    if not ok:
        raise AssertionError(f"{label} block {block} disagrees with its "
                             f"plain version")
    return max_err


def check_matmul(K, torch, gen) -> None:
    """Kernel vs plain on the card (:func:`hold_matmul`), blocks (256, 256,
    256) and (64, 64, 32), A and B scaled by bk^-1/4 (each step's product of
    unit variance, gemm_chain's f32 check): two shapes on the split route,
    1024^3 on the tile route. Then one shape the blocks do not divide,
    which takes the library route and launches nothing."""
    for block, (m, k, n) in (((256, 256, 256), (512, 2048, 768)),
                             ((64, 64, 32), (192, 512, 320)),
                             ((256, 256, 256), (1024, 1024, 1024))):
        s = block[2] ** -0.25
        for dtype in (torch.float32, torch.bfloat16):
            a = (torch.randn(m, k, device="cuda", generator=gen) * s).to(dtype)
            b = (torch.randn(k, n, device="cuda", generator=gen) * s).to(dtype)
            before = K.matmul.launches
            got = K.matmul(a, b, block)
            if K.matmul.launches != before + 1:
                raise AssertionError("matmul did not launch its kernel")
            hold_matmul(K, torch, a, b, got, block, gen,
                        f"kernel check matmul {str(dtype)[6:]}")
    a = torch.randn(300, 256, device="cuda", generator=gen)
    b = torch.randn(256, 64, device="cuda", generator=gen)
    before = K.matmul.launches
    err = (K.matmul(a, b) - torch.matmul(a, b)).abs().max().item()
    log(f"kernel check matmul f32 (300, 256) x (256, 64), blocks not "
        f"dividing: library route, {K.matmul.launches - before} launches, "
        f"max abs err against torch.matmul {err:.3e}")
    if K.matmul.launches != before or err > 1e-4:
        raise AssertionError("a non-dividing matmul did not take the "
                             "library route")
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


def lm_serving(K, torch) -> tuple:
    """The LM serving path at GPT-2 small width; returns the flash kernel's
    launches on it, in all and by route. Raises when a check fails."""
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
    K.flash_attention.launches_by_route = dict.fromkeys(K.FLASH_ROUTES, 0)
    by_route = K.flash_attention.launches_by_route
    with torch.inference_mode():
        # 1. f32 forward: flash core against dense core
        got = M.lm_apply(params, x, attention=flash_attention_core)
        if K.flash_attention.launches != L or by_route["simt"] != L:
            raise AssertionError(f"f32 forward launched the flash kernel "
                                 f"{K.flash_attention.launches} times, not {L}"
                                 f" on the simt route ({by_route})")
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
        before = K.flash_attention.launches, by_route["wgmma"]
        rounds = 6
        fwd_ms, sdpa_ms = medians_in_turns(
            torch, [fwd, lambda: fwd(sdpa_core)], rounds=rounds)
        if K.flash_attention.launches - before[0] != L * (1 + rounds) or \
                by_route["wgmma"] - before[1] != L * (1 + rounds):
            raise AssertionError("bf16 forwards did not launch the flash "
                                 f"kernel {L} times each, all on the wgmma "
                                 f"route ({by_route})")
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
        flash_ms = sum(ms for name, ms in by_name.items()
                       if "flash_bf16_wgmma" in name)
        log(f"  the flash kernel's device time in the profiled forward: "
            f"{flash_ms:.3f} ms for {L} launches")
        launches = K.flash_attention.launches
        log(f"LM flash launches {launches}, by route {by_route}")

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
    M._decode_graphs.clear()                     # the kept decode graphs
    torch.cuda.empty_cache()
    return launches, dict(by_route)


class gc_time:
    """Seconds Python's cyclic garbage collector runs inside the block,
    from its start/stop callbacks: ``with gc_time() as spent: ...``, then
    ``spent[0]``."""

    def __enter__(self) -> list:
        self.spent, self.t0 = [0.0], 0.0
        gc.callbacks.append(self._on_gc)
        return self.spent

    def _on_gc(self, phase, info) -> None:
        if phase == "start":
            self.t0 = time.perf_counter()
        else:
            self.spent[0] += time.perf_counter() - self.t0

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self._on_gc)


def logits_check(torch, got, want) -> tuple:
    """(elements beyond rtol/atol LOGIT_TOL, max abs error, norm-wise
    relative error ||got - want|| / ||want||) of ``got`` against ``want``."""
    err = (got - want).abs()
    beyond = int((err > LOGIT_TOL + LOGIT_TOL * want.abs()).sum())
    return (beyond, err.max().item(),
            ((got - want).norm() / want.norm()).item())


def greedy_decode(M, torch, params, cfg, n_params, prompt) -> None:
    """Times ``lm_generate`` on ``prompt`` with the decode step as one
    replayed CUDA graph (the first call of a token count captures it, later
    calls replay the kept graph) and as the eager loop, in turns (graph,
    eager, eager, graph), at GEN_TOKENS and at a short GEN_SHORT tokens;
    holds graph and eager to the same tokens and the graph's tokens to a
    full f32 recompute; raises when they differ or a chosen token is not
    its row's maximum."""
    B, P, L = prompt.shape[0], prompt.shape[1], cfg.n_layers

    def gen_s(n, graph=True):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = M.lm_generate(params, prompt, n) if graph else \
            M._generate(params, prompt, n, True, 1.0, None, graph=False)
        torch.cuda.synchronize()
        return time.perf_counter() - t, out
    gen_s(2, graph=False)                        # warm the eager kernels
    t1 = min(gen_s(1)[0] for _ in range(2))      # the prefill alone
    # the first call of each token count: warm-up step, capture, replays;
    # with the time Python's cyclic garbage collector took during it (the
    # profiled runs before leave many objects behind)
    first, gc_s = {}, {}
    for n in (GEN_SHORT, GEN_TOKENS):
        with gc_time() as spent:
            first[n] = gen_s(n)
        gc_s[n] = spent[0]
    times, outs = {}, {}
    for n in (GEN_TOKENS, GEN_SHORT):
        for graph in (True, False, False, True):
            dt, outs[n, graph] = gen_s(n, graph)
            times.setdefault((n, graph), []).append(dt)
    step_ms = {g: (min(times[GEN_TOKENS, g]) - t1) / (GEN_TOKENS - 1) * 1e3
               for g in (True, False)}
    # a decode step reads every f32 weight but the position table, and the
    # caches at their full length, at least once
    dh = cfg.d_model // cfg.n_heads
    step_bytes = 4 * (n_params - params["pos"].numel()
                      + 2 * L * B * cfg.n_heads * (P + GEN_TOKENS) * dh)
    step_bound_ms = step_bytes / PEAK_BYTES_PER_S * 1e3
    for graph, what in ((True, "decode step as one CUDA graph (kept)"),
                        (False, "eager decode loop")):
        log(f"LM greedy generate f32 B={B} prompt {P} + {GEN_TOKENS} tokens, "
            f"{what}: {', '.join(f'{t:.3f}' for t in times[GEN_TOKENS, graph])}"
            f" s in turns (prefill + 1 token {t1:.3f} s) -> "
            f"{step_ms[graph]:.3f} ms per decode step, "
            f"{B / step_ms[graph] * 1e3:.1f} decode tokens/s; bound "
            f"{step_bound_ms:.4f} ms per step ({step_bytes / 1e6:.1f} MB "
            f"read) -> {B / step_bound_ms * 1e3:.1f} tokens/s")
    log(f"LM decode graph B={B}: the first call of {GEN_TOKENS} tokens "
        f"{first[GEN_TOKENS][0]:.3f} s (garbage collector "
        f"{gc_s[GEN_TOKENS] * 1e3:.3f} ms of it) against "
        f"{min(times[GEN_TOKENS, True]):.3f} s replaying the kept graph -> "
        f"warm-up step + capture + instantiate about "
        f"{(first[GEN_TOKENS][0] - min(times[GEN_TOKENS, True])) * 1e3:.3f}"
        f" ms (less one replay)")
    log(f"LM short generate B={B} prompt {P} + {GEN_SHORT} tokens: first call "
        f"(captures) {first[GEN_SHORT][0] * 1e3:.3f} ms (garbage collector "
        f"{gc_s[GEN_SHORT] * 1e3:.3f} ms of it), kept graph "
        f"{', '.join(f'{t * 1e3:.3f}' for t in times[GEN_SHORT, True])} ms, "
        f"eager {', '.join(f'{t * 1e3:.3f}' for t in times[GEN_SHORT, False])}"
        f" ms (in turns)")
    busy_n = device_profile(torch, lambda: gen_s(GEN_TOKENS))[0]
    busy_s = device_profile(torch, lambda: gen_s(GEN_SHORT))[0]
    log(f"LM decode graph B={B}: device busy a replayed step "
        f"{(busy_n - busy_s) / (GEN_TOKENS - GEN_SHORT):.3f} ms (profiler: "
        f"(busy(T{GEN_TOKENS}) - busy(T{GEN_SHORT})) / "
        f"{GEN_TOKENS - GEN_SHORT})")
    same = all(torch.equal(outs[n, True], outs[n, False])
               and torch.equal(first[n][1], outs[n, False])
               for n in (GEN_SHORT, GEN_TOKENS))
    out = outs[GEN_TOKENS, True]
    logits = M.lm_apply(params, out)
    rows = logits[:, P - 1:-1]                   # predicts out[:, P:]
    chosen = rows.gather(-1, out[:, P:, None].long()).squeeze(-1)
    gap = (rows.max(-1).values - chosen).max().item()
    log(f"LM generate check: graph (first call and kept) and eager tokens "
        f"{'identical' if same else 'DIFFER'}; against a full f32 recompute "
        f"of {tuple(out.shape)}: chosen logit at most {gap:.3e} below its "
        f"row max (limit 1e-3)")
    if tuple(out.shape) != (B, P + GEN_TOKENS) or not gap <= 1e-3 or \
            not torch.equal(out[:, :P], prompt) or not same:
        raise AssertionError("KV-cached decode disagrees with the eager loop "
                             "or the full recompute")


def gemm_chain_entry(K, torch, gen, launches: int, by_route: dict) -> dict:
    """The chain kernel at the DTD GEMM's shape, C 512^2 and a chain of 32
    tiles: error against plain, times, bound, in bf16 (the entry) and in
    float32 (its ``float32`` sub-entry), each beside ``torch.addmm`` on the
    concatenated stacks in the same dtype."""
    kt, m, k, n = GEMM_N // GEMM_TS, GEMM_TS, GEMM_TS, GEMM_TS
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        c = torch.randn(m, n, device="cuda", generator=gen).to(dtype)
        a = torch.randn(kt, m, k, device="cuda", generator=gen).to(dtype)
        b = torch.randn(kt, k, n, device="cuda", generator=gen).to(dtype)
        max_err = (K.gemm_chain(c, a, b).float()
                   - K.gemm_chain_plain(c, a, b).float()).abs().max().item()
        kernel_ms = cuda_time_ms(lambda: K.gemm_chain(c, a, b))
        plain_ms = cuda_time_ms(lambda: K.gemm_chain_plain(c, a, b))
        a_cat = a.permute(1, 0, 2).reshape(m, kt * k)   # [A0 A1 ... ]
        b_cat = b.reshape(kt * k, n)                    # [B0; B1; ...]
        K.dot_precision()                               # no TF32 for addmm
        library_ms = cuda_time_ms(lambda: torch.addmm(c, a_cat, b_cat))
        nbytes = (kt * (m * k + k * n) + 2 * m * n) * c.element_size()
        ops = 2.0 * kt * m * k * n
        rows[name] = kernel_entry(
            "gemm_chain", "parsec_tpu_torch/csrc/gemm_chain.cu",
            "parsec_tpu/ops/pallas_kernels.py:157", launches, max_err,
            kernel_ms, plain_ms, nbytes, ops, name, library_ms)
        e = rows[name]
        log(f"gemm_chain {name} C {m}^2 kt={kt}: kernel {kernel_ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, torch.addmm {library_ms:.4f} ms, bound "
            f"{e['bound_ms']:.4f} ms ({e['bound_by']}) -> "
            f"{ops / kernel_ms / 1e9:.1f} TFLOP/s; max abs err against plain "
            f"{max_err:.3e}")
        del c, a, b, a_cat, b_cat
    entry = rows["bfloat16"]
    entry["launches_by_route"] = by_route
    entry["float32"] = {k: rows["float32"][k] for k in
                        ("max_abs_err", "ms", "plain_ms", "bound_ms",
                         "bound_by", "library_ms")}
    return entry


# the SASS each library must hold, by kernel: Hopper's tensor-core
# instruction (HGMMA), TMA loads (UTMALDG), cp.async (LDGSTS)
SASS_NEEDS = {
    "gemm_chain": {"chain_bf16_wgmma": ("HGMMA", "UTMALDG"),
                   "chain_f32_tiled": ("LDGSTS",)},
    "flash_attention": {"flash_bf16_wgmma": ("HGMMA", "UTMALDG")},
}


def sass_check(K) -> dict:
    """The SASS of the libraries that the wrappers load, by kernel: the
    chain's bf16 tile/split kernel and the flash wgmma kernel must hold
    HGMMA and UTMALDG, the chain's float32 kernel LDGSTS. Returns the
    counts; raises when one is missing."""
    tool = os.path.join(os.path.dirname(K.nvcc_path()), "cuobjdump")
    counts = {}
    for lib, needs in SASS_NEEDS.items():
        so = K.build(lib)
        if K._library(lib)._name != so:
            raise AssertionError(f"the loaded {lib} library is not the built "
                                 "one")
        sass = subprocess.run([tool, "-sass", so], capture_output=True,
                              text=True, check=True).stdout
        name = None
        for line in sass.splitlines():
            if "Function :" in line:
                name = line.split("Function :")[1].strip()
                continue
            for kernel, ops in needs.items():
                if name and kernel in name:
                    for op in ops:
                        if op in line:
                            key = f"{kernel} {op}"
                            counts[key] = counts.get(key, 0) + 1
        mine = {k: n for k, n in counts.items() if k.split()[0] in needs}
        log(f"SASS of {os.path.basename(so)}: {mine}")
        for kernel, ops in needs.items():
            for op in ops:
                if not counts.get(f"{kernel} {op}"):
                    raise AssertionError(f"the {lib} library has no {op} in "
                                         f"{kernel}")
    return counts


def flash_on_route(K, torch, q, k, v, route: str):
    """One causal flash launch on ``route`` through the C entry point,
    bypassing the wrapper's route choice and its counts (to time the mma
    route at a shape that the wrapper sends to wgmma)."""
    out = torch.empty_like(q)
    bh, sq, d = q.shape
    err = K._library("flash_attention").flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, sq,
        k.shape[1], d, 1, d ** -0.5, 0, 0, 1 if q.dtype == torch.bfloat16
        else 0, K.FLASH_ROUTES[route], K._sm_count(q.device),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise AssertionError(f"flash {route} route refused: CUDA error {err}")
    return out


def profiled_kernels(torch, run, n: int = 5, tries: int = 3) -> dict:
    """Device ms of one launch by kernel name, from torch.profiler over
    ``n`` runs of ``run()``: each name's summed time over the launches the
    trace holds (the tracer may drop some). A trace that holds no device
    events is taken again, up to ``tries`` times ({} if none holds any)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                run()
            torch.cuda.synchronize()
        times = {}
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                t = times.setdefault(ev.name, [0.0, 0])
                t[0] += (ev.time_range.end - ev.time_range.start) / 1e3
                t[1] += 1
        if times:
            return {name: ms / k for name, (ms, k) in times.items()}
    return {}


def profiled_ms(torch, run, kernel: str):
    """Device ms of one ``run()`` in the kernels whose name holds
    ``kernel`` (:func:`profiled_kernels`), or None if the profiler saw
    none."""
    times = [ms for name, ms in profiled_kernels(torch, run).items()
             if kernel in name]
    return sum(times) if times else None


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def flash_entry(K, torch, gen, launches: int, by_route: dict) -> dict:
    """The flash kernel at the LM path's shape, (96, 1024, 64) causal. In
    bf16 (the entry, wgmma route): error against plain, the kernel line's
    time (CUDA events over back-to-back calls), the kernel's device time
    (torch.profiler), the mma route's (the earlier kernel's) times on the
    same inputs in turns with it, bound, and SDPA's time. In float32 (the
    ``float32`` sub-entry, simt route) the same beside SDPA with TF32 off;
    for both, SDPA's kernel (its backend) and its error against plain."""
    import torch.nn.functional as F
    bh, s, d = LM_BATCH * GPT2_SMALL["n_heads"], LM_SEQ, 64
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        q, k, v = (torch.randn(bh, s, d, device="cuda", generator=gen
                               ).to(dtype) for _ in range(3))
        route = K.flash_route(dtype, d, True)
        want = K.flash_attention_plain(q, k, v, causal=True).float()
        max_err = (K.flash_attention(q, k, v, causal=True).float()
                   - want).abs().max().item()

        def run():
            return K.flash_attention(q, k, v, causal=True)
        kernel_ms = cuda_time_ms(run)
        plain_ms = cuda_time_ms(
            lambda: K.flash_attention_plain(q, k, v, causal=True), iters=5)
        q4, k4, v4 = (t.view(LM_BATCH, GPT2_SMALL["n_heads"], s, d)
                      for t in (q, k, v))
        K.dot_precision()                  # no TF32 for the library either

        def sdpa():
            return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
        library_ms = cuda_time_ms(sdpa)
        sdpa_err = (sdpa().float().reshape(bh, s, d) - want
                    ).abs().max().item()
        sdpa_kernels = profiled_kernels(torch, sdpa)
        sdpa_kernel = (max(sdpa_kernels, key=sdpa_kernels.get)[:120]
                       if sdpa_kernels else "not measured")
        kernel = "flash_bf16_wgmma" if route == "wgmma" else "flash_f32"
        device_ms = profiled_ms(torch, run, kernel)
        nbytes = 4 * bh * s * d * q.element_size()
        ops = 4.0 * d * bh * (s * (s + 1) / 2)   # q.k and p.v on the triangle
        e = rows[name] = kernel_entry(
            "flash_attention", "parsec_tpu_torch/csrc/flash_attention.cu",
            "parsec_tpu/ops/pallas_kernels.py:329", launches, max_err,
            kernel_ms, plain_ms, nbytes, ops, name, library_ms)
        e.update(route=route, device_ms=device_ms, library_kernel=sdpa_kernel,
                 library_max_abs_err=sdpa_err)
        log(f"flash_attention {name} ({bh}, {s}, {d}) causal, {route} route:"
            f" kernel {kernel_ms:.4f} ms (device {fmt_ms(device_ms)}), plain "
            f"{plain_ms:.4f} ms, scaled_dot_product_attention "
            f"{library_ms:.4f} ms (kernel {sdpa_kernel}; max abs err "
            f"against plain {sdpa_err:.3e}), bound {e['bound_ms']:.4f} ms "
            f"({e['bound_by']}) -> {ops / kernel_ms / 1e9:.1f} TFLOP/s; max "
            f"abs err against plain {max_err:.3e}")
        if dtype == torch.bfloat16:
            # the mma route (the kernel this one replaced at d = 64) on the
            # same inputs, in turns: wgmma, mma, mma, wgmma
            mma_err = (flash_on_route(K, torch, q, k, v, "mma").float()
                       - want).abs().max().item()
            turns = [cuda_time_ms(fn) for fn in (
                run, lambda: flash_on_route(K, torch, q, k, v, "mma"),
                lambda: flash_on_route(K, torch, q, k, v, "mma"), run)]
            mma_device_ms = profiled_ms(
                torch, lambda: flash_on_route(K, torch, q, k, v, "mma"),
                "flash_bf16<")
            e.update(in_turns_with_mma_ms=turns, mma_device_ms=mma_device_ms,
                     mma_max_abs_err=mma_err)
            log(f"flash_attention bf16 in turns with the mma route on the "
                f"same inputs: wgmma {turns[0]:.4f}, mma {turns[1]:.4f}, mma "
                f"{turns[2]:.4f}, wgmma {turns[3]:.4f} ms; mma device "
                f"{fmt_ms(mma_device_ms)}, max abs err against plain "
                f"{mma_err:.3e}")
        del q, k, v, q4, k4, v4, want
    entry = rows["bfloat16"]
    entry["launches_by_route"] = by_route
    entry["float32"] = {k: rows["float32"][k] for k in
                        ("route", "max_abs_err", "ms", "device_ms",
                         "plain_ms", "bound_ms", "bound_by", "library_ms",
                         "library_kernel", "library_max_abs_err")}
    return entry


def tiles_of(torch, M) -> "torch.Tensor":
    """The newest copy of every tile of ``M``, assembled on the card."""
    return torch.cat([torch.cat([M.data_of(m, n).newest_copy().payload.to(
        "cuda") for n in range(M.nt)], dim=1) for m in range(M.mt)], dim=0)


def dtd_stencil(ptt, K, torch, ctx, dev) -> tuple:
    """The DTD 1D Jacobi stencil at N = 2^28, TS = 2^24, 8 iterations (f32);
    returns the kernel's launches on it and the slope (s a DAG). Raises
    when a check fails."""
    import torch.nn.functional as F
    from parsec_tpu_torch.ops.stencil import (insert_stencil1d_tasks,
                                              stencil_flops)
    N, TS, IT = STENCIL_N, STENCIL_TS, STENCIL_ITERS
    nt = N // TS
    w = (0.25, 0.5, 0.25)
    t0 = time.perf_counter()
    # made in bulk on the card; the tiles' home copies are views of it
    x0 = torch.randn(1, N, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(5))
    A = ptt.TiledMatrix("SA", 1, N, 1, TS, device="cuda")
    B = ptt.TiledMatrix("SB", 1, N, 1, TS, device="cuda")
    A.fill(lambda m, n: x0[:, n * TS:(n + 1) * TS])
    B.fill(lambda m, n: torch.zeros(1, TS, device="cuda"))
    torch.cuda.synchronize()
    log(f"DTD stencil f32 N=2^{N.bit_length() - 1} TS=2^"
        f"{TS.bit_length() - 1} ({nt} tiles) x {IT} iterations: A and B "
        f"{N * 4 / 2**30:.0f} GiB each, made on the card in "
        f"{time.perf_counter() - t0:.3f} s")
    counts = {"dags": 0, "inserted": 0, "insert_s": {}}

    def run_dags(n_dags: int) -> float:
        tp = ptt.DTDTaskpool(ctx, "stencil")
        t = time.perf_counter()
        for _ in range(n_dags):
            counts["inserted"] += insert_stencil1d_tasks(tp, A, B, IT, w)
        counts["insert_s"].setdefault(n_dags, []).append(
            time.perf_counter() - t)
        tp.wait(); tp.close(); ctx.wait()
        torch.cuda.synchronize()
        counts["dags"] += n_dags
        return time.perf_counter() - t

    K.stencil1d.launches = 0
    executed0 = dev.executed_tasks
    t_first = run_dags(1)
    # the first DAG against the plain version iterated over the whole row:
    # every element sees the same operations, so they agree bit for bit
    got = tiles_of(torch, A)                     # IT even: the result is in A
    want = x0
    for _ in range(IT):
        want = K.stencil1d_plain(want, None, None, w)
    exact = torch.equal(got, want)
    err = (got - want).abs().max().item()
    log(f"DTD stencil first DAG ({t_first:.3f} s) against {IT} plain "
        f"whole-row iterations: {'bit-exact' if exact else 'DIFFERS'} (max "
        f"abs err {err:.3e}), finite {bool(torch.isfinite(got).all())}")
    if not exact:
        raise AssertionError("the DTD stencil differs from the plain "
                             "whole-row iteration")
    del got, want
    st_s, t_lo, t_hi = slope(run_dags)
    launches = K.stencil1d.launches
    executed = dev.executed_tasks - executed0
    per_dag = nt * IT
    log(f"DTD stencil f32: T1 {t_lo * 1e3:.3f} ms, T3 {t_hi * 1e3:.3f} ms, "
        f"slope {st_s * 1e3:.3f} ms/DAG -> "
        f"{stencil_flops(N, IT) / 1e9 / st_s:.1f} GFLOP/s "
        f"({per_dag} tasks a DAG, {st_s / per_dag * 1e6:.1f} us a task)")
    log(f"stencil1d launches {launches} over {counts['dags']} DAGs "
        f"({launches / counts['dags']:.0f}/DAG), device executed {executed} "
        f"of {counts['inserted']} inserted tasks")
    if launches != per_dag * counts["dags"]:
        raise AssertionError(f"stencil1d launched {launches} times, expected "
                             f"{per_dag} per DAG")
    if executed != counts["inserted"]:
        raise AssertionError("not every stencil task ran on the CUDA device")
    ins = min(counts["insert_s"][1])
    bound_ms = IT * 2 * N * 4 / PEAK_BYTES_PER_S * 1e3
    log(f"DTD stencil breakdown: insertion {ins * 1e3:.3f} ms of the "
        f"one-DAG run's {t_lo * 1e3:.3f} ms; byte bound of a DAG "
        f"{bound_ms:.3f} ms ({IT} x (read + write) of {N * 4 / 2**30:.0f} "
        f"GiB at 3.35 TB/s)")
    log(idle_line("DTD stencil one DAG",
                  *device_profile(torch, lambda: run_dags(1))[:2]))
    K.dot_precision()                      # cuDNN without TF32
    wk = torch.tensor(w, device="cuda").view(1, 1, 3)

    def conv_iterations():
        y = x0.view(1, 1, N)
        for _ in range(IT):
            y = F.conv1d(y, wk, padding=1)
        return y
    conv_ms = cuda_time_ms(conv_iterations, iters=3, warmup=1)
    log(f"yardstick: {IT} x torch.nn.functional.conv1d over the zero-padded "
        f"row: {conv_ms:.3f} ms -> {stencil_flops(N, IT) / 1e6 / conv_ms:.1f}"
        f" GFLOP/s")
    del A, B, x0
    torch.cuda.empty_cache()
    return launches, st_s


def lu_test_matrix(torch, n: int, seed: int) -> "torch.Tensor":
    """2I + (G + 11^T)/sqrt(n), G standard normal, on the card: safe for LU
    without pivoting (the eigenvalues of 2I + G/sqrt(n) lie near the disk
    |z - 2| <= 1, and the rank-one term only adds sqrt(n) along the ones
    vector), and the all-ones term gives every tile's trailing update a
    coherent part, so that one update left out moves L U - A far past the
    gate (make_dd's diagonal of about n would hide it)."""
    g = torch.randn(n, n, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(seed))
    a = (g + 1.0) / math.sqrt(n)
    a.diagonal().add_(2.0)
    return a


class SkipOne:
    """A taskpool that leaves out the ``index``-th insert (from 1) of the
    task class named ``name``: a planted fault in a copy of a DAG."""

    def __init__(self, tp, name: str, index: int = 1) -> None:
        self.tp, self.name, self.index, self.seen = tp, name, index, 0

    def __getattr__(self, attr):
        return getattr(self.tp, attr)

    def insert_task(self, fn, *args, name=None, **kw):
        if name == self.name:
            self.seen += 1
            if self.seen == self.index:
                return None
        return self.tp.insert_task(fn, *args, name=name, **kw)


def factor_once(ptt, torch, ctx, insert, a, ts, name, skip=None) -> tuple:
    """One DAG of ``insert`` over a tiled copy of ``a`` (tiles on the card),
    optionally with one task left out; returns (the factored matrix
    assembled, tasks, seconds)."""
    n = a.shape[0]
    M = ptt.TiledMatrix(name, n, n, ts, ts, device="cuda")
    M.fill(lambda m, k: a[m * ts:(m + 1) * ts, k * ts:(k + 1) * ts])
    torch.cuda.synchronize()
    tp = ptt.DTDTaskpool(ctx, name)
    t = time.perf_counter()
    ntasks = insert(SkipOne(tp, *skip) if skip else tp, M)
    tp.wait(); tp.close(); ctx.wait()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    return tiles_of(torch, M), ntasks, secs


def lu_residual(torch, packed, a) -> float:
    """||L U - A||_F / ||A||_F in float64 on the card."""
    p = packed.double()
    lower = p.tril(-1)
    lower.diagonal().fill_(1.0)
    a64 = a.double()
    return (torch.linalg.norm(lower @ p.triu() - a64)
            / torch.linalg.norm(a64)).item()


def qr_residuals(torch, packed, a, ts) -> tuple:
    """(||R^T R - A^T A||_F / ||A^T A||_F in float64 on the card, the
    largest |entry| of the below-diagonal tiles over max|A|)."""
    r = packed.double().triu()
    a64 = a.double()
    ata = a64.mT @ a64
    resid = (torch.linalg.norm(r.mT @ r - ata) / torch.linalg.norm(ata)).item()
    n = a.shape[0]
    below = max(packed[m * ts:(m + 1) * ts, :m * ts].abs().max().item()
                for m in range(1, n // ts))
    return resid, below / a.abs().max().item()


def dtd_factorizations(ptt, K, torch, ctx, dev) -> None:
    """DTD getrf and geqrf at N = 8192, TS = 256 (f32): one DAG each after a
    small warm-up DAG, timed, held to its gate, and a copy of the DAG with
    one trailing update left out that the gate must reject. Raises when a
    check fails."""
    from parsec_tpu_torch.ops.geqrf import geqrf_flops, insert_geqrf_tasks
    from parsec_tpu_torch.ops.getrf import getrf_flops, insert_getrf_tasks
    N, TS = LU_N, LU_TS
    gate = N * 2.0 ** -24
    K.dot_precision()
    legs = (("getrf", insert_getrf_tasks, getrf_flops, "GEMM",
             lambda n, s: lu_test_matrix(torch, n, s)),
            ("geqrf", insert_geqrf_tasks, geqrf_flops, "TSMQR",
             lambda n, s: torch.randn(n, n, device="cuda",
                                      generator=torch.Generator(
                                          device="cuda").manual_seed(s))))
    for name, insert, flops, fault, make in legs:
        factor_once(ptt, torch, ctx, insert, make(4 * TS, 1), TS,
                    f"{name}-warm")                       # handles, caches
        a = make(N, 2)
        executed0 = dev.executed_tasks
        packed, ntasks, secs = factor_once(ptt, torch, ctx, insert, a, TS,
                                           name)
        if dev.executed_tasks - executed0 != ntasks:
            raise AssertionError(f"not every {name} task ran on the CUDA "
                                 f"device")
        bad, _, _ = factor_once(ptt, torch, ctx, insert, a, TS,
                                f"{name}-fault", skip=(fault, 1))
        if name == "getrf":
            resid, resid_bad = lu_residual(torch, packed, a), \
                lu_residual(torch, bad, a)
            extra, below_ok = "", True
            what = "||LU - A||_F / ||A||_F"
        else:
            (resid, below), (resid_bad, _) = qr_residuals(torch, packed, a,
                                                          TS), \
                qr_residuals(torch, bad, a, TS)
            below_ok = below <= 1e-3
            extra = f"; below-diagonal tiles at most {below:.3e} of max|A|"
            what = "||R^T R - A^T A||_F / ||A^T A||_F"
        finite = bool(torch.isfinite(packed).all())
        log(f"DTD {name} f32 N={N} TS={TS}: {ntasks} tasks, one DAG "
            f"{secs:.3f} s -> {flops(N) / 1e9 / secs:.1f} GFLOP/s "
            f"({secs / ntasks * 1e6:.1f} us a task); {what} = {resid:.3e} "
            f"(gate N 2^-24 = {gate:.3e}){extra}, finite {finite}")
        log(f"DTD {name} planted fault (the first {fault} task left out): "
            f"{what} = {resid_bad:.3e} -> "
            f"{'rejected' if resid_bad >= gate else 'NOT rejected'}")
        if not (resid < gate and below_ok and finite):
            raise AssertionError(f"DTD {name} fails its gate")
        if not resid_bad >= gate:
            raise AssertionError(f"the {name} gate passes a DAG with a "
                                 f"{fault} task left out")
        if name == "getrf":
            lib_ms = cuda_time_ms(
                lambda: torch.linalg.lu_factor(a, pivot=False), iters=3,
                warmup=1)
            lib = "torch.linalg.lu_factor(pivot=False)"
        else:
            lib_ms = cuda_time_ms(lambda: torch.linalg.qr(a, mode="r"),
                                  iters=3, warmup=1)
            lib = "torch.linalg.qr(mode='r')"
        log(f"yardstick {lib} of the whole {N}^2 matrix: {lib_ms:.3f} ms -> "
            f"{flops(N) / 1e6 / lib_ms:.1f} GFLOP/s")
        del a, packed, bad
        torch.cuda.empty_cache()


def dtd_apps(ptt, torch, ctx, dev) -> None:
    """The apps at the CPU tests' sizes on the card context, against numpy;
    raises when one disagrees, or when a tensor-body task (every task but
    merge sort's host-code ones) did not run on the CUDA device."""
    import functools
    from parsec_tpu_torch import apps

    def host(tile):
        return tile.data.newest_copy().payload.cpu().numpy()

    rng = np.random.default_rng(22)
    checks = {}
    executed0 = dev.executed_tasks
    tp = ptt.DTDTaskpool(ctx, "apps")
    chunks = [rng.standard_normal(17).astype(np.float32) for _ in range(5)]
    sorted_tile = apps.merge_sort(tp, chunks)
    n_host = tp.inserted            # the jit=False sort and merge tasks
    A2 = ptt.TiledMatrix("A2A", 1, 32, 1, 8)
    B2 = ptt.TiledMatrix("B2A", 1, 32, 1, 8)
    A2.fill(lambda m, n: np.full((1, 8), float(n + 1), np.float32))
    B2.fill(lambda m, n: np.zeros((1, 8), np.float32))
    apps.all2all(tp, A2, B2)
    PP = ptt.TiledMatrix("PP", 8, 4, 4, 4)
    PP.fill(lambda m, n: np.zeros((4, 4), np.float32))
    apps.pingpong(tp, PP, 7)
    leaves = [tp.tile_new(np.full((1,), float(i), np.float32))
              for i in range(8)]
    roots = apps.haar_transform(tp, leaves)
    vals = rng.standard_normal((13, 8)).astype(np.float32)
    red = apps.generalized_reduction(tp, [tp.tile_new(v) for v in vals])
    mats = [rng.standard_normal((4, 4)).astype(np.float32) * 0.5
            for _ in range(5)]
    prod = apps.generalized_reduction(tp, [tp.tile_new(m) for m in mats],
                                      op=lambda x, y: x @ y)
    n_card = tp.inserted - n_host
    tp.wait(); tp.close(); ctx.wait()
    torch.cuda.synchronize()
    on_card = dev.executed_tasks - executed0
    checks[f"{on_card} of {n_card} tensor tasks on the card"] = \
        on_card == n_card
    checks["merge sort"] = np.array_equal(host(sorted_tile),
                                          np.sort(np.concatenate(chunks)))
    checks["all2all"] = np.array_equal(B2.to_dense(), np.full((1, 32), 10.0))
    checks["pingpong"] = np.array_equal(
        PP.data_of(1, 0).newest_copy().payload.cpu().numpy(),
        np.full((4, 4), 7.0))
    checks["haar"] = np.allclose(host(roots[-1]), 3.5)
    checks["reduction"] = np.allclose(host(red), vals.sum(axis=0), rtol=1e-5,
                                      atol=1e-5)
    checks["ordered product"] = np.allclose(
        host(prod), functools.reduce(lambda x, y: x @ y, mats), rtol=1e-4,
        atol=1e-5)
    log("apps on the card: " + ", ".join(
        f"{k} {'ok' if v else 'WRONG'}" for k, v in checks.items()))
    if not all(checks.values()):
        raise AssertionError("an app disagrees with numpy on the card")


# the kernels whose launches a replayed graph is counted by (names in the
# device trace and in the graph's kernel nodes)
CHAIN_KERNEL, STENCIL_KERNEL = "chain_bf16_wgmma", "stencil1d_kernel"


def launches_in(counts: dict, kernel: str) -> int:
    """The counts (device events, graph nodes) of the kernels whose name
    holds ``kernel``."""
    return sum(n for name, n in counts.items() if kernel in name)


def check_mixed_chain(K, torch, gen) -> None:
    """``gemm_chain``'s mixed form, bf16 A and B with a float32 C, on its
    split, tile and general routes: a kernel launch on the route (counted),
    within rtol/atol 1e-4 of the plain version on unit-scale data (the
    float32 check), bit for bit on small integers."""
    for kt, m, k, n in ((17, 512, 512, 512), (4, 768, 256, 768),
                        (5, 64, 64, 20)):
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        route = K.chain_route(kt, m, k, n, k, m * k, 2, True, sms)
        s = k ** -0.25
        c = torch.randn(m, n, device="cuda", generator=gen)
        a = (torch.randn(kt, m, k, device="cuda", generator=gen) * s).bfloat16()
        b = (torch.randn(kt, k, n, device="cuda", generator=gen) * s).bfloat16()
        before = K.gemm_chain.launches_by_route[route]
        got = K.gemm_chain(c, a, b)
        want = K.gemm_chain_plain(c, a, b)
        err = (got - want).abs()
        bad = int((err > 1e-4 + 1e-4 * want.abs()).sum())
        ci, ai, bi = (torch.randint(lo, hi, sh, device="cuda", generator=gen)
                      for lo, hi, sh in ((-8, 9, (m, n)), (-4, 5, (kt, m, k)),
                                         (-4, 5, (kt, k, n))))
        ci, ai, bi = ci.float(), ai.bfloat16(), bi.bfloat16()
        exact = torch.equal(K.gemm_chain(ci, ai, bi),
                            K.gemm_chain_plain(ci, ai, bi))
        launched = K.gemm_chain.launches_by_route[route] - before
        log(f"kernel check gemm_chain mixed (bf16 A, B; float32 C) kt={kt} C "
            f"{m}x{n} k={k} ({route} route, {launched} launches): max abs "
            f"err {err.max().item():.3e}, {bad} beyond rtol/atol 1e-4; "
            f"integer data {'bit-exact' if exact else 'DIFFERS'}")
        if bad or not exact or launched != 2 or got.dtype != torch.float32:
            raise AssertionError(f"gemm_chain's mixed form disagrees with its "
                                 f"plain version on the {route} route")
        if (kt, m, k, n) == (17, 512, 512, 512):
            time_mixed_chain(K, torch, c, a, b, err.max().item())
    torch.cuda.synchronize()


def time_mixed_chain(K, torch, c, a, b, max_err: float) -> None:
    """The mixed form's times at its split-route shape, beside its bound
    (bf16 A and B read once, the float32 C read and written once, 2 kt m k
    n operations at the bf16 peak) and one PyTorch call of the same
    function where there is one: ``torch.addmm`` of the concatenated bf16
    stacks into the float32 C (``out_dtype``)."""
    kt, m, k = a.shape
    n = b.shape[2]
    kernel_ms = cuda_time_ms(lambda: K.gemm_chain(c, a, b))
    plain_ms = cuda_time_ms(lambda: K.gemm_chain_plain(c, a, b))
    a_cat = a.permute(1, 0, 2).reshape(m, kt * k)
    b_cat = b.reshape(kt * k, n)
    K.dot_precision()
    try:
        def library():
            return torch.addmm(c, a_cat, b_cat, out_dtype=torch.float32)
        lib_err = (library() - K.gemm_chain_plain(c, a, b)).abs().max().item()
        library_ms = cuda_time_ms(library)
        lib = (f"torch.addmm(out_dtype=float32) {library_ms:.4f} ms (max abs "
               f"err against plain {lib_err:.3e})")
    except (TypeError, RuntimeError) as e:
        library_ms = None
        lib = f"no single PyTorch call computes it here ({e})"
    nbytes = kt * (m * k + k * n) * a.element_size() + 2 * m * n * 4
    e = kernel_entry("gemm_chain", "", "", 0, max_err, kernel_ms, plain_ms,
                     nbytes, 2.0 * kt * m * k * n, "bfloat16", library_ms)
    log(f"gemm_chain mixed (bf16 A, B; float32 C) kt={kt} C {m}x{n} k={k}: "
        f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, {lib}; bound "
        f"{e['bound_ms']:.4f} ms ({e['bound_by']}: {nbytes / 1e6:.2f} MB, "
        f"{2.0 * kt * m * k * n / 1e9:.2f} GFLOP) ({smi_line()})")


def capture_line(what, mode, first_s, cap_s, slope_s, sched_s, busy, window,
                 flops=None) -> None:
    rate = (f" -> {flops / 1e9 / slope_s:.1f} GFLOP/s" if flops else "")
    cap = "not measured" if cap_s is None else f"{cap_s:.3f} s"
    log(f"{what} captured ({mode}): first DAG {first_s:.3f} s (warm-up run, "
        f"capture + instantiate {cap}), slope {slope_s * 1e3:.3f} ms/DAG"
        f"{rate}; scheduled slope {sched_s * 1e3:.3f} ms/DAG")
    log(idle_line(f"{what} captured ({mode}) one DAG", busy, window))


def host_split(ptt, torch, ctx, capture, insert) -> tuple:
    """Seconds of one captured DAG's insertion and of its ``wait()`` (the
    execution: staging, program lookup, the replay, landing, and the wait
    for the card), a warm program assumed."""
    torch.cuda.synchronize()
    tp = ptt.DTDTaskpool(ctx, "split", capture=capture)
    t0 = time.perf_counter()
    insert(tp)
    t1 = time.perf_counter()
    tp.wait()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    tp.close()
    ctx.wait()
    return t1 - t0, t2 - t1


def captured_gemm(ptt, K, torch, ctx, a_host, b_host, sched_s) -> int:
    """The DTD GEMM of phase 3 (bf16, N = 16384, TS = 512) captured, inline
    and with ``capture=True`` (the scan interpreter at 1024 tasks). Each
    strategy's first execution (its warm-up, then the capture) and a replay
    on another zero C (the graph's tiles handed over) are held bit for bit
    to one scheduled DAG (the same chain kernel); then its slope (every DAG
    a replay), capture time, and one replayed DAG under the profiler:
    device busy, idle share and the chain kernels the trace holds.
    Returns the chain kernel's launches: the wrapper's (the scheduled DAG,
    the warm-ups) and the replays' (the graph's chain kernel nodes times
    the replays run)."""
    from parsec_tpu_torch.data.matrix import collection_from_numpy
    from parsec_tpu_torch.dsl import capture as CAP
    from parsec_tpu_torch.ops.gemm import gemm_flops, insert_gemm_tasks
    N, TS = GEMM_N, GEMM_TS
    tiles = (N // TS) ** 2
    zeros = np.zeros((N, N), np.float32)
    A = collection_from_numpy("cA", a_host, TS, TS, dtype=torch.bfloat16)
    B = collection_from_numpy("cB", b_host, TS, TS, dtype=torch.bfloat16)

    def zero_c(tag):
        return collection_from_numpy(tag, zeros, TS, TS, dtype=torch.bfloat16)

    ran = [0]

    def dags(capture, C, n: int = 1):
        tp = ptt.DTDTaskpool(ctx, "cgemm", capture=capture)
        t = time.perf_counter()
        for _ in range(n):
            insert_gemm_tasks(tp, A, B, C, batch_k=True)
            tp.wait()
        tp.close()
        ctx.wait()
        torch.cuda.synchronize()
        ran[0] += n
        return tp, time.perf_counter() - t

    K.gemm_chain.launches = 0
    ref = zero_c("cS")
    dags(False, ref)
    want = tiles_of(torch, ref)
    del ref
    replayed = 0
    for capture, expect in (("inline", "inline"), (True, "scan")):
        ran[0] = 0
        C = zero_c(f"cC{capture}")
        tp, first_s = dags(capture, C)
        mode, cap_s = tp._capture.last_mode, tp._capture.last_capture_s
        same_first = torch.equal(tiles_of(torch, C), want)
        C2 = zero_c(f"cR{capture}")
        tp, _ = dags(capture, C2)
        same_replay = torch.equal(tiles_of(torch, C2), want)
        hit = tp._capture.cache_hit
        del C2
        log(f"DTD GEMM captured ({mode}): first execution "
            f"{'bit-exact' if same_first else 'DIFFERS'}, replay on other "
            f"tiles {'bit-exact' if same_replay else 'DIFFERS'} (program "
            f"cache hit {hit}) against the scheduled DAG")
        if mode != expect or not (same_first and same_replay and hit):
            raise AssertionError(f"the captured DTD GEMM ({mode}) is not the "
                                 f"scheduled one bit for bit")
        cap_slope, _, _ = slope(lambda n: dags(capture, C, n)[1])
        ins_s, exec_s = host_split(ptt, torch, ctx, capture, lambda tp:
                                   insert_gemm_tasks(tp, A, B, C,
                                                     batch_k=True))
        ran[0] += 1                              # host_split's replay
        nodes = launches_in(tp._capture.last_program.kernel_nodes(),
                            CHAIN_KERNEL)
        busy, window, by_name, counts = device_profile_counts(
            torch, lambda: dags(capture, C))
        n_chain = launches_in(counts, CHAIN_KERNEL)
        replayed += nodes * (ran[0] - 1)         # every DAG but the first
        capture_line("DTD GEMM bf16 N=16384 TS=512", mode, first_s, cap_s,
                     cap_slope, sched_s, busy, window, gemm_flops(N, N, N))
        log(f"  host time of one replayed DAG: insertion {ins_s * 1e3:.3f} "
            f"ms, wait() {exec_s * 1e3:.3f} ms (staging, program lookup, "
            f"replay launch, landing, until the card is done)")
        log(f"  the graph holds {nodes} chain kernel nodes ({tiles} tasks a "
            f"DAG), replayed {ran[0] - 1} times; the profiler's trace of one "
            f"replay holds {n_chain}; device ms by kernel:")
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:5]:
            log(f"  device {ms:8.3f} ms  {counts[name]:6d}x  {name[:90]}")
        if nodes != tiles:
            raise AssertionError("the GEMM graph does not hold one chain "
                                 "kernel a task")
        del C
        CAP._program_cache.clear()
        torch.cuda.empty_cache()
    return K.gemm_chain.launches + replayed


def captured_potrf(ptt, torch, ctx, spd, sched_s, chol_ms) -> None:
    """The DTD POTRF of phase 5 (f32, N = 8192, TS = 256) under the scan
    interpreter: the first execution and a replay each held to the
    residual gate, then the slope, capture time, device busy and idle
    share of one replayed DAG."""
    from parsec_tpu_torch.data.matrix import collection_from_numpy
    from parsec_tpu_torch.dsl import capture as CAP
    from parsec_tpu_torch.ops.potrf import insert_potrf_tasks, potrf_flops
    pN, pTS = POTRF_N, POTRF_TS
    spd_t = torch.from_numpy(spd)
    Pm = collection_from_numpy("Pcap", spd, pTS, pTS)
    A64 = spd_t.to("cuda", torch.float64)

    def dags(n: int = 1):
        Pm.fill(lambda m, k: spd_t[m * pTS:(m + 1) * pTS,
                                   k * pTS:(k + 1) * pTS])
        tp = ptt.DTDTaskpool(ctx, "cpotrf", capture="scan")
        t = time.perf_counter()
        for _ in range(n):
            insert_potrf_tasks(tp, Pm)
            tp.wait()
        tp.close()
        ctx.wait()
        torch.cuda.synchronize()
        return tp, time.perf_counter() - t

    def residual():
        L = torch.from_numpy(Pm.to_dense()).to("cuda", torch.float64).tril()
        return ((L @ L.mT - A64).abs().max() / A64.abs().max()).item()
    tp, first_s = dags()
    cap_s, mode = tp._capture.last_capture_s, tp._capture.last_mode
    r_first = residual()
    tp, _ = dags()
    r_replay, hit = residual(), tp._capture.cache_hit
    log(f"POTRF f32 N={pN} TS={pTS} captured ({mode}): max|LL^T - A| / max|A|"
        f" = {r_first:.3e} (first execution), {r_replay:.3e} (replay, program"
        f" cache hit {hit})")
    if mode != "scan" or not (r_first < 1e-5 and r_replay < 1e-5 and hit):
        raise AssertionError("the captured POTRF fails its residual gate")
    cap_slope, _, _ = slope(lambda n: dags(n)[1])
    ins_s, exec_s = host_split(ptt, torch, ctx, "scan",
                               lambda tp: insert_potrf_tasks(tp, Pm))
    busy, window = device_profile(torch, dags)[:2]
    capture_line(f"DTD POTRF f32 N={pN} TS={pTS}", mode, first_s, cap_s,
                 cap_slope, sched_s, busy, window, potrf_flops(pN))
    log(f"  host time of one replayed DAG: insertion {ins_s * 1e3:.3f} ms, "
        f"wait() {exec_s * 1e3:.3f} ms")
    log(f"  yardstick torch.linalg.cholesky_ex of the whole matrix: "
        f"{chol_ms:.3f} ms")
    CAP._program_cache.clear()
    torch.cuda.empty_cache()


def capture_gates(ptt, K, torch, ctx) -> None:
    """The 256-size gates of phase 4 in capture mode (``capture=True``,
    and the POTRF gate under scan as well)."""
    from parsec_tpu_torch.data.matrix import collection_from_numpy
    from parsec_tpu_torch.dsl import capture as CAP
    from parsec_tpu_torch.ops.gemm import insert_gemm_tasks
    from parsec_tpu_torch.ops.potrf import insert_potrf_tasks, make_spd
    rng = np.random.default_rng(3)
    ga = rng.standard_normal((256, 2048)).astype(np.float32)
    gb = rng.standard_normal((2048, 256)).astype(np.float32)
    mats = [collection_from_numpy(f"q{k}", x, 64, 64) for k, x in
            (("A", ga), ("B", gb), ("C", np.zeros((256, 256), np.float32)))]
    tp = ptt.DTDTaskpool(ctx, "cgate-kt32", capture=True)
    insert_gemm_tasks(tp, *mats, batch_k=True)
    tp.wait(); tp.close(); ctx.wait()
    ref = ga.astype(np.float64) @ gb.astype(np.float64)
    rel = np.abs(mats[2].to_dense() - ref).max() / np.abs(ref).max()
    log(f"gate f32 GEMM 256x2048x256 captured ({tp._capture.last_mode}): max "
        f"err / max |ref| = {rel:.3e}")
    if rel >= 1e-5:
        raise AssertionError("captured f32 kt=32 GEMM gate failed")
    a256 = rng.standard_normal((256, 256)).astype(np.float32)
    b256 = rng.standard_normal((256, 256)).astype(np.float32)
    mats = [collection_from_numpy(f"q{k}s", x, 64, 64) for k, x in
            (("A", a256), ("B", b256), ("C", np.zeros((256, 256), np.float32)))]
    tp = ptt.DTDTaskpool(ctx, "cgate-gemm", capture=True)
    insert_gemm_tasks(tp, *mats, batch_k=True)
    tp.wait(); tp.close(); ctx.wait()
    err = np.abs(mats[2].to_dense() - a256 @ b256).max()
    log(f"gate GEMM 256 captured ({tp._capture.last_mode}): max err {err:.2e}")
    if err >= 1e-2:
        raise AssertionError(f"captured GEMM 256 gate failed: {err}")
    spd_s = make_spd(256, seed=11)
    for capture in (True, "scan"):
        Ps = collection_from_numpy(f"qP{capture}", spd_s, 64, 64)
        tp = ptt.DTDTaskpool(ctx, "cgate-potrf", capture=capture)
        insert_potrf_tasks(tp, Ps)
        tp.wait(); tp.close(); ctx.wait()
        Ls = np.tril(Ps.to_dense())
        perr = np.abs(Ls @ Ls.T - spd_s).max()
        log(f"gate POTRF 256 captured ({tp._capture.last_mode}): max err "
            f"{perr:.2e}")
        if perr >= 1e-2:
            raise AssertionError(f"captured POTRF 256 gate failed: {perr}")
    CAP._program_cache.clear()


def captured_stencil(ptt, K, torch, ctx, sched_s) -> int:
    """The DTD stencil of phase 7 (f32, N = 2^28, TS = 2^24, 8 iterations)
    captured with ``capture=True`` (scan at 128 tasks) and inline. For each
    strategy the tiles are filled on the caller's stream with no
    synchronize (the execution orders itself after that stream), and the
    first DAG (warm-up + capture) and a second one on refilled tiles (a
    replay of the kept graph) are each held bit for bit to the plain
    whole-row iteration; then the graph's stencil kernel nodes (one a
    task), the slope beside the scheduled one and the DAG's byte bound,
    capture time, and one replayed DAG under the profiler (device busy,
    idle share, the stencil kernels the trace holds). Returns the stencil
    kernel's launches: the wrapper's (the warm-ups) and the replays' (the
    graph's stencil nodes times the replays run)."""
    from parsec_tpu_torch.dsl import capture as CAP
    from parsec_tpu_torch.ops.stencil import insert_stencil1d_tasks
    N, TS, IT = STENCIL_N, STENCIL_TS, STENCIL_ITERS
    nt = N // TS
    x0 = torch.randn(1, N, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(5))
    want = x0
    for _ in range(IT):
        want = K.stencil1d_plain(want, None, None)
    A = ptt.TiledMatrix("CSA", 1, N, 1, TS, device="cuda")
    B = ptt.TiledMatrix("CSB", 1, N, 1, TS, device="cuda")
    ran = [0]

    def dags(capture, n: int = 1):
        tp = ptt.DTDTaskpool(ctx, "cstencil", capture=capture)
        t = time.perf_counter()
        for _ in range(n):
            insert_stencil1d_tasks(tp, A, B, IT)
            tp.wait()
        tp.close()
        ctx.wait()
        torch.cuda.synchronize()
        ran[0] += n
        return tp, time.perf_counter() - t

    K.stencil1d.launches = 0
    replayed = 0
    bound_ms = IT * 2 * N * 4 / PEAK_BYTES_PER_S * 1e3
    for capture, expect in ((True, "scan"), ("inline", "inline")):
        ran[0] = 0
        exact = []
        for run in ("first", "replay"):
            # the tiles' own copies of x0 (capture writes tiles in place),
            # made on the caller's stream
            A.fill(lambda m, n: x0[:, n * TS:(n + 1) * TS].clone())
            B.fill(lambda m, n: torch.zeros(1, TS, device="cuda"))
            tp, t = dags(capture)
            if run == "first":
                first_s = t
                mode, cap_s = tp._capture.last_mode, tp._capture.last_capture_s
            else:
                hit = tp._capture.cache_hit
            exact.append(torch.equal(tiles_of(torch, A), want))
        log(f"DTD stencil captured ({mode}) against {IT} plain whole-row "
            f"iterations, tiles filled on the caller's stream unsynchronized:"
            f" first DAG {'bit-exact' if exact[0] else 'DIFFERS'}, replay on "
            f"refilled tiles {'bit-exact' if exact[1] else 'DIFFERS'} "
            f"(program cache hit {hit})")
        if mode != expect or not all(exact) or not hit:
            raise AssertionError("the captured DTD stencil differs from the "
                                 "plain whole-row iteration")
        nodes = launches_in(tp._capture.last_program.kernel_nodes(),
                            STENCIL_KERNEL)
        cap_slope, _, _ = slope(lambda n: dags(capture, n)[1])
        busy, window, _, counts = device_profile_counts(
            torch, lambda: dags(capture))
        n_st = launches_in(counts, STENCIL_KERNEL)
        replayed += nodes * (ran[0] - 1)         # every DAG but the first
        capture_line("DTD stencil f32 N=2^28", mode, first_s, cap_s,
                     cap_slope, sched_s, busy, window)
        log(f"  the graph holds {nodes} stencil kernel nodes ({nt * IT} "
            f"tasks a DAG), replayed {ran[0] - 1} times; the profiler's "
            f"trace of one replay holds {n_st} stencil kernels; byte bound "
            f"of a DAG {bound_ms:.3f} ms")
        if nodes != nt * IT:
            raise AssertionError("the stencil graph does not hold one "
                                 "stencil kernel a task")
        CAP._program_cache.clear()
    del A, B, x0, want
    torch.cuda.empty_cache()
    return K.stencil1d.launches + replayed


def kernel_entry(name, source, replaces, launches, max_err, kernel_ms,
                 plain_ms, nbytes, ops, dtype, library_ms) -> dict:
    """One entry of the kernels line; the bound is the larger of the bytes
    over the memory rate and the operations over the dtype's peak."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max_err,
        "max_err": max_err,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
    }


def stencil_entry(K, torch, gen, launches: int) -> dict:
    """The stencil kernel at the DTD path's tile, (1, 2^24) float32 with both
    halos: error against plain, times, bound."""
    import torch.nn.functional as F
    cols = STENCIL_TS
    x, left, right = (torch.randn(1, cols, device="cuda", generator=gen)
                      for _ in range(3))
    w = (0.25, 0.5, 0.25)
    max_err = (K.stencil1d(x, left, right, w)
               - K.stencil1d_plain(x, left, right, w)).abs().max().item()
    kernel_ms = cuda_time_ms(lambda: K.stencil1d(x, left, right, w))
    plain_ms = cuda_time_ms(lambda: K.stencil1d_plain(x, left, right, w))
    K.dot_precision()
    xpad = torch.cat([left[:, -1:], x, right[:, :1]], dim=1).view(1, 1, -1)
    wk = torch.tensor(w, device="cuda").view(1, 1, 3)
    library_ms = cuda_time_ms(lambda: F.conv1d(xpad, wk))
    # x read once, the two halo columns, out written once
    entry = kernel_entry("stencil1d", "parsec_tpu_torch/csrc/stencil1d.cu",
                         "parsec_tpu/ops/pallas_kernels.py:273", launches,
                         max_err, kernel_ms, plain_ms, (2 * cols + 2) * 4,
                         5.0 * cols, "float32", library_ms)
    log(f"stencil1d f32 (1, 2^24) with halos: kernel {kernel_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, conv1d {library_ms:.4f} ms, bound "
        f"{entry['bound_ms']:.4f} ms ({entry['bound_by']}) -> "
        f"{(2 * cols + 2) * 4 / kernel_ms / 1e9:.3f} TB/s")
    return entry


def matmul_main(K, torch, gen) -> dict:
    """The blocked matmul's path, its entry point at bf16 8192^3 (32
    roundings a product) and f32 4096^3, 256^3 blocks: one launch each with
    the count set to 0 just before, each output held against the plain
    version (:func:`hold_matmul`), then kernel, plain and torch.matmul
    timed. Returns the kernels line's entry: bf16, the f32 figures beside."""
    runs = []
    K.matmul.launches = 0
    K.matmul.launches_by_route = dict.fromkeys(K.CHAIN_ROUTES, 0)
    for n, dtype in ((MATMUL_N, torch.bfloat16),
                     (MATMUL_F32_N, torch.float32)):
        a = torch.randn(n, n, device="cuda", generator=gen).to(dtype)
        b = torch.randn(n, n, device="cuda", generator=gen).to(dtype)
        runs.append((a, b, K.matmul(a, b)))
    torch.cuda.synchronize()
    launches = K.matmul.launches
    by_route = dict(K.matmul.launches_by_route)
    log(f"matmul entry point: {launches} launches, by route {by_route}")
    rows = {}
    while runs:
        a, b, got = runs.pop(0)
        n, name = a.shape[0], str(a.dtype).replace("torch.", "")
        max_err = hold_matmul(K, torch, a, b, got, (256, 256, 256), gen,
                              f"matmul entry point {name}")
        del got
        kernel_ms = cuda_time_ms(lambda: K.matmul(a, b), iters=5, warmup=1)
        plain_ms = cuda_time_ms(lambda: K.matmul_plain(a, b), iters=3,
                                warmup=1)
        library_ms = cuda_time_ms(lambda: torch.matmul(a, b), iters=5,
                                  warmup=1)
        rows[name] = kernel_entry(
            "matmul", "parsec_tpu_torch/csrc/gemm_chain.cu",
            "parsec_tpu/ops/pallas_kernels.py:219", launches, max_err,
            kernel_ms, plain_ms, 3 * n * n * a.element_size(),
            2.0 * n ** 3, name, library_ms)
        e = rows[name]
        log(f"matmul {name} {n}^3 block 256^3: kernel {kernel_ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, torch.matmul {library_ms:.4f} ms, "
            f"bound {e['bound_ms']:.4f} ms ({e['bound_by']}) -> "
            f"{2.0 * n ** 3 / kernel_ms / 1e9:.1f} TFLOP/s; max abs err "
            f"against plain {max_err:.3e}")
        del a, b
    entry = rows["bfloat16"]
    entry["launches_by_route"] = by_route
    entry["float32_4096"] = {k: rows["float32"][k] for k in
                             ("max_abs_err", "ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms")}
    return entry


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    import parsec_tpu_torch as ptt
    from parsec_tpu_torch import native as NATIVE
    from parsec_tpu_torch.core import pins as pins_mod
    from parsec_tpu_torch.data.matrix import collection_from_numpy
    from parsec_tpu_torch.device.cuda import CUDADevice
    from parsec_tpu_torch.dsl.dtd import PTDTD_STATS
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
    names = ("gemm_chain", "flash_attention", "stencil1d")
    lanes = ("ptdtd", "ptsched")         # the host lanes: C++, no device code
    py_h = os.path.join(sysconfig.get_paths()["include"], "Python.h")
    log(f"Python headers for the host lanes: {py_h} "
        f"{'present' if os.path.exists(py_h) else 'MISSING'}")
    # one compiler process per source (nvcc for the kernels, the host C++
    # compiler for the lanes), all started together
    with ThreadPoolExecutor(len(names) + len(lanes)) as pool:
        jobs = [pool.submit(K.build, n) for n in names] + \
            [pool.submit(NATIVE.build, s) for s in lanes]
        for job in jobs:
            job.result()
    log(f"built {', '.join(names)} (nvcc) and _{', _'.join(lanes)} "
        f"({' '.join(NATIVE.cxx())}) in {time.perf_counter() - t0:.3f} s")
    for stem in lanes:
        for line in NATIVE.build_log.get(stem, "").splitlines():
            log(f"c++ {stem}: {line}")
    for name in names:
        for line in K.build_log.get(name, "").splitlines():
            log(f"nvcc {name}: {line}")
        # C7518: ptxas serialised the wgmma pipeline; C7508: it ignored a
        # setmaxnreg
        if any(w in K.build_log.get(name, "") for w in ("C7518", "C7508")):
            raise AssertionError(f"ptxas serialised {name}'s wgmmas")
    sass_check(K)
    gen = torch.Generator(device="cuda").manual_seed(0)
    # the split route (C 512^2 and 256 x 512), the tile route (36 output
    # tiles) and the general route (a 36-byte bf16 / 72-byte float32 pitch)
    for dtype in (torch.float32, torch.bfloat16):
        before = dict(K.gemm_chain.launches_by_route)
        for kt, m, k, n in ((17, 512, 512, 512), (32, 512, 512, 512),
                            (32, 256, 128, 512), (4, 768, 256, 768),
                            (5, 64, 64, 18)):
            check_gemm_chain(K, torch, dtype, kt, m, k, n, gen)
        moved = {r: K.gemm_chain.launches_by_route[r] - before[r]
                 for r in before}
        log(f"kernel checks gemm_chain {str(dtype)[6:]}: launches by route "
            f"{moved}")
        if not all(moved.values()):
            raise AssertionError("the gemm_chain checks missed a route")
    check_flash(K, torch, gen)
    check_stencil1d(K, torch, gen)
    check_matmul(K, torch, gen)
    check_mixed_chain(K, torch, gen)
    # the device module sizes its tile budget from the memory free when the
    # context starts: hand the checks' cached blocks back first
    torch.cuda.empty_cache()

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
    #: (native, PINS on) -> [DAGs, chain launches, of them on the split
    #: route]: each engine's runs, with and without the split's PINS
    #: callbacks, keep a launch count of their own
    by_lane = {}

    def run_dags(n_dags: int, native: bool = True, split=None) -> float:
        """``n_dags`` GEMM DAGs in one pool on the engine asked for (the
        native per-task lane by default); every task is checked to have
        taken it, and the chain launches the run made are added to its
        lane's count. With ``split``, its phases are timed."""
        before = PTDTD_STATS.snapshot()
        l0 = K.gemm_chain.launches
        s0 = K.gemm_chain.launches_by_route["split"]
        with dtd_engine(ptt, native):
            tp = ptt.DTDTaskpool(ctx, "gemm")
            if split is not None:
                split.wrap(tp, "_cuda_submit", "submit")
                split.push("insert")
            t = time.perf_counter()
            n = 0
            for _ in range(n_dags):
                n += insert_gemm_tasks(tp, A, B, C, batch_k=True)
            if split is not None:
                split.pop()
            counts["insert_s"].setdefault((n_dags, native), []).append(
                time.perf_counter() - t)
            tp.wait()
            tp.close()
            ctx.wait()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
        check_lane(tp, ctx, before, n, native, "DTD GEMM")
        lane = by_lane.setdefault((native, split is not None), [0, 0, 0])
        lane[0] += n_dags
        lane[1] += K.gemm_chain.launches - l0
        lane[2] += K.gemm_chain.launches_by_route["split"] - s0
        counts["inserted"] += n
        counts["dags"] += n_dags
        return secs

    K.gemm_chain.launches = 0
    K.gemm_chain.launches_by_route = dict.fromkeys(K.CHAIN_ROUTES, 0)
    executed0 = dev.executed_tasks
    t_warm = run_dags(1)            # stages the tiles in
    gemm_slopes = slopes_in_turns(run_dags)
    gemm_s, t_lo, t_hi = gemm_slopes[True]
    tiles = (N // TS) ** 2
    for native, (s_, lo_, hi_) in gemm_slopes.items():
        log(f"DTD GEMM bf16 N={N} TS={TS} kt={kt}, {engine_name(native)}: "
            f"warm {t_warm:.3f} s, T1 {lo_:.3f} s, T3 {hi_:.3f} s, slope "
            f"{s_ * 1e3:.1f} ms/DAG -> {gemm_flops(N, N, N) / 1e9 / s_:.1f} "
            f"GFLOP/s ({smi})")
    log(f"DTD GEMM: every one of the {tiles} tasks a DAG took the engine "
        f"asked for (PTDTD_STATS delta, the engine's id map empty after)")
    # the two engines' C, bit for bit: the same bodies in the same per-tile
    # chain order, from a zero C each
    zero = torch.zeros(TS, TS, dtype=torch.bfloat16)
    got = {}
    for native in (True, False):
        C.fill(lambda m, n: zero)
        run_dags(1, native)
        got[native] = tiles_of(torch, C)
    same = torch.equal(got[True], got[False])
    log(f"DTD GEMM one DAG from a zero C: native lane and Python engine "
        f"{'bit-identical' if same else 'DIFFER'}")
    if not same:
        raise AssertionError("the DTD GEMM's C differs between the native "
                             "lane and the Python engine")
    del got
    # the host time of a task by phase, one DAG under each engine, then the
    # slopes with the split's PINS callbacks on (beside the slopes above)
    split = HostSplit(pins_mod, ctx, dev)
    for native in (True, False):
        split.reset()
        wall = run_dags(1, native, split)
        log(split.line(f"DTD GEMM {engine_name(native)}", wall, tiles)
            + f" ({smi})")
    pins_slopes = slopes_in_turns(
        lambda n_, native: run_dags(n_, native, split))
    split.detach()
    for native in (True, False):
        log(f"DTD GEMM {engine_name(native)} slope with PINS on (the split's "
            f"callbacks) {pins_slopes[native][0] * 1e3:.1f} ms/DAG, off "
            f"{gemm_slopes[native][0] * 1e3:.1f} ms/DAG ({smi})")
    executed = dev.executed_tasks - executed0
    for (native, pins), (dags, n_l, n_split) in sorted(by_lane.items()):
        log(f"gemm_chain launches on the {engine_name(native)}, PINS "
            f"{'on' if pins else 'off'}: {n_l} over {dags} DAGs "
            f"({n_l / dags:.0f}/DAG, {n_split} on the split route)")
        if n_l != tiles * dags:
            raise AssertionError(
                f"gemm_chain launched {n_l} times on the "
                f"{engine_name(native)}, expected {tiles} per DAG")
        if n_split != n_l:
            raise AssertionError("the DTD GEMM's chains did not all take "
                                 "the split route (TMA + wgmma)")
    if sum(lane[1] for lane in by_lane.values()) != K.gemm_chain.launches:
        raise AssertionError("gemm_chain launched outside the DTD GEMM runs")
    # the main path's count: the native lane's scheduled DAGs, PINS off;
    # the other lanes' counts stand beside it in the kernels line
    launches = by_lane[(True, False)][1]
    lane_launches = {
        f"{'native' if native else 'python'}{'_pins' if pins else ''}": n_l
        for (native, pins), (_, n_l, _) in by_lane.items()}
    gemm_by_route = dict.fromkeys(K.CHAIN_ROUTES, 0)
    gemm_by_route["split"] = launches
    log(f"device executed {executed} of {counts['inserted']} inserted tasks")
    if executed != counts["inserted"]:
        raise AssertionError("not every task ran on the CUDA device")
    # one DAG (1024 tasks) fits the insert window: its insertion runs alone,
    # before tp.wait() drains the ready queue (with 3 DAGs the window
    # stalls interleave insertion and execution)
    ins = min(counts["insert_s"][(1, True)])
    log(f"DTD GEMM breakdown: insertion {ins * 1e3:.1f} ms of the one-DAG "
        f"run's {t_lo * 1e3:.1f} ms; the card waits during it")
    busy, window, by_name = device_profile(torch, lambda: run_dags(1))
    log(idle_line("DTD GEMM one DAG", busy, window))

    def device_ms(*keys):
        return sum(ms for name, ms in by_name.items()
                   if any(key in name for key in keys))
    log(f"DTD GEMM device time a task ({tiles} tasks): chain phase 1 "
        f"{device_ms('chain_bf16_wgmma') / tiles * 1e3:.2f} us, phase 2 "
        f"{device_ms('ordered_sum') / tiles * 1e3:.2f} us, torch.stack "
        f"copies {device_ms('CatArrayBatchedCopy') / tiles * 1e3:.2f} us "
        f"(2 stacks of {kt} tiles), device busy {busy / tiles * 1e3:.2f} us")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        log(f"  device {ms:8.3f} ms  {name[:100]}")
    a_dev = torch.from_numpy(a_host).to("cuda", torch.bfloat16)
    b_dev = torch.from_numpy(b_host).to("cuda", torch.bfloat16)
    mm_ms = cuda_time_ms(lambda: torch.matmul(a_dev, b_dev), iters=5)
    log(f"yardstick torch.matmul bf16 {N}^3: {mm_ms:.3f} ms -> "
        f"{gemm_flops(N, N, N) / 1e6 / mm_ms:.1f} GFLOP/s")
    del a_dev, b_dev, A, B, C

    # ---- 3b. the same DAG captured (its chain launches join the path's)
    launches += captured_gemm(ptt, K, torch, ctx, a_host, b_host, gemm_s)
    del a_host, b_host

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
    capture_gates(ptt, K, torch, ctx)

    # ---- 5. scheduled DTD POTRF -----------------------------------------
    pN, pTS = POTRF_N, POTRF_TS
    spd = make_spd(pN, seed=7)
    spd_t = torch.from_numpy(spd)
    Pm = collection_from_numpy("Pbench", spd, pTS, pTS)
    ptasks = {"n": 0}

    def run_potrf(n_dags: int, native: bool = True) -> float:
        """Repeated in-place factorizations in one pool: WAW chains
        serialize the reps (refactoring a factor is numerical nonsense, but
        op count and dataflow are identical). Every task is checked to have
        taken the engine asked for."""
        Pm.fill(lambda m, k: spd_t[m * pTS:(m + 1) * pTS,
                                   k * pTS:(k + 1) * pTS])
        before = PTDTD_STATS.snapshot()
        with dtd_engine(ptt, native):
            tp = ptt.DTDTaskpool(ctx, "potrf")
            t = time.perf_counter()
            for _ in range(n_dags):
                ptasks["n"] = insert_potrf_tasks(tp, Pm)
            tp.wait(); tp.close(); ctx.wait()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
        check_lane(tp, ctx, before, ptasks["n"] * n_dags, native,
                   "DTD POTRF")
        return secs

    run_potrf(1)
    L = torch.from_numpy(Pm.to_dense()).to("cuda", torch.float64).tril()
    A64 = spd_t.to("cuda", torch.float64)
    resid = ((L @ L.mT - A64).abs().max() / A64.abs().max()).item()
    log(f"POTRF f32 N={pN} TS={pTS}: {ptasks['n']} tasks/DAG, "
        f"max|LL^T - A| / max|A| = {resid:.3e}")
    if not resid < 1e-5:
        raise AssertionError(f"POTRF residual check failed: {resid}")
    del L, A64
    potrf_slopes = slopes_in_turns(run_potrf)
    potrf_s = potrf_slopes[True][0]
    spd_dev = spd_t.to("cuda")
    chol_ms = cuda_time_ms(lambda: torch.linalg.cholesky_ex(spd_dev), iters=5)
    for native, (s_, lo_, hi_) in potrf_slopes.items():
        log(f"DTD POTRF f32 N={pN} TS={pTS}, {engine_name(native)}: T1 "
            f"{lo_:.3f} s, T3 {hi_:.3f} s, slope {s_ * 1e3:.1f} ms/DAG -> "
            f"{potrf_flops(pN) / 1e9 / s_:.1f} GFLOP/s (yardstick "
            f"torch.linalg.cholesky_ex: {chol_ms:.3f} ms) ({smi})")
    got = {}
    for native in (True, False):
        run_potrf(1, native)
        got[native] = tiles_of(torch, Pm)
    same = torch.equal(got[True], got[False])
    log(f"DTD POTRF: every one of the {ptasks['n']} tasks a DAG took the "
        f"engine asked for; one DAG's factor, native lane and Python "
        f"engine: {'bit-identical' if same else 'DIFFER'}")
    if not same:
        raise AssertionError("the DTD POTRF factor differs between the "
                             "native lane and the Python engine")
    del got
    del spd_dev
    captured_potrf(ptt, torch, ctx, spd, potrf_s, chol_ms)
    ctx.fini()

    # ---- 6. LM serving at GPT-2 small width ----------------------------
    flash_launches, flash_by_route = lm_serving(K, torch)

    # ---- 7. the stencil and the other tile algorithms, on a new context
    # (after the earlier paths, which so run as they did before them) -----
    ctx = ptt.Context(nb_cores=1)
    dev = next(d for d in ctx.devices.devices if isinstance(d, CUDADevice))
    stencil_launches, stencil_s = dtd_stencil(ptt, K, torch, ctx, dev)
    stencil_launches += captured_stencil(ptt, K, torch, ctx, stencil_s)
    dtd_factorizations(ptt, K, torch, ctx, dev)
    dtd_apps(ptt, torch, ctx, dev)
    ctx.fini()

    # ---- 8. the blocked matmul's entry point, held and timed ------------
    matmul = matmul_main(K, torch, gen)

    # ---- 9. kernel line at the main paths' shapes -----------------------
    kernels = [gemm_chain_entry(K, torch, gen, launches, gemm_by_route),
               flash_entry(K, torch, gen, flash_launches, flash_by_route),
               stencil_entry(K, torch, gen, stencil_launches),
               matmul]
    kernels[0]["launches_by_lane"] = lane_launches
    for e in kernels:
        if not e["launches"]:
            raise AssertionError(f"{e['name']} was not launched on its path")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
