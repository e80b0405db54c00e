#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``parsec_tpu_torch``) on one card.

    python3 chip_smoke.py

Builds the hand-written kernels from ``parsec_tpu_torch/csrc`` with nvcc,
holds each against its plain PyTorch version, then drives the port's main
path through the entry points a user calls: the DTD tiled GEMM (bf16,
N = 16384 in 512 x 512 tiles, so every GEMM_K task runs the ``gemm_chain``
kernel over a k-chain of 32) and the DTD tiled Cholesky (f32, N = 8192 in
256 x 256 tiles), with the 256-size correctness gates of the reference
benchmark. Every phase that fails ends the run with a nonzero exit code.

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

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

GEMM_N, GEMM_TS = 16384, 512         # kt = 32: every GEMM_K task hits the kernel
POTRF_N, POTRF_TS = GEMM_N // 2, GEMM_TS // 2
REPS = 2


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


def device_busy_ms(torch, run) -> float:
    """Device time summed over every kernel and copy of one ``run()``
    under torch.profiler (0.0 when the trace holds no device events)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    total_us = 0.0
    for ev in prof.key_averages():
        total_us += getattr(ev, "self_device_time_total",
                            getattr(ev, "self_cuda_time_total", 0.0))
    return total_us / 1e3


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
    K.build("gemm_chain")
    log(f"built gemm_chain in {time.perf_counter() - t0:.3f} s")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for kt, m, k, n in ((17, 512, 512, 512), (32, 512, 512, 512),
                            (32, 256, 128, 512)):
            check_gemm_chain(K, torch, dtype, kt, m, k, n, gen)

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
    busy_ms = device_busy_ms(torch, lambda: run_dags(1))
    log(f"DTD GEMM one DAG under torch.profiler: device busy "
        + (f"{busy_ms:.1f} ms" if busy_ms else "not measured (no device "
           "events in the trace)"))
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

    # ---- 6. kernel line at the main path's shape ------------------------
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
    }]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
