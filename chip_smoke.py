#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``parsec_tpu_torch``) on one card.

    python3 chip_smoke.py

Builds the hand-written kernels from ``parsec_tpu_torch/csrc`` with nvcc (one
nvcc per source, all started together; a build whose wgmmas ptxas
serialised fails the run), checks with ``cuobjdump -sass`` that the
chain's bf16 kernel and the flash kernel's wgmma route run on Hopper's
tensor-core and TMA instructions (HGMMA, UTMALDG) and the float32 kernels
on cp.async (LDGSTS), reads with ``cuobjdump -res-usage`` the registers and
spills of the flash kernels built at 256 (wgmma, which must hold 168
registers without spills) and of the float32 kernel, holds each kernel
against its plain
PyTorch version (``gemm_chain`` on its tile, split and general routes,
``flash_attention`` on its wgmma, mma, simt and chunked routes, at head
dims from 1 to 1000), then drives the
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
  64 tokens and at 4;
* the PTG frontend on a card context (``compile_ptg(src).instantiate(ctx,
  ...)``, ``ctx.add_taskpool``, ``ctx.wait()``): the reference benchmark's
  PTG legs on the native execution lane (``csrc/ptexec.cpp``, built with
  the host C++ compiler beside the other lanes) and on the Python FSM in
  turns — INIT plus 1024 CTL chains of 8 (8193 tasks), EP with 20000
  flowless tasks (agglomerated, scheduled FSM, scheduled native) and
  data-flow chains 512 x 16 (the written-back tiles bit for bit the same;
  the native runs fuse a region a chain) — each native run required to
  have engaged the lane; then the PTG GEMM with a ``[type=CUDA]`` body
  (f32, N = 8192 in 512 x 512 tiles, 4096 tasks, TF32 off) in three modes:
  (a) the native device lane (``csrc/ptdev.cpp``) with its k-chains fused
  into device regions, each run eagerly on the lane's stream (one
  dispatch of its members' launches), (b) the device lane per task
  (``--mca region_fusion 0``), (c) the interpreted FSM on the CUDA device
  module (``--mca device_native 0``): each held to ``torch.matmul`` (max
  err / max|ref| < 1e-5; (a) on the DAG whose regions are cold and on one
  that reuses them), (b) and (c) and (a) compared bit for bit, the cost
  model's one exploration of the CPU twin spent in the warm-up and held to
  the device leg, then each mode's slope in turns, and for one profiled
  DAG of each its device busy time, idle share and the lanes', coherency
  table's, cost model's and regions' counters; the placement of every
  pool, the cost of a completion poll, and a device region's two forms
  (eager, the lane's, and a CUDA graph, which the lane does not take)
  timed on one DAG's regions;
* the observability substrate on those paths, on a context made with
  ``--mca profile_enabled 1`` (the tracer dumps its file at ``fini``,
  which the phase reads back), ``hist_enabled`` and the stall watchdog:
  the DTD GEMM traced on the native lane (C bit for bit the untraced
  DAG's, one matched exec span a task on the device module's stream, the
  engine ring's landed events plus its drops equal to what it recorded,
  the last memory event equal to the module's residency), the PTG GEMM in
  modes (a) and (b) with the lanes' rings (C bit for bit, the device
  lane's ring equal to its counters), the histograms counting every task,
  ``/metrics`` and ``/health`` served in process on port 0 and equal to
  the lanes' stats, no watchdog trip; and the overheads, reported and not
  gated: the reference benchmark's tracing and histogram legs on the PTG
  chain shape, the DTD GEMM slope with the tracer on and off and mode
  (a)'s with the rings on and off, each in turns;
* the rest of the single-rank substrate (phase 11), on one context at the
  POTRF cell's width: ``compose`` of a redistribution (f32 8192², 512²
  tiles, into a symmetric lower collection of 256² tiles, 528 fragment
  tasks) and a POTRF on the result (5984 tasks), no POTRF task before the
  first stage completed, the copy bit for bit and the factor's residual
  held; redistribution with unaligned offsets (bit for bit the plain
  slice) and the whole-tile reshuffle (every payload moved by reference,
  no memory grown); four recursive-device tasks, each factoring a 4096²
  tile by a nested POTRF over its subtile view; the collection helpers
  (apply, map_operator, the reductions, broadcast) bit for bit a plain
  pass, and ``diag_band_to_rect`` of the factor; a checkpoint of the
  factor restored onto the card bit for bit; the backend probe, from its
  subprocess and then cached; and ``flash_attention`` at head dims 80,
  256 and 512 (the chunked route; also f32 at (16, 1024, 512) and (96,
  1024, 64)) timed beside SDPA (d = 256 bf16 also in turns with the
  kernel it replaced, the mma route), with a 2-layer LM at head dim 80 (n_embd 1280, 16 heads)
  through the flash core against the dense core;
* distribution on the task path (phase 12), every rank on the one card
  with a tile budget of its own: the DTD GEMM of phase 3 on two in-process
  ranks joined by the d2d backend (``comm/d2d.py``; its C bit for bit the
  single-rank DAG's, the B half a rank lacks moved card to card with no
  host materialization, both slopes); the DTD POTRF of phase 5 on two OS
  processes over TCP (``comm/tcp.py``, forkserver ranks) with ``--mca
  comm_device_mem 1`` (CUDA IPC pulls, ``comm/xhost.py``; residual < 1e-5,
  every pin retired) and without (the factor bit for bit the same, the
  host bounces counted); the reference bench's 2-rank PTG legs through the
  native comm lane (``csrc/ptcomm.cpp``) and through ``remote_dep.py`` in
  turns; and the 2-rank PTG GEMM with a ``[type=CUDA]`` body (f32, N =
  8192) against ``torch.matmul``;
* training on the card (phase 13, run right after the LM serving phase,
  before the large traces of phases 9-12): (a) gradients of the GPT-2
  small LM at depth 2 (B = 4, S = 1024) through the flash kernel, which
  autograd differentiates through the dense expression's backward, held
  to the dense core's in f32 (simt route) and with bf16 compute (wgmma
  route), every block's ``wqkv`` gradient nonzero; (b) all 12 layers (B =
  8, bf16 compute, f32 masters, remat, clip + AdamW, the flash core) for
  20 steps fed by ``PrefetchLoader(token_batches(...))`` from a seeded
  low-entropy Markov corpus (the loss must fall by 1 nat; 24 flash
  launches a step), then the step's time with the flash, dense and SDPA
  cores in turns, one profiled step and peak memory; (d) a checkpoint
  saved after step 10 and restored, one step from each copy bit for bit
  equal; (e) ``xla_trace`` around 2 steps, the trace holding the flash
  kernel's device events and the steps' ranges; (c) the MoE-LM (4 layers,
  8 experts, k = 2) for 5 SGD steps on the dense routed path, and
  ``moe_forward`` on a one-device expert group at capacity factor 1.0
  against ``dense_reference``, its drops the host's numbering's;
* the serving fabric (phase 14): (a) the credit wire, the plane's
  remote window and a 3-rank gateway in process; (b) the reference's
  acceptance program on two OS processes with CPU rank contexts (victim
  p99 within 2x of unloaded over at most three attempts, shares within
  25% of 2:1, no frame error); (c) a serving rank's death mid-window; (d)
  a serving rank whose control context is a card context, each request a
  bf16 GEMM_K task (C 512², kt = 32) on the card through a fabric-owned
  KIND_EXT plane pool: one ``gemm_chain`` launch a request, every C tile
  the plain chain's bit for bit; then the mesh telemetry plane over the
  fabric: (e) its acceptance program on two OS processes (CPU rank
  contexts, ``--mca tel_interval_ms 25``), held to the reference test's
  assertions: rank 0's pushed rollup equal to each rank's own served
  counters, the reconciler in push mode with no HTTP fetch, one flight
  record ``flight-r1-*`` for a stall forced on rank 1 and rank 0's
  watchdog clean; (f) (d)'s card leg with the plane pushing every 25 ms,
  in turns with it off: every tile bit for bit, the rollup equal to each
  rank's own counts, no HTTP fetch, requests a second on and off;
* the package's entry points (phase 15): ``python -m parsec_tpu_torch
  --devices`` (the CUDA device module on ``cuda:0``) and ``--help-mca``
  (``tel_interval_ms`` listed), and the EP scaling row
  (``launch.ep_scaling_rates``) at P = 1, 2, 4 OS processes with card rank
  contexts beside ``cpu_budget()``, then P = 1 on a CPU context and on a
  card context in turns;
* meshes on the one card (phase 16): a gloo group of 8 ranks, every one on
  the card (``multihost.RankPool``), running the collectives' probe, GPT-2
  small's AdamW step over dp 2 x tp 4, Ulysses (the flash kernel on each
  rank) and the ring, the sp, pp and ep steps, and the SPMD GEMMs and
  POTRF;
* mesh capture (phase 17) on the same group over a 2 x 4 mesh: a bf16 DTD
  GEMM window (N = 8192, TS = 256, kt = 32: every body a ``gemm_chain``
  launch on the rank that owns its C tile) run by ``wait_mesh`` twice, the
  first C bit for bit the window captured inline on one card, the second
  run a cached plan; then the f32 DTD POTRF (the POTRF cell's shape) over
  the mesh, held to its residual gate and to the one-card capture.

Every phase that fails ends the run with a nonzero exit code. At its
end, and when it fails, the script stops every process it started and
waits for each (the TCP ranks' forkserver among them).

Output: one line per measurement, then the card's name and power limit as
nvidia-smi gives them, then ``{"kernels": [...]}`` (one entry per ported
kernel: launches on the main path, error against the plain version, times
and bound; the chain's entry counts the native lane's scheduled DAGs and
the replays, with each engine's count, PINS on and off, beside it under
``launches_by_lane``; flash's entry also its profiled device time, its
launches by route, the mma route's times in turns with it, a float32
sub-entry, the ``head_dims`` rows at d = 80, 256 and 512 (and float32 64),
the mma route's times at d = 256 in turns under ``in_turns``, and the new
kernels' ptxas ``resources``; its launches
include the head-dim-80 LM's and the training steps' (its ``training``
sub-entry); the chain's ``distributed`` lane counts the
2-rank GEMM's launches, its ``serving`` lane phase 14 (d)'s and
(f)'s, its ``mesh_capture`` lane phase 17's), and last ``{"ok": true, "device":
{...}}``.

Needs one CUDA card; exits nonzero without one.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import struct
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


def become_subreaper() -> None:
    """Make this process the parent of every orphan among its descendants
    (Linux ``PR_SET_CHILD_SUBREAPER``), so that :func:`stop_children` also
    finds a process whose own parent exited before it."""
    import ctypes
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(36, 1, 0, 0, 0) != 0:      # PR_SET_CHILD_SUBREAPER
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_CHILD_SUBREAPER)")


def _children() -> list:
    """(pid, state, command) of each process whose parent is this one."""
    me, out = os.getpid(), []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                stat = f.read()
        except OSError:
            continue                          # exited while we looked
        cmd = stat[stat.index("(") + 1:stat.rindex(")")]
        state, ppid = stat[stat.rindex(")") + 2:].split()[:2]
        if int(ppid) == me:
            out.append((int(name), state, cmd))
    return out


def stop_children(grace_s: float = 5.0) -> list:
    """Stop every process this one started and is still running, and wait
    for each: the forkserver of the TCP ranks and its resource tracker
    first, as they ask to be stopped, then whatever is left, with SIGTERM
    and, after ``grace_s``, SIGKILL. With :func:`become_subreaper` in force
    the orphans of exited children are among them. Returns the commands of
    the processes it had to signal."""
    import signal
    if "parsec_tpu_torch.comm.tcp" in sys.modules:
        sys.modules["parsec_tpu_torch.comm.tcp"].stop_forkserver()
    signalled, deadline = [], time.monotonic() + grace_s
    while True:
        with contextlib.suppress(ChildProcessError):
            while os.waitpid(-1, os.WNOHANG)[0]:
                pass                          # reap the ones that exited
        live = [(pid, cmd) for pid, state, cmd in _children() if state != "Z"]
        if not live:
            return signalled
        sig = signal.SIGKILL if time.monotonic() > deadline else signal.SIGTERM
        for pid, cmd in live:
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, sig)
            if cmd not in signalled:
                signalled.append(cmd)
        time.sleep(0.05)


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
        # a record_function range on the device's rows (torch.optim's
        # step is one) spans kernels and the gaps between them: not work
        if ev.device_type != DeviceType.CUDA or \
                getattr(ev, "is_user_annotation", False):
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
# bf16 takes the wgmma route at head dims 33-256 that are multiples of 8
# (past 128 the kernel built at 256), the mma route at the others (up to
# 256), float32 the simt route (the tiled kernel, built up to 1024), and
# either dtype the chunked route past 256; a head dim between built sizes
# runs the next one's instantiation, its extra columns zero-filled as they
# load
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
    "d=1 causal ragged": ((2, 70, 1), (2, 90, 1), True, 20, 0, 0),
    "d=8": ((2, 100, 8), (2, 100, 8), False, 0, 0, 0),
    "d=48 ring offset": ((2, 200, 48), (2, 260, 48), True, 60, 0, 0),
    "d=80 causal": ((16, 1024, 80), (16, 1024, 80), True, 0, 0, 0),
    "d=80 all-masked block": ((1, 128, 80), (1, 128, 80), True, 0, 128,
                              128),
    "d=96 ragged": ((2, 130, 96), (2, 190, 96), False, 0, 0, 0),
    "d=200 causal": ((2, 150, 200), (2, 150, 200), True, 0, 0, 0),
    "d=256 causal": ((4, 512, 256), (4, 512, 256), True, 0, 0, 0),
    "d=256 offsets": ((2, 129, 256), (2, 300, 256), True, 171, 0, 0),
    "d=136 ragged": ((2, 200, 136), (2, 333, 136), False, 0, 0, 0),
    "d=256 all-masked block": ((1, 128, 256), (1, 128, 256), True, 0, 128,
                               128),
    "d=256 offsets and sq != sk": ((2, 257, 256), (2, 190, 256), True, 40,
                                   72, 32),
    "d=250 causal offsets": ((2, 100, 250), (2, 130, 250), True, 30, 0, 0),
    # past one 256-column step: the chunked route
    "d=257 causal offsets": ((2, 130, 257), (2, 150, 257), True, 20, 0, 0),
    "d=320 all-masked block": ((1, 128, 320), (1, 128, 320), True, 0, 64,
                               64),
    "d=512 causal": ((4, 512, 512), (4, 512, 512), True, 0, 0, 0),
    "d=512 ragged": ((1, 64, 512), (1, 100, 512), False, 0, 0, 0),
    "d=1000 causal offsets": ((1, 70, 1000), (1, 90, 1000), True, 20, 0,
                              0),
    # past 1024: float32 reloads its q tile a 1024-column step
    "d=1100 causal offsets": ((1, 40, 1100), (1, 60, 1100), True, 20, 0,
                              0),
}
#: the timing rows beside the LM path's head dim 64, (dtype, bh, d) at
#: sequence 1024, causal: Phi-2's 80 and Gemma's 256 at the LM path's bh
#: in bf16, d = 512 (the chunked route) in bf16 at that bh and in float32
#: at bh 16, and the LM path's float32 shape
FLASH_TIMED = (("bfloat16", 96, 80), ("bfloat16", 96, 256),
               ("bfloat16", 96, 512), ("float32", 16, 512),
               ("float32", 96, 64))
#: the rows timed in turns with the kernel their route replaced: d = 256
#: bf16 with the mma route of the same library (``flash_variants.py`` times
#: the float32 rows in turns with the float32 kernel the tiled one replaced)
FLASH_TURNED = (("bfloat16", 96, 256),)


def flash_kernel_name(route: str, dtype: str, d: int) -> str:
    """The device kernel's name prefix on a flash route (torch.profiler)."""
    if dtype == "float32":
        return "flash_f32_tiled<"
    if route == "chunked":
        return "flash_bf16<256, true>"
    if route == "wgmma":
        return "flash_bf16_wgmma256" if d > 128 else "flash_bf16_wgmma<"
    return "flash_bf16<"


def sdpa_view(t, bh: int):
    """(bh, s, d) as SDPA's (batch, heads, s, d): the LM path's 12 heads,
    else one batch of bh heads."""
    h = GPT2_SMALL["n_heads"] if bh % GPT2_SMALL["n_heads"] == 0 else bh
    return t.view(bh // h, h, *t.shape[-2:])


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
    "flash_attention": {"flash_bf16_wgmma": ("HGMMA", "UTMALDG"),
                        "flash_bf16_wgmma256": ("HGMMA", "UTMALDG"),
                        "flash_f32_tiled": ("LDGSTS",)},
}


def sass_check(K) -> dict:
    """The SASS of the libraries that the wrappers load, by kernel: the
    chain's bf16 tile/split kernel and the flash wgmma kernels must hold
    HGMMA and UTMALDG, the chain's and flash's float32 kernels LDGSTS.
    Returns the counts; raises when one is missing."""
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


def flash_resources(K) -> dict:
    """ptxas's resources of flash_bf16_wgmma256 and flash_f32_tiled, from
    ``cuobjdump -res-usage`` of the built library: registers a thread and
    the stack frame (where ptxas puts spilled registers: a kernel that
    spills has one, and none otherwise) of flash_bf16_wgmma256 and of each
    flash_f32_tiled<D>. Raises when the wgmma256 kernel spills or holds
    other than the 168 registers a thread that its setmaxnreg transfer is
    sized for (its launcher refuses it then)."""
    tool = os.path.join(os.path.dirname(K.nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-res-usage", K.build("flash_attention")],
                          capture_output=True, text=True, check=True).stdout
    rows, name = {}, None
    for line in text.splitlines():
        if "Function" in line:
            name = line.split("Function", 1)[1].strip().rstrip(":")
        elif "REG:" in line and name:
            fields = dict(f.split(":", 1) for f in line.split() if ":" in f)
            tiled = re.search(r"flash_f32_tiledILi(\d+)E", name)
            key = ("flash_bf16_wgmma256" if "flash_bf16_wgmma256" in name
                   else f"flash_f32_tiled<{tiled.group(1)}>" if tiled
                   else None)
            if key:
                rows[key] = {"registers": int(fields["REG"]),
                             "stack_bytes": int(fields.get("STACK", 0))}
            name = None
    log("ptxas resources of the new flash kernels (cuobjdump -res-usage): "
        + "; ".join(f"{k} {v['registers']} registers, a {v['stack_bytes']} B "
                    f"stack frame (spills)" for k, v in sorted(rows.items())))
    w = rows.get("flash_bf16_wgmma256")
    if w is None or w["stack_bytes"] or w["registers"] != 168:
        raise AssertionError(f"flash_bf16_wgmma256's resources {w}: not 168 "
                             f"registers without spills")
    return rows


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


def profile_session(torch, run, n: int):
    """The events of one torch.profiler session over ``n`` runs of
    ``run()`` and a synchronize."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    return prof.events()


def profiled_kernels(torch, run, n: int = 5, tries: int = 3) -> dict:
    """Device ms of one launch by kernel name, from torch.profiler over
    ``n`` runs of ``run()``: each name's summed time over the launches the
    trace holds (the tracer may drop some). A trace that holds no device
    events is taken again, up to ``tries`` times ({} if none holds any)."""
    from torch.autograd import DeviceType
    for i in range(tries):
        events = profile_session(torch, run, n)
        times = {}
        for ev in events:
            if ev.device_type == DeviceType.CUDA:
                t = times.setdefault(ev.name, [0.0, 0])
                t[0] += (ev.time_range.end - ev.time_range.start) / 1e3
                t[1] += 1
        if times:
            return {name: ms / k for name, (ms, k) in times.items()}
        launch_calls = sum(1 for ev in events if "LaunchKernel" in ev.name)
        log(f"torch.profiler: try {i + 1} of {tries} held no device events "
            f"({len(events)} host events, {launch_calls} kernel-launch "
            f"calls among them)")
    return {}


def profiler_probe(torch, where: str, sessions: int = 3) -> None:
    """Whether torch.profiler sees the card's kernels at this point of the
    script: how many of ``sessions`` short sessions (two small matmuls, the
    library's kernel) hold device events. In a fresh process every one
    does; after the script's large traces most hold none (PERF.md)."""
    from torch.autograd import DeviceType
    x = torch.ones(256, 256, device="cuda")
    seen = sum(
        any(ev.device_type == DeviceType.CUDA
            for ev in profile_session(torch, lambda: x @ x, 2))
        for _ in range(sessions))
    log(f"torch.profiler probe {where}: device events in {seen} of "
        f"{sessions} sessions")


def profiled_ms(torch, run, kernel: str):
    """Device ms of one ``run()`` in the kernels whose name holds
    ``kernel`` (:func:`profiled_kernels`), or None if the profiler saw
    none."""
    times = [ms for name, ms in profiled_kernels(torch, run).items()
             if kernel in name]
    return sum(times) if times else None


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def flash_device_times(K, torch) -> dict:
    """torch.profiler's device times at the LM path's flash shape, (96,
    1024, 64) causal, taken right after the kernel checks, before the
    script's large traces: after those the tracer loses most short
    sessions' device events (:func:`profiler_probe`). For bf16 and float32:
    the kernel's device ms on its route and SDPA's kernel (its backend);
    for bf16 also the mma route's device ms. Then the FLASH_TIMED rows, and
    for the FLASH_TURNED ones the kernel in turns with the mma route and
    SDPA: kernel line and device ms of each, and each one's max abs err
    against the plain version. These launches come before the main path's
    counts are set to 0."""
    import torch.nn.functional as F
    bh, s, d = LM_BATCH * GPT2_SMALL["n_heads"], LM_SEQ, 64
    gen = torch.Generator(device="cuda").manual_seed(11)
    K.dot_precision()                      # no TF32 for the library either
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        q, k, v = (torch.randn(bh, s, d, device="cuda", generator=gen
                               ).to(dtype) for _ in range(3))
        q4, k4, v4 = (t.view(LM_BATCH, GPT2_SMALL["n_heads"], s, d)
                      for t in (q, k, v))
        route = K.flash_route(dtype, d, True)
        kernel = flash_kernel_name(route, name, d)
        sdpa_kernels = profiled_kernels(
            torch, lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                          is_causal=True))
        row = out[name] = {
            "device_ms": profiled_ms(
                torch, lambda: K.flash_attention(q, k, v, causal=True),
                kernel),
            "library_kernel": (max(sdpa_kernels, key=sdpa_kernels.get)[:120]
                               if sdpa_kernels else "not measured")}
        if dtype == torch.bfloat16:
            row["mma_device_ms"] = profiled_ms(
                torch, lambda: flash_on_route(K, torch, q, k, v, "mma"),
                "flash_bf16<")
        log(f"flash_attention {name} ({bh}, {s}, {d}) causal under "
            f"torch.profiler after the kernel checks: {route} route device "
            f"{fmt_ms(row['device_ms'])}"
            + (f", mma route device {fmt_ms(row['mma_device_ms'])}"
               if "mma_device_ms" in row else "")
            + f"; scaled_dot_product_attention's kernel "
            f"{row['library_kernel']}")
        del q, k, v, q4, k4, v4
    for name, bh_, hd in FLASH_TIMED:
        dt = getattr(torch, name)
        q, k, v = (torch.randn(bh_, s, hd, device="cuda", generator=gen
                               ).to(dt) for _ in range(3))
        q4, k4, v4 = (sdpa_view(t, bh_) for t in (q, k, v))
        route = K.flash_route(dt, hd, True)
        kernel = flash_kernel_name(route, name, hd)
        sdpa_kernels = profiled_kernels(
            torch, lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                          is_causal=True))
        out[f"{name} d={hd}"] = row = {
            "route": route,
            "device_ms": profiled_ms(
                torch, lambda: K.flash_attention(q, k, v, causal=True),
                kernel),
            "library_device_ms": (max(sdpa_kernels.values())
                                  if sdpa_kernels else None),
            "library_kernel": (max(sdpa_kernels, key=sdpa_kernels.get)[:120]
                               if sdpa_kernels else "not measured")}
        log(f"flash_attention {name} ({bh_}, {s}, {hd}) causal under "
            f"torch.profiler: {route} route device "
            f"{fmt_ms(row['device_ms'])}; scaled_dot_product_attention "
            f"device {fmt_ms(row['library_device_ms'])} (kernel "
            f"{row['library_kernel']})")
        if (name, bh_, hd) in FLASH_TURNED:
            row.update(flash_turns(K, torch, q, k, v, q4, k4, v4, route))
        del q, k, v, q4, k4, v4
    return out


def flash_turns(K, torch, q, k, v, q4, k4, v4, route) -> dict:
    """The kernel in turns with the one it replaced (the mma route of the
    same library) and SDPA on the same inputs: the kernel line of each
    (new, old, old, new, SDPA, SDPA), the device ms of each (new, old, new,
    old), and each one's max abs err against the plain version."""
    import torch.nn.functional as F
    name = str(q.dtype).replace("torch.", "")
    d = q.shape[-1]

    def new_fn():
        return K.flash_attention(q, k, v, causal=True)

    def old_fn():
        return flash_on_route(K, torch, q, k, v, "mma")

    def sdpa():
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    want = K.flash_attention_plain(q, k, v, causal=True).float()
    errs = [(fn().float().reshape(want.shape) - want).abs().max().item()
            for fn in (new_fn, old_fn, sdpa)]
    line = [cuda_time_ms(fn) for fn in (new_fn, old_fn, old_fn, new_fn,
                                        sdpa, sdpa)]
    dev = [profiled_ms(torch, fn, kern) for fn, kern in (
        (new_fn, flash_kernel_name(route, name, d)), (old_fn, "flash_bf16<"),
        (new_fn, flash_kernel_name(route, name, d)), (old_fn, "flash_bf16<"))]
    label = "the mma route (flash_bf16<256, false>)"
    log(f"flash_attention {name} {tuple(q.shape)} causal in turns with "
        f"{label}: kernel line new {line[0]:.4f}, old {line[1]:.4f}, old "
        f"{line[2]:.4f}, new {line[3]:.4f}, SDPA {line[4]:.4f}, "
        f"{line[5]:.4f} ms; device new {fmt_ms(dev[0])}, old "
        f"{fmt_ms(dev[1])}, new {fmt_ms(dev[2])}, old {fmt_ms(dev[3])}; max "
        f"abs err against plain new {errs[0]:.3e}, old {errs[1]:.3e}, SDPA "
        f"{errs[2]:.3e}")
    return {"in_turns": {"replaced": label, "ms": line[0:4:3],
                         "replaced_ms": line[1:3], "library_ms": line[4:6],
                         "device_ms": dev[0::2], "replaced_device_ms":
                         dev[1::2], "max_abs_err": errs[0],
                         "replaced_max_abs_err": errs[1],
                         "library_max_abs_err": errs[2]}}


def flash_entry(K, torch, gen, launches: int, by_route: dict,
                device_times: dict) -> dict:
    """The flash kernel at the LM path's shape, (96, 1024, 64) causal. In
    bf16 (the entry, wgmma route): error against plain, the kernel line's
    time (CUDA events over back-to-back calls), the mma route's (the
    earlier kernel's) times on the same inputs in turns with it, bound, and
    SDPA's time. In float32 (the ``float32`` sub-entry, simt route) the
    same beside SDPA with TF32 off; for both, SDPA's error against plain,
    and from ``device_times`` (:func:`flash_device_times`) the device times
    and SDPA's kernel (its backend)."""
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
        device_ms = device_times[name]["device_ms"]
        sdpa_kernel = device_times[name]["library_kernel"]
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
            mma_device_ms = device_times[name]["mma_device_ms"]
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


def tiles_of(torch, M, device: str = "cuda") -> "torch.Tensor":
    """The newest copy of every stored tile of ``M`` assembled on
    ``device``, zeros where ``M`` stores no tile."""
    out = torch.zeros(M.lm, M.ln, dtype=M.dtype, device=device)
    for m in range(M.mt):
        for n in range(M.nt):
            if not M.stored(m, n):
                continue
            r, c = M.tile_shape(m, n)
            out[m * M.mb:m * M.mb + r, n * M.nb:n * M.nb + c] = \
                torch.as_tensor(M.data_of(m, n).newest_copy().payload
                                )[:r, :c].to(device)
    return out


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


# the reference benchmark's PTG legs (bench.py:643-745, 959-990): the EP
# flowless class, the data-flow chains and the CTL chains gated by INIT
PTG_EP_SRC = "%global NT\nEP(i)\n  i = 0 .. NT-1\nBODY\n  pass\nEND\n"
PTG_EP_N = 20000
PTG_DF_SRC = (
    "%global NT\n%global DEPTH\n%global descX\n%global descY\n"
    "T(i, l)\n  i = 0 .. NT-1\n  l = 0 .. DEPTH-1\n"
    "  RW X <- (l == 0) ? descX(0, i) : X T(i, l-1)\n"
    "       -> (l < DEPTH-1) ? X T(i, l+1) : descY(0, i)\n"
    "BODY\n  pass\nEND\n")
PTG_DF_NT, PTG_DF_DEPTH = 512, 16
PTG_CHAIN_SRC = (
    "%global NT\n%global DEPTH\n"
    "INIT(z)\n  z = 0 .. 0\n"
    "  CTL S -> (DEPTH >= 1) ? S T(1 .. NT, 1)\nBODY\n  pass\nEND\n\n"
    "T(i, l)\n  i = 1 .. NT\n  l = 1 .. DEPTH\n"
    "  CTL S <- (l == 1) ? S INIT(0) : S T(i, l-1)\n"
    "        -> (l < DEPTH) ? S T(i, l+1)\nBODY\n  pass\nEND\n")
PTG_CHAIN_NT, PTG_CHAIN_DEPTH = 1024, 8
# the reference's PTG GEMM (tests/test_ptg.py GEMM_SRC) with its body in
# torch; f32, 16 x 16 x 16 tiles of 512^2 (N = 8192): 4096 tasks over three
# 256 MiB matrices on the card
PTG_GEMM_SRC = """
%global MT
%global NT
%global KT
%global descA
%global descB
%global descC

GEMM(m, n, k)
  m = 0 .. MT-1
  n = 0 .. NT-1
  k = 0 .. KT-1
  : descC(m, n)
  priority = KT - k
  READ A <- descA(m, k)
  READ B <- descB(k, n)
  RW   C <- (k == 0) ? descC(m, n) : C GEMM(m, n, k-1)
       -> (k < KT-1) ? C GEMM(m, n, k+1) : descC(m, n)
BODY [type=CUDA]
  C = C + torch.matmul(A, B)
END
"""
PTG_GEMM_T, PTG_GEMM_TS = 16, 512


@contextlib.contextmanager
def ptg_mode(ptt, native: bool = True, agglomerate: bool = True):
    """PTG pools added in the block take the native execution lane
    (``native``) or the Python FSM (``--mca ptg_native_exec 0``), with or
    without the agglomerated sweep of flowless classes."""
    if not native:
        ptt.mca.set("ptg_native_exec", False)
    if not agglomerate:
        ptt.mca.set("ptg_agglomerate", False)
    try:
        yield
    finally:
        ptt.mca.params.unset("ptg_native_exec")
        ptt.mca.params.unset("ptg_agglomerate")


def ptg_lane(ptt, torch, ctx, smi, device: str = "cuda") -> None:
    """Phase 9: the PTG frontend on the card context, through
    ``compile_ptg(src).instantiate(ctx, ...)``, ``ctx.add_taskpool`` and
    ``ctx.wait()``: the reference benchmark's chain, EP and data-flow legs
    on the native execution lane and on the Python FSM, in turns, each
    native run required to have engaged the lane (the data-flow chains fuse
    one region a chain); then the PTG GEMM with a ``[type=CUDA]`` body in
    its three modes (:func:`ptg_gemm_modes`).
    ``device`` is where the tensors and collections live: the card, or the
    CPU for a rehearsal on a CPU context with the CUDA device module over
    the CPU (``--mca device_cuda_over_cpu 1``) at cut sizes."""
    import statistics
    from parsec_tpu_torch.device.cuda import CUDADevice
    from parsec_tpu_torch.dsl.ptg.compiler import PTEXEC_STATS, compile_ptg
    t_phase = time.perf_counter()
    if ctx.sched_plane is None:
        raise AssertionError("the card context has no scheduler plane")
    dev = next(d for d in ctx.devices.devices if isinstance(d, CUDADevice))

    def timed(prog, globals_, collections, n_tasks, native, agglomerate=True,
              name="ptg"):
        """One pool run to completion: (tasks/s, the PTEXEC_STATS delta).
        A native run must have engaged the lane, an FSM run must not."""
        s0 = PTEXEC_STATS.snapshot()
        with ptg_mode(ptt, native, agglomerate):
            tp = prog.instantiate(ctx, globals=globals_,
                                  collections=collections, name=name)
            t0 = time.perf_counter()
            ctx.add_taskpool(tp)
            ctx.wait(timeout=600)
            secs = time.perf_counter() - t0
        d = PTEXEC_STATS.delta(s0)
        lane = native and not (agglomerate and getattr(tp, "_agglomerated",
                                                       0))
        if d["pools_engaged"] != int(lane):
            raise AssertionError(
                f"PTG {name}: pools_engaged rose by {d['pools_engaged']}, "
                f"expected {int(lane)} (PTEXEC_STATS delta {d})")
        return n_tasks / secs, d

    def in_turns(run, modes, reps: int = 3) -> dict:
        """One warm run of each mode, then ``reps`` measured runs of each
        in turns; {mode: [tasks/s, ...]}."""
        for m in modes:
            run(m)
        rates = {m: [] for m in modes}
        for _ in range(reps):
            for m in modes:
                rates[m].append(run(m))
        return rates

    # -- the chains: INIT + NT CTL chains of DEPTH, empty bodies (the
    # reference's tasks_per_sec shape) --
    chain = compile_ptg(PTG_CHAIN_SRC, "chain_ep")
    n_chain = PTG_CHAIN_NT * PTG_CHAIN_DEPTH + 1
    rates = in_turns(lambda native: timed(
        chain, {"NT": PTG_CHAIN_NT, "DEPTH": PTG_CHAIN_DEPTH}, {}, n_chain,
        native, name="chain")[0], (True, False))
    med = {m: statistics.median(r) for m, r in rates.items()}
    log(f"PTG chains {PTG_CHAIN_NT}x{PTG_CHAIN_DEPTH} + INIT ({n_chain} "
        f"tasks, empty bodies): native lane median {med[True]:,.0f} "
        f"tasks/s (runs {', '.join(f'{x:,.0f}' for x in rates[True])}), "
        f"Python FSM median {med[False]:,.0f} tasks/s (runs "
        f"{', '.join(f'{x:,.0f}' for x in rates[False])}); every native run "
        f"engaged the lane ({smi})")

    # -- EP: 20000 flowless tasks, agglomerated, scheduled FSM, scheduled
    # native --
    ep = compile_ptg(PTG_EP_SRC, "ep")
    modes = {"agglomerated": (True, True), "scheduled FSM": (False, False),
             "scheduled native": (True, False)}
    rates = in_turns(lambda m: timed(
        ep, {"NT": PTG_EP_N}, {}, PTG_EP_N, modes[m][0], modes[m][1],
        name="ep")[0], tuple(modes))
    log(f"PTG EP {PTG_EP_N} tasks: " + ", ".join(
        f"{m} {statistics.median(r):,.0f} tasks/s" for m, r in rates.items())
        + f" (medians of 3 after a warm run; {smi})")

    # -- data-flow chains 512 x 16: RW chains from descX to descY (payloads
    # card tensors), native then the FSM; the written-back tiles equal
    # each other and descX bit for bit --
    df = compile_ptg(PTG_DF_SRC, "df_chain")
    X = ptt.TiledMatrix("descX", 1, PTG_DF_NT, 1, 1, device=device)
    X.fill(lambda m, i: torch.randn(1, 1))
    Ys = {m: ptt.TiledMatrix(f"descY{int(m)}", 1, PTG_DF_NT, 1, 1,
                             device=device) for m in (True, False)}
    n_df = PTG_DF_NT * PTG_DF_DEPTH
    fused = []

    def df_run(native):
        rate, d = timed(df, {"NT": PTG_DF_NT, "DEPTH": PTG_DF_DEPTH},
                        {"descX": X, "descY": Ys[native]}, n_df, native,
                        name="df")
        if native:
            fused.append((d["fused_regions"], d["fused_tasks"],
                          d["seam_tasks"]))
        return rate
    rates = in_turns(df_run, (True, False))
    tiles = {m: torch.cat([Y.data_of(0, i).newest_copy().payload.reshape(1)
                           for i in range(PTG_DF_NT)]) for m, Y in Ys.items()}
    x = torch.cat([X.data_of(0, i).newest_copy().payload.reshape(1)
                   for i in range(PTG_DF_NT)])
    same = torch.equal(tiles[True], tiles[False]) and \
        torch.equal(tiles[True], x) and tiles[True].device.type == device
    log(f"PTG data-flow chains {PTG_DF_NT}x{PTG_DF_DEPTH} ({n_df} tasks): "
        f"native lane median {statistics.median(rates[True]):,.0f} tasks/s, "
        f"Python FSM median {statistics.median(rates[False]):,.0f} tasks/s; "
        f"native runs' (fused_regions, fused_tasks, seam_tasks), in order "
        f"{fused}; written-back tiles native vs FSM vs descX "
        f"{'bit-identical' if same else 'DIFFER'} ({smi})")
    if not same:
        raise AssertionError("the PTG data-flow chains' written-back tiles "
                             "differ between the lane and the FSM")
    del X, Ys, tiles, x

    # -- the PTG GEMM with a [type=CUDA] body: f32 N = 8192 in 512^2 tiles
    # on the card, TF32 off, in three modes --
    ptg_gemm_modes(ptt, torch, ctx, dev, smi, device)
    if device == "cuda":
        torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    log(f"PTG phase wall time {wall:.1f} s")


#: the PTG GEMM's modes: (a) the device lane with device regions (the
#: default), (b) the device lane per task, (c) the interpreted FSM on the
#: device module
GEMM_MODES = {"a": ("ptdev lane, device regions", {}),
              "b": ("ptdev lane per task", {"region_fusion": False}),
              "c": ("interpreted FSM on the device module",
                    {"device_native": False})}


@contextlib.contextmanager
def mca_set(ptt, params: dict):
    """The MCA parameters ``params`` set for the block."""
    for k, v in params.items():
        ptt.mca.set(k, v)
    try:
        yield
    finally:
        for k in params:
            ptt.mca.params.unset(k)


def poll_cost_us(torch, n: int = 2000) -> tuple:
    """What one completion poll costs the manager thread on this card:
    ``torch.cuda.Event.query()`` on a completed event and on one still
    pending behind a long kernel, microseconds a call."""
    s = torch.cuda.Stream()
    done = torch.cuda.Event()
    done.record(s)
    s.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        done.query()
    t_done = (time.perf_counter() - t0) / n * 1e6
    with torch.cuda.stream(s):
        torch.cuda._sleep(200_000_000)
    pend = torch.cuda.Event()
    pend.record(s)
    t0 = time.perf_counter()
    for _ in range(n):
        pend.query()
    t_pend = (time.perf_counter() - t0) / n * 1e6
    s.synchronize()
    return t_done, t_pend


class GraphRegion:
    """The device-region form the lane does not take, kept here to measure
    it against the eager form: the region's members captured into one CUDA
    graph at its first call (inputs in static buffers, clones of that
    call's), each later call copying its inputs into the static buffers,
    replaying, and cloning the outputs out of the graph's private pool."""

    def __init__(self, torch, program) -> None:
        self.torch, self.program = torch, program
        self.graph = None

    def __call__(self, ext_vals):
        torch = self.torch
        if self.graph is None:
            outs = self.program(ext_vals)                  # warm-up, eager
            self.static = [t.clone() for t in ext_vals]
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph,
                                  stream=torch.cuda.current_stream()):
                self.outs = self.program(tuple(self.static))
            return outs
        for dst, src in zip(self.static, ext_vals):
            dst.copy_(src, non_blocking=True)
        self.graph.replay()
        outs, wbs = self.outs
        return (tuple(o.clone() for o in outs), tuple(w.clone() for w in wbs))


def region_forms(torch, tp, ntask: int) -> dict:
    """The two forms of a device region's program, timed on one DAG's
    regions of a finished mode-(a) pool ``tp`` of ``ntask`` tasks (its
    program's cache holds plans of other sizes too), on one side stream:
    eager
    (the lane's form: the members' launches in order) and a CUDA graph of
    the members (:class:`GraphRegion`). Wall time (the host's part) and
    device time (CUDA events) of the DAG's regions each way, in turns, the
    card memory the graphs keep allocated (their pools' free blocks not
    counted), and whether the graph's write-backs equal the eager ones bit
    for bit."""
    from parsec_tpu_torch.dsl.ptg.compiler import _mk_region_program
    ent = next(e for e in tp.program._ptexec_cache.values()
               if e["fusion"] is not None and e["flat"]["n"] == ntask
               and e["fusion"]["dev_mask"] is not None)
    plan, data = ent["fusion"], ent["flat"]["data"]
    fns, written = tp._ptexec_class_fns(
        [tp._classes["GEMM"]], data, host=False)
    mem = [tp.collections[n].data_of(*i).newest_copy().payload
           for n, i in data["mem_reads"]]
    inputs = [tuple(mem[v] for _k, v in rp["ext"])
              for rp in plan["regions"]]
    eager = [_mk_region_program(rp, fns, written) for rp in plan["regions"]]
    graphs = [GraphRegion(torch, p) for p in eager]
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    s.synchronize()
    held0 = torch.cuda.memory_allocated()
    with torch.cuda.stream(s):
        t0 = time.perf_counter()
        for g, ev in zip(graphs, inputs):     # the first calls: captures
            g(ev)
        s.synchronize()
        cap_s = time.perf_counter() - t0
    held = torch.cuda.memory_allocated() - held0
    res = {}
    for name, progs in (("eager", eager), ("graph", graphs)) * 2:
        start, end = torch.cuda.Event(True), torch.cuda.Event(True)
        s.synchronize()
        with torch.cuda.stream(s):
            start.record()
            t0 = time.perf_counter()
            outs = [p(ev)[1][0] for p, ev in zip(progs, inputs)]
            wall = time.perf_counter() - t0
            end.record()
        s.synchronize()
        res[name] = (wall * 1e3, start.elapsed_time(end), outs)
    same = all(torch.equal(x, y) for x, y in
               zip(res["eager"][2], res["graph"][2]))
    times = {k: v[:2] for k, v in res.items()}
    del graphs, res
    torch.cuda.empty_cache()
    return {"regions": len(inputs),
            "members": len(plan["regions"][0]["members"]),
            "copy_in_mib": sum(t.nbytes for t in inputs[0]) / 2 ** 20,
            "capture_s": cap_s, "held_mib": held / 2 ** 20,
            "eager": times["eager"], "graph": times["graph"], "same": same}


def ptg_gemm_modes(ptt, torch, ctx, dev, smi, device: str) -> None:
    """The PTG GEMM (f32, N = 8192 in 512^2 tiles, 4096 tasks,
    ``[type=CUDA]`` body, TF32 off) in modes (a), (b), (c): a first DAG of
    each from a zero C held to ``torch.matmul`` ((a) twice: cold regions,
    then warm), (b) and (c) compared bit for bit, a warm DAG of (b), after
    which the cost model's one exploration of the CPU twin is spent (held
    to the device leg's result), the slopes in turns, then one profiled DAG
    of each with the lane's, the coherency table's, the cost model's and
    the regions' counters. The placement is the cost model's throughout:
    every pool but the exploration must stay on the card, and every pool's
    placement is printed. Before all that, one mode-(a) DAG at N = 16384
    (32768 tasks), held to ``torch.matmul``, with the card memory it
    took."""
    from parsec_tpu_torch.core.costmodel import COSTMODEL_STATS
    from parsec_tpu_torch.core.costmodel import model as cost_model
    from parsec_tpu_torch.device.native import PTDEV_STATS
    from parsec_tpu_torch.dsl.ptg.compiler import PTEXEC_STATS, compile_ptg
    if device == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the f32 GEMM gate needs it off")
    gemm = compile_ptg(PTG_GEMM_SRC, "gemm")
    # first, while the cost model knows nothing of the class: the default
    # fusion limits hold, so its k-chains run as device regions
    big_gemm(ptt, torch, ctx, dev, smi, device, gemm)
    T, TS = PTG_GEMM_T, PTG_GEMM_TS
    N = T * TS
    gen = torch.Generator(device=device).manual_seed(8)
    a = torch.randn(N, N, device=device, generator=gen)
    b = torch.randn(N, N, device=device, generator=gen)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    def tiled(name, dense):
        M = ptt.TiledMatrix(name, N, N, TS, TS, device=device)
        M.fill(lambda m, n: dense[m * TS:(m + 1) * TS, n * TS:(n + 1) * TS])
        return M
    A, B = tiled("descA", a), tiled("descB", b)
    Cs = [tiled(f"descC{j}", torch.zeros(N, N, device=device))
          for j in range(3)]
    ntask = T ** 3
    placements = {m: [] for m in GEMM_MODES}
    placements["explore"] = []
    #: (mode, pools run together) -> pools the scheduler plane bound, per
    #: run: a lane pool binds once a second one runs beside it
    plane_bound = {}
    last = {}
    split = [None]
    pool_bucket = [0]
    # the collector's pauses, seconds (a run's share is printed with it)
    gc_pause = [0.0, None]

    def gc_cb(phase, _info):
        if phase == "start":
            gc_pause[1] = time.perf_counter()
        elif gc_pause[1] is not None:
            gc_pause[0] += time.perf_counter() - gc_pause[1]
            gc_pause[1] = None
    gc.callbacks.append(gc_cb)

    def zero(C):
        C.fill(lambda m, n: torch.zeros(TS, TS, device=device))

    def dense(C):
        return torch.cat([torch.cat([C.data_of(m, n).newest_copy().payload
                                     .to(device) for n in range(T)], 1)
                          for m in range(T)])

    def run_gemm(n_dags: int, mode: str, cpu_twin: bool = False,
                 cs=None) -> float:
        """``n_dags`` GEMM pools (each its own C of ``cs``, by default
        ``Cs``) added together in ``mode``, run to completion: wall
        seconds. Every task must have run where the mode puts it, and the
        lanes' accounting must say so."""
        cs = Cs if cs is None else cs
        s0, d0, e0 = (PTEXEC_STATS.snapshot(), PTDEV_STATS.snapshot(),
                      dev.executed_tasks)
        g0 = gc_pause[0]
        p0 = ctx.sched_plane.stats()["pools_registered"]
        sync()
        t0 = time.perf_counter()
        with mca_set(ptt, GEMM_MODES[mode][1]):
            tps = [gemm.instantiate(
                ctx, globals={"MT": T, "NT": T, "KT": T},
                collections={"descA": A, "descB": B, "descC": cs[j]},
                name=f"gemm{j}") for j in range(n_dags)]
            t1 = time.perf_counter()
            for tp in tps:
                ctx.add_taskpool(tp)
        t2 = time.perf_counter()
        ctx.wait(timeout=600)
        sync()
        secs = time.perf_counter() - t0
        # the host's split of the run: the pools' instantiation, the
        # add_taskpool calls (the lane's prepare: flatten, plan, binding,
        # and the first dispatches) and the wait
        split[0] = (t1 - t0, t2 - t1, time.perf_counter() - t2)
        d, dd = PTEXEC_STATS.delta(s0), PTDEV_STATS.delta(d0)
        bound = ctx.sched_plane.stats()["pools_registered"] - p0
        plane_bound.setdefault((mode, n_dags), []).append(bound)
        lane = mode != "c"
        on_dev = 0 if cpu_twin else ntask * n_dags
        ok = (dev.executed_tasks - e0 == on_dev
              and dd["pools_fallback"] == 0 and d["pools_fallback"] == 0)
        if lane:
            # pools that run together drain through the plane's DRR
            ok &= (d["pools_engaged"] == n_dags
                   and dd["pools_engaged"] == (0 if cpu_twin else n_dags)
                   and dd["pools_ineligible"] == 0
                   and bound == (n_dags if n_dags > 1 else 0))
        else:
            ok &= (dd["pools_ineligible"] == n_dags
                   and d["pools_engaged"] == 0)
        pool_bucket[0] = tps[0]._ptexec_pool_bucket()
        if not ok:
            raise AssertionError(
                f"PTG GEMM mode ({mode}): accounting PTEXEC {d}, PTDEV "
                f"{dd}, {dev.executed_tasks - e0} tasks on the device; "
                f"the model {cost_model.snapshot()}")
        key = "explore" if cpu_twin else mode
        costs = {k: cost_model.cost("gemm.GEMM", pool_bucket[0], k)
                 for k in ("cuda", "cpu")}
        costs["stage-in"] = cost_model.cost("__stage_in__", pool_bucket[0],
                                            "cuda")
        log(f"  pool run ({key}) x{n_dags}: {secs:.3f} s, fused regions "
            f"{d['fused_regions']}, GC pauses {gc_pause[0] - g0:.3f} s; the "
            f"model after it, us a task: "
            + ", ".join(f"{k} {'-' if v is None else f'{v / 1e3:.1f}'}"
                        for k, v in costs.items()))
        for tp in tps:
            st = tp._ptexec_state
            placements[key].append(
                "interpreted FSM, device module" if st is None else
                "ptdev lane" if st.get("dev_pool") is not None else
                "CPU twin on host copies (execution lane)")
        last[mode] = tps[-1]
        return secs

    ref = torch.matmul(a, b)
    refmax = ref.abs().max()
    results = {}
    # a DAG of each mode from a zero C, each in its own matrix; (a) twice:
    # its first DAG builds each region's program (cold regions, left out of
    # the cost model), the second reuses them
    for j, (mode, what) in enumerate((("a", "first DAG, cold regions"),
                                      ("a", "second DAG, warm regions"),
                                      ("b", "first DAG"),
                                      ("c", "first DAG"))):
        C = Cs[min(j, 2)]
        zero(C)
        t_first = run_gemm(1, mode, cs=[C])
        got = dense(C)
        rel = ((got - ref).abs().max() / refmax).item()
        results[(mode, j)] = got
        log(f"PTG GEMM f32 N={N} TS={TS} ({ntask} tasks) mode ({mode}) "
            f"{GEMM_MODES[mode][0]}, {what}: {t_first:.3f} s (instantiate "
            f"{split[0][0]:.3f}, add_taskpool {split[0][1]:.3f}, wait "
            f"{split[0][2]:.3f}); max err / max|ref| against torch.matmul "
            f"= {rel:.3e}")
        if not (got.device.type == device and rel < 1e-5):
            raise AssertionError(f"PTG GEMM mode ({mode}) f32 gate: {rel}")
    same = {k: torch.equal(results[x], results[y]) for k, x, y in (
        ("(b) vs (c)", ("b", 2), ("c", 3)),
        ("(a) cold regions vs (b)", ("a", 0), ("b", 2)),
        ("(a) warm regions vs (b)", ("a", 1), ("b", 2)))}
    log("PTG GEMM C bit for bit: " + ", ".join(
        f"{k} {'the same' if v else 'DIFFERENT'}" for k, v in same.items()))
    # the first (b) DAG was the class's first per-task pool on the lane:
    # cold, so unobserved. A warm (b) DAG measures the card per task (still
    # placed there: nothing is measured yet); the next lane instantiation
    # then explores the CPU twin once — spent here, in the warm-up, on its
    # own C, and held to the device leg's result
    run_gemm(1, "b", cs=[Cs[1]])
    x0 = COSTMODEL_STATS.snapshot()
    zero(Cs[0])
    t_x = run_gemm(1, "b", cpu_twin=True)
    got = dense(Cs[0])
    rel = ((got - results[("b", 2)]).abs().max() / refmax).item()
    xd = COSTMODEL_STATS.delta(x0)
    bucket = last["b"]._ptexec_pool_bucket()
    per = {k: cost_model.cost("gemm.GEMM", bucket, k) / 1e3
           for k in ("cuda", "cpu")}
    log(f"PTG GEMM the cost model's exploration of the CPU twin (mode (b), "
        f"host copies): {t_x:.3f} s, placements_explore "
        f"{xd['placements_explore']}, placements_diverged "
        f"{xd['placements_diverged']}; max err / max|ref| against the "
        f"device leg = {rel:.3e}; measured per task: card "
        f"{per['cuda']:.1f} us, CPU twin {per['cpu']:.1f} us")
    if not (xd["placements_explore"] == 1 and rel < 1e-5):
        raise AssertionError(f"PTG GEMM CPU-twin exploration: {xd}, {rel}")
    zero(Cs[0])
    del results, got
    for mode in GEMM_MODES:                    # warm runs after the explore
        run_gemm(1, mode)
    slopes = slopes_in_turns(run_gemm, engines=tuple(GEMM_MODES))
    mm_ms = cuda_time_ms(lambda: torch.matmul(a, b), iters=5) \
        if device == "cuda" else float("nan")
    for mode, (s_, t1, t3) in slopes.items():
        log(f"PTG GEMM mode ({mode}) {GEMM_MODES[mode][0]}: T1 {t1:.3f} s, "
            f"T3 {t3:.3f} s, slope {s_ * 1e3:.1f} ms/DAG -> host "
            f"{s_ / ntask * 1e6:.1f} us a task, "
            f"{2 * N ** 3 / 1e9 / s_:.1f} GFLOP/s ({smi})")
    log(f"yardstick torch.matmul f32 {N}^3: {mm_ms:.3f} ms")
    log("PTG GEMM pools the card context's scheduler plane bound, per run "
        "(mode, pools run together): " + ", ".join(
            f"({m}) x{n}: {b}" for (m, n), b in sorted(plane_bound.items())))
    lane = ctx._ptdev
    for mode in GEMM_MODES:
        s0, d0, c0 = (PTDEV_STATS.snapshot(), COSTMODEL_STATS.snapshot(),
                      dev.coh_stats())
        l0 = lane.clane.stats()
        busy, window, by_name = device_profile(
            torch, lambda: run_gemm(1, mode))
        dd, cd = PTDEV_STATS.delta(s0), COSTMODEL_STATS.delta(d0)
        l1, c1 = lane.clane.stats(), dev.coh_stats()
        ld = {k: l1[k] - l0[k] for k in ("dispatched", "dispatch_batches",
                                        "overlap_hits", "late_retires",
                                        "cb_errors")}
        coh = {k: c1[k] - c0[k] for k in ("coh_hits", "coh_misses",
                                         "stage_in_bytes")}
        st = last[mode]._ptexec_state
        rs = st["graph"].region_stats() if st is not None else None
        log(idle_line(f"PTG GEMM mode ({mode}) one DAG", busy, window))
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:3]:
            log(f"  device {ms:8.3f} ms  {name[:100]}")
        log(f"  PTDEV_STATS delta {dd}; lane {ld}; CohTable {coh}; "
            f"COSTMODEL_STATS placements_adaptive "
            f"{cd['placements_adaptive']}, placements_diverged "
            f"{cd['placements_diverged']}, decision_ns {cd['decision_ns']}; "
            f"region_stats {rs}")
        if mode != "c" and not (ld["cb_errors"] == 0 and rs is not None
                                and rs["weighted_total"] == ntask):
            raise AssertionError(f"PTG GEMM mode ({mode}): lane {ld}, "
                                 f"regions {rs}")
    log("PTG GEMM placement of every pool: " + "; ".join(
        f"({m}) " + ", ".join(f"{p} x{placements[m].count(p)}"
                              for p in sorted(set(placements[m])))
        for m in placements))
    if device == "cuda":
        t_done, t_pend = poll_cost_us(torch)
        log(f"device lane poll: torch.cuda.Event.query() {t_done:.2f} us on "
            f"a completed event, {t_pend:.2f} us on a pending one (one "
            f"event a dispatch batch; {smi})")
        rf = region_forms(torch, last["a"], ntask)
        log(f"device region forms, one DAG's {rf['regions']} regions of "
            f"{rf['members']} members: eager (the lane's form) "
            f"{rf['eager'][0]:.3f} ms wall ({rf['eager'][1]:.3f} ms "
            f"device), CUDA graph with {rf['copy_in_mib']:.0f} MiB copied "
            f"in a region {rf['graph'][0]:.3f} ms wall ({rf['graph'][1]:.3f} "
            f"ms device); first calls with the captures "
            f"{rf['capture_s']:.3f} s, {rf['held_mib']:.0f} MiB allocated "
            f"by the graphs (static inputs, outputs); write-backs bit for bit "
            f"{'the same' if rf['same'] else 'DIFFERENT'} ({smi})")
        if not rf["same"]:
            raise AssertionError("the region graph's write-backs differ")
    del A, B, Cs, a, b, ref, last
    gc.callbacks.remove(gc_cb)


def big_gemm(ptt, torch, ctx, dev, smi, device: str, gemm) -> None:
    """One mode-(a) DAG of the PTG GEMM at N = 16384 (32 x 32 x 32 tasks of
    512^2 f32 tiles, the size of the port's DTD GEMM), from a zero C, held
    to ``torch.matmul`` at 1e-5 of max|ref|: device regions hold no card
    memory of their own, and a slot's tile is dropped once its consumers
    retired, so the run needs the matrices and little else (the peak
    allocation above them is printed, with whether the cost model kept the
    regions fused)."""
    from parsec_tpu_torch.core.costmodel import COSTMODEL_STATS
    from parsec_tpu_torch.device.native import PTDEV_STATS
    T, TS = 2 * PTG_GEMM_T, PTG_GEMM_TS
    N = T * TS
    gen = torch.Generator(device=device).manual_seed(16)
    a = torch.randn(N, N, device=device, generator=gen)
    b = torch.randn(N, N, device=device, generator=gen)
    mats = {}
    for name, d in (("descA", a), ("descB", b), ("descC", None)):
        M = ptt.TiledMatrix(name, N, N, TS, TS, device=device)
        M.fill(lambda m, n, d=d: torch.zeros(TS, TS, device=device)
               if d is None else d[m * TS:(m + 1) * TS, n * TS:(n + 1) * TS])
        mats[name] = M
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    base = torch.cuda.memory_allocated() if device == "cuda" else 0
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    d0, e0 = PTDEV_STATS.snapshot(), dev.executed_tasks
    f0 = COSTMODEL_STATS.snapshot()
    t0 = time.perf_counter()
    tp = gemm.instantiate(ctx, globals={"MT": T, "NT": T, "KT": T},
                          collections=mats, name="gemm16k")
    ctx.add_taskpool(tp)
    ctx.wait(timeout=600)
    sync()
    secs = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20 \
        if device == "cuda" else float("nan")
    dd, fd = PTDEV_STATS.delta(d0), COSTMODEL_STATS.delta(f0)
    rs = tp._ptexec_state["graph"].region_stats()
    C = mats["descC"]
    got = torch.cat([torch.cat([C.data_of(m, n).newest_copy().payload
                                for n in range(T)], 1) for m in range(T)])
    del mats, C, tp
    ref = torch.matmul(a, b)
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    log(f"PTG GEMM f32 N={N} TS={TS} ({T ** 3} tasks) mode (a), one DAG: "
        f"{secs:.3f} s; {peak:.0f} MiB allocated above the matrices at the "
        f"peak; PTDEV_STATS delta {dd}; region_stats {rs}; fusion declined "
        f"by the cost model {fd['fusion_declined']}; max err / max|ref| "
        f"against torch.matmul = "
        f"{rel:.3e} ({smi})")
    if not (dd["pools_engaged"] == 1 and dd["pools_fallback"] == 0
            and dev.executed_tasks - e0 == T ** 3
            and rs["weighted_total"] == T ** 3 and rel < 1e-5):
        raise AssertionError(f"PTG GEMM N={N} mode (a): {dd}, {rs}, {rel}")


# ---------------------------------------------------------------------------
# Phase 10: the observability substrate on the main paths
# ---------------------------------------------------------------------------

#: the stall watchdog's threshold over the phase (a lane holding work whose
#: progress counter stays still this long trips it)
OBS_WATCHDOG_MS = 5000
#: the DTD GEMM's and the PTG GEMM's shapes under the tracer: phases 3 and 9
OBS_GEMM_N, OBS_GEMM_TS = GEMM_N, GEMM_TS
#: measured runs of each chain leg, in turns
OBS_CHAIN_ROUNDS = 15


def stream_events(trace, prefix: str) -> int:
    return sum(len(s["events"]) for s in trace.streams
               if s["name"].startswith(prefix))


def keyword_events(trace, keyword: str) -> tuple:
    """(matched intervals as (begin, end), the keyword's raw event count)
    of ``keyword`` in ``trace``."""
    from parsec_tpu_torch.tools.trace_reader import _intervals
    key = next((d["key"] for d in trace.dictionary
                if d["name"] == keyword), None)
    spans = [(t_s, t_e) for _si, _sn, base, _e, _tp, t_s, t_e, _i
             in _intervals(trace) if base == key]
    raw = sum(1 for s in trace.streams for e in s["events"]
              if e[0] >> 1 == key)
    return spans, raw


def points(trace, keyword: str) -> list:
    """(event id, info) of every POINT event of ``keyword``, in order."""
    from parsec_tpu_torch.utils.trace import EVENT_FLAG_POINT
    key = next((d["key"] for d in trace.dictionary
                if d["name"] == keyword), None)
    return [(e[1], e[5]) for s in trace.streams for e in s["events"]
            if e[0] >> 1 == key and e[4] & EVENT_FLAG_POINT]


def hist_counts() -> dict:
    from parsec_tpu_torch.utils.hist import histograms
    return {k: v["count"] for k, v in histograms.snapshot().items()}


def chain_overheads(ptt, smi, device: str) -> dict:
    """The reference benchmark's tracing and histogram legs
    (``bench.py:1017-1082``) on the PTG chain shape (INIT + 1024 CTL
    chains of 8), each on a context of its own, in turns: plain, traced
    (rings armed), traced then switched off, histograms armed. Medians of
    ``OBS_CHAIN_ROUNDS`` runs each after a warm run (the reference takes
    3; a run is about 1 ms, and its rate varies by a third between runs),
    each run after a collection; the overheads against the plain rate."""
    import statistics
    from parsec_tpu_torch.dsl.ptg.compiler import compile_ptg
    from parsec_tpu_torch.utils.trace import Profiling

    def new_ctx():
        return ptt.Context(nb_cores=1, device=device)
    chain = compile_ptg(PTG_CHAIN_SRC, "chain_ep")
    n_chain = PTG_CHAIN_NT * PTG_CHAIN_DEPTH + 1
    ctxs = {"plain": new_ctx(), "traced": new_ctx(), "off": new_ctx()}
    with mca_set(ptt, {"hist_enabled": True}):
        ctxs["hist"] = new_ctx()
    ctxs["traced"].profiling = Profiling()
    ctxs["off"].profiling = Profiling()

    def run(leg: str) -> float:
        c = ctxs[leg]
        tp = chain.instantiate(c, globals={"NT": PTG_CHAIN_NT,
                                           "DEPTH": PTG_CHAIN_DEPTH},
                               collections={}, name=f"chain-{leg}")
        # the traced leg's landed events stay alive in its tracer: collect
        # before each run, so no leg pays a collection the previous one's
        # allocations started
        gc.collect()
        t0 = time.perf_counter()
        c.add_taskpool(tp)
        c.wait(timeout=120)
        secs = time.perf_counter() - t0
        if tp._ptexec_state is None:
            raise AssertionError(f"chain leg {leg}: the pool left the lane")
        return n_chain / secs
    h0 = hist_counts().get("ptexec.exec_ns", 0)
    for leg in ctxs:
        run(leg)                     # warm: the lane's one-time flatten
    ctxs["off"].profiling = None     # traced once, then switched off
    rates = {leg: [] for leg in ctxs}
    for _ in range(OBS_CHAIN_ROUNDS):
        for leg in ctxs:
            rates[leg].append(run(leg))
    nt = ctxs["traced"]._ntrace
    landed, dropped = nt.events_landed, nt.dropped()
    for c in ctxs.values():
        c.fini()
    hist_n = hist_counts().get("ptexec.exec_ns", 0) - h0
    runs = OBS_CHAIN_ROUNDS + 1
    med = {leg: statistics.median(r) for leg, r in rates.items()}
    out = {
        "tasks_per_sec_chain": round(med["plain"]),
        "tasks_per_sec_chain_traced": round(med["traced"]),
        "tasks_per_sec_chain_trace_off": round(med["off"]),
        "tasks_per_sec_chain_hist": round(med["hist"]),
        "trace_overhead_pct_native":
            round(100.0 * (med["plain"] - med["traced"]) / med["plain"], 2),
        "trace_off_overhead_pct_native":
            round(100.0 * (med["plain"] - med["off"]) / med["plain"], 2),
        "hist_overhead_pct_native":
            round(100.0 * (med["plain"] - med["hist"]) / med["plain"], 2)}
    log(f"observability: PTG chains {PTG_CHAIN_NT}x{PTG_CHAIN_DEPTH} + INIT "
        f"in turns, {OBS_CHAIN_ROUNDS} runs a leg, tasks/s median (min, "
        f"max): " + "; ".join(
            f"{leg} {med[leg]:,.0f} ({min(r):,.0f}, {max(r):,.0f})"
            for leg, r in rates.items()) + f" ({smi})")
    log(f"observability: chain overheads {json.dumps(out)}; traced leg "
        f"landed {landed} ring events, dropped {dropped}; ptexec.exec_ns "
        f"counted {hist_n} tasks ({n_chain} a run, {runs} runs)")
    if landed + dropped != 2 * n_chain * runs or hist_n != runs * n_chain:
        raise AssertionError(
            f"chain legs: {landed} + {dropped} ring events for "
            f"{runs * n_chain} traced tasks, {hist_n} histogram samples")
    return out


def observability(ptt, K, torch, smi, device: str = "cuda") -> dict:
    """Phase 10: the observability substrate on the main paths, on a
    context made with ``--mca profile_enabled 1`` (its tracer dumps to
    ``profile_filename`` at ``fini``), ``hist_enabled`` and the stall
    watchdog armed:

    1. the DTD GEMM (phase 3's shape, the native per-task lane) with the
       tracer off, then on: C bit for bit the same, every task on the lane,
       the CUDA device stream's exec spans one matched pair a task, the
       engine ring's landed events plus its drops equal to what it
       recorded (a link interval and a completion point a task), the last
       memory POINT's resident bytes the module's; then the scheduled
       slope with the tracer on and off, in turns;
    2. the PTG GEMM (phase 9's) in modes (a) and (b) with the rings off,
       then on: C bit for bit the same, the device lane's ring (dispatch
       intervals, retire points) agreeing with its counters; then mode
       (a)'s slope with the rings on and off, in turns;
    3. the histograms (``ptdtd``, ``ptdev``: every task of the phase),
       the metrics endpoint on port 0 (``/metrics`` and ``/health`` in
       process, equal to the stats snapshots, shut down without a leaked
       thread or socket) and the watchdog (no stall trip);
    4. the reference benchmark's chain legs (:func:`chain_overheads`).

    Returns the overheads and the chain kernel's launches in the phase."""
    import threading
    from parsec_tpu_torch.core.costmodel import COSTMODEL_STATS
    from parsec_tpu_torch.core.watchdog import WATCHDOG_STATS
    from parsec_tpu_torch.data.matrix import collection_from_numpy
    from parsec_tpu_torch.device.cuda import CUDADevice
    from parsec_tpu_torch.device.native import PTDEV_STATS
    from parsec_tpu_torch.dsl.dtd import PTDTD_STATS
    from parsec_tpu_torch.dsl.ptg.compiler import PTEXEC_STATS, compile_ptg
    from parsec_tpu_torch.ops.gemm import insert_gemm_tasks
    from parsec_tpu_torch.tools.metrics_server import MetricsServer, fetch
    from parsec_tpu_torch.tools.trace_reader import read_pbp, read_trace
    t_phase = time.perf_counter()
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    build = os.path.join(os.path.dirname(os.path.abspath(ptt.__file__)),
                         "build")
    os.makedirs(build, exist_ok=True)
    auto_path = os.path.join(build, "chip_smoke_obs_fini.pbp")
    if os.path.exists(auto_path):
        os.unlink(auto_path)
    wd0 = WATCHDOG_STATS.snapshot()
    # the tracer dumps to the profile_filename set when fini runs
    ptt.mca.set("profile_filename", auto_path)
    with mca_set(ptt, {"profile_enabled": True, "hist_enabled": True,
                       "watchdog_stall_ms": OBS_WATCHDOG_MS}):
        ctx = ptt.Context(nb_cores=1, device=device)
    prof = ctx.profiling
    if prof is None or ctx.watchdog is None or not ctx._hist_on:
        raise AssertionError("the context's tracer, watchdog or histograms "
                             "did not arm from the MCA parameters")
    ctx.profiling = None             # the untraced runs come first
    dev = next(d for d in ctx.devices.devices if isinstance(d, CUDADevice))
    h_start = hist_counts()
    lane_tasks = {"dtd": 0}

    # -- 1. the DTD GEMM --
    N, TS = OBS_GEMM_N, OBS_GEMM_TS
    tiles = (N // TS) ** 2
    gen = torch.Generator(device=device).manual_seed(42)

    def host(shape):
        return torch.randn(shape, device=device, generator=gen) \
            .cpu().numpy()
    A = collection_from_numpy("oA", host((N, N)), TS, TS,
                              dtype=torch.bfloat16)
    B = collection_from_numpy("oB", host((N, N)), TS, TS,
                              dtype=torch.bfloat16)
    C = collection_from_numpy("oC", np.zeros((N, N), np.float32), TS, TS,
                              dtype=torch.bfloat16)
    zero = torch.zeros(TS, TS, dtype=torch.bfloat16)
    launches = {"traced": 0, "split": 0}

    def run_dags(n_dags: int, traced: bool) -> float:
        """``n_dags`` GEMM DAGs in one pool on the native per-task lane,
        with the tracer on or off; every task checked to have taken it, and
        on the card, a traced run's chain launches (one a task, every one
        on the split route) added to the phase's count."""
        ctx.profiling = prof if traced else None
        before = PTDTD_STATS.snapshot()
        l0 = K.gemm_chain.launches
        s0 = K.gemm_chain.launches_by_route["split"]
        sync()
        t = time.perf_counter()
        tp = ptt.DTDTaskpool(ctx, "gemm-obs")
        n = 0
        for _ in range(n_dags):
            n += insert_gemm_tasks(tp, A, B, C, batch_k=True)
        tp.wait()
        tp.close()
        ctx.wait()
        sync()
        secs = time.perf_counter() - t
        check_lane(tp, ctx, before, n, True, "DTD GEMM (observability)")
        lane_tasks["dtd"] += n
        if traced:
            n_l = K.gemm_chain.launches - l0
            n_s = K.gemm_chain.launches_by_route["split"] - s0
            if on_card and not n_s == n_l == tiles * n_dags:
                raise AssertionError(
                    f"traced DTD GEMM: {n_l} chain launches, {n_s} on the "
                    f"split route, for {tiles * n_dags} tasks")
            launches["traced"] += n_l
            launches["split"] += n_s
        return secs

    # the traced DAG first: it stages the tiles in, so the module's
    # residency moves under the tracer (a resident tile's rewrite keeps its
    # size and records no memory event)
    run_dags(1, True)
    resident = dev._resident_bytes
    c_traced = tiles_of(torch, C, device)
    eng = ctx._dtd_neng
    dropped = eng.trace_dropped()
    h_dtd = hist_counts().get("ptdtd.pt_ready_to_done_ns", 0)
    trace = read_pbp(prof.dump(os.path.join(build,
                                            "chip_smoke_obs_dtd.pbp")))
    C.fill(lambda m, n: zero)
    run_dags(1, False)
    same = torch.equal(c_traced, tiles_of(torch, C, device))
    spans, n_exec = keyword_events(trace, f"{dev.name}::exec")
    landed = stream_events(trace, "ptdtd-w")
    mem = points(trace, f"{dev.name}::mem")
    # a memory POINT's info blob is resident{q};delta{q}
    last_resident = struct.unpack("<qq", mem[-1][1])[0] if mem else None
    log(f"observability: DTD GEMM bf16 N={N} TS={TS} traced on the native "
        f"lane: C {'bit-identical' if same else 'DIFFERS'} to the untraced "
        f"DAG's; {dev.name} exec spans: {len(spans)} matched of {n_exec} "
        f"events, {sum(1 for a, b in spans if b < a)} ending before they "
        f"begin; engine ring: {landed} landed + {dropped} dropped of "
        f"{3 * tiles} recorded (a link interval and a completion point a "
        f"task); {len(mem)} {dev.name}::mem POINTs, the last one's resident "
        f"{last_resident} B, the module's {resident} B; "
        f"ptdtd.pt_ready_to_done_ns "
        f"counted {h_dtd} tasks; gemm_chain launches {launches['traced']} "
        f"({smi})")
    if not (same and len(spans) == tiles and n_exec == 2 * tiles
            and all(b >= a for a, b in spans)
            and landed + dropped == 3 * tiles
            and last_resident == resident and h_dtd == tiles):
        raise AssertionError("the traced DTD GEMM failed its checks")
    del c_traced, trace
    dtd_slopes = slopes_in_turns(run_dags)
    for traced, (s_, lo_, hi_) in dtd_slopes.items():
        log(f"observability: DTD GEMM tracer {'on' if traced else 'off'}: "
            f"T1 {lo_:.3f} s, T3 {hi_:.3f} s, slope {s_ * 1e3:.1f} ms/DAG "
            f"({smi})")
    del A, B, C

    # -- 2. the PTG GEMM in modes (a) and (b) on the device lane --
    gemm = compile_ptg(PTG_GEMM_SRC, "gemm")
    T, PTS = PTG_GEMM_T, PTG_GEMM_TS
    NP = T * PTS
    gen = torch.Generator(device=device).manual_seed(8)
    a = torch.randn(NP, NP, device=device, generator=gen)
    b = torch.randn(NP, NP, device=device, generator=gen)

    def tiled(name, dense):
        M = ptt.TiledMatrix(name, NP, NP, PTS, PTS, device=device)
        M.fill(lambda m, n: dense[m * PTS:(m + 1) * PTS,
                                  n * PTS:(n + 1) * PTS])
        return M
    PA, PB = tiled("oPA", a), tiled("oPB", b)
    Cs = [tiled(f"oPC{j}", torch.zeros(NP, NP, device=device))
          for j in range(3)]
    ntask = T ** 3

    def run_gemm(n_dags: int, mode: str, traced: bool) -> float:
        """``n_dags`` GEMM pools (each its own C) in ``mode``, rings on or
        off; every pool must have run on the device lane."""
        ctx.profiling = prof if traced else None
        for C_ in Cs[:n_dags]:
            C_.fill(lambda m, n: torch.zeros(PTS, PTS, device=device))
        s0, d0 = PTEXEC_STATS.snapshot(), PTDEV_STATS.snapshot()
        sync()
        t0 = time.perf_counter()
        with mca_set(ptt, GEMM_MODES[mode][1]):
            tps = [gemm.instantiate(
                ctx, globals={"MT": T, "NT": T, "KT": T},
                collections={"descA": PA, "descB": PB, "descC": Cs[j]},
                name=f"gemm-obs{j}") for j in range(n_dags)]
            for tp in tps:
                ctx.add_taskpool(tp)
        ctx.wait(timeout=600)
        sync()
        secs = time.perf_counter() - t0
        d, dd = PTEXEC_STATS.delta(s0), PTDEV_STATS.delta(d0)
        if not (d["pools_engaged"] == n_dags == dd["pools_engaged"]
                and dd["pools_fallback"] == 0
                and all(tp._ptexec_state.get("dev_pool") is not None
                        for tp in tps)):
            raise AssertionError(f"PTG GEMM ({mode}) under observation: "
                                 f"PTEXEC {d}, PTDEV {dd}")
        return secs

    for mode in ("a", "b"):
        run_gemm(1, mode, False)                    # warm
        run_gemm(1, mode, False)
        plain = tiles_of(torch, Cs[0], device)
        mark = {s.name: len(s.events) for s in prof._streams}
        lane = ctx._ptdev
        l0 = lane.clane.stats()
        run_gemm(1, mode, True)
        l1 = lane.clane.stats()
        ld = {k: l1[k] - l0[k] for k in ("dispatched", "dispatch_batches",
                                        "retired")}
        same = torch.equal(plain, tiles_of(torch, Cs[0], device))
        trace = read_pbp(prof.dump(os.path.join(
            build, f"chip_smoke_obs_ptg_{mode}.pbp")))
        # this DAG's events: the ptdev streams' tail past the mark
        disp, retire = ptdev_events(trace, mark)
        log(f"observability: PTG GEMM f32 N={NP} mode ({mode}) "
            f"{GEMM_MODES[mode][0]}, rings on: C "
            f"{'bit-identical' if same else 'DIFFERS'} to the untraced "
            f"DAG's; ptdev ring {len(disp)} dispatch intervals of "
            f"{sum(disp)} ids, {retire} retire points; the lane's counters "
            f"{ld} ({smi})")
        if not (same and len(disp) == ld["dispatch_batches"]
                and sum(disp) == ld["dispatched"]
                and retire == ld["retired"]):
            raise AssertionError(f"PTG GEMM mode ({mode}) under the tracer "
                                 f"failed its checks")
        del plain, trace
    ptg_slopes = slopes_in_turns(lambda n, on: run_gemm(n, "a", on))
    for traced, (s_, lo_, hi_) in ptg_slopes.items():
        log(f"observability: PTG GEMM mode (a) rings "
            f"{'on' if traced else 'off'}: T1 {lo_:.3f} s, T3 {hi_:.3f} s, "
            f"slope {s_ * 1e3:.1f} ms/DAG -> host "
            f"{s_ / ntask * 1e6:.1f} us a task ({smi})")
    del PA, PB, Cs, a, b

    # -- 3. histograms, metrics endpoint, watchdog --
    hists = {k: v - h_start.get(k, 0) for k, v in hist_counts().items()}
    lane_retired = ctx._ptdev.clane.stats()["retired"]
    from parsec_tpu_torch.utils.hist import histograms
    summ = histograms.summaries(ttl=0.0)
    log("observability: histograms over the phase " + "; ".join(
        f"{k}: {n} samples, p50 {summ[k]['p50_us']:.1f} us, p99 "
        f"{summ[k]['p99_us']:.1f} us" for k, n in sorted(hists.items())
        if n) + f" (DTD tasks {lane_tasks['dtd']}, device lane retires "
        f"{lane_retired})")
    if not (hists.get("ptdtd.pt_ready_to_done_ns") == lane_tasks["dtd"]
            and hists.get("ptdev.retire_ns") == lane_retired):
        raise AssertionError(f"the histograms miss the phase's tasks: "
                             f"{hists}")
    threads0 = {t.name for t in threading.enumerate()}
    # the device lane's C-side samplers serve a snapshot up to 50 ms old
    # (one stats() call a sweep): let any snapshot taken while the last
    # DAG ran expire before the scrape
    time.sleep(0.1)
    srv = MetricsServer(port=0).start()
    try:
        met = fetch(srv.endpoint, "/metrics")
        health = fetch(srv.endpoint, "/health")
    finally:
        srv.stop()
    c = met["counters"]
    want = {}
    for stats, prefix in ((PTDTD_STATS, "ptdtd"), (PTEXEC_STATS, "ptexec"),
                          (PTDEV_STATS, "ptdev"),
                          (COSTMODEL_STATS, "costmodel")):
        want.update({f"{prefix}.{k}": v for k, v in stats.snapshot().items()})
    # the C-side samplers sum the live lanes: this context's alone (a
    # lane leaves the sum at its context's fini)
    from parsec_tpu_torch.device.native import _lanes
    if list(_lanes) != [ctx._ptdev]:
        raise AssertionError(f"live device lanes: {len(_lanes)}")
    ls = ctx._ptdev.clane.stats()
    want.update({f"ptdev.{k}": ls[k] for k in ("submitted", "dispatched",
                                               "retired", "inflight")})
    bad = {k: (c.get(k), v) for k, v in want.items() if c.get(k) != v}
    leaked = [t.name for t in threading.enumerate()
              if t.name.startswith("parsec-metrics") and
              t.name not in threads0]
    try:
        fetch(srv.endpoint, "/health", timeout=0.5)
        closed = False
    except (OSError, RuntimeError):
        closed = True
    log(f"observability: /metrics served {len(c)} counters; {len(want)} of "
        f"ptdtd.*, ptexec.*, ptdev.*, costmodel.* checked against the stats "
        f"({len(bad)} differ); /health {health}; after stop: socket "
        f"{'closed' if closed else 'STILL ANSWERING'}, leaked threads "
        f"{leaked}")
    if bad or not health["ok"] or not closed or leaked:
        raise AssertionError(f"metrics endpoint: {bad}, {health}, "
                             f"closed {closed}, leaked {leaked}")
    ctx.profiling = prof             # the fini dump holds the traced runs
    ctx.fini()
    ptt.mca.params.unset("profile_filename")
    wd = WATCHDOG_STATS.delta(wd0)
    trips = wd["pool_stalls"] + wd["device_stalls"] + wd["comm_stalls"]
    log(f"observability: watchdog ({OBS_WATCHDOG_MS} ms) over the phase: "
        f"{wd['ticks']} ticks, {trips} stall trips, p99 breaches "
        f"{wd['p99_breaches']}, flight dumps {wd['flight_dumps']}")
    if trips or not wd["ticks"]:
        raise AssertionError(f"watchdog over the phase: {wd}")
    # the tracer's dump at fini (the reference only warns when it fails)
    if not os.path.exists(auto_path):
        raise AssertionError(f"the fini trace dump {auto_path} is missing")
    fin = read_trace(auto_path)
    names = {s["name"].split("-w")[0] for s in fin.streams}
    log(f"observability: fini dump {auto_path}: "
        f"{os.path.getsize(auto_path)} B, {len(fin.dictionary)} keywords, "
        f"{sum(len(s['events']) for s in fin.streams)} events in streams "
        f"{sorted(names)}")
    if not {"ptdtd", "ptexec", "ptdev", dev.name} <= names:
        raise AssertionError(f"the fini dump lacks streams: {names}")

    # -- 4. the reference benchmark's chain legs --
    chain = chain_overheads(ptt, smi, device)
    out = dict(chain)
    out.update({
        "dtd_gemm_slope_ms_traced": round(dtd_slopes[True][0] * 1e3, 1),
        "dtd_gemm_slope_ms_untraced": round(dtd_slopes[False][0] * 1e3, 1),
        "ptg_gemm_a_slope_ms_rings_on": round(ptg_slopes[True][0] * 1e3, 1),
        "ptg_gemm_a_slope_ms_rings_off":
            round(ptg_slopes[False][0] * 1e3, 1)})
    log(f"observability overheads (not gated): {json.dumps(out)} ({smi})")
    log(f"observability phase wall time {time.perf_counter() - t_phase:.1f} s")
    return {"overheads": out, "launches": launches["traced"],
            "split": launches["split"]}


def ptdev_events(trace, mark: dict) -> tuple:
    """The device lane's dispatch intervals (their ids: batch sizes) and
    retire points past ``mark`` (events per stream name before the run)."""
    from parsec_tpu_torch.utils.trace import EVENT_FLAG_END, EVENT_FLAG_POINT
    names = {d["key"]: d["name"] for d in trace.dictionary}
    disp, retire = [], 0
    for s in trace.streams:
        if not s["name"].startswith("ptdev-w"):
            continue
        for e in s["events"][mark.get(s["name"], 0):]:
            name = names[e[0] >> 1]
            if name == "ptdev::retire" and e[4] & EVENT_FLAG_POINT:
                retire += 1
            elif name == "ptdev::dispatch" and e[4] & EVENT_FLAG_END:
                disp.append(e[1] & ((1 << 40) - 1))
    return disp, retire


# ---------------------------------------------------------------------------
# Phase 11: the rest of the single-rank substrate on the card
# ---------------------------------------------------------------------------

#: (a) the POTRF cell's width: S at the GEMM's tile, T (symmetric lower) at
#: POTRF's; (b) V's tile and the unaligned region; (c) the recursive tiles
SUB_N, SUB_S_TS, SUB_T_TS = POTRF_N, GEMM_TS, POTRF_TS
SUB_V_TS = 384
SUB_REGION = dict(m=7000, n=6000, si=7, sj=13, ti=21, tj=5)
SUB_REC_N, SUB_REC_TILES = 4096, 4
#: the 2-layer LM at head dim 80 (n_embd 1280, 16 heads; Phi-2's head dim)
LM_D80 = dict(vocab_size=50257, d_model=1280, d_ff=5120, n_heads=16,
              n_layers=2, max_seq=1024)
LM_D80_BATCH = 4


def sync(torch, device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def potrf_tasks(mt: int) -> int:
    """The tasks of a tiled POTRF over mt x mt tiles: POTRF, TRSM, SYRK and
    GEMM."""
    return mt + 2 * (mt * (mt - 1) // 2) + mt * (mt - 1) * (mt - 2) // 6


def frob_residual(torch, L, A) -> float:
    """||L Lᵀ - A||_F / ||A||_F in float64 on L's device, L's lower
    triangle."""
    L64, A64 = L.double().tril(), A.double()
    return ((L64 @ L64.mT - A64).norm() / A64.norm()).item()


def substrate_compose(ptt, torch, ctx, dev, spd, spd_dev,
                      device: str = "cuda") -> tuple:
    """(a) ``compose(ctx, redistribute S→T lower, POTRF on T)`` at the POTRF
    cell's width. Gates: when the POTRF stage is built (the compound calls
    its builder at stage 1's completion), every fragment task has run on
    the card and no POTRF task exists yet, and T's lower tiles are S's
    slices bit for bit; the factor's residual is within the POTRF cell's
    1e-5. Returns (S, T)."""
    from parsec_tpu_torch.data.matrix import SymTwoDimBlockCyclic
    from parsec_tpu_torch.data.redistribute import redistribute
    from parsec_tpu_torch.ops.potrf import insert_potrf_tasks
    N, sts, tts = SUB_N, SUB_S_TS, SUB_T_TS
    S = ptt.collection_from_numpy("S", spd, sts, sts, device=device)
    T = SymTwoDimBlockCyclic("T", N, N, tts, tts, uplo=0, device=device)
    rec = {}
    ex0 = dev.executed_tasks
    t0 = time.perf_counter()
    stage1 = ptt.DTDTaskpool(ctx, "redistribute S->T")
    n1 = redistribute(stage1, S, T)

    def stage1_done(_tp):
        rec["done"] = time.perf_counter()

    def potrf_stage():
        rec["built"] = time.perf_counter()
        rec["ran"] = dev.executed_tasks - ex0
        r = sts // tts
        rec["same"] = all(torch.equal(
            T.data_of(m, n).newest_copy().payload,
            S.data_of(m // r, n // r).newest_copy().payload[
                (m % r) * tts:(m % r + 1) * tts,
                (n % r) * tts:(n % r + 1) * tts])
            for m in range(T.mt) for n in range(m + 1))
        tp = ptt.DTDTaskpool(ctx, "potrf T")
        rec["n2"] = insert_potrf_tasks(tp, T)
        tp.close()
        return tp

    stage1.on_complete = stage1_done
    comp = ptt.compose(ctx, stage1, potrf_stage)
    stage1.close()
    ctx.wait()
    sync(torch, device)
    t_end = time.perf_counter()
    resid = frob_residual(torch, tiles_of(torch, T, device), spd_dev)
    log(f"substrate (a) compose: redistribute S ({N}^2 f32, TS {sts}) -> T "
        f"(symmetric lower, TS {tts}) {n1} fragment tasks in "
        f"{rec['done'] - t0:.3f} s, then POTRF on T {rec.get('n2')} tasks "
        f"in {t_end - rec['built']:.3f} s; at the POTRF stage's build "
        f"{rec['ran']} tasks had run on the card, T's lower tiles "
        f"{'bit for bit' if rec['same'] else 'NOT'} S's slices; "
        f"||LL^T - A||_F/||A||_F = {resid:.3e}")
    if not comp.completed or n1 != T.mt * (T.mt + 1) // 2 or \
            rec["ran"] != n1 or rec["built"] < rec["done"] or \
            rec["n2"] != potrf_tasks(T.mt):
        raise AssertionError(f"compose ran out of order or miscounted: {rec}")
    if not rec["same"]:
        raise AssertionError("stage 1 left T's tiles unequal to S's slices")
    if not resid < 1e-5:
        raise AssertionError(f"the composed POTRF's residual {resid:.3e}")
    return S, T


def substrate_redistribute(ptt, torch, ctx, dev, S, spd_dev,
                           device: str = "cuda") -> None:
    """(b) Redistribution at full size: the unaligned fragment path S → V
    (TS 384) over the region, bit for bit the plain slice assignment, and
    the reshuffle path S → U (same tiles): each U tile's device payload IS
    S's, and the card's allocated memory grows by less than one tile."""
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
    from parsec_tpu_torch.data.redistribute import redistribute
    N, R = SUB_N, SUB_REGION
    V = TwoDimBlockCyclic("V", N, N, SUB_V_TS, SUB_V_TS, device=device)
    t0 = time.perf_counter()
    tp = ptt.DTDTaskpool(ctx, "redistribute S->V")
    n_v = redistribute(tp, S, V, **R)
    tp.wait(); tp.close(); ctx.wait()
    sync(torch, device)
    t_v = time.perf_counter() - t0
    want = torch.zeros(N, N, device=device)
    want[R["ti"]:R["ti"] + R["m"], R["tj"]:R["tj"] + R["n"]] = \
        spd_dev[R["si"]:R["si"] + R["m"], R["sj"]:R["sj"] + R["n"]]
    same_v = torch.equal(tiles_of(torch, V, device), want)
    del V, want
    U = TwoDimBlockCyclic("U", N, N, SUB_S_TS, SUB_S_TS, device=device)
    for m in range(U.mt):
        for n in range(U.nt):
            U.data_of(m, n)                  # U's zero tiles exist before
    sync(torch, device)

    def allocated():
        return torch.cuda.memory_allocated() if device == "cuda" else 0
    mem0 = allocated()
    t0 = time.perf_counter()
    tp = ptt.DTDTaskpool(ctx, "reshuffle S->U")
    n_u = redistribute(tp, S, U)
    tp.wait(); tp.close(); ctx.wait()
    sync(torch, device)
    t_u = time.perf_counter() - t0
    grown = allocated() - mem0
    tile = SUB_S_TS * SUB_S_TS * 4
    moved = sum(U.data_of(m, n).get_copy(dev.device_index).payload is
                S.data_of(m, n).newest_copy().payload
                for m in range(U.mt) for n in range(U.nt))
    log(f"substrate (b) redistribute: S -> V (TS {SUB_V_TS}, region {R}) "
        f"{n_v} fragment tasks in {t_v:.3f} s, "
        f"{'bit for bit' if same_v else 'NOT equal to'} the plain slice; "
        f"reshuffle S -> U (TS {SUB_S_TS}) {n_u} move tasks in {t_u:.3f} s, "
        f"{moved} of {U.mt * U.nt} U device payloads are S's, allocated "
        f"memory grew {grown} B (a tile is {tile} B)")
    if not same_v:
        raise AssertionError("the unaligned redistribution differs from the "
                             "plain slice")
    if n_u != U.mt * U.nt or moved != n_u or not grown < tile:
        raise AssertionError("the reshuffle copied instead of moving")


def substrate_recursive(ptt, torch, ctx, device: str = "cuda") -> None:
    """(c) Four DEV_RECURSIVE tasks, each factoring one 4096² SPD tile on the
    card by a nested POTRF (TS 256, 816 tasks) over its subtile view.
    Gates: each task ran on the recursive device, each subtile buffer lies
    on the card, each parent completed after its nested pool, each
    residual within 1e-5."""
    from parsec_tpu_torch.core.task import (Chore, DEV_RECURSIVE,
                                            FLOW_ACCESS_CTL, Flow, Task,
                                            TaskClass, Taskpool)
    from parsec_tpu_torch.data.matrix import TiledMatrix
    from parsec_tpu_torch.data.subtile import SubtileCollection
    from parsec_tpu_torch.device.recursive import (RecursiveDevice,
                                                   make_recursive_hook)
    from parsec_tpu_torch.ops.potrf import insert_potrf_tasks
    nt, ts = SUB_REC_TILES, SUB_REC_N
    spds = []
    for k in range(nt):
        g = torch.Generator(device=device).manual_seed(100 + k)
        x = torch.randn(ts, ts, dtype=torch.float64, device=device,
                        generator=g) / math.sqrt(ts)
        spds.append((x @ x.mT + torch.eye(ts, dtype=torch.float64,
                                          device=device) * ts * 0.05
                     ).float())
    R = TiledMatrix("Rec", nt * ts, ts, ts, ts, device=device)
    R.fill(lambda m, n: spds[m])
    order, seen = [], {}

    def builder(task):
        k = task.locals["k"]
        sub = SubtileCollection(R.data_of(k, 0), SUB_T_TS, SUB_T_TS,
                                name=f"sub{k}")
        tp = ptt.DTDTaskpool(ctx, f"nested potrf {k}")
        seen[k] = (isinstance(task.selected_device, RecursiveDevice),
                   sub.buffer.device.type == device,
                   insert_potrf_tasks(tp, sub))
        tp.close()

        def flushed(_tp):
            sub.flush()
            order.append(("nested", k))
        tp.on_complete = flushed
        return tp

    outer = Taskpool("recursive outer")
    tc = TaskClass("R")
    tc.add_flow(Flow("ctl", FLOW_ACCESS_CTL))
    tc.count_mode = True
    tc.add_chore(Chore(DEV_RECURSIVE, make_recursive_hook(builder)))
    outer.add_task_class(tc)

    def startup(stream, pool):
        pool.set_nb_tasks(nt)
        tasks = [Task(pool, tc, {"k": k}) for k in range(nt)]
        for t in tasks:
            t.on_complete = lambda t_: order.append(("parent",
                                                     t_.locals["k"]))
        return tasks

    outer.startup_hook = startup
    t0 = time.perf_counter()
    ctx.add_taskpool(outer)
    ctx.wait()
    sync(torch, device)
    wall = time.perf_counter() - t0
    resid = [frob_residual(torch, torch.as_tensor(
        R.data_of(k, 0).newest_copy().payload), spds[k]) for k in range(nt)]
    after = all(order.index(("nested", k)) < order.index(("parent", k))
                for k in range(nt)) if len(order) == 2 * nt else False
    log(f"substrate (c) recursive: {nt} DEV_RECURSIVE tasks, each a nested "
        f"POTRF over the subtile view of a {ts}^2 tile (TS {SUB_T_TS}): "
        f"(recursive device, buffer on the card, tasks) {seen}; parents "
        f"after their nested pools {after}; residuals "
        f"{', '.join(f'{r:.3e}' for r in resid)}; {wall:.3f} s")
    if not outer.completed or not after or \
            seen != {k: (True, True, potrf_tasks(ts // SUB_T_TS))
                     for k in range(nt)} or \
            not all(r < 1e-5 for r in resid):
        raise AssertionError("the recursive subtile POTRF failed its gates")


def band_pack_plain(torch, d, sd, shape) -> "torch.Tensor":
    """The reference's per-column band packing on the card (the plain
    version of ``diag_band_to_rect``'s body)."""
    mb = d.shape[0]
    out = torch.zeros(shape, dtype=d.dtype, device=d.device)
    for j in range(mb):
        out[:mb - j, j] = d[j:mb, j]
        if sd is not None:
            out[mb - j:mb + 1, j] = sd[:j + 1, j]
    return out


def substrate_ops(ptt, torch, ctx, T, device: str = "cuda") -> None:
    """(d) The collection helpers on f32 8192², TS 512 collections on the
    card (apply, map_operator, reduce_row, reduce_col, reduce_all,
    broadcast), each tile bit for bit a plain torch pass in the same order,
    and diag_band_to_rect of T's factor against the plain per-column
    packing."""
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
    from parsec_tpu_torch.data import ops as O
    N, ts = SUB_N, SUB_S_TS
    rng = np.random.default_rng(31)
    D = ptt.collection_from_numpy(
        "D", rng.standard_normal((N, N), dtype=np.float32), ts, ts,
        device=device)
    E = ptt.collection_from_numpy(
        "E", rng.standard_normal((N, N), dtype=np.float32), ts, ts,
        device=device)
    cells = [(m, n) for m in range(D.mt) for n in range(D.nt)]
    Dp = {c: D.data_of(*c).newest_copy().payload.clone() for c in cells}
    Ep = {c: E.data_of(*c).newest_copy().payload.clone() for c in cells}
    t0 = time.perf_counter()
    tp = ptt.DTDTaskpool(ctx, "ops")
    n = O.apply(tp, D, lambda m, k, x: x * (1.5 + (m - k) * 0.25))
    n += O.map_operator(tp, D, E, lambda s, d: d - s)
    n += O.reduce_row(tp, E, lambda d, s: d + s)
    n += O.reduce_col(tp, E, lambda d, s: d - s)
    n += O.reduce_all(tp, D, lambda d, s: d + s, root=(1, 2))
    tp.wait(); tp.close(); ctx.wait()
    tp = ptt.DTDTaskpool(ctx, "broadcast")
    n += O.broadcast(tp, E, root=(0, 0))
    tp.wait(); tp.close(); ctx.wait()
    sync(torch, device)
    wall = time.perf_counter() - t0
    # the plain pass, in the helpers' insertion order
    for m, k in cells:
        Dp[m, k] = Dp[m, k] * (1.5 + (m - k) * 0.25)
    for c in cells:
        Ep[c] = Ep[c] - Dp[c]
    for m in range(E.mt):
        for k in range(1, E.nt):
            Ep[m, 0] = Ep[m, 0] + Ep[m, k]
    for k in range(E.nt):
        for m in range(1, E.mt):
            Ep[0, k] = Ep[0, k] - Ep[m, k]
    order = [(1, 2)] + [c for c in cells if c != (1, 2)]
    stride = 1
    while stride < len(order):
        for i in range(0, len(order) - stride, 2 * stride):
            dst, src = order[i], order[i + stride]
            Dp[dst] = Dp[dst] + Dp[src]
        stride *= 2
    for c in cells:
        if c != (0, 0):
            Ep[c] = Ep[0, 0]
    same = sum(torch.equal(D.data_of(*c).newest_copy().payload, Dp[c]) and
               torch.equal(E.data_of(*c).newest_copy().payload, Ep[c])
               for c in cells)
    del D, E, Dp, Ep
    mb = T.mb
    B = TwoDimBlockCyclic("Band", mb + 1, T.nt * (mb + 2), mb + 1, mb + 2,
                          device=device)
    t1 = time.perf_counter()
    tp = ptt.DTDTaskpool(ctx, "diag_band_to_rect")
    n_band = O.diag_band_to_rect(tp, T, B)
    tp.wait(); tp.close(); ctx.wait()
    sync(torch, device)
    wall_band = time.perf_counter() - t1
    band_same = all(torch.equal(
        B.data_of(0, k).newest_copy().payload,
        band_pack_plain(torch, T.data_of(k, k).newest_copy().payload,
                        T.data_of(k + 1, k).newest_copy().payload
                        if k + 1 < T.nt else None, (mb + 1, mb + 2)))
        for k in range(T.nt))
    log(f"substrate (d) collection ops on f32 {N}^2 (TS {ts}) on the card: "
        f"{n} tasks in {wall:.3f} s, {same} of {len(cells)} tile pairs bit "
        f"for bit the plain pass; diag_band_to_rect of T's factor: "
        f"{n_band} tasks in {wall_band:.3f} s, "
        f"{'bit for bit' if band_same else 'NOT equal to'} the plain "
        f"per-column packing")
    if same != len(cells) or not band_same or n_band != T.nt:
        raise AssertionError("a collection helper differs from its plain "
                             "pass")


def substrate_checkpoint(ptt, K, torch, T, device: str = "cuda") -> None:
    """(e) Save T's factor, restore it into a fresh collection on the card,
    bit for bit; the files go under the build directory and are removed."""
    import shutil
    from parsec_tpu_torch.data.matrix import SymTwoDimBlockCyclic
    from parsec_tpu_torch.utils import checkpoint
    where = os.path.join(K.BUILD_DIR, "chip_smoke_checkpoint")
    path = os.path.join(where, "T")
    try:
        t0 = time.perf_counter()
        npz = checkpoint.save(path, {"T": T})
        t_save = time.perf_counter() - t0
        nbytes = os.path.getsize(npz)
        T2 = SymTwoDimBlockCyclic("T", T.lm, T.ln, T.mb, T.nb, uplo=0,
                                  device=device)
        t0 = time.perf_counter()
        n = checkpoint.restore(path, {"T": T2})
        sync(torch, device)
        t_restore = time.perf_counter() - t0
    finally:
        shutil.rmtree(where, ignore_errors=True)
    tiles = [(m, k) for m in range(T.mt) for k in range(m + 1)]
    same = sum(torch.equal(T.data_of(*c).newest_copy().payload,
                           T2.data_of(*c).newest_copy().payload) for c in tiles)
    on_card = all(T2.data_of(*c).newest_copy().payload.device.type == device
                  for c in tiles)
    log(f"substrate (e) checkpoint of T's factor: {nbytes} B "
        f"({nbytes / 2**20:.1f} MiB) saved in {t_save:.3f} s, {n} tiles "
        f"restored onto the card in {t_restore:.3f} s, {same} of "
        f"{len(tiles)} bit for bit")
    if n != len(tiles) or same != len(tiles) or not on_card:
        raise AssertionError("the checkpoint did not restore T's factor")


def substrate_probe(torch) -> None:
    """(f) The backend probe: after a reset, the first decision comes from
    its subprocess (and writes the cache file), the second is an
    in-process hit."""
    from parsec_tpu_torch.device import probe
    probe.reset_for_tests()
    t0 = time.perf_counter()
    first = probe.decide_backend()
    t1 = time.perf_counter()
    second = probe.decide_backend()
    t2 = time.perf_counter()
    cached = os.path.exists(probe._cache_path())
    log(f"substrate (f) probe: decide_backend() {first} from its subprocess "
        f"in {t1 - t0:.3f} s (cache file written: {cached}), again "
        f"{second} in {(t2 - t1) * 1e6:.1f} us")
    if first != ("cuda", torch.cuda.device_count()) or second is not first \
            or not cached:
        raise AssertionError(f"the probe decided {first}, then {second}")


def flash_head_dim_rows(K, torch, device_times: dict) -> list:
    """(g) The flash kernel at the FLASH_TIMED rows (head dims 80 and 256
    at the LM path's (96, 1024) causal bf16 shape; d = 512 on the chunked
    route at that shape in bf16 and at (16, 1024) in float32; the LM path's
    float32 shape): every element within the tolerance of its plain
    version (bf16's bound; float32 rtol/atol 2e-4), the kernel line's time,
    plain's, SDPA's, and the bound; the profiled device times, and the
    FLASH_TURNED row's times in turns with the mma route, from
    ``device_times``."""
    import torch.nn.functional as F
    s = LM_SEQ
    gen = torch.Generator(device="cuda").manual_seed(12)
    rows = []
    for name, bh, d in FLASH_TIMED:
        dt_ = getattr(torch, name)
        q, k, v = (torch.randn(bh, s, d, device="cuda", generator=gen
                               ).to(dt_) for _ in range(3))
        got = K.flash_attention(q, k, v, causal=True).float()
        want = K.flash_attention_plain(q, k, v, causal=True).float()
        err = (got - want).abs()
        tol = K.flash_attention_bf16_tolerance(q, k, v, causal=True) \
            if name == "bfloat16" else 2e-4 + 2e-4 * want.abs()
        beyond = int((err > tol).sum())
        kernel_ms = cuda_time_ms(lambda: K.flash_attention(q, k, v,
                                                           causal=True))
        plain_ms = cuda_time_ms(
            lambda: K.flash_attention_plain(q, k, v, causal=True), iters=5)
        q4, k4, v4 = (sdpa_view(t, bh) for t in (q, k, v))
        K.dot_precision()                  # no TF32 for the library either
        library_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True))
        e = kernel_entry(
            "flash_attention", "parsec_tpu_torch/csrc/flash_attention.cu",
            "parsec_tpu/ops/pallas_kernels.py:329", 0, err.max().item(),
            kernel_ms, plain_ms, 4 * bh * s * d * q.element_size(),
            4.0 * d * bh * (s * (s + 1) / 2), name, library_ms)
        dt = device_times[f"{name} d={d}"]
        row = {"shape": [bh, s, d], "dtype": name, "causal": True,
               "route": dt["route"], "max_abs_err": e["max_abs_err"],
               "beyond_tolerance": beyond, "ms": kernel_ms,
               "device_ms": dt["device_ms"], "plain_ms": plain_ms,
               "bound_ms": e["bound_ms"], "bound_by": e["bound_by"],
               "library_ms": library_ms,
               "library_device_ms": dt["library_device_ms"],
               "library_kernel": dt["library_kernel"]}
        if "in_turns" in dt:
            row["in_turns"] = dt["in_turns"]
        rows.append(row)
        log(f"flash_attention {name} ({bh}, {s}, {d}) causal, "
            f"{row['route']} route: kernel {kernel_ms:.4f} ms (device "
            f"{fmt_ms(row['device_ms'])}), plain {plain_ms:.4f} ms, "
            f"scaled_dot_product_attention {library_ms:.4f} ms (device "
            f"{fmt_ms(row['library_device_ms'])}), bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}); max abs err "
            f"{row['max_abs_err']:.3e}, {beyond} beyond the tolerance; "
            f"SDPA's kernel {row['library_kernel']}")
        if beyond:
            raise AssertionError(f"flash_attention at head dim {d} disagrees "
                                 f"with its plain version")
        del q, k, v, q4, k4, v4, got, want, err
    return rows


def lm_head_dim_80(K, torch) -> tuple:
    """(g) A 2-layer LM at n_embd 1280 and 16 heads (head dim 80): the f32
    forward through the flash core against the dense core at the LM's
    rtol/atol 2e-3, and the bf16 flash forward against the f32 flash
    logits at LOGIT_TOL / LOGIT_NORM_TOL. Returns the flash launches, in
    all and by route, counted from 0 just before."""
    from parsec_tpu_torch.parallel import model as M
    from parsec_tpu_torch.parallel.transformer import flash_attention_core
    cfg = M.ModelConfig(**LM_D80)
    params = M.params_from_numpy(M.init_lm_params(3, cfg))
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                      (LM_D80_BATCH, LM_SEQ))).cuda()
    L = cfg.n_layers
    K.flash_attention.launches = 0
    K.flash_attention.launches_by_route = dict.fromkeys(K.FLASH_ROUTES, 0)
    by_route = K.flash_attention.launches_by_route
    with torch.inference_mode():
        got = M.lm_apply(params, x, attention=flash_attention_core)
        want = M.lm_apply(params, x)
        err = (got - want).abs()
        bad = int((err > 2e-3 + 2e-3 * want.abs()).sum())
        bf16 = M.lm_apply(params, x, attention=flash_attention_core,
                          compute_dtype=torch.bfloat16)
        dev = logits_check(torch, bf16, got)
        finite = bool(torch.isfinite(got).all() and
                      torch.isfinite(bf16).all())
    launches = K.flash_attention.launches
    log(f"LM head dim 80 ({LM_D80}, B={LM_D80_BATCH} S={LM_SEQ}): f32 "
        f"flash-core logits vs dense core max abs err "
        f"{err.max().item():.3e}, {bad} beyond rtol/atol 2e-3; bf16 flash "
        f"logits vs f32: {dev[0]} beyond rtol/atol {LOGIT_TOL}, norm-wise "
        f"{dev[2]:.3e}; finite {finite}; flash launches {launches}, by "
        f"route {by_route}")
    if bad or not finite or dev[0] or not dev[2] <= LOGIT_NORM_TOL:
        raise AssertionError("the head-dim-80 LM's flash core disagrees")
    if launches != 2 * L or by_route["simt"] != L or by_route["wgmma"] != L:
        raise AssertionError(f"the head-dim-80 LM launched the flash kernel "
                             f"{launches} times ({by_route})")
    del params, got, want, bf16, err
    torch.cuda.empty_cache()
    return launches, dict(by_route)


def substrate(ptt, K, torch, smi, device_times: dict,
              device: str = "cuda") -> tuple:
    """Phase 11: the single-rank substrate on the card, (a)-(g) in order on
    one context. Returns the flash launches of the head-dim-80 LM (in all
    and by route) and the flash timing rows. ``device="cpu"`` rehearses
    (a)-(e) on a CPU context with the CUDA module over CPU tensors (at the
    sizes the caller sets) and returns nothing."""
    from parsec_tpu_torch.device.cuda import CUDADevice
    from parsec_tpu_torch.ops.potrf import make_spd
    t_phase = time.perf_counter()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
        ctx = ptt.Context(nb_cores=1)
    else:
        ptt.mca.set("device_cuda_over_cpu", True)
        ctx = ptt.Context(nb_cores=1, device="cpu")
    dev = next(d for d in ctx.devices.devices if isinstance(d, CUDADevice))
    names = [d.name for d in ctx.devices.devices]
    log(f"substrate: devices {list(enumerate(names))} ({smi})")
    if names[:2] != ["cpu", "recursive"] or dev.device_index != 2:
        raise AssertionError(f"device numbering {names}")
    spd = make_spd(SUB_N, seed=7)
    spd_dev = torch.from_numpy(spd).to(device)
    S, T = substrate_compose(ptt, torch, ctx, dev, spd, spd_dev, device)
    substrate_redistribute(ptt, torch, ctx, dev, S, spd_dev, device)
    del S
    substrate_recursive(ptt, torch, ctx, device)
    substrate_ops(ptt, torch, ctx, T, device)
    substrate_checkpoint(ptt, K, torch, T, device)
    del T, spd_dev
    ctx.fini()
    if device != "cuda":
        ptt.mca.params.unset("device_cuda_over_cpu")
        return None
    torch.cuda.empty_cache()
    substrate_probe(torch)
    rows = flash_head_dim_rows(K, torch, device_times)
    launches, by_route = lm_head_dim_80(K, torch)
    log(f"substrate phase peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, wall time "
        f"{time.perf_counter() - t_phase:.1f} s ({smi})")
    return launches, by_route, rows


# ---------------------------------------------------------------------------
# phase 12: distribution on the task path
# ---------------------------------------------------------------------------
#: step 1: the DTD GEMM of phase 3 on two in-process ranks (P = 2, Q = 1)
DIST_GEMM_N, DIST_GEMM_TS = GEMM_N, GEMM_TS
#: step 2: the DTD POTRF of phase 5 on two OS processes over TCP
DIST_POTRF_N, DIST_POTRF_TS = POTRF_N, POTRF_TS
#: step 3: the 2-rank PTG legs of the reference bench (bench.py:1130-1170)
DIST_CHAIN_NT, DIST_CHAIN_DEPTH = 64, 128
DIST_DATA_NT, DIST_DATA_DEPTH, DIST_DATA_TS = 16, 32, 32
DIST_REPS = 2
#: the chain leg's lanes in turns (True: the native comm lane)
DIST_TURNS = (True, False, False, True)
#: step 4: the 2-rank PTG GEMM with a [type=CUDA] body, f32
DIST_PTG_T, DIST_PTG_TS = 16, 512
#: each rank's tile budget on the one card (``device_cuda_max_bytes``):
#: a second context on the card would otherwise budget 75% of what the
#: first left free
DIST_RANK_BYTES = 4 << 30
DIST_PROC_BYTES = 1 << 30

#: the test program of the distributed PTG GEMM (the reference's
#: tests/test_distributed.py::test_distributed_ptg_gemm), its body in torch
DIST_PTG_GEMM_SRC = """
%global MT
%global NT
%global KT
%global descA
%global descB
%global descC

RA(m, k)
  m = 0 .. MT-1
  k = 0 .. KT-1
  : descA(m, k)
  READ A <- descA(m, k)
       -> A GEMM(m, 0 .. NT-1, k)
BODY
  A = A
END

RB(k, n)
  k = 0 .. KT-1
  n = 0 .. NT-1
  : descB(k, n)
  READ B <- descB(k, n)
       -> B GEMM(0 .. MT-1, n, k)
BODY
  B = B
END

GEMM(m, n, k)
  m = 0 .. MT-1
  n = 0 .. NT-1
  k = 0 .. KT-1
  : descC(m, n)
  priority = KT - k
  READ A <- A RA(m, k)
  READ B <- B RB(k, n)
  RW   C <- (k == 0) ? descC(m, n) : C GEMM(m, n, k-1)
       -> (k < KT-1) ? C GEMM(m, n, k+1) : descC(m, n)
BODY [type=CUDA]
  C = C + torch.matmul(A, B)
END
"""

#: the reference bench's 2-rank legs (benchmarks/comm_lane.py): every
#: chain edge crosses ranks (level l is owned by rank l % 2)
DIST_CHAIN_SRC = """%global NT
%global DEPTH
%global descA
T(i, l)
  i = 0 .. NT-1
  l = 0 .. DEPTH-1
  : descA(l, i)
  CTL S <- (l > 0) ? S T(i, l-1)
        -> (l < DEPTH-1) ? S T(i, l+1)
BODY
  pass
END
"""
DIST_DATA_SRC = """%global NT
%global DEPTH
%global TS
%global descA
%global descX
%global descY
T(i, l)
  i = 0 .. NT-1
  l = 0 .. DEPTH-1
  : descA(l, i)
  RW X <- (l == 0) ? descX(0, i) : X T(i, l-1)
       -> (l < DEPTH-1) ? X T(i, l+1) : descY(0, i)
BODY
  pass
END
"""


def dist_counters() -> dict:
    from parsec_tpu_torch.utils.counters import counters
    return {k: counters.read(k) for k in (
        "comm.ici_d2d_msgs", "comm.ici_d2d_bytes", "comm.ici_host_msgs",
        "comm.host_materialized_msgs", "comm.xhost_offered_msgs",
        "comm.xhost_d2d_msgs", "comm.xhost_d2d_bytes")}


def dist_gemm(ptt, K, torch, smi, device: str = "cuda") -> dict:
    """Step 1: the DTD GEMM of phase 3 (bf16, batch_k) on two in-process
    ranks joined by the d2d backend, both driving the one card. C is held
    bit for bit to the single-rank DAG's C (each tile's chain runs the
    same kernel over the same tiles in the same order); every GEMM_K task
    launches the chain on its split route; the B tiles a rank does not own
    cross card to card, none host-materialized. Slopes (3 DAGs - 1 DAG)
    of the 2-rank run and of the single-rank Python engine (the engine the
    distributed pools take). Returns the chain launches of the 2-rank
    runs."""
    from parsec_tpu_torch.comm.d2d import D2DCE
    from parsec_tpu_torch.comm.remote_dep import RemoteDepEngine
    from parsec_tpu_torch.comm.threads import run_distributed
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
    from parsec_tpu_torch.ops.gemm import gemm_flops, insert_gemm_tasks
    N, TS = DIST_GEMM_N, DIST_GEMM_TS
    T = N // TS
    on_card = device == "cuda"
    # the operands made on the device from a seed (a host generator takes
    # seconds at this size)
    gen = torch.Generator(device=device).manual_seed(42)
    a_dev = torch.randn(N, N, device=device, generator=gen).to(
        torch.bfloat16)
    b_dev = torch.randn(N, N, device=device, generator=gen).to(
        torch.bfloat16)

    def tiled(name, rank=0, nodes=1, P=1, zero=False):
        M = TwoDimBlockCyclic(name, N, N, TS, TS, P=P, Q=1, nodes=nodes,
                              myrank=rank, dtype=torch.bfloat16,
                              device=device)
        src = a_dev if name == "A" else b_dev
        M.fill(lambda m, n: torch.zeros(TS, TS, dtype=torch.bfloat16)
               if zero else src[m * TS:(m + 1) * TS, n * TS:(n + 1) * TS])
        return M

    # the single-rank reference C (one DAG from a zero C) and the
    # single-rank Python engine's slope, on a context of its own
    t0 = time.perf_counter()
    ctx = ptt.Context(nb_cores=1, device=device)
    A, B, C = tiled("A"), tiled("B"), tiled("C", zero=True)
    if on_card:
        torch.cuda.synchronize()

    def single(n_dags: int) -> float:
        with dtd_engine(ptt, False):
            tp = ptt.DTDTaskpool(ctx, "gemm1")
            t = time.perf_counter()
            for _ in range(n_dags):
                insert_gemm_tasks(tp, A, B, C, batch_k=True)
            tp.wait(); tp.close(); ctx.wait()
            if on_card:
                torch.cuda.synchronize()
            return time.perf_counter() - t
    single(1)
    ref_c = tiles_of(torch, C, device)
    s_lo, s_hi = single(1), single(3)
    ctx.fini()
    del A, B, C, ctx
    if on_card:
        torch.cuda.empty_cache()
    t_single = time.perf_counter() - t0

    dmap = [torch.device(device, 0) if on_card else torch.device("cpu")] * 2
    ptt.mca.set("device_cuda_max_bytes", DIST_RANK_BYTES)
    if not on_card:
        ptt.mca.set("device_cuda_over_cpu", True)
    runs = []         # (what, wall s, counter delta, chain launches)
    rank_out = [None, None]

    def program(rank, fabric):
        ctx = ptt.Context(nb_cores=1, device=device, my_rank=rank,
                          nb_ranks=2)
        RemoteDepEngine(ctx, D2DCE(fabric, rank, dmap))
        # the home tiles on the card: the B tiles a rank sends are CUDA
        # tensors, the d2d plane's case
        A = tiled("A", rank, 2, 2)
        B = tiled("B", rank, 2, 2)
        C = tiled("C", rank, 2, 2, zero=True)
        if on_card:
            torch.cuda.synchronize()

        def run(what: str, n_dags: int) -> None:
            fabric.barrier()
            if rank == 0:
                runs.append([what, time.perf_counter(), dist_counters(),
                             K.gemm_chain.launches,
                             K.gemm_chain.launches_by_route["split"]])
            # the counters are the process's, both ranks': no rank sends
            # (an insert may) before rank 0 has read them
            fabric.barrier()
            tp = ptt.DTDTaskpool(ctx, "dgemm")
            for _ in range(n_dags):
                insert_gemm_tasks(tp, A, B, C, batch_k=True)
            tp.wait(timeout=600)
            tp.close()
            ctx.wait(timeout=600)
            if on_card:
                torch.cuda.synchronize()
            fabric.barrier()
            if rank == 0:
                r = runs[-1]
                c1 = dist_counters()
                r[1] = time.perf_counter() - r[1]
                r[2] = {k: c1[k] - v for k, v in r[2].items()}
                r[3] = K.gemm_chain.launches - r[3]
                r[4] = K.gemm_chain.launches_by_route["split"] - r[4]
        run("1 DAG from a zero C", 1)
        mine = {(m, n): C.data_of(m, n).newest_copy().payload
                for m in range(T) for n in range(T) if C.rank_of(m, n) == rank}
        same = all(torch.equal(t, ref_c[m * TS:(m + 1) * TS,
                                        n * TS:(n + 1) * TS])
                   for (m, n), t in mine.items())
        del mine
        run("1 DAG", 1)
        run("3 DAGs", 3)
        rank_out[rank] = {"same": same, "tasks_local": tp_local(ctx)}
        ctx.fini()
        return same

    def tp_local(ctx):
        return sum(s.nb_executed for s in ctx.streams)

    t0 = time.perf_counter()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    same = run_distributed(2, program, timeout=900)
    t_dist = time.perf_counter() - t0
    ptt.mca.params.unset("device_cuda_max_bytes")
    if not on_card:
        ptt.mca.params.unset("device_cuda_over_cpu")
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else 0.0
    del a_dev, b_dev, ref_c
    first, one, three = runs
    tile_bytes = TS * TS * 2
    want_msgs = 2 * (T // 2) * T          # each rank: the B half it lacks
    for what, wall, cnt, l_, split_ in runs:
        log(f"distribution step 1, 2-rank DTD GEMM bf16 N={N} TS={TS} "
            f"(P=2, Q=1, d2d backend, one card), {what}: wall {wall:.3f} s, "
            f"gemm_chain {l_} launches ({split_} split), comm.ici_d2d_msgs "
            f"{cnt['comm.ici_d2d_msgs']:.0f}, comm.ici_d2d_bytes "
            f"{cnt['comm.ici_d2d_bytes']:.0f}, comm.ici_host_msgs "
            f"{cnt['comm.ici_host_msgs']:.0f}, comm.host_materialized_msgs "
            f"{cnt['comm.host_materialized_msgs']:.0f} ({smi})")
    slope = (three[1] - one[1]) / 2
    s_slope = (s_hi - s_lo) / 2
    log(f"distribution step 1: 2-rank slope {slope * 1e3:.1f} ms/DAG -> "
        f"{gemm_flops(N, N, N) / 1e9 / slope:.1f} GFLOP/s; single-rank "
        f"Python engine T1 {s_lo:.3f} s, T3 {s_hi:.3f} s, slope "
        f"{s_slope * 1e3:.1f} ms/DAG; C of the 2-rank DAG bit for bit the "
        f"single-rank DAG's: {all(same)}; tasks run a rank "
        f"{[o['tasks_local'] for o in rank_out]}; peak device memory "
        f"{peak:.3f} GiB for both ranks and the reference C (each rank "
        f"holds its halves of A, B, C and the B half it receives: "
        f"{4 * N * N // 2 * 2 / 2**30:.2f} GiB, budget "
        f"{DIST_RANK_BYTES / 2**30:.0f} GiB); single {t_single:.1f} s, "
        f"2-rank {t_dist:.1f} s ({smi})")
    if not all(same):
        raise AssertionError("the 2-rank DTD GEMM's C differs from the "
                             "single-rank DAG's")
    for what, wall, cnt, l_, split_ in runs:
        dags = 3 if what == "3 DAGs" else 1
        if on_card and (l_ != T * T * dags or split_ != l_):
            raise AssertionError(f"2-rank GEMM ({what}): {l_} chain launches "
                                 f"({split_} split), expected {T * T * dags}")
        if cnt["comm.host_materialized_msgs"] or cnt["comm.ici_host_msgs"]:
            raise AssertionError(f"2-rank GEMM ({what}): a payload crossed "
                                 f"through host memory: {cnt}")
    if first[2]["comm.ici_d2d_msgs"] != want_msgs or \
            first[2]["comm.ici_d2d_bytes"] != want_msgs * tile_bytes:
        raise AssertionError(f"2-rank GEMM: {first[2]} d2d traffic, "
                             f"expected {want_msgs} tiles of {tile_bytes} B")
    return {"launches": sum(r[3] for r in runs), "wall_s": t_single + t_dist}


def _dist_spd(torch, n: int, device: str):
    """The POTRF operand, made on ``device`` from a seed (every process
    makes the same one)."""
    gen = torch.Generator(device=device).manual_seed(7)
    a = torch.randn(n, n, device=device, generator=gen,
                    dtype=torch.float64) / math.sqrt(n)
    return (a @ a.T + torch.eye(n, device=device, dtype=torch.float64)
            * n * 0.05).float()


def dist_potrf_program(rank, ce, n, ts, device="cuda"):
    """One rank of step 2 (an OS process): the DTD POTRF of an n x n
    operand in ts x ts tiles over the TCP mesh on the card, with a tile
    budget of its own; ``comm_device_mem`` comes from the parent's
    environment. Returns the rank's lower tiles, the xhost counters and
    its peak device memory."""
    import torch

    import parsec_tpu_torch as ptt
    from parsec_tpu_torch.comm.remote_dep import RemoteDepEngine
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
    from parsec_tpu_torch.ops.potrf import insert_potrf_tasks
    on_card = device == "cuda"
    ptt.mca.set("device_cuda_max_bytes", DIST_PROC_BYTES)
    ptt.mca.set("device_load_balance_allow_cpu", False)
    if not on_card:
        ptt.mca.set("device_cuda_over_cpu", True)
    t0 = time.perf_counter()
    spd = _dist_spd(torch, n, device)
    ctx = ptt.Context(nb_cores=1, device=device, my_rank=rank,
                      nb_ranks=ce.nb_ranks)
    RemoteDepEngine(ctx, ce)
    A = TwoDimBlockCyclic("A", n, n, ts, ts, P=2, Q=1, nodes=2, myrank=rank,
                          device=device)
    A.fill(lambda m, k: spd[m * ts:(m + 1) * ts, k * ts:(k + 1) * ts])
    del spd
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    c0 = dist_counters()
    ce.sync()
    t1 = time.perf_counter()
    tp = ptt.DTDTaskpool(ctx, "dpotrf")
    ntasks = insert_potrf_tasks(tp, A)
    tp.wait(timeout=600)
    tp.close()
    ctx.wait(timeout=600)
    if on_card:
        torch.cuda.synchronize()
    ce.sync()
    wall = time.perf_counter() - t1
    tiles = {(m, k): A.data_of(m, k).newest_copy().payload.cpu().numpy()
             for m in range(A.mt) for k in range(m + 1)
             if A.rank_of(m, k) == rank}
    executed = sum(s.nb_executed for s in ctx.streams)
    ctx.fini()
    # every pull ACKed: the ledger empties once the peer's ACKs land
    t2 = time.perf_counter()
    while ce._xhost is not None and ce._xhost.pending() and \
            time.perf_counter() - t2 < 30:
        ce.progress()
        time.sleep(0.002)
    c1 = dist_counters()
    out = {"tiles": tiles, "wall": wall, "setup": t1 - t0,
           "ntasks": ntasks, "executed": executed,
           "pins": ce._xhost.pending() if ce._xhost is not None else -1,
           "counters": {k: c1[k] - v for k, v in c0.items()},
           "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                        if on_card else 0.0)}
    ce.sync()
    ce.fini()
    return out


def dist_potrf(torch, smi, device: str = "cuda") -> float:
    """Step 2: the DTD POTRF of phase 5 (f32) on two OS processes on the
    one card over TCP (``run_distributed_procs``), with ``--mca
    comm_device_mem 1`` (CUDA IPC pulls: residual < 1e-5, xhost pulls > 0,
    no host materialization, every pin retired) and then with it off (the
    factor bit for bit the same, the host bounces counted)."""
    from parsec_tpu_torch.comm.tcp import run_distributed_procs
    import functools
    n, ts = DIST_POTRF_N, DIST_POTRF_TS
    t0 = time.perf_counter()
    got = {}
    for device_mem in (True, False):
        os.environ["PARSEC_MCA_comm_device_mem"] = "1" if device_mem else "0"
        try:
            res = run_distributed_procs(
                2, functools.partial(dist_potrf_program, n=n, ts=ts,
                                     device=device),
                timeout=900)
        finally:
            os.environ.pop("PARSEC_MCA_comm_device_mem", None)
        L = np.zeros((n, n), np.float32)
        for r in res:
            for (m, k), t in r["tiles"].items():
                L[m * ts:(m + 1) * ts, k * ts:(k + 1) * ts] = t
        got[device_mem] = L = np.tril(L)
        Ld = torch.from_numpy(L).to(device, torch.float64)
        A64 = _dist_spd(torch, n, device).double()
        resid = ((Ld @ Ld.mT - A64).abs().max() / A64.abs().max()).item()
        del Ld, A64
        cnt = [r["counters"] for r in res]
        log(f"distribution step 2, 2-process DTD POTRF f32 N={n} TS={ts} "
            f"over TCP on one card, comm_device_mem "
            f"{int(device_mem)}: {res[0]['ntasks']} tasks, run "
            f"{[r['executed'] for r in res]} a rank, wall "
            f"{max(r['wall'] for r in res):.3f} s (set-up "
            f"{max(r['setup'] for r in res):.1f} s), max|LL^T - A| / max|A| "
            f"= {resid:.3e}; per rank xhost offered "
            f"{[c['comm.xhost_offered_msgs'] for c in cnt]}, pulled "
            f"{[c['comm.xhost_d2d_msgs'] for c in cnt]} "
            f"({[c['comm.xhost_d2d_bytes'] for c in cnt]} B), host "
            f"materialized {[c['comm.host_materialized_msgs'] for c in cnt]}"
            f", pins left {[r['pins'] for r in res]}, peak device memory "
            f"{[round(r['peak_gib'], 3) for r in res]} GiB (budget "
            f"{DIST_PROC_BYTES / 2**30:.0f} GiB a process) ({smi})")
        if not resid < 1e-5:
            raise AssertionError(f"2-process POTRF residual {resid}")
        pulled = sum(c["comm.xhost_d2d_msgs"] for c in cnt)
        bounced = sum(c["comm.host_materialized_msgs"] for c in cnt)
        if device_mem and device == "cuda" and (
                pulled <= 0 or bounced or any(r["pins"] for r in res)
                or pulled != sum(c["comm.xhost_offered_msgs"] for c in cnt)):
            raise AssertionError("the POTRF's panels did not all cross by "
                                 "CUDA IPC pulls")
        if not device_mem and device == "cuda" and (pulled or not bounced):
            raise AssertionError("with comm_device_mem 0 the panels must "
                                 "host-bounce, counted")
    same = np.array_equal(got[True], got[False])
    log(f"distribution step 2: the factor over CUDA IPC and over the host "
        f"bounce {'bit for bit the same' if same else 'DIFFER'}; "
        f"{time.perf_counter() - t0:.1f} s")
    if not same:
        raise AssertionError("the 2-process POTRF factor depends on the "
                             "payload plane")
    return time.perf_counter() - t0


def dist_chain_program(rank, ce, nt, depth, reps, native=True,
                       device="cuda"):
    """One rank of the 2-rank chain leg (bench.py's chain_program): NT
    CTL chains of DEPTH levels, every edge crossing ranks; rate = global
    tasks / barrier-aligned wall, median of DIST_REPS after a warm rep."""
    import statistics

    import parsec_tpu_torch as ptt
    from parsec_tpu_torch.comm.remote_dep import RemoteDepEngine
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
    from parsec_tpu_torch.dsl.ptg.compiler import compile_ptg
    if not native:
        ptt.mca.set("comm_native", False)
    ptt.mca.set("device_cuda_max_bytes", 1 << 28)
    ctx = ptt.Context(nb_cores=1, device=device, my_rank=rank,
                      nb_ranks=ce.nb_ranks)
    RemoteDepEngine(ctx, ce)
    A = TwoDimBlockCyclic("descA", depth, nt, 1, 1, P=2, Q=1, nodes=2,
                          myrank=rank)
    prog = compile_ptg(DIST_CHAIN_SRC, "dist-chain")
    rates, tp = [], None
    for r in range(reps + 1):
        ce.sync()
        t0 = time.perf_counter()
        tp = prog.instantiate(ctx, globals={"NT": nt, "DEPTH": depth},
                              collections={"descA": A},
                              name=f"dist-chain-{r}")
        ctx.add_taskpool(tp)
        ctx.wait(timeout=600)
        ce.sync()
        if r:
            rates.append(nt * depth / (time.perf_counter() - t0))
    return _dist_lane_result(ctx, ce, tp, rates)


def dist_data_program(rank, ce, nt, depth, ts, reps, native=True,
                      device="cuda"):
    """One rank of the 2-rank data-flow leg (bench.py's data_program): a
    TS x TS f32 tile hops ranks at every level."""
    import parsec_tpu_torch as ptt
    from parsec_tpu_torch.comm.remote_dep import RemoteDepEngine
    from parsec_tpu_torch.data.matrix import TiledMatrix, TwoDimBlockCyclic
    from parsec_tpu_torch.dsl.ptg.compiler import compile_ptg
    if not native:
        ptt.mca.set("comm_native", False)
    ptt.mca.set("device_cuda_max_bytes", 1 << 28)
    ctx = ptt.Context(nb_cores=1, device=device, my_rank=rank,
                      nb_ranks=ce.nb_ranks)
    RemoteDepEngine(ctx, ce)
    A = TwoDimBlockCyclic("descA", depth, nt, 1, 1, P=2, Q=1, nodes=2,
                          myrank=rank)
    X = TiledMatrix("descX", ts, nt * ts, ts, ts)
    X.fill(lambda m, i: np.full((ts, ts), float(i + 1), np.float32))
    Y = TiledMatrix("descY", ts, nt * ts, ts, ts)
    prog = compile_ptg(DIST_DATA_SRC, "dist-data")
    rates, tp = [], None
    for r in range(reps + 1):
        ce.sync()
        t0 = time.perf_counter()
        tp = prog.instantiate(ctx, globals={"NT": nt, "DEPTH": depth,
                                            "TS": ts},
                              collections={"descA": A, "descX": X,
                                           "descY": Y},
                              name=f"dist-data-{r}")
        ctx.add_taskpool(tp)
        ctx.wait(timeout=600)
        ce.sync()
        if r:
            rates.append(nt * depth / (time.perf_counter() - t0))
    # the terminal write-back landed on the owner of T(i, DEPTH-1) with the
    # forwarded (unchanged) seed value
    checked = 0
    if (depth - 1) % 2 == rank:
        for i in range(nt):
            v = float(Y.data_of(0, i).newest_copy().payload[0, 0])
            if v != float(i + 1):
                raise AssertionError(f"data leg tile {i}: {v}")
            checked += 1
    return dict(_dist_lane_result(ctx, ce, tp, rates), checked=checked)


def _dist_lane_result(ctx, ce, tp, rates) -> dict:
    import statistics
    engaged = tp._ptexec_state is not None and \
        tp._ptexec_state.get("pool_id") is not None
    stats = None
    if ctx.comm.native is not None:
        s = ctx.comm.native.comm.stats()
        stats = {k: (list(v) if isinstance(v, list) else v)
                 for k, v in s.items()}
    out = {"rate": statistics.median(rates), "rates": rates,
           "engaged": engaged, "stats": stats}
    ce.sync()
    ctx.fini()
    ce.fini()
    return out


def dist_ptg_legs(smi, device: str = "cuda") -> float:
    """Step 3: the reference bench's 2-rank PTG legs on two OS processes,
    through the native comm lane (``csrc/ptcomm.cpp``) and through
    ``remote_dep.py`` (``--mca comm_native 0``) in turns: the chains
    (NT x DEPTH CTL tasks, every edge crossing ranks) native, python,
    python, native; the data-flow leg native. Every native run engaged the
    lane on both ranks with no frame error."""
    import functools
    from parsec_tpu_torch.comm.tcp import run_distributed_procs
    t0 = time.perf_counter()
    rates = {True: [], False: []}
    for native in DIST_TURNS:
        res = run_distributed_procs(2, functools.partial(
            dist_chain_program, nt=DIST_CHAIN_NT, depth=DIST_CHAIN_DEPTH,
            reps=DIST_REPS, native=native, device=device),
            timeout=900)
        if native and not all(r["engaged"] and r["stats"]["frame_errors"]
                              == 0 for r in res):
            raise AssertionError(f"2-rank chain off the native comm lane: "
                                 f"{[(r['engaged'], r['stats']) for r in res]}")
        if not native and any(r["engaged"] for r in res):
            raise AssertionError("the comm_native 0 chain rode the lane")
        rates[native].append(res[0]["rate"])
        log(f"distribution step 3, 2-rank PTG chain NT={DIST_CHAIN_NT} "
            f"DEPTH={DIST_CHAIN_DEPTH} "
            f"{'native comm lane' if native else 'remote_dep.py'}: "
            f"{res[0]['rate']:,.0f} tasks/s (reps "
            f"{[round(x) for x in res[0]['rates']]})"
            + (f", frames acts_tx {[r['stats']['acts_tx'] for r in res]}, "
               f"frame_errors {[r['stats']['frame_errors'] for r in res]}"
               if native else "") + f" ({smi})")
    res = run_distributed_procs(2, functools.partial(
        dist_data_program, nt=DIST_DATA_NT, depth=DIST_DATA_DEPTH,
        ts=DIST_DATA_TS, reps=DIST_REPS, device=device), timeout=900)
    if not all(r["engaged"] and r["stats"]["frame_errors"] == 0
               for r in res) or sum(r["checked"] for r in res) != \
            DIST_DATA_NT:
        raise AssertionError(f"2-rank data leg: {res}")
    nat = float(np.median(rates[True]))
    py = float(np.median(rates[False]))
    log(f"distribution step 3: chain rates in turns native "
        f"{[round(x) for x in rates[True]]}, remote_dep.py "
        f"{[round(x) for x in rates[False]]} tasks/s -> native / "
        f"remote_dep.py = {nat / py:.1f}x; data-flow leg NT="
        f"{DIST_DATA_NT} DEPTH={DIST_DATA_DEPTH} TS={DIST_DATA_TS} native "
        f"{res[0]['rate']:,.0f} tasks/s, data_tx "
        f"{[r['stats']['data_tx'] for r in res]}, frame_errors "
        f"{[r['stats']['frame_errors'] for r in res]}; "
        f"{time.perf_counter() - t0:.1f} s ({smi})")
    return time.perf_counter() - t0


def dist_ptg_gemm(ptt, torch, smi, device: str = "cuda") -> float:
    """Step 4: the 2-rank PTG GEMM (the reference test's program) with its
    ``[type=CUDA]`` body, f32, on two in-process ranks driving the one
    card: max err / max |ref| < 1e-5 against torch.matmul, TF32 off."""
    from parsec_tpu_torch.comm.remote_dep import RemoteDepEngine
    from parsec_tpu_torch.comm.threads import ThreadsCE, run_distributed
    from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
    from parsec_tpu_torch.dsl.ptg.compiler import compile_ptg
    from parsec_tpu_torch.ops.cuda_kernels import dot_precision
    T, TS = DIST_PTG_T, DIST_PTG_TS
    n = T * TS
    dot_precision()                      # TF32 off for the bodies and ref
    gen = torch.Generator(device=device).manual_seed(5)
    a = torch.randn(n, n, device=device, generator=gen)
    b = torch.randn(n, n, device=device, generator=gen)
    prog = compile_ptg(DIST_PTG_GEMM_SRC, "dist_ptg_gemm")
    ptt.mca.set("device_cuda_max_bytes", DIST_RANK_BYTES)
    ptt.mca.set("device_load_balance_allow_cpu", False)
    if device != "cuda":
        ptt.mca.set("device_cuda_over_cpu", True)
    out = {}

    def program(rank, fabric):
        ctx = ptt.Context(nb_cores=1, device=device, my_rank=rank,
                          nb_ranks=2)
        RemoteDepEngine(ctx, ThreadsCE(fabric, rank))
        kw = dict(nodes=2, myrank=rank, P=2, Q=1, device=device)
        A = TwoDimBlockCyclic("dA", n, n, TS, TS, **kw)
        B = TwoDimBlockCyclic("dB", n, n, TS, TS, **kw)
        C = TwoDimBlockCyclic("dC", n, n, TS, TS, **kw)
        A.fill(lambda m, k: a[m * TS:(m + 1) * TS, k * TS:(k + 1) * TS])
        B.fill(lambda k, j: b[k * TS:(k + 1) * TS, j * TS:(j + 1) * TS])
        C.fill(lambda m, j: torch.zeros(TS, TS))
        if device == "cuda":
            torch.cuda.synchronize()
        tp = prog.instantiate(ctx, globals={"MT": T, "NT": T, "KT": T},
                              collections={"descA": A, "descB": B,
                                           "descC": C},
                              name="dist_ptg_gemm")
        fabric.barrier()
        t = time.perf_counter()
        ctx.add_taskpool(tp)
        ctx.wait(timeout=600)
        if device == "cuda":
            torch.cuda.synchronize()
        fabric.barrier()
        wall = time.perf_counter() - t
        for m in range(T):
            for j in range(T):
                if C.rank_of(m, j) == rank:
                    out[(m, j)] = C.data_of(m, j).newest_copy().payload
        executed = sum(s.nb_executed for s in ctx.streams)
        ctx.fini()
        return wall, executed

    t0 = time.perf_counter()
    res = run_distributed(2, program, timeout=900)
    ptt.mca.params.unset("device_cuda_max_bytes")
    ptt.mca.params.unset("device_load_balance_allow_cpu")
    if device != "cuda":
        ptt.mca.params.unset("device_cuda_over_cpu")
    got = torch.zeros(n, n, device=device)
    for (m, j), t in out.items():
        got[m * TS:(m + 1) * TS, j * TS:(j + 1) * TS] = t.to(device)
    ref = torch.matmul(a, b)
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    log(f"distribution step 4, 2-rank PTG GEMM f32 N={n} TS={TS} "
        f"([type=CUDA] body, ThreadsCE): wall {max(w for w, _ in res):.3f} "
        f"s, tasks run a rank {[e for _, e in res]}, max err / max |ref| "
        f"{rel:.3e} against torch.matmul (TF32 off) ({smi})")
    if len(out) != T * T or not rel < 1e-5:
        raise AssertionError(f"2-rank PTG GEMM: {len(out)} tiles, rel {rel}")
    return time.perf_counter() - t0


def distribution(ptt, K, torch, smi, device: str = "cuda") -> dict:
    """Phase 12: distribution on the task path, steps 1-4 in order, each
    step's wall seconds and the phase's. Returns the chain launches of the
    2-rank GEMM (the ``distributed`` lane of the chain's entry)."""
    t0 = time.perf_counter()
    walls = {}
    if device == "cuda":
        torch.cuda.empty_cache()
    g = dist_gemm(ptt, K, torch, smi, device)
    walls["1 2-rank DTD GEMM (d2d)"] = g["wall_s"]
    if device == "cuda":
        torch.cuda.empty_cache()
    walls["2 2-process DTD POTRF (TCP, CUDA IPC)"] = dist_potrf(
        torch, smi, device)
    walls["3 2-rank PTG legs (native comm lane, remote_dep)"] = \
        dist_ptg_legs(smi, device)
    walls["4 2-rank PTG GEMM [type=CUDA]"] = dist_ptg_gemm(ptt, torch, smi,
                                                          device)
    if device == "cuda":
        torch.cuda.empty_cache()
    log("distribution: wall seconds by step " + "; ".join(
        f"{k} {v:.1f}" for k, v in walls.items())
        + f"; phase {time.perf_counter() - t0:.1f} s ({smi})")
    return {"launches": g["launches"], "walls": walls}



# ---------------------------------------------------------------------------
# phase 13: training on the card
# ---------------------------------------------------------------------------
#: (a) the gradients' check: GPT-2 small widths at this depth and batch
TRAIN_GRAD_LAYERS, TRAIN_GRAD_BATCH = 2, 4
#: (b) the 12-layer training run: batch, steps (the loader's), the step
#: after which (d) saves, the AdamW rate; the corpus's length and alphabet
TRAIN_BATCH, TRAIN_STEPS, TRAIN_SAVE_AT, TRAIN_LR = 8, 20, 10, 1e-3
TRAIN_CORPUS, TRAIN_ALPHABET = 1 << 18, 64
#: (b) timed steps of each core, in turns, after one warm-up each
TRAIN_ROUNDS = 4
#: (c) the MoE-LM: layers, experts, top-k, batch, SGD rate, steps; the
#: tokens of the one-device expert group's capacity check
MOE_LAYERS, MOE_EXPERTS, MOE_K, MOE_BATCH, MOE_LR, MOE_STEPS = 4, 8, 2, 4, \
    0.05, 5
MOE_TOKENS = 2048


def markov_corpus(seed: int, n: int, alphabet: int, vocab: int):
    """A seeded order-1 Markov chain of ``n`` tokens over ``alphabet`` ids
    spread over the vocabulary: each state's next token is one of 4
    successors with probabilities 0.7, 0.1, 0.1, 0.1, so the chain's
    entropy rate is about 0.94 nats, far below ln(vocab). Returns the
    corpus and that entropy rate."""
    rng = np.random.default_rng(seed)
    ids = rng.choice(vocab, size=alphabet, replace=False)
    succ = rng.integers(0, alphabet, size=(alphabet, 4))
    probs = np.array([0.7, 0.1, 0.1, 0.1])
    pick = rng.choice(4, size=n, p=probs)
    states = np.empty(n, np.int64)
    s = 0
    for i in range(n):
        s = succ[s, pick[i]]
        states[i] = s
    return ids[states], float(-(probs * np.log(probs)).sum())


def leaf_errors(torch, got: list, want: list) -> list:
    """Norm-wise relative error of each gradient leaf."""
    return [((a.float() - b.float()).norm() / b.float().norm().clamp_min(
        1e-30)).item() for a, b in zip(got, want)]


def train_gradients(K, torch, M, core, device: str) -> None:
    """(a) Gradients at GPT-2 small width, TRAIN_GRAD_LAYERS layers, B =
    TRAIN_GRAD_BATCH, S = 1024: the flash core against the dense core in
    f32 (the simt route) and with bf16 compute (the wgmma route)."""
    from parsec_tpu_torch.parallel.optim import tree_leaves, value_and_grad
    from parsec_tpu_torch.parallel.transformer import _dense_attention_core
    cfg = M.ModelConfig(**dict(GPT2_SMALL, n_layers=TRAIN_GRAD_LAYERS))
    params = M.params_from_numpy(M.init_lm_params(0, cfg), device)
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (TRAIN_GRAD_BATCH, LM_SEQ + 1)))
    x, y = toks[:, :-1].to(device), toks[:, 1:].to(device)
    wqkv = [i for i, t in enumerate(tree_leaves(params))
            if any(t is bp["wqkv"] for bp in params["blocks"])]
    for cd, route, tol in ((None, "simt", (1e-5, 1e-4)),
                           (torch.bfloat16, "wgmma", (2e-2, 2e-2))):
        before = K.flash_attention.launches_by_route[route]
        lf, _, gf = value_and_grad(
            lambda p: M.lm_loss(p, x, y, attention=core, compute_dtype=cd),
            params)
        launched = K.flash_attention.launches_by_route[route] - before
        ld, _, gd = value_and_grad(
            lambda p: M.lm_loss(p, x, y, attention=_dense_attention_core,
                                compute_dtype=cd), params)
        loss_err = abs(float(lf) - float(ld)) / abs(float(ld))
        errs = leaf_errors(torch, gf, gd)
        wq = [gf[i].norm().item() for i in wqkv]
        name = "f32" if cd is None else "bf16"
        log(f"train (a) {name} L={TRAIN_GRAD_LAYERS} B={TRAIN_GRAD_BATCH} "
            f"S={LM_SEQ}: loss flash {float(lf):.6f} dense {float(ld):.6f} "
            f"(rel {loss_err:.3e}, limit {tol[0]}); worst leaf norm-wise "
            f"{max(errs):.3e} (limit {tol[1]}), median "
            f"{float(np.median(errs)):.3e}; wqkv gradient norms "
            f"{', '.join(f'{v:.4e}' for v in wq)}; {launched} flash "
            f"launches on the {route} route")
        if launched != TRAIN_GRAD_LAYERS:
            raise AssertionError(f"(a) {name}: {launched} flash launches on "
                                 f"the {route} route, not "
                                 f"{TRAIN_GRAD_LAYERS}")
        if not (loss_err <= tol[0] and max(errs) <= tol[1]):
            raise AssertionError(f"(a) {name}: flash-core gradients disagree "
                                 f"with the dense core's")
        if not all(v > 0 for v in wq):
            raise AssertionError(f"(a) {name}: a block's wqkv got no "
                                 f"gradient through the flash core")
        del gf, gd


def moe_capacity_check(torch, MoE, mp, device: str) -> None:
    """(c) moe_forward on a one-device expert group with capacity_factor
    1.0 against dense_reference, with the drops numbered independently on
    the host (choice-major, first come first served) from the router's
    choices: the same (token, choice) pairs dropped, the rows they touch
    the only rows that differ from dense_reference, the kept routes equal
    to it."""
    gen = torch.Generator(device=device).manual_seed(9)
    x = torch.randn(MOE_TOKENS, GPT2_SMALL["d_model"], device=device,
                    generator=gen)
    out, aux = MoE.moe_forward(mp, x, mesh=torch.device(device), k=MOE_K,
                               capacity_factor=1.0, return_aux=True)
    dense = MoE.dense_reference(mp, x, k=MOE_K)
    gates, eid = MoE._topk_gates(torch.softmax(x @ mp["router"], dim=-1),
                                 MOE_K)
    E = mp["w1"].shape[0]
    cap = math.ceil(1.0 * MOE_K * MOE_TOKENS / E)
    eid_h = eid.cpu().numpy()
    keep = np.zeros(eid_h.shape, bool)
    fill = np.zeros(E, np.int64)
    for c in range(MOE_K):                       # choice-major
        for t in range(MOE_TOKENS):
            e = eid_h[t, c]
            keep[t, c] = fill[e] < cap
            fill[e] += 1
    n_drop = int((~keep).sum())
    kept = torch.from_numpy(keep).to(device)
    want = torch.zeros_like(x)
    for e in range(E):
        w = (gates * ((eid == e) & kept)).sum(-1)
        want += MoE._expert_mlp(mp["w1"][e], mp["w2"][e], x) * w[:, None]
    err = (out - want).abs()
    bad = int((err > 2e-5 + 2e-4 * want.abs()).sum())
    differs = ((out - dense).abs() > 2e-5 + 2e-4 * dense.abs()).any(-1)
    host_rows = ~keep.all(-1)
    same_rows = bool((differs.cpu().numpy() == host_rows).all())
    log(f"train (c) moe_forward, one-device expert group, T={MOE_TOKENS}, "
        f"E={E}, k={MOE_K}, capacity_factor 1.0 ({cap} slots): dropped "
        f"{float(aux['dropped']):.0f} (host count {n_drop}) in "
        f"{int(host_rows.sum())} rows; max abs err against the kept routes "
        f"{err.max().item():.3e} ({bad} beyond rtol 2e-4 atol 2e-5); rows "
        f"differing from dense_reference {int(differs.sum())}, the dropped "
        f"rows exactly: {same_rows}; aux loss {float(aux['aux_loss']):.6f}")
    if not (n_drop > 0 and float(aux["dropped"]) == n_drop and not bad
            and same_rows):
        raise AssertionError("(c) moe_forward's drops disagree with the "
                             "host's numbering or with dense_reference")


def train_moe(torch, M, MoE, device: str) -> None:
    """(c) The MoE-LM at GPT-2 small width: MOE_STEPS SGD steps of
    make_lm_moe_train_step on the dense routed path (the loss must fall),
    then the capacity check."""
    from parsec_tpu_torch.data.loader import token_batches
    cfg = M.ModelConfig(**dict(GPT2_SMALL, n_layers=MOE_LAYERS))
    t0 = time.perf_counter()
    params = M.params_from_numpy(
        M.init_lm_moe_params(0, cfg, n_experts=MOE_EXPERTS), device)
    init_s = time.perf_counter() - t0
    corpus, _ = markov_corpus(3, TRAIN_CORPUS, TRAIN_ALPHABET,
                              cfg.vocab_size)
    x, y = next(token_batches(corpus, MOE_BATCH, LM_SEQ, seed=3))
    x, y = torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)
    step = M.make_lm_moe_train_step(k=MOE_K, lr=MOE_LR)
    losses, times = [], []
    for _ in range(MOE_STEPS):
        t = time.perf_counter()
        params, loss = step(params, x, y)
        losses.append(float(loss))
        times.append(time.perf_counter() - t)
    log(f"train (c) MoE-LM L={MOE_LAYERS} E={MOE_EXPERTS} k={MOE_K} "
        f"d_ff={cfg.d_ff} B={MOE_BATCH} S={LM_SEQ}, dense routed path, SGD "
        f"lr {MOE_LR}: losses {', '.join(f'{v:.4f}' for v in losses)}; "
        f"step {min(times) * 1e3:.1f}-{max(times) * 1e3:.1f} ms (wall, "
        f"first included); init {init_s:.1f} s")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError("(c) the MoE-LM's loss did not fall")
    moe_capacity_check(torch, MoE, params["blocks"][0]["moe"], device)


def training(K, torch, smi, device: str = "cuda") -> dict:
    """Phase 13: training on the card, (a)-(e). Returns the flash kernel's
    launches on the training steps of (b), (d) and (e) (in all and by
    route) and the figures of (b) for the kernels line. (a) compares the
    flash core with the dense core and its launches are not counted."""
    import shutil
    import tempfile

    import torch.nn.functional as F
    from parsec_tpu_torch.data.loader import PrefetchLoader, token_batches
    from parsec_tpu_torch.parallel import model as M
    from parsec_tpu_torch.parallel import moe as MoE
    from parsec_tpu_torch.parallel import optim as O
    from parsec_tpu_torch.parallel.transformer import (_dense_attention_core,
                                                       flash_attention_core)
    from parsec_tpu_torch.utils.model_ckpt import (restore_train_state,
                                                   save_train_state)
    from parsec_tpu_torch.utils.xla_trace import annotate, xla_trace
    t_phase = time.perf_counter()
    train_gradients(K, torch, M, flash_attention_core, device)
    log(f"train (a) took {time.perf_counter() - t_phase:.1f} s")

    # ---- (b) GPT-2 small, 12 layers, bf16 compute, remat, clip + AdamW
    cfg = M.ModelConfig(**GPT2_SMALL)
    L, B, S = cfg.n_layers, TRAIN_BATCH, LM_SEQ
    t0 = time.perf_counter()
    tree = M.init_lm_params(0, cfg)
    tx = O.chain(O.clip_by_global_norm(1.0), O.adamw(TRAIN_LR))

    def make(core):
        return M.make_lm_opt_train_step(
            torch.device(device), tx, params, remat=True,
            compute_dtype=torch.bfloat16, attention=core)[0]
    step, opt, place_p, place_t = M.make_lm_opt_train_step(
        torch.device(device), tx, tree, remat=True,
        compute_dtype=torch.bfloat16, attention=flash_attention_core)
    params = place_p(tree)
    del tree
    n_params = sum(t.numel() for t in O.tree_leaves(params))
    corpus, entropy = markov_corpus(1, TRAIN_CORPUS, TRAIN_ALPHABET,
                                    cfg.vocab_size)
    log(f"train (b) GPT-2 small {n_params} parameters (f32 masters), "
        f"bf16 compute, remat, clip 1.0 + AdamW lr {TRAIN_LR}, flash core, "
        f"B={B} S={S}; corpus {corpus.size} tokens, an order-1 Markov chain "
        f"over {TRAIN_ALPHABET} ids (entropy rate {entropy:.3f} nats, ln V = "
        f"{math.log(cfg.vocab_size):.3f}); set-up "
        f"{time.perf_counter() - t0:.1f} s")
    K.flash_attention.launches = 0
    K.flash_attention.launches_by_route = dict.fromkeys(K.FLASH_ROUTES, 0)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    loader = PrefetchLoader(
        lambda: token_batches(corpus, B, S, seed=1, n_batches=TRAIN_STEPS),
        device=device, ahead=2)
    losses, per_step, walls = [], [], []
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    snap = None
    try:
        t_run = time.perf_counter()
        for i, (x, y) in enumerate(loader):
            before = K.flash_attention.launches
            t = time.perf_counter()
            params, opt, loss = step(params, opt, x, y)
            losses.append(loss)
            per_step.append(K.flash_attention.launches - before)
            walls.append(time.perf_counter() - t)
            if i + 1 == TRAIN_SAVE_AT:
                # (d): the live state at this step, kept beside its save
                snap = (O.tree_map(lambda t: t.clone(), params),
                        O.tree_map(lambda t: t.clone(), opt))
                t_save = time.perf_counter()
                save_train_state(ckpt_dir, params, opt, step=i + 1)
                save_s = time.perf_counter() - t_save
        run_s = time.perf_counter() - t_run
        losses = [float(v) for v in losses]
        peak = (torch.cuda.max_memory_allocated() / 2**30
                if device == "cuda" else 0.0)
        log(f"train (b) {len(losses)} steps through PrefetchLoader("
            f"token_batches) in {run_s:.2f} s: loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f} (fell {losses[0] - losses[-1]:.4f} nats); "
            f"losses {', '.join(f'{v:.3f}' for v in losses)}; flash launches "
            f"a step {sorted(set(per_step))} (expected {2 * L}: the forward "
            f"and the remat recompute); step wall median "
            f"{float(np.median(walls)) * 1e3:.1f} ms; peak device memory "
            f"{peak:.3f} GiB ({smi})")
        if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all() or \
                losses[0] - losses[-1] < 1.0:
            raise AssertionError("(b) the loss is not finite or did not "
                                 "fall by 1 nat")
        if set(per_step) != {2 * L}:
            raise AssertionError(f"(b) flash launches a step {per_step}, "
                                 f"expected {2 * L}")

        # step time of each core, in turns, on one batch (training goes on)
        x, y = next(token_batches(corpus, B, S, seed=2))
        x, y = place_t(x), place_t(y)

        def sdpa_core(q, k, v, causal, scale):
            return F.scaled_dot_product_attention(
                q.contiguous(), k.contiguous(), v.contiguous(),
                is_causal=causal, scale=scale)
        cores = {"flash": step, "dense": make(_dense_attention_core),
                 "sdpa": make(sdpa_core)}
        state = {"p": params, "o": opt}

        def runner(fn):
            def run():
                state["p"], state["o"], _ = fn(state["p"], state["o"], x, y)
            return run
        before = K.flash_attention.launches
        ms = medians_in_turns(torch, [runner(f) for f in cores.values()],
                              rounds=TRAIN_ROUNDS)
        timed = K.flash_attention.launches - before
        step_ms = dict(zip(cores, ms))
        log("train (b) step, medians of " + str(TRAIN_ROUNDS) + " in turns: "
            + "; ".join(f"{n} core {t:.2f} ms -> {B * S / t * 1e3:.0f} "
                        f"tokens/s" for n, t in step_ms.items())
            + f" ({timed} flash launches) ({smi})")
        if timed != 2 * L * (TRAIN_ROUNDS + 1):
            raise AssertionError("(b) the timed flash steps did not launch "
                                 "the kernel 2 L times each")
        busy, window, by_name = device_profile(torch, runner(step))
        log(idle_line("train (b) one flash-core step", busy, window))
        flash_prof = sum(v for n, v in by_name.items() if "flash_bf16" in n)
        for name, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
            log(f"  device {v:8.3f} ms  {name[:100]}")
        log(f"  the flash kernel's device time in the profiled step: "
            f"{flash_prof:.3f} ms for {2 * L} launches")
        del cores
        params, opt = state["p"], state["o"]

        # ---- (d) checkpoint saved after step TRAIN_SAVE_AT, restored; one
        # step from each copy
        t = time.perf_counter()
        rp, ro, rstep = restore_train_state(ckpt_dir, like=snap)
        load_s = time.perf_counter() - t
        a, _, la = step(snap[0], snap[1], x, y)
        b, _, lb = step(rp, ro, x, y)
        same = all(torch.equal(s, t) for s, t in
                   zip(O.tree_leaves(a), O.tree_leaves(b)))
        size = sum(os.path.getsize(os.path.join(ckpt_dir, f))
                   for f in os.listdir(ckpt_dir))
        log(f"train (d) checkpoint after step {TRAIN_SAVE_AT}: {size} B "
            f"saved in {save_s:.2f} s, restored in {load_s:.2f} s (step "
            f"{rstep}); one step from the live state and one from the "
            f"restored: loss {float(la):.6f} / {float(lb):.6f}, parameters "
            f"{'bit for bit equal' if same else 'DIFFER'}")
        if not (same and rstep == TRAIN_SAVE_AT and float(la) == float(lb)):
            raise AssertionError("(d) the restored state does not continue "
                                 "bit for bit")
        del a, b, rp, ro, snap
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    # ---- (e) a profiler trace of two steps
    trace_dir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        with xla_trace(trace_dir):
            for i in range(2):
                with annotate(f"lm_train::step{i}"):
                    params, opt, _ = step(params, opt, x, y)
        files = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)]
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
        flash_ev = sum(1 for e in events if e.get("cat") == "kernel"
                       and "flash_bf16" in e.get("name", ""))
        ranges = {e.get("cat") for e in events
                  if str(e.get("name", "")).startswith("lm_train::step")}
        log(f"train (e) xla_trace of 2 steps: {len(files)} file(s), "
            f"{os.path.getsize(files[0])} B, {len(events)} events; flash "
            f"kernel device events {flash_ev} (of {4 * L} launched); the "
            f"steps' ranges (NVTX and record_function) as {sorted(ranges)}")
        if not flash_ev or not {"user_annotation"} <= ranges:
            raise AssertionError("(e) the trace lacks the flash kernel's "
                                 "device events or the step ranges")
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    launches = K.flash_attention.launches
    by_route = dict(K.flash_attention.launches_by_route)
    del params, opt, step
    if device == "cuda":
        torch.cuda.empty_cache()

    # ---- (c) the MoE-LM at GPT-2 small width
    train_moe(torch, M, MoE, device)
    log(f"training phase wall time {time.perf_counter() - t_phase:.1f} s "
        f"({smi})")
    return {"launches": launches, "by_route": by_route,
            "launches_per_step": 2 * L, "step_ms": step_ms,
            "tokens_per_s": {n: B * S / t * 1e3 for n, t in step_ms.items()},
            "busy_ms": busy, "window_ms": window, "peak_gib": peak,
            "loss_first_last": [losses[0], losses[-1]]}


# ---------------------------------------------------------------------------
# phase 14: the serving fabric
# ---------------------------------------------------------------------------

#: keyword arguments of the 2-rank acceptance program: the reference's
#: defaults (a rehearsal on the CPU cuts the durations)
FAB_KW: dict = {}
#: the card leg: requests, admission window, C tile size (kt = 32)
FAB_CARD_KW = {"requests": 64, "window": 16, "ts": 512}
#: the p99 leg's attempts (the reference test's bounded retry)
FAB_ATTEMPTS = 3


def fabric_units(ptt) -> None:
    """Phase 14 (a): the wire and plane units in process — credits granted,
    spent locally and returned over a socketpair of two native comm
    objects, with no frame for a spend; the plane's remote-window budget
    and its set_weight; and a 3-rank in-process mesh (ranks 0 and 1 serve,
    rank 2 routes) whose gateway follows the credit balances and raises
    AdmissionBackpressure once every balance is spent."""
    import functools
    import socket
    from parsec_tpu_torch import native as NATIVE
    from parsec_tpu_torch.core.sched_plane import SchedPlane
    from parsec_tpu_torch.dsl.dtd import AdmissionBackpressure
    from parsec_tpu_torch.serving import IngestGateway, ServingFabric
    pc, ps = NATIVE.load_ptcomm(), NATIVE.load_ptsched()
    a, b = socket.socketpair()
    c0, c1 = pc.Comm(0, 2), pc.Comm(1, 2)
    c0.add_peer_fd(1, a.fileno())
    c1.add_peer_fd(0, b.fileno())

    def pump(*comms):
        for _ in range(3):
            for c in comms:
                c.pump(2)
    c0.cred_grant(1, 42, 7, 16)
    pump(c0, c1)
    frames = c0.stats()["cred_frames_tx"]
    ok = c1.cred_avail(0, 42, 7) == 16 and c1.cred_take(0, 42, 7, 10)
    pump(c0, c1)
    ok &= c0.stats()["cred_frames_tx"] == frames
    ok &= c1.cred_return(0, 42, 7, 100) == 6
    pump(c1, c0)
    ok &= c0.cred_outstanding(1, 42, 7) == 10
    wire = c1.stats()
    c0.stop(); c1.stop(); a.close(); b.close()
    pl = ps.Plane(nworkers=1)
    h = pl.register_pool(ext_id=1, kind=ps.KIND_EXT, window=10)
    pl.admit(h, 4)
    pl.remote_grant(h, 3)
    ok &= pl.headroom(h) == 3 and not pl.over_window(h)
    pl.set_weight(h, 3)
    ok &= pl.pool_stats(h)["weight"] == 3
    comms = [pc.Comm(r, 3) for r in range(3)]
    socks = []
    for i in range(3):
        for j in range(i + 1, 3):
            x, y = socket.socketpair()
            comms[i].add_peer_fd(j, x.fileno())
            comms[j].add_peer_fd(i, y.fileno())
            socks += [x, y]
    fabs = [ServingFabric(comms[r], SchedPlane(ps, 1, "wdrr"), r, 3,
                          replenish=False) for r in range(3)]
    landed = []
    for r, fab in enumerate(fabs):
        fab.insert_transport = functools.partial(
            lambda dst, hdr, payload, _src: fabs[dst].on_fab(
                _src, hdr, payload), _src=r)
        if r < 2:
            fab.serve("T", handler=lambda p, src, r=r: landed.append(r),
                      window=(4, 64)[r])

    def rounds():
        for _ in range(3):
            for fab in fabs:
                fab.step()
            pump(*comms)
    rounds()
    gw = IngestGateway(fabs[2], ranks=[0, 1])
    heads = gw.headrooms("T")
    for i in range(sum(heads.values())):
        gw.submit("T", {"i": i}, nowait=True)
    try:
        gw.submit("T", {"i": -1}, nowait=True)
        ok = False
    except AdmissionBackpressure:
        pass
    rounds()
    ok &= len(landed) == sum(heads.values()) and \
        landed.count(1) > landed.count(0) > 0
    for fab in fabs:
        fab.fini()
    for c in comms:
        c.stop()
    for x in socks:
        x.close()
    log(f"serving fabric (a) units: credits on a socketpair (granted "
        f"{wire['creds_granted_rx']}, spent {wire['creds_spent']} with no "
        f"frame, returned {wire['creds_returned_tx']}); plane remote window "
        f"and set_weight; 3-rank gateway: headrooms {heads}, landed "
        f"{landed.count(0)} on rank 0 and {landed.count(1)} on rank 1, then "
        f"AdmissionBackpressure: {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError("serving fabric wire/plane units failed")


def fabric_acceptance(smi) -> dict:
    """Phase 14 (b): ``fabric_2rank_program`` as two OS processes (CPU
    rank contexts, one BLAS thread a rank), held to the reference's own
    bounds: on every attempt the antagonist was rejected and served, spends
    dwarf credit frames, no frame error, the reconciled cross-rank shares
    within 25% of 2:1 with reconcile rounds and weight nudges on both
    ranks; and the victim's merged p99 loaded within 2x of unloaded on one
    of at most :data:`FAB_ATTEMPTS` attempts."""
    import functools
    from parsec_tpu_torch.comm.tcp import run_distributed_procs
    from parsec_tpu_torch.serving.harness import fabric_2rank_program
    attempts = []
    for attempt in range(FAB_ATTEMPTS):
        t0 = time.perf_counter()
        res = run_distributed_procs(
            2, functools.partial(fabric_2rank_program, **FAB_KW),
            timeout=300)
        wall = time.perf_counter() - t0
        if not all(r.get("fabric") for r in res):
            raise AssertionError(f"serving fabric down: {res}")
        wire = {k: [r["wire"][k] for r in res] for k in (
            "creds_granted_tx", "creds_spent", "cred_frames_rx",
            "frame_errors")}
        sv = sum(r["shares_window"]["sv"] for r in res)
        sa = sum(r["shares_window"]["sa"] for r in res)
        base = [x for r in res for x in r["victim_lats_base_ns"]]
        load = [x for r in res for x in r["victim_lats_load_ns"]]
        p99b = float(np.percentile(np.asarray(base), 99)) / 1e3
        p99l = float(np.percentile(np.asarray(load), 99)) / 1e3
        rejects = sum(r["antagonist_rejects"] for r in res)
        served = sum(r["antagonist_served"] for r in res)
        ratio = sv / max(1, sa)
        bodies = [r["victim_body_ms"] for r in res]
        log(f"serving fabric (b) attempt {attempt + 1}: victim p99 "
            f"unloaded {p99b:.1f} us ({len(base)} probes), loaded "
            f"{p99l:.1f} us ({len(load)} probes), {p99l / p99b:.2f}x; "
            f"antagonist rejects {rejects}, served {served}; credit "
            f"counters by rank {wire}; shares sv:sa {sv}:{sa} = {ratio:.3f} "
            f"(weights 2:1), reconcile rounds {res[0]['reconcile_rounds']}, "
            f"weight adjusts {[r['weight_adjusts'] for r in res]}; rank CPU "
            f"s {[r['cpu_s'] for r in res]}, BLAS threads pinned by "
            f"{res[0]['blas_threads_set']}; the victim's body alone (both "
            f"ranks at once), this harness's product / the reference's "
            f"passes, ms by rank: at the default BLAS thread count "
            + ", ".join(f"{b['default_threads']['product']} / "
                        f"{b['default_threads']['passes']}" for b in bodies)
            + "; on one thread "
            + ", ".join(f"{b['one_thread']['product']} / "
                        f"{b['one_thread']['passes']}" for b in bodies)
            + f"; job wall {wall:.1f} s ({smi})")
        engaged = (rejects > 0 and served > 0
                   and sum(wire["creds_granted_tx"]) > 0
                   and all(r["wire"]["creds_spent"] > 0
                           and r["wire"]["cred_frames_rx"]
                           < r["wire"]["creds_spent"]
                           + r["wire"]["creds_granted_rx"]
                           and r["wire"]["frame_errors"] == 0
                           and r["weight_adjusts"] > 0 for r in res)
                   and res[0]["reconcile_rounds"] > 0
                   and sv > 0 and sa > 0 and abs(ratio - 2.0) / 2.0 < 0.25
                   and len(base) > 40 and len(load) > 40)
        if not engaged:
            raise AssertionError(f"serving fabric (b): engagement or shares "
                                 f"failed on attempt {attempt + 1}")
        attempts.append({"p99_us_unloaded": round(p99b, 1),
                         "p99_us_loaded": round(p99l, 1),
                         "rejects": rejects, "served": served,
                         "shares": [sv, sa], "wire": wire,
                         "victim_body_ms": bodies,
                         "reconcile_rounds": res[0]["reconcile_rounds"]})
        if p99l <= 2.0 * p99b:
            return {"attempts": attempts}
    raise AssertionError(f"serving fabric (b): the victim's p99 moved past "
                         f"2x of unloaded on every attempt: {attempts}")


def fabric_reclaim(smi) -> dict:
    """Phase 14 (c): ``reclaim_2rank_program``: the serving rank dies
    mid-window; the inserter's blocking acquire must raise in under 30 s
    with its balance reclaimed."""
    import functools
    from parsec_tpu_torch.comm.tcp import run_distributed_procs
    from parsec_tpu_torch.serving.harness import reclaim_2rank_program
    target, ins = run_distributed_procs(
        2, functools.partial(reclaim_2rank_program), timeout=240)
    log(f"serving fabric (c) peer death: target granted "
        f"{target.get('granted')}, inserter balance {ins.get('avail_before')}"
        f" -> {ins.get('avail_after')}, blocking acquire {ins.get('outcome')}"
        f" after {ins.get('waited_s')} s, dead {ins.get('dead')} ({smi})")
    if not (target.get("granted", 0) > 0 and ins.get("outcome") == "raised"
            and ins["waited_s"] < 30 and ins["avail_after"] == 0
            and 0 in ins["dead"]):
        raise AssertionError(f"serving fabric (c): {target}, {ins}")
    return ins


def fabric_card(smi, device: str = "cuda") -> dict:
    """Phase 14 (d): ``card_serving_2rank_program``: rank 0's control
    context is a card context (its plane up), attached through
    ``ServingFabric.attach``; it serves tenant ``gemm`` through a KIND_EXT
    fabric pool, each request inserting one bf16 GEMM_K task (C 512², kt =
    32) into a card context's DTD pool and retired through
    ``ServingFabric.done``; rank 1 sends the requests through an
    IngestGateway. Every request served, one ``gemm_chain`` launch each,
    one credit spent each; every served C tile equal to the plain chain of
    the same (small-integer) tiles bit for bit, and within 1e-2 of
    ``torch.matmul`` of them in float32 norm-wise (the chain rounds C to
    bf16 at each of its 32 steps: its own max error / max |ref| is printed
    beside)."""
    import functools
    from parsec_tpu_torch.comm.tcp import run_distributed_procs
    from parsec_tpu_torch.serving.harness import card_serving_2rank_program
    kw = dict(FAB_CARD_KW)
    t0 = time.perf_counter()
    server, client = run_distributed_procs(
        2, functools.partial(card_serving_2rank_program, device=device,
                             **kw), timeout=300)
    wall = time.perf_counter() - t0
    n = kw["requests"]
    log(f"serving fabric (d) card leg: rank 0 control context a card "
        f"context {server['card_context']}, plane {server['plane']}, fabric "
        f"{server['fabric']}; {server['served']} of {n} requests served "
        f"through a KIND_EXT pool (window {server['pool_window']}, inflight "
        f"{server['pool_inflight']} after), {server['served_per_s']} "
        f"requests/s from the first arrival to the last retire; gemm_chain "
        f"launches {server['launches']} (by route "
        f"{server['launches_by_route']}); credits spent "
        f"{client['wire']['creds_spent']}, gateway stalls "
        f"{client['fab_stats']['remote_stalls']}, rejects "
        f"{client['fab_stats']['remote_rejects']}, routed "
        f"{client['routed']}, submit wall {client['submit_s']} s; C tiles "
        f"the plain chain's bit for bit {server['tiles_equal_plain']}; "
        f"against torch.matmul f32: max err / max |ref| "
        f"{server['max_err_rel']:.3e} (the plain chain's "
        f"{server['plain_max_err_rel']:.3e}), norm-wise "
        f"{server['norm_err_rel']:.3e}; job wall {wall:.1f} s ({smi})")
    ok = (server["card_context"] and server["plane"] and server["fabric"]
          and client["fabric"] and server["served"] == n
          and client["wire"]["creds_spent"] == n
          and server["pool_inflight"] == 0
          and server["tiles_equal_plain"] and server["norm_err_rel"] < 1e-2
          and server["wire"]["frame_errors"] == 0
          and client["wire"]["frame_errors"] == 0)
    if device == "cuda":
        ok &= server["launches"] == n
    if not ok:
        raise AssertionError(f"serving fabric (d): {server}, {client}")
    server["wall_s"] = wall
    return server


#: phase 14 (f): ``tel_interval_ms`` of each card-leg run, in turns (the
#: plane up at the reference program's 25 ms, and down)
TEL_CARD_TURNS = (25, 0, 0, 25)


def telemetry_gate(res, bodies) -> bool:
    """Phase 14 (e)'s gate, the reference test's own assertions on the two
    ranks' results of ``pttel_2rank_program(stall=True)`` and the bodies of
    the flight records ``flight-r1-*.json``: rank 0's pushed rollup of
    every ``ptfab.served.*`` counter equal to each rank's own registry
    value and summed to their total, staleness under 30 s, the leaf pushed
    and the root folded and sent no frame, no tx or frame error, the
    reconciler in push mode with push rounds and no HTTP fetch, and exactly
    one flight record (trigger ``watchdog_stall``, lane
    ``pool:stall-inject``) detected within 1000 ms while rank 0's watchdog
    stays clean."""
    r0, r1 = res
    stall = r1["stall"]
    tel = [r["tel_stats"] for r in res]
    return (sorted(r0["ranks_seen"]) == [0, 1]
            and all(r["served_local"] and r0["per_rank_served"][rank]
                    == r["served_local"] for rank, r in enumerate(res))
            and all(r0["rollup_served"][k] == sum(
                r0["per_rank_served"][r].get(k, 0) for r in (0, 1))
                for k in r0["per_rank_served"][0])
            and all(v < 30 for v in r0["staleness_s"].values())
            and tel[1]["frames_tx"] > 0 and tel[0]["frames_rx"] > 0
            and tel[0]["frames_tx"] == 0
            and all(t["rounds"] > 0 and t["tx_errors"] == 0 for t in tel)
            and all(r["frame_errors"] == 0 for r in res)
            and r0["reconcile_mode"] == "push"
            and r0["reconcile"]["push_rounds"] > 0
            and r0["reconcile"]["http_fetches"] == 0
            and r0["watchdog_armed"] and r1["watchdog_armed"]
            and stall["watchdog"]["pool_stalls"] == 1
            and stall["detected_ms"] <= 2 * 500
            and stall["flight_records"] == 1
            and r0["watchdog_stats"]["pool_stalls"] == 0
            and r0["watchdog_stats"]["device_stalls"] == 0
            and len(bodies) == 1 and bodies[0]["trigger"] == "watchdog_stall"
            and bodies[0]["detail"]["lane"] == "pool:stall-inject")


def telemetry_acceptance(smi) -> dict:
    """Phase 14 (e): ``pttel_2rank_program(stall=True)`` as two OS
    processes (CPU rank contexts), held to :func:`telemetry_gate`. Returns
    the frames a round and the staleness."""
    import functools
    import glob
    import tempfile
    from parsec_tpu_torch.comm.tcp import run_distributed_procs
    from parsec_tpu_torch.serving.harness import pttel_2rank_program
    with tempfile.TemporaryDirectory() as flight_dir:
        t0 = time.perf_counter()
        res = run_distributed_procs(
            2, functools.partial(pttel_2rank_program, stall=True,
                                 flight_dir=flight_dir),
            timeout=300)
        wall = time.perf_counter() - t0
        records = glob.glob(os.path.join(flight_dir, "flight-r1-*.json"))
        bodies = [json.load(open(p)) for p in records]
    if not all(r.get("telemetry") for r in res):
        raise AssertionError(f"telemetry plane down: "
                             f"{[r.get('reason') for r in res]}")
    r0, r1 = res
    stall = r1["stall"]
    tel = [r["tel_stats"] for r in res]
    frames = {"leaf_tx_per_round": tel[1]["frames_tx"] / tel[1]["rounds"],
              "root_rx_per_round": tel[0]["frames_rx"] / tel[0]["rounds"]}
    log(f"telemetry plane (e) 2 OS ranks: rollup ptfab.served.* by rank "
        f"{r0['per_rank_served']} against each rank's own "
        f"{[r['served_local'] for r in res]}, mesh sums "
        f"{r0['rollup_served']}; staleness s {r0['staleness_s']}, depth "
        f"{r0['depth']}; rounds {[t['rounds'] for t in tel]}, frames tx "
        f"{[t['frames_tx'] for t in tel]}, rx {[t['frames_rx'] for t in tel]}"
        f" ({frames['leaf_tx_per_round']:.3f} sent a round by the leaf, "
        f"{frames['root_rx_per_round']:.3f} received a round by the root), "
        f"folds {[t['folds'] for t in tel]}, late drops "
        f"{[t['late_drops'] for t in tel]}, tx errors "
        f"{[t['tx_errors'] for t in tel]}, frame errors "
        f"{[r['frame_errors'] for r in res]}; reconciler "
        f"{r0['reconcile_mode']}: push rounds "
        f"{r0['reconcile']['push_rounds']}, HTTP fetches "
        f"{r0['reconcile']['http_fetches']}; stall on rank 1 detected in "
        f"{stall['detected_ms']} ms (pool stalls "
        f"{stall['watchdog']['pool_stalls']}), flight records "
        f"{len(records)} ({[b['trigger'] for b in bodies]}), rank 0's "
        f"watchdog pool/device stalls {r0['watchdog_stats']['pool_stalls']}"
        f"/{r0['watchdog_stats']['device_stalls']}; job wall {wall:.1f} s "
        f"({smi})")
    if not telemetry_gate(res, bodies):
        raise AssertionError(f"telemetry plane (e): {res}")
    return {"frames": frames, "staleness_s": r0["staleness_s"],
            "wall_s": wall}


def telemetry_card_gate(server, client, interval, n,
                        device: str = "cuda") -> bool:
    """Phase 14 (f)'s gate on one run of ``card_serving_2rank_program`` at
    ``tel_interval_ms=interval`` with ``n`` requests: every request served,
    one ``gemm_chain`` launch each on the card, every C tile the plain
    chain's bit for bit, no frame error, the plane up on both ranks exactly
    when ``interval`` is not 0. With the plane up: rank 0's settled rollup
    of the served and routed-insert counters (``harness.CARD_SERVED_KEYS``:
    the tenant's fabric-owned pool is never popped, so
    ``ptfab.served.gemm`` stays 0 and sends nothing) equal to each rank's
    own nonzero values after the requests retired, rank 0's received and
    rank 1's sent inserts each ``n``, and the reconciler's rounds read from
    it with no HTTP fetch."""
    res = (server, client)
    ok = (server["fabric"] and client["fabric"] and server["served"] == n
          and server["tiles_equal_plain"]
          and server["wire"]["frame_errors"] == 0
          and client["wire"]["frame_errors"] == 0
          and all(r["telemetry"] == bool(interval) for r in res))
    if device == "cuda":
        ok &= server["card_context"] and server["launches"] == n
    if interval:
        ok &= (sorted(server["ranks_seen"]) == [0, 1]
               and all(server["per_rank_served"][rank] == r["served_local"]
                       for rank, r in enumerate(res))
               and server["per_rank_served"][0].get(
                   "ptfab.remote_inserts_rx") == n
               and server["per_rank_served"][1].get(
                   "ptfab.remote_inserts_tx") == n
               and all(server["rollup_served"][k] == sum(
                   server["per_rank_served"][r].get(k, 0) for r in (0, 1))
                   for k in server["rollup_served"])
               and server["reconcile_mode"] == "push"
               and server["reconcile"]["push_rounds"] > 0
               and server["reconcile"]["http_fetches"] == 0)
    return ok


def telemetry_card(smi, device: str = "cuda") -> dict:
    """Phase 14 (f): ``card_serving_2rank_program`` (phase 14 (d)'s card
    leg) with the telemetry plane pushing every 25 ms, in turns with the
    plane down (:data:`TEL_CARD_TURNS`), each run held to
    :func:`telemetry_card_gate`. Returns the launches of every run and the
    requests a second on and off."""
    import functools
    from parsec_tpu_torch.comm.tcp import run_distributed_procs
    from parsec_tpu_torch.serving.harness import card_serving_2rank_program
    kw = dict(FAB_CARD_KW)
    n = kw["requests"]
    launches, by_route = 0, {}
    rates = {"on": [], "off": []}
    for interval in TEL_CARD_TURNS:
        t0 = time.perf_counter()
        server, client = run_distributed_procs(
            2, functools.partial(card_serving_2rank_program, device=device,
                                 tel_interval_ms=interval, **kw),
            timeout=300)
        wall = time.perf_counter() - t0
        line = (f"telemetry plane (f) card leg, tel_interval_ms {interval}: "
                f"{server['served']} of {n} served at "
                f"{server['served_per_s']} requests/s, gemm_chain launches "
                f"{server['launches']}, C tiles the plain chain's bit for bit "
                f"{server['tiles_equal_plain']}")
        if interval:
            line += (f"; rollup by rank {server['per_rank_served']} against "
                     f"each rank's own "
                     f"{[server['served_local'], client['served_local']]}, "
                     f"staleness s {server['staleness_s']}; reconciler "
                     f"{server['reconcile_mode']}: push rounds "
                     f"{server['reconcile']['push_rounds']}, HTTP fetches "
                     f"{server['reconcile']['http_fetches']}")
        log(line + f"; job wall {wall:.1f} s ({smi})")
        if not telemetry_card_gate(server, client, interval, n, device):
            raise AssertionError(f"telemetry plane (f): {server}, {client}")
        rates["on" if interval else "off"].append(server["served_per_s"])
        launches += server["launches"]
        for r, n_r in server["launches_by_route"].items():
            by_route[r] = by_route.get(r, 0) + n_r
    log(f"telemetry plane (f): requests/s with the plane up {rates['on']}, "
        f"down {rates['off']}, in turns {list(TEL_CARD_TURNS)} ms ({smi})")
    return {"launches": launches, "launches_by_route": by_route,
            "served_per_s": rates}


def serving_fabric(ptt, smi, device: str = "cuda") -> dict:
    """Phase 14: the serving fabric, in four legs (a)-(d), and the mesh
    telemetry plane over it, (e) and (f). Returns the card legs' result:
    the ``gemm_chain`` launches of (d) and (f) and their routes."""
    t0 = time.perf_counter()
    walls = {}
    fabric_units(ptt)
    walls["a"] = time.perf_counter() - t0
    fabric_acceptance(smi)
    walls["b"] = time.perf_counter() - t0 - sum(walls.values())
    fabric_reclaim(smi)
    walls["c"] = time.perf_counter() - t0 - sum(walls.values())
    card = fabric_card(smi, device)
    walls["d"] = time.perf_counter() - t0 - sum(walls.values())
    card["telemetry"] = telemetry_acceptance(smi)
    walls["e"] = time.perf_counter() - t0 - sum(walls.values())
    tel_card = telemetry_card(smi, device)
    walls["f"] = time.perf_counter() - t0 - sum(walls.values())
    card["launches"] += tel_card["launches"]
    for r, n_r in tel_card["launches_by_route"].items():
        card["launches_by_route"][r] = \
            card["launches_by_route"].get(r, 0) + n_r
    card["telemetry_card"] = tel_card
    log("serving fabric: wall seconds by leg " + "; ".join(
        f"({k}) {v:.1f}" for k, v in walls.items())
        + f"; phase {time.perf_counter() - t0:.1f} s ({smi})")
    return card


# ---------------------------------------------------------------------------
# phase 15: the package's entry points
# ---------------------------------------------------------------------------

#: the EP scaling row: process counts and tasks a rank (the reference
#: benchmark's EP leg, ``bench.py:929-945``)
EP_PROCS, EP_NTASKS = (1, 2, 4), 20000
#: P = 1 on a CPU context and on a card context, in turns
EP_TURNS = ("cpu", "cuda", "cuda", "cpu")


def entry_points(smi, device: str = "cuda") -> dict:
    """Phase 15: ``python -m parsec_tpu_torch --devices`` (a card context:
    the CUDA device module on ``cuda:0``; ``--cpu`` added for a CPU
    rehearsal) and ``--help-mca`` (``tel_interval_ms`` listed); then
    ``launch.ep_scaling_rates`` at P = 1, 2, 4 with card rank contexts
    (each P's rank walls and aggregate tasks/s beside ``cpu_budget()``),
    and P = 1 on a CPU context and on a card context in turns."""
    from parsec_tpu_torch.launch import ep_scaling_rates
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    dev_args = ["--devices"] + (["--cpu"] if device == "cpu" else [])
    out = {}
    for name, args in (("devices", dev_args), ("help_mca", ["--help-mca"])):
        out[name] = subprocess.run(
            [sys.executable, "-m", "parsec_tpu_torch", *args], cwd=root,
            capture_output=True, text=True, timeout=180)
    devices = out["devices"].stdout.strip().splitlines()
    want = "on cuda:0" if device == "cuda" else "cpu type="
    ok = (out["devices"].returncode == 0 and any(
        want in line and (device != "cuda" or "cuda(0)" in line)
        for line in devices)
        and out["help_mca"].returncode == 0
        and "--mca tel_interval_ms" in out["help_mca"].stdout)
    log(f"entry points: python -m parsec_tpu_torch {' '.join(dev_args)}: "
        f"{devices} (rc {out['devices'].returncode}); --help-mca lists "
        f"tel_interval_ms "
        f"{'--mca tel_interval_ms' in out['help_mca'].stdout} (rc "
        f"{out['help_mca'].returncode}; "
        f"{len(out['help_mca'].stdout.splitlines())} lines)")
    if not ok:
        raise AssertionError(f"entry points: {out['devices'].stderr[-2000:]}"
                             f"{out['help_mca'].stderr[-2000:]}")
    detail = {}
    rates = ep_scaling_rates(EP_PROCS, ntasks=EP_NTASKS, device=device,
                             detail=detail)
    for p in EP_PROCS:
        log(f"EP scaling row P={p} ({device} rank contexts, {EP_NTASKS} "
            f"tasks a rank, best of 2 after a warm run of 2000): rank walls "
            f"{detail[p]['walls_s']} s, aggregate {rates[p]} tasks/s "
            f"({smi})")
    log(f"EP scaling row: cpu_budget {detail['cpu_budget']}")
    turns = []
    for dev in EP_TURNS:
        dev = dev if device == "cuda" else "cpu"
        d = {}
        rate = ep_scaling_rates((1,), ntasks=EP_NTASKS, device=dev,
                                detail=d)[1]
        turns.append((dev, rate, d[1]["walls_s"][0]))
    log("EP P=1 in turns, rank context: " + ", ".join(
        f"{dev} {rate} tasks/s ({wall} s)" for dev, rate, wall in turns)
        + f" ({smi})")
    if not all(rates[p] > 0 for p in EP_PROCS):
        raise AssertionError(f"EP scaling row: {rates}")
    log(f"entry points phase {time.perf_counter() - t0:.1f} s ({smi})")
    return {"ep": rates, "ep_detail": detail, "ep_turns": turns}


# ---------------------------------------------------------------------------
# phase 16: meshes on the one card
# ---------------------------------------------------------------------------
#: the phase's sizes (a CPU rehearsal cuts them; the rank jobs take them
#: as an argument, since a rank imports this module afresh):
#: ranks of the group, every one on cuda:0, time-sharing it; the model of
#: (b) and (d), GPT-2 small; (a) the timed all-reduce, MiB of float32;
#: (b) batch, sequence, AdamW rate and the steps after the first (f32)
#: step, which is held to the single-rank step; (c) attention (B, H, S,
#: d): Ulysses bf16 causal on ``sp_ranks`` ranks (they must divide the
#: heads), the ring f32 causal on all; (d) the sp block step's batch (its
#: sequence (b)'s), pp stages, microbatches and batch, the ep layer's
#: tokens and experts (top-2); (e) the SPMD GEMMs' and POTRF's N (float32,
#: TF32 off); one job's deadline
MESH = dict(ranks=8, cfg=GPT2_SMALL, ar_mib=64, train_b=8, train_s=1024,
            lr=1e-3, steps=3, attn=(8, 12, 1024, 64), sp_ranks=4, sp_b=2,
            pp_stages=4, pp_micro=4, pp_b=8, moe_t=8192, moe_e=8, n=8192,
            job_s=900.0)
#: the rank-side cache of parameter trees (a rank builds GPT-2 once)
_MESH_PARAMS: dict = {}


def _mesh_sync(torch, device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def _timed(torch, device, fn):
    _mesh_sync(torch, device)
    t = time.perf_counter()
    out = fn()
    _mesh_sync(torch, device)
    return out, (time.perf_counter() - t) * 1e3


def _mesh_tree(sz: dict, seed: int):
    from parsec_tpu_torch.parallel import model as M
    key = (seed, tuple(sorted(sz["cfg"].items())))
    if key not in _MESH_PARAMS:
        _MESH_PARAMS[key] = M.init_lm_params(seed, M.ModelConfig(**sz["cfg"]))
    return _MESH_PARAMS[key]


def mesh_tokens(sz: dict, seed: int, B: int):
    """(B, S + 1) int32 tokens of the seeded Markov corpus (low entropy,
    so a few steps lower the loss)."""
    S = sz["train_s"]
    vocab = sz["cfg"]["vocab_size"]
    corpus, _ = markov_corpus(seed, B * (S + 1), min(64, vocab), vocab)
    return corpus.reshape(B, S + 1).astype(np.int32)


def mesh_probe_job(sz: dict, device: str) -> dict:
    """(a) on every rank: the routes compat chose from the group's probe,
    and one ``ar_mib`` MiB float32 all-reduce over all the ranks, timed
    (after a warm one)."""
    import torch
    import torch.distributed as dist
    from parsec_tpu_torch.parallel import compat
    x = torch.ones(sz["ar_mib"] * (1 << 20) // 4,
                   device=compat._probe_device(device))
    compat.all_reduce_(x, dist.group.WORLD)
    _, ms = _timed(torch, device,
                   lambda: compat.all_reduce_(x, dist.group.WORLD))
    n = dist.get_world_size()
    return {"routes": compat.routes(device), "ms": ms,
            "ok": bool(x[0].item() == float(n * n) and
                       x[-1].item() == float(n * n))}


def mesh_gpt2_job(sz: dict, device: str, seed: int) -> dict:
    """(b) on every rank: the model's clipped AdamW step over dp 2 x tp 4
    (``make_tp_mesh(8, tp_must_divide=n_heads)``): the first step's loss
    and block 0's w1 after it (on rank 0), then ``steps`` more steps; each
    step's ms and loss, the rank's peak memory, the first step's
    collectives."""
    import torch
    from parsec_tpu_torch.parallel import compat
    from parsec_tpu_torch.parallel import model as M
    from parsec_tpu_torch.parallel import optim as O
    from parsec_tpu_torch.parallel import transformer as T
    tree = _mesh_tree(sz, seed)
    mesh = T.make_tp_mesh(sz["ranks"], tp_must_divide=sz["cfg"]["n_heads"],
                          device_type=device)
    tx = O.chain(O.clip_by_global_norm(1.0), O.adamw(sz["lr"]))
    step, opt, place_p, place_t = M.make_lm_opt_train_step(mesh, tx, tree)
    toks = mesh_tokens(sz, seed, sz["train_b"])
    p = place_p(tree)
    x, y = place_t(toks[:, :-1]), place_t(toks[:, 1:])
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    compat.reset_stats()
    out = {"losses": [], "ms": [], "mesh": tuple(mesh.shape),
           "embed_local": tuple(p["embed"].to_local().shape)}
    for i in range(1 + sz["steps"]):
        (p, opt, loss), ms = _timed(torch, device,
                                    lambda: step(p, opt, x, y))
        out["losses"].append(float(loss))
        out["ms"].append(ms)
        if i == 0:
            out["stats"] = compat.stats_summary()
            w1 = compat.full_tensor(p["blocks"][0]["w1"])
            out["w1"] = w1.cpu().numpy() \
                if torch.distributed.get_rank() == 0 else None
            del w1
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30 \
        if device == "cuda" else None
    return out


def mesh_attention_job(sz: dict, device: str, seed: int) -> dict:
    """(c) Ulysses (bf16, causal) on the first ``sp_ranks`` ranks: the
    flash kernel's launches by route in its calls (counted from 0 before
    the first), its output against the plain version's on the whole
    sequence within the bf16 flash check's bound; then the ring (f32,
    causal) on every rank against dense attention (2e-4)."""
    import torch
    from parsec_tpu_torch.ops import cuda_kernels as K
    from parsec_tpu_torch.parallel import ring_attention as RA
    K.dot_precision()
    B, H, S, D = sz["attn"]
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn((B, H, S, D), generator=gen, device=device) * 0.5
               for _ in range(3))
    out = {}
    sp = RA._seq_mesh(sz["sp_ranks"], device)
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    K.flash_attention.launches_by_route = dict.fromkeys(K.FLASH_ROUTES, 0)
    o, ms = _timed(torch, device, lambda: RA.ulysses_attention(
        qb, kb, vb, mesh=sp, causal=True))
    if o is not None:
        _, out["ulysses_ms2"] = _timed(torch, device, lambda: (
            RA.ulysses_attention(qb, kb, vb, mesh=sp, causal=True)))
        out["ulysses_launches"] = dict(K.flash_attention.launches_by_route)
        out["ulysses_ms"] = ms
        blk = S // sz["sp_ranks"]
        rows = slice(sp.get_local_rank("sp") * blk,
                     (sp.get_local_rank("sp") + 1) * blk)
        plain = K.flash_attention_plain(qb, kb, vb, True, 1.0 / D ** 0.5)
        tol = K.flash_attention_bf16_tolerance(qb, kb, vb, causal=True)
        err = (o.to_local().float() - plain[:, :, rows].float()).abs()
        out["ulysses_excess"] = float((err - tol[:, :, rows]).max())
        out["ulysses_max_err"] = float(err.max())
        del plain, tol, err
    ring = RA._seq_mesh(sz["ranks"], device)
    o, out["ring_ms"] = _timed(torch, device, lambda: RA.ring_attention(
        q, k, v, mesh=ring, causal=True))
    blk = S // sz["ranks"]
    r = ring.get_local_rank("sp")
    ref = RA.dense_attention_reference(q, k, v, causal=True)[
        :, :, r * blk:(r + 1) * blk]
    diff = (o.to_local() - ref).abs()
    out["ring_ok"] = bool((diff <= 2e-4 + 2e-4 * ref.abs()).all())
    out["ring_max_err"] = float(diff.max())
    return out


def mesh_models_job(sz: dict, device: str, seed: int) -> dict:
    """(d) the sp block step at the model's width against the
    single-device dense step (rank 0 holds it: loss 1e-5/1e-6, parameters
    5e-4/5e-5), ``lm_pp_forward`` over ``pp_stages`` stages against
    ``lm_apply`` (2e-4), and ``moe_forward`` on the ep mesh against the
    dense routing (2e-4/2e-5), the reference tests' tolerances."""
    import torch
    from parsec_tpu_torch.ops import cuda_kernels as K
    from parsec_tpu_torch.parallel import model as M
    from parsec_tpu_torch.parallel import moe as MoE
    from parsec_tpu_torch.parallel import ring_attention as RA
    from parsec_tpu_torch.parallel import transformer as T
    from parsec_tpu_torch.parallel.pipeline import make_pp_mesh
    K.dot_precision()
    rank = torch.distributed.get_rank()
    cfg = sz["cfg"]
    D, Fd, S = cfg["d_model"], cfg["d_ff"], sz["train_s"]
    out = {}
    # the sp block step: one block, the sequence over all the ranks
    bp = T.init_block_params(seed, D, Fd, cfg["n_heads"])
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((sz["sp_b"], S, D), generator=gen, device=device)
    y = torch.randn((sz["sp_b"], S, D), generator=gen, device=device)
    mesh = RA._seq_mesh(sz["ranks"], device)
    step, place_p, place_x = T.make_sp_train_step(mesh, lr=1e-2)
    p = place_p(bp)
    (p, loss), out["sp_ms"] = _timed(
        torch, device, lambda: step(p, place_x(x), place_x(y)))
    out["sp_loss"] = float(loss)
    if rank == 0:
        rstep, rpp, rpx = T.make_train_step(device, lr=1e-2)
        rp, rloss = rstep(rpp(bp), rpx(x), rpx(y))
        out["sp_ref_loss"] = float(rloss)
        out["sp_loss_ok"] = abs(float(loss) - float(rloss)) <= \
            1e-6 + 1e-5 * abs(float(rloss))
        out["sp_params_excess"] = max(float(((p[k].to_local() - rp[k]).abs()
                                             - (5e-5 + 5e-4 * rp[k].abs())
                                             ).max()) for k in bp)
    # lm_pp_forward: pp_stages stages of L / pp_stages layers
    params = M.params_from_numpy(_mesh_tree(sz, seed), device=device)
    toks = mesh_tokens(sz, seed + 1, sz["pp_b"])[:, :-1]
    logits, out["pp_ms"] = _timed(torch, device, lambda: M.lm_pp_forward(
        params, toks, mesh=make_pp_mesh(sz["pp_stages"], device),
        n_micro=sz["pp_micro"]))
    if logits is not None and rank == 0:
        with torch.no_grad():
            ref = M.lm_apply(params, toks)
        d = (logits.to_local() - ref).abs()
        out["pp_ok"] = bool((d <= 2e-4 + 2e-4 * ref.abs()).all())
        out["pp_max_err"] = float(d.max())
        del ref, d
    del logits, params
    # the ep layer: moe_e experts over the ranks, top-2, no drops
    mp = MoE.init_moe_params(seed, sz["moe_e"], D, Fd)
    xt = torch.randn((sz["moe_t"], D), generator=gen, device=device)
    emesh = MoE.make_ep_mesh(sz["ranks"], device)
    (yo, aux), out["moe_ms"] = _timed(torch, device, lambda: MoE.moe_forward(
        mp, xt, mesh=emesh, k=2, return_aux=True))
    blk = sz["moe_t"] // sz["ranks"]
    r = emesh.get_local_rank("ep")
    ref = MoE.dense_reference({k: torch.from_numpy(v).to(device)
                               for k, v in mp.items()},
                              xt[r * blk:(r + 1) * blk], k=2)
    d = (yo.to_local() - ref).abs()
    out["moe_ok"] = bool((d <= 2e-5 + 2e-4 * ref.abs()).all())
    out["moe_max_err"] = float(d.max())
    out["moe_dropped"] = float(aux["dropped"])
    return out


def mesh_spmd_job(sz: dict, device: str, seed: int) -> dict:
    """(e) Cannon on 2 x 2 (the first 4 ranks), the all-gather GEMM on
    2 x 4 and the blocked POTRF on 2 x 4, N = ``n`` float32: each rank's
    block against ``torch.matmul``/``torch.linalg.cholesky`` of the whole
    matrices (TF32 off), max err / max |ref| over the mesh."""
    import torch
    from parsec_tpu_torch.ops import cuda_kernels as K
    from parsec_tpu_torch.parallel import compat, spmd
    K.dot_precision()
    n = sz["n"]
    gen = torch.Generator(device=device).manual_seed(seed)
    A = torch.randn((n, n), generator=gen, device=device)
    B = torch.randn((n, n), generator=gen, device=device)
    out = {}

    def rel(dt, ref_fn, mesh):
        """max |local - ref| / max |ref| over the mesh's ranks."""
        if dt is None:
            return None
        local = dt.to_local()
        p, q = mesh.get_local_rank(0), mesh.get_local_rank(1)
        mb, nb = local.shape
        ref = ref_fn(slice(p * mb, (p + 1) * mb), slice(q * nb, (q + 1) * nb))
        t = torch.stack([(local - ref).abs().max(), ref.abs().max()])
        for ax in (1, 0):
            compat.all_reduce_(t, mesh.get_group(ax), "max")
        return float(t[0] / t[1])

    for name, fn, size in (("cannon", spmd.distributed_gemm, 4),
                           ("allgather", spmd.distributed_gemm_allgather,
                            sz["ranks"])):
        mesh = spmd.make_mesh(size, device_type=device)
        C, out[f"{name}_ms"] = _timed(torch, device, lambda: fn(A, B, mesh))
        out[f"{name}_mesh"] = tuple(mesh.shape)
        out[f"{name}_rel"] = rel(C, lambda r, c: A[r] @ B[:, c], mesh)
        del C
    spd = A @ A.T / n + torch.eye(n, device=device) * (0.05 * n)
    del A, B
    mesh = spmd.make_mesh(sz["ranks"], device_type=device)
    L, out["potrf_ms"] = _timed(torch, device,
                                lambda: spmd.distributed_potrf(spd, mesh))
    chol = torch.linalg.cholesky(spd)
    out["potrf_rel"] = rel(L, lambda r, c: chol[r, c], mesh)
    out["potrf_mesh"] = tuple(mesh.shape)
    return out


def mesh_check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"phase 16: {what}")


def meshes(K, torch, smi, device: str = "cuda", pool=None) -> dict:
    """Phase 16: one group of ``MESH["ranks"]`` ranks (every rank on the one
    card, joined in a gloo group: ``multihost.RankPool``) running (a) the
    collectives' probe and a timed all-reduce, (b) GPT-2 small's AdamW
    step over dp 2 x tp 4 held to the single-rank step, then a few steps,
    (c) Ulysses with the flash kernel on each of 4 ranks and the ring on
    8, (d) the sp block step, the pp LM forward and the ep layer, (e)
    Cannon, the all-gather GEMM and the blocked POTRF at N = 8192. Returns
    the flash launches of (c)'s Ulysses calls, by route. A ``pool`` given
    is used and left open (phase 17 runs on it after); else the phase
    makes its own and closes it."""
    from parsec_tpu_torch.parallel import model as M
    from parsec_tpu_torch.parallel import optim as O
    from parsec_tpu_torch.parallel.multihost import RankPool
    sz = dict(MESH)
    t0 = time.perf_counter()
    seed = 16
    # the single-rank step (b) is held to, in this process, first
    K.dot_precision()
    tree = _mesh_tree(sz, seed)
    toks = mesh_tokens(sz, seed, sz["train_b"])
    tx = O.chain(O.clip_by_global_norm(1.0), O.adamw(sz["lr"]))
    step, opt, place_p, place_t = M.make_lm_opt_train_step(device, tx, tree)
    p = place_p(tree)
    (p, opt, ref_loss), ref_ms = _timed(torch, device, lambda: step(
        p, opt, place_t(toks[:, :-1]), place_t(toks[:, 1:])))
    ref_w1 = p["blocks"][0]["w1"].cpu().numpy()
    ref_loss = float(ref_loss)
    del p, opt, step
    if device == "cuda":
        torch.cuda.empty_cache()
    log(f"mesh (b) single-rank reference step (f32, B={sz['train_b']}, "
        f"S={sz['train_s']}): loss {ref_loss:.6f}, {ref_ms:.1f} ms ({smi})")
    own = pool is None
    if own:
        pool = RankPool(sz["ranks"], device, timeout=sz["job_s"])
    try:
        t = time.perf_counter()
        pool.start()
        log(f"mesh: {sz['ranks']} ranks on {device} joined a gloo group in "
            f"{time.perf_counter() - t:.1f} s, the collectives' probe "
            f"included")
        # (a) the probe
        table = pool.native.get(device, {})
        probe = pool.run(mesh_probe_job, sz, device)
        routes = probe[0]["routes"]
        log(f"mesh (a) gloo on {device} tensors at {sz['ranks']} ranks: "
            + ", ".join(f"{op} {'taken' if table.get(op) else 'refused'} "
                        f"-> {routes[op]}" for op in routes))
        ms = [r["ms"] for r in probe]
        log(f"mesh (a) one {sz['ar_mib']} MiB float32 all-reduce over "
            f"{sz['ranks']} ranks ({routes['all_reduce']}): {max(ms):.3f} "
            f"ms (slowest rank; fastest {min(ms):.3f}) ({smi})")
        mesh_check(all(r["ok"] for r in probe), "the timed all-reduce's sum")
        # (b) the model over dp 2 x tp 4
        res = pool.run(mesh_gpt2_job, sz, device, seed)
        g0 = res[0]
        dl = abs(g0["losses"][0] - ref_loss)
        w1_err = np.abs(g0["w1"] - ref_w1)
        w1_excess = float((w1_err - (2e-4 + 2e-4 * np.abs(ref_w1))).max())
        log(f"mesh (b) AdamW + clip, dp x tp {g0['mesh']} (vocab "
            f"{sz['cfg']['vocab_size']} split in "
            f"{sorted({r['embed_local'][0] for r in res})} rows): first "
            f"loss {g0['losses'][0]:.6f}, |d| {dl:.3e} against the single "
            f"rank; block 0 w1 max err {w1_err.max():.3e}, excess over "
            f"rtol/atol 2e-4 {w1_excess:.3e}")
        log("mesh (b) losses " + ", ".join(f"{v:.4f}" for v in g0["losses"])
            + "; step ms (slowest rank) " + ", ".join(
                f"{max(r['ms'][i] for r in res):.1f}"
                for i in range(len(g0["ms"]))) + f" ({smi})")
        if device == "cuda":
            log("mesh (b) peak memory a rank, GiB: " + ", ".join(
                f"{r['peak_gib']:.2f}" for r in res))
        log(f"mesh (b) the first step's collectives on rank 0: "
            f"{g0['stats']}")
        mesh_check(dl < 1e-3, f"(b) first loss off the single rank's by {dl}")
        mesh_check(w1_excess <= 0, "(b) block 0's w1 off the single rank's")
        mesh_check(all(r["losses"] == g0["losses"] for r in res),
                   "(b) the ranks disagree on the losses")
        mesh_check(g0["losses"][-1] < g0["losses"][0],
                   "(b) the loss did not fall")
        # (c) Ulysses with the flash kernel, the ring
        att = pool.run(mesh_attention_job, sz, device, seed)
        uly = [a for a in att if "ulysses_launches" in a]
        by_route = {}
        for a in uly:
            for r_, n_ in a["ulysses_launches"].items():
                by_route[r_] = by_route.get(r_, 0) + n_
        log(f"mesh (c) Ulysses bf16 causal {sz['attn']} on {len(uly)} "
            f"ranks, two calls: flash launches by route {by_route} (each "
            f"rank {[a['ulysses_launches'] for a in uly]}); max |out - "
            f"plain| {max(a['ulysses_max_err'] for a in uly):.3e}, worst "
            f"excess over the bf16 bound "
            f"{max(a['ulysses_excess'] for a in uly):.3e}; "
            f"{max(a['ulysses_ms'] for a in uly):.2f} ms first call, "
            f"{max(a['ulysses_ms2'] for a in uly):.2f} ms second ({smi})")
        log(f"mesh (c) ring f32 causal {sz['attn']} on {sz['ranks']} "
            f"ranks: max err {max(a['ring_max_err'] for a in att):.3e} "
            f"against dense; {max(a['ring_ms'] for a in att):.2f} ms "
            f"({smi})")
        mesh_check(len(uly) == sz["sp_ranks"], "(c) Ulysses ranks")
        if device == "cuda":
            mesh_check(all(a["ulysses_launches"]["wgmma"] >= 1
                           for a in uly), "(c) Ulysses did not launch the "
                       "flash kernel's wgmma route on every rank")
        mesh_check(all(a["ulysses_excess"] <= 0 for a in uly),
                   "(c) Ulysses off the plain version")
        mesh_check(all(a["ring_ok"] for a in att), "(c) ring off dense")
        # (d) sp, pp, ep
        mod = pool.run(mesh_models_job, sz, device, seed)
        m0 = mod[0]
        log(f"mesh (d) sp block step (width {sz['cfg']['d_model']}, "
            f"B={sz['sp_b']}, S={sz['train_s']} over {sz['ranks']} ranks): "
            f"loss {m0['sp_loss']:.6f} vs dense {m0['sp_ref_loss']:.6f}, "
            f"parameters' excess over 5e-4/5e-5 "
            f"{m0['sp_params_excess']:.3e}; "
            f"{max(r['sp_ms'] for r in mod):.1f} ms ({smi})")
        log(f"mesh (d) lm_pp_forward {sz['pp_stages']} stages x "
            f"{sz['cfg']['n_layers'] // sz['pp_stages']} layers, B="
            f"{sz['pp_b']}, {sz['pp_micro']} microbatches: max err "
            f"{m0['pp_max_err']:.3e} against lm_apply; "
            f"{max(r['pp_ms'] for r in mod):.1f} ms ({smi})")
        log(f"mesh (d) moe_forward over {sz['ranks']} ranks, "
            f"{sz['moe_e']} experts, d_model {sz['cfg']['d_model']}, d_ff "
            f"{sz['cfg']['d_ff']}, {sz['moe_t']} tokens, top-2: max err "
            f"{max(r['moe_max_err'] for r in mod):.3e}, dropped "
            f"{m0['moe_dropped']}; {max(r['moe_ms'] for r in mod):.1f} ms "
            f"({smi})")
        mesh_check(m0["sp_loss_ok"] and m0["sp_params_excess"] <= 0,
                   "(d) the sp step off the dense step")
        mesh_check(m0["pp_ok"], "(d) lm_pp_forward off lm_apply")
        mesh_check(all(r["moe_ok"] for r in mod) and
                   m0["moe_dropped"] == 0, "(d) moe_forward off dense")
        # (e) Cannon, the all-gather GEMM, POTRF
        spmd_ = pool.run(mesh_spmd_job, sz, device, seed)
        e0 = spmd_[0]
        for name in ("cannon", "allgather", "potrf"):
            what = "distributed_potrf" if name == "potrf" else \
                f"distributed_gemm {name}"
            log(f"mesh (e) {what} on {e0[name + '_mesh']} N={sz['n']} f32: "
                f"max err / max |ref| {e0[name + '_rel']:.3e}; "
                f"{max(r[name + '_ms'] for r in spmd_):.1f} ms ({smi})")
            mesh_check(e0[name + "_rel"] < 1e-5, f"(e) {what} off its "
                       "reference")
    finally:
        if own:
            pool.close()
    log(f"mesh phase {time.perf_counter() - t0:.1f} s; the ranks time-share "
        f"one card, so no figure here is a scaling figure ({smi})")
    return {"launches": sum(by_route.values()), "by_route": by_route,
            "routes": routes}


# ---------------------------------------------------------------------------
# phase 17: mesh capture on the one card
# ---------------------------------------------------------------------------
#: the phase's sizes (a CPU rehearsal cuts them; the rank job takes them as
#: an argument): (a) the bf16 DTD GEMM's N and TS (kt = N / TS > 16, so
#: every GEMM_K body is a gemm_chain launch), (b) the f32 DTD POTRF's N and
#: TS (the POTRF cell's shape), each rank's tile budget on the card
#: (``device_cuda_max_bytes``); the group is phase 16's, over a 2 x 4 mesh
MCAP = dict(n=8192, ts=256, potrf_n=8192, potrf_ts=256, rank_bytes=6 << 30)


def _digest(torch, t) -> str:
    """sha256 of a tensor's bytes (bit-for-bit comparisons across ranks)."""
    import hashlib
    return hashlib.sha256(t.detach().cpu().contiguous().view(torch.uint8)
                          .numpy().tobytes()).hexdigest()


def _plan_figures(plan: dict, me: int) -> dict:
    """This rank's side of a mesh plan: ops run, transfers sent and
    received with their bytes, the largest transfer, the landing's bytes."""
    sent = [t for t in plan["transfers"] if t[2] == me]
    got = [t for t in plan["transfers"] if t[3] == me]
    return {"ops": len(plan["ops"][me]), "sent": len(sent),
            "sent_bytes": sum(t[4] for t in sent), "recv": len(got),
            "recv_bytes": sum(t[4] for t in got),
            "largest": max((t[4] for t in plan["transfers"]), default=0),
            "transfers": len(plan["transfers"]),
            "landing_bytes": plan["landing_bytes"]}


def _timed_wait_mesh(torch, device, tp, mesh) -> float:
    """ms of one ``wait_mesh`` on this rank, every rank starting together."""
    import torch.distributed as dist
    _mesh_sync(torch, device)
    dist.barrier()
    t = time.perf_counter()
    tp.wait_mesh(mesh)
    _mesh_sync(torch, device)
    return (time.perf_counter() - t) * 1e3


def mesh_capture_job(sz: dict, device: str, seed: int) -> dict:
    """Phase 17 on one rank of the group, on its own single-rank context:
    (a) the bf16 GEMM window over the 2 x 4 mesh, twice (the plan built,
    then cached), this rank's C digest after the first, one C tile it owns
    held against the plain chain; rank 0 also runs the window captured
    inline on the card alone and holds C to ``torch.matmul`` in f32; (b)
    the f32 POTRF window over the mesh; rank 0 also captures it on the
    card alone and checks the residual gate and the two factors."""
    import torch
    import torch.distributed as dist
    import parsec_tpu_torch as ptt
    from parsec_tpu_torch.data.matrix import collection_from_numpy
    from parsec_tpu_torch.ops import cuda_kernels as K
    from parsec_tpu_torch.ops.gemm import insert_gemm_tasks
    from parsec_tpu_torch.ops.potrf import insert_potrf_tasks
    from parsec_tpu_torch.parallel import compat
    from parsec_tpu_torch.parallel.multihost import device_mesh
    K.dot_precision()
    me = dist.get_rank()
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    ptt.mca.set("device_cuda_max_bytes", sz["rank_bytes"])
    ptt.mca.set("device_load_balance_allow_cpu", False)
    mesh = device_mesh((2, 4), ("x", "y"), device)
    ctx = ptt.Context(nb_cores=1) if device == "cuda" else \
        ptt.Context(nb_cores=1, device="cpu")
    bf = torch.bfloat16
    out = {"rank": me}
    try:
        # (a) the GEMM window, twice
        n, ts = sz["n"], sz["ts"]
        kt = n // ts
        rng = np.random.default_rng(seed)
        a = rng.standard_normal((n, n), dtype=np.float32)
        b = rng.standard_normal((n, n), dtype=np.float32)
        A = collection_from_numpy("mcA", a, ts, ts, dtype=bf)
        B = collection_from_numpy("mcB", b, ts, ts, dtype=bf)
        C = collection_from_numpy("mcC", np.zeros((n, n), np.float32), ts,
                                  ts, dtype=bf)
        tp = ptt.DTDTaskpool(ctx, "mesh-gemm", capture=True)
        runs = []
        for i in range(2):
            nops = insert_gemm_tasks(tp, A, B, C, batch_k=True)
            compat.reset_stats()
            l0 = K.gemm_chain.launches
            r0 = dict(K.gemm_chain.launches_by_route)
            ms = _timed_wait_mesh(torch, device, tp, mesh)
            runs.append({
                "ms": ms, "hit": tp._capture.cache_hit,
                "launches": K.gemm_chain.launches - l0,
                "by_route": {r: K.gemm_chain.launches_by_route[r] - r0[r]
                             for r in r0},
                "stats": compat.stats_summary()})
            if i == 0:
                plan = tp._capture.mesh_plan()
                cm = tiles_of(torch, C, "cpu")
                out["c_digest"] = _digest(torch, cm)
        tp.close()
        ctx.wait()
        out.update(gemm=runs, nops=nops, gemm_plan=_plan_figures(plan, me),
                   tile_bytes=ts * ts * 2)
        # one C tile this rank owns (its first op), against the plain chain
        mine = plan["ops"][me]
        out["tile_checked"] = None
        if mine:
            m, nn = divmod(mine[0], n // ts)
            c0 = torch.zeros(ts, ts, dtype=bf, device=device)
            a_st = torch.from_numpy(a[m * ts:(m + 1) * ts]).to(device, bf) \
                .reshape(ts, kt, ts).permute(1, 0, 2).contiguous()
            b_st = torch.from_numpy(b[:, nn * ts:(nn + 1) * ts]).to(
                device, bf).reshape(kt, ts, ts)
            want = K.gemm_chain_plain(c0, a_st, b_st)
            got = cm[m * ts:(m + 1) * ts, nn * ts:(nn + 1) * ts].to(device)
            err = (got.float() - want.float()).abs()
            bad = int((err > K.gemm_chain_bf16_tolerance(c0, a_st, b_st))
                      .sum())
            out["tile_checked"] = (m, nn, float(err.max()), bad,
                                   bad <= 1e-3 * err.numel())
        if me == 0:
            # the same window captured inline on the card alone
            A1 = collection_from_numpy("scA", a, ts, ts, dtype=bf)
            B1 = collection_from_numpy("scB", b, ts, ts, dtype=bf)
            C1 = collection_from_numpy("scC", np.zeros((n, n), np.float32),
                                       ts, ts, dtype=bf)
            tp1 = ptt.DTDTaskpool(ctx, "single-gemm", capture="inline")
            single = []
            for i in range(2):
                insert_gemm_tasks(tp1, A1, B1, C1, batch_k=True)
                _mesh_sync(torch, device)
                t = time.perf_counter()
                tp1.wait()
                _mesh_sync(torch, device)
                single.append((time.perf_counter() - t) * 1e3)
                if i == 0:
                    c1 = tiles_of(torch, C1, "cpu")
                    out["single_digest"] = _digest(torch, c1)
                    out["bit_equal"] = bool(torch.equal(c1, cm))
            tp1.close()
            ctx.wait()
            out["single_ms"] = single
            ref = torch.from_numpy(a).to(device, bf).float() @ \
                torch.from_numpy(b).to(device, bf).float()
            out["rel"] = float((cm.to(device).float() - ref).norm()
                               / ref.norm())
            del ref, A1, B1, C1, c1
        del A, B, C, cm
        dist.barrier()
        # (b) the POTRF window
        pn, pts = sz["potrf_n"], sz["potrf_ts"]
        g = torch.randn(pn, pn, generator=torch.Generator().manual_seed(
            seed)).to(device)
        spd = (g @ g.T / pn + torch.eye(pn, device=device) * (0.05 * pn)
               ).cpu()
        del g
        out["spd_digest"] = _digest(torch, spd)
        P = collection_from_numpy("mcP", spd.numpy(), pts, pts)
        tp2 = ptt.DTDTaskpool(ctx, "mesh-potrf", capture=True)
        out["potrf_tasks"] = insert_potrf_tasks(tp2, P)
        compat.reset_stats()
        out["potrf_ms"] = _timed_wait_mesh(torch, device, tp2, mesh)
        out["potrf_stats"] = compat.stats_summary()
        out["potrf_plan"] = _plan_figures(tp2._capture.mesh_plan(), me)
        tp2.close()
        ctx.wait()
        lm = tiles_of(torch, P, device).tril()
        out["l_digest"] = _digest(torch, lm)
        if me == 0:
            # the first execution (warm-up and capture), then a replay on
            # the matrix filled anew
            P1 = collection_from_numpy("scP", spd.numpy(), pts, pts)
            tp3 = ptt.DTDTaskpool(ctx, "single-potrf", capture=True)
            out["potrf_single_ms"] = []
            for i in range(2):
                if i:
                    l1 = tiles_of(torch, P1, device).tril()
                    P1.fill(lambda m, k: spd[m * pts:(m + 1) * pts,
                                             k * pts:(k + 1) * pts])
                insert_potrf_tasks(tp3, P1)
                _mesh_sync(torch, device)
                t = time.perf_counter()
                tp3.wait()
                _mesh_sync(torch, device)
                out["potrf_single_ms"].append(
                    (time.perf_counter() - t) * 1e3)
            tp3.close()
            ctx.wait()
            out["potrf_vs_single"] = float(
                ((lm - l1).abs() - (1e-5 + 1e-5 * l1.abs())).max())
            a64 = spd.to(device, torch.float64)
            l64 = lm.double()
            out["potrf_resid"] = float((l64 @ l64.mT - a64).abs().max()
                                       / a64.abs().max())
            del a64, l64, l1, P1
        del P, lm
        dist.barrier()
        if device == "cuda":
            out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        return out
    finally:
        ctx.fini()
        ptt.mca.params.unset("device_cuda_max_bytes")
        ptt.mca.params.unset("device_load_balance_allow_cpu")


def cap_check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"phase 17: {what}")


def mesh_capture(K, torch, smi, pool, device: str = "cuda") -> dict:
    """Phase 17: mesh capture over a 2 x 4 mesh of phase 16's group (every
    rank on the one card): (a) the bf16 DTD GEMM window run by
    ``wait_mesh`` twice, C after the first bit for bit the window captured
    inline on the card alone and within 1e-2 of ``torch.matmul`` in f32
    norm-wise, one ``gemm_chain`` launch a C tile over the ranks in each
    run, the second run a cache hit, one owned C tile on every rank held
    against the plain chain; (b) the f32 DTD POTRF window over the mesh,
    its residual < 1e-5 (the cell's gate) and its factor within rtol/atol
    1e-5 of the window captured on the card alone; (c) the figures.
    Returns the chain's launches over the ranks, by route."""
    sz = dict(MCAP)
    t0 = time.perf_counter()
    res = pool.run(mesh_capture_job, sz, device, 17)
    r0 = res[0]
    n, ts = sz["n"], sz["ts"]
    tiles = (n // ts) ** 2
    # (a)
    for i, what in enumerate(("builds the plan", "cache hit")):
        run = [r["gemm"][i] for r in res]
        launches = sum(x["launches"] for x in run)
        routes = {}
        for x in run:
            for k, v in x["by_route"].items():
                routes[k] = routes.get(k, 0) + v
        ms = [x["ms"] for x in run]
        hits = sorted({x["hit"] for x in run})
        used = {k: v for k, v in routes.items() if v}
        log(f"mesh capture (a) bf16 DTD GEMM N={n} TS={ts} kt={n // ts} "
            f"over 2 x 4 ranks, wait_mesh {i + 1} ({what}: cache_hit "
            f"{hits}): {max(ms):.1f} ms (slowest rank; fastest "
            f"{min(ms):.1f}), gemm_chain launches {launches} over the ranks "
            f"({[x['launches'] for x in run]}; by route {used}) ({smi})")
        ops = sum(r["gemm_plan"]["ops"] for r in res)
        cap_check(ops == tiles, f"(a) {ops} ops over the ranks, want {tiles}")
        # on the CPU the wrapper takes the plain version and counts nothing
        want = tiles if device == "cuda" else 0
        cap_check(launches == want, f"(a) run {i + 1}: {launches} chain "
                  f"launches over the ranks, want {want}")
        cap_check(all(x["hit"] == (i == 1) for x in run),
                  f"(a) run {i + 1}: cache_hit not {i == 1} on every rank")
    owners = [r for r in res if r["gemm_plan"]["ops"]]
    if device == "cuda":
        cap_check(all(r["gemm"][0]["launches"] >= 1 for r in owners),
                  "(a) a rank that owns C tiles launched no chain")
    single = r0["single_ms"]
    log(f"mesh capture (a) the window captured inline on the card alone: "
        f"{single[0]:.1f} ms first execution (warm-up + capture), "
        f"{single[1]:.1f} ms replay ({smi})")
    same = {r["c_digest"] for r in res}
    agree = "the same on every rank and" if len(same) == 1 else \
        "DIFFERS between ranks;"
    log(f"mesh capture (a) C after the first wait_mesh: {agree} "
        f"{'bit for bit' if r0['bit_equal'] else 'NOT bit for bit'} the "
        f"inline single-card DAG's; |C - ref| / |ref| {r0['rel']:.3e} "
        f"against torch.matmul in f32")
    cap_check(len(same) == 1 and same == {r0["single_digest"]}
              and r0["bit_equal"], "(a) C is not the single-card DAG's bit "
              "for bit on every rank")
    cap_check(r0["rel"] < 1e-2, f"(a) |C - ref| / |ref| {r0['rel']}")
    for r in owners:
        m, nn, err, bad, ok = r["tile_checked"]
        cap_check(ok, f"(a) rank {r['rank']}'s C tile ({m}, {nn}) off the "
                  f"plain chain ({bad} elements)")
    log("mesh capture (a) one owned C tile a rank against the plain chain: "
        + ", ".join(f"r{r['rank']} ({r['tile_checked'][0]},"
                    f"{r['tile_checked'][1]}) max err "
                    f"{r['tile_checked'][2]:.3e}, {r['tile_checked'][3]} "
                    f"beyond the bound" for r in owners))
    # (b)
    pl = [r["potrf_plan"] for r in res]
    log(f"mesh capture (b) f32 DTD POTRF N={sz['potrf_n']} "
        f"TS={sz['potrf_ts']} ({r0['potrf_tasks']} tasks) over 2 x 4 ranks: "
        f"{max(r['potrf_ms'] for r in res):.1f} ms (slowest rank), the "
        f"window captured on the card alone {r0['potrf_single_ms'][0]:.1f} "
        f"ms first execution, {r0['potrf_single_ms'][1]:.1f} ms replay; "
        f"max|LL^T - A| / max|A| {r0['potrf_resid']:.3e}; L's worst excess "
        f"over rtol/atol 1e-5 from the single-card factor "
        f"{r0['potrf_vs_single']:.3e} ({smi})")
    cap_check(len({r["spd_digest"] for r in res}) == 1,
              "(b) the ranks built different matrices")
    cap_check(len({r["l_digest"] for r in res}) == 1,
              "(b) the ranks landed different factors")
    cap_check(r0["potrf_resid"] < 1e-5, f"(b) residual {r0['potrf_resid']}")
    cap_check(r0["potrf_vs_single"] <= 0, "(b) L off the single-card factor")
    # (c)
    for what, key in (("(a) GEMM", "gemm_plan"), ("(b) POTRF", "potrf_plan")):
        f0 = res[0][key]
        tb = r0["tile_bytes"] if key == "gemm_plan" else \
            sz["potrf_ts"] ** 2 * 4
        log(f"mesh capture {what} plan: ops a rank "
            f"{[r[key]['ops'] for r in res]}; transfers {f0['transfers']} "
            f"({sum(r[key]['sent_bytes'] for r in res)} B), received a rank "
            f"{[r[key]['recv'] for r in res]} "
            f"({[r[key]['recv_bytes'] for r in res]} B), the largest "
            f"{f0['largest']} B against a tile's {tb} B; landing "
            f"{f0['landing_bytes']} B a rank")
        cap_check(0 < f0["largest"] <= tb, f"{what}: a transfer of "
                  f"{f0['largest']} B, above one tile")
    log("mesh capture compat.STATS, rank 0: (a) first run "
        f"{r0['gemm'][0]['stats']}; (b) {r0['potrf_stats']}")
    if device == "cuda":
        cap_check(all("send_recv/staged" in r["gemm"][0]["stats"]
                      for r in res if r["gemm_plan"]["recv"]),
                  "(a) no transfer took the staged route")
        log("mesh capture peak memory a rank, GiB: " + ", ".join(
            f"{r['peak_gib']:.2f}" for r in res))
    log(f"mesh capture phase {time.perf_counter() - t0:.1f} s; the ranks "
        f"time-share one card, so no figure here is a scaling figure "
        f"({smi})")
    by_route = {}
    for r in res:
        for x in r["gemm"]:
            for k, v in x["by_route"].items():
                by_route[k] = by_route.get(k, 0) + v
    return {"launches": sum(x["launches"] for r in res for x in r["gemm"]),
            "by_route": by_route}


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
    # the host lanes (C++, no device code): the DTD engine, the PTG lane,
    # the scheduler plane, the device lane, the comm lane and the native
    # core (the dependency table)
    lanes = ("ptdtd", "ptexec", "ptsched", "ptdev", "ptcomm", "ptcore")
    py_h = os.path.join(sysconfig.get_paths()["include"], "Python.h")
    log(f"Python headers for the host lanes: {py_h} "
        f"{'present' if os.path.exists(py_h) else 'MISSING'}")
    # one compiler process per source (nvcc for the kernels, the host C++
    # compiler for the lanes), all started together
    build_s = {}

    def timed(build, name):
        t = time.perf_counter()
        build(name)
        build_s[name] = time.perf_counter() - t

    with ThreadPoolExecutor(len(names) + len(lanes) + 1) as pool:
        jobs = [pool.submit(timed, K.build, n) for n in names] + \
            [pool.submit(timed, NATIVE.build, s) for s in lanes]
        for job in jobs:
            job.result()
    log(f"built {', '.join(names)} (nvcc) and _{', _'.join(lanes)} "
        f"({' '.join(NATIVE.cxx())}) in {time.perf_counter() - t0:.3f} s; "
        f"each, started together: "
        + ", ".join(f"{n} {t:.1f} s" for n, t in build_s.items()))
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
    flash_res = flash_resources(K)
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
    profiler_probe(torch, "after the kernel checks")
    flash_device = flash_device_times(K, torch)
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

    # ---- 13. training on the card: run here, after the serving phase and
    # before the large traces of phases 9-12 (after those, short profiler
    # sessions lose their device events), so its trace (e) holds them
    train = training(K, torch, smi)
    flash_launches += train["launches"]
    for r, n_r in train["by_route"].items():
        flash_by_route[r] += n_r

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

    # ---- 9. the PTG frontend on a card context --------------------------
    ctx = ptt.Context(nb_cores=1)
    ptg_lane(ptt, torch, ctx, smi)
    ctx.fini()

    # ---- 10. the observability substrate on the main paths -------------
    profiler_probe(torch, "before phase 10")
    obs = observability(ptt, K, torch, smi)
    profiler_probe(torch, "after phase 10")
    launches += obs["launches"]
    lane_launches["native_traced"] = obs["launches"]
    gemm_by_route["split"] += obs["split"]

    # ---- 11. the rest of the single-rank substrate on the card ---------
    lm80_launches, lm80_by_route, flash_rows = substrate(ptt, K, torch, smi,
                                                         flash_device)
    flash_launches += lm80_launches
    for r, n_r in lm80_by_route.items():
        flash_by_route[r] += n_r

    # ---- 12. distribution on the task path, ranks on the one card ------
    dist = distribution(ptt, K, torch, smi)
    launches += dist["launches"]
    lane_launches["distributed"] = dist["launches"]
    gemm_by_route["split"] += dist["launches"]

    # ---- 14. the serving fabric: CPU ranks, then card work served, then
    # the mesh telemetry plane over both ----------------------------------
    card = serving_fabric(ptt, smi)
    launches += card["launches"]
    lane_launches["serving"] = card["launches"]
    for r, n_r in card["launches_by_route"].items():
        gemm_by_route[r] += n_r

    # ---- 15. the package's entry points: the CLI, the EP scaling row ----
    entry_points(smi)

    # ---- 16. meshes: a gloo group of 8 ranks on the one card ------------
    # ---- 17. mesh capture on the same group -----------------------------
    from parsec_tpu_torch.parallel.multihost import RankPool
    torch.cuda.empty_cache()
    pool = RankPool(MESH["ranks"], "cuda", timeout=MESH["job_s"])
    try:
        mesh = meshes(K, torch, smi, pool=pool)
        cap = mesh_capture(K, torch, smi, pool)
    finally:
        pool.close()
    flash_launches += mesh["launches"]
    for r, n_r in mesh["by_route"].items():
        flash_by_route[r] += n_r
    launches += cap["launches"]
    lane_launches["mesh_capture"] = cap["launches"]
    for r, n_r in cap["by_route"].items():
        gemm_by_route[r] += n_r

    # ---- the kernel line at the main paths' shapes ----------------------
    kernels = [gemm_chain_entry(K, torch, gen, launches, gemm_by_route),
               flash_entry(K, torch, gen, flash_launches, flash_by_route,
                           flash_device),
               stencil_entry(K, torch, gen, stencil_launches),
               matmul]
    kernels[0]["launches_by_lane"] = lane_launches
    kernels[1]["head_dims"] = flash_rows
    kernels[1]["resources"] = flash_res
    kernels[1]["training"] = {k: train[k] for k in (
        "launches", "launches_per_step", "step_ms", "tokens_per_s",
        "busy_ms", "window_ms", "peak_gib", "loss_first_last")}
    for e in kernels:
        if not e["launches"]:
            raise AssertionError(f"{e['name']} was not launched on its path")
    left = stop_children()
    log(f"processes left running and stopped at the end: {left or 'none'}")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    become_subreaper()
    try:
        rc = main()
    finally:
        left = stop_children()
        if left:
            print(f"chip_smoke: stopped processes left running: {left}",
                  file=sys.stderr)
    sys.exit(rc)
