#!/usr/bin/env python3
"""Times the flash kernel's wgmma route (``parsec_tpu_torch/csrc/
flash_attention.cu``) against variants of its source, on one CUDA card.

    python3 flash_variants.py

Each variant is the source with one region replaced (from a start marker up
to an end marker), built with the same nvcc flags into
``parsec_tpu_torch/build/variants/``. Every variant's output must equal the
unchanged kernel's bit for bit before it is timed. The libraries then take
turns (base, variants, variants reversed, base) at the LM path's shape,
(96, 1024, 64) bf16 causal, and at (32, 1024, 128) bf16 causal. Each gets
two times, as in ``chip_smoke.py``: the kernel line (CUDA events over
back-to-back calls, which the host's enqueue bounds from below) and the
kernel's device time (torch.profiler).

Probes (``no softmax``: P is S packed as it is; ``loads only``: the
consumers wait for each K and V tile and release it) cut work out of the
kernel to show where its time goes; their output is not the function and
only their time is printed.

Variants of the consumers' loop over a unit's key tiles (the kernel's own
loop waits for each S before its softmax and for each P V before the next
tile, the two consumer warpgroups running side by side):

* ``warpgroups take turns``: FA3's ping-pong. The two warpgroups take turns
  on named barriers 1 and 2: one issues P V of its previous tile and S of
  its next, then lets the other issue, and runs its softmax while the
  other's wgmmas run.
* ``P V under the next softmax``: FA3's overlap inside a warpgroup. S of
  tile j is issued, then P V of tile j - 1 (O rescaled just before it), and
  the softmax of tile j runs while that P V is on the tensor cores.
* ``S of the next tile under the softmax``: the other overlap inside a
  warpgroup. S of tile j + 1 is issued into a second set of registers
  before the softmax of tile j, which runs while it is on the tensor
  cores.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

# the consumers' loop over one unit's key tiles
LOOP_START = "      uint32_t pa[8][4];\n"
LOOP_END = "      ++qi;\n    }\n#pragma unroll"

_TURNS = """\
      uint32_t pa[8][4];
      int prev = 0;
      uint32_t prev_phase = 0;
      if (half == 1) asm volatile("bar.arrive 1, 256;" ::: "memory");
      for (int j = 0; j <= ntiles; ++j) {
        const int k0 = j * W_BK;
        const uint32_t k_addr =
            smem_u32(kv_tiles + (size_t)stage * 2 * W::TILE);
        float s[64];
        if (j < ntiles) mbar_wait(&k_full[stage], phase);
        if (j > 0) mbar_wait(&v_full[prev], prev_phase);
        asm volatile("bar.sync %0, 256;" ::"r"(1 + half) : "memory");
        if (j > 0) {
          wgmma_fence();
          issue_pv<D>(o, pa, smem_u32(kv_tiles + (size_t)prev * 2 * W::TILE +
                                      W::TILE));
          wgmma_commit();
        }
        if (j < ntiles) {
          wgmma_fence();
          issue_s<D>(s, q_addr, k_addr);
          wgmma_commit();
        }
        if (j < ntiles || half == 0)
          asm volatile("bar.arrive %0, 256;" ::"r"(2 - half) : "memory");
        wgmma_wait_all();
        if (j > 0 && lane == 0) mbar_arrive(&empty[prev]);
        if (j == ntiles - 1 && lane == 0) mbar_arrive(&q_empty[qb]);
        if (j == ntiles) break;
        const bool whole =
            k0 + W_BK <= sk &&
            (!causal || k_off + k0 + W_BK - 1 <= q_off + wg_row0);
        float corr[2];
        softmax_tile(s, m, l, corr, whole, k0, sk, causal, k_off, qpos, t,
                     scale_log2);
        rescale_o<D>(o, corr);
        pack_p(s, pa);
        prev = stage;
        prev_phase = phase;
        if (++stage == W::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
"""

_UNDER = """\
      uint32_t pa[8][4];
      float corr[2];
      int prev = stage;
      uint32_t prev_phase = phase;
      {
        // tile 0: S, its softmax
        float s[64];
        mbar_wait(&k_full[stage], phase);
        wgmma_fence();
        issue_s<D>(s, q_addr,
                   smem_u32(kv_tiles + (size_t)stage * 2 * W::TILE));
        wgmma_commit();
        wgmma_wait_all();
        if (ntiles == 1 && lane == 0) mbar_arrive(&q_empty[qb]);
        const bool whole = W_BK <= sk &&
                           (!causal || k_off + W_BK - 1 <= q_off + wg_row0);
        softmax_tile(s, m, l, corr, whole, 0, sk, causal, k_off, qpos, t,
                     scale_log2);
        pack_p(s, pa);
        if (++stage == W::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      for (int j = 1; j < ntiles; ++j) {
        // S of tile j, then P V of tile j - 1, which runs under the
        // softmax of tile j
        const int k0 = j * W_BK;
        float s[64];
        mbar_wait(&k_full[stage], phase);
        wgmma_fence();
        issue_s<D>(s, q_addr,
                   smem_u32(kv_tiles + (size_t)stage * 2 * W::TILE));
        wgmma_commit();
        rescale_o<D>(o, corr);
        mbar_wait(&v_full[prev], prev_phase);
        wgmma_fence();
        issue_pv<D>(o, pa, smem_u32(kv_tiles + (size_t)prev * 2 * W::TILE +
                                    W::TILE));
        wgmma_commit();
        asm volatile("wgmma.wait_group.sync.aligned 1;\\n" ::: "memory");
        if (j == ntiles - 1 && lane == 0) mbar_arrive(&q_empty[qb]);
        const bool whole =
            k0 + W_BK <= sk &&
            (!causal || k_off + k0 + W_BK - 1 <= q_off + wg_row0);
        softmax_tile(s, m, l, corr, whole, k0, sk, causal, k_off, qpos, t,
                     scale_log2);
        wgmma_wait_all();
        if (lane == 0) mbar_arrive(&empty[prev]);
        pack_p(s, pa);
        prev = stage;
        prev_phase = phase;
        if (++stage == W::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      rescale_o<D>(o, corr);
      mbar_wait(&v_full[prev], prev_phase);
      wgmma_fence();
      issue_pv<D>(o, pa, smem_u32(kv_tiles + (size_t)prev * 2 * W::TILE +
                                  W::TILE));
      wgmma_commit();
      wgmma_wait_all();
      if (lane == 0) mbar_arrive(&empty[prev]);
"""

_S_AHEAD = """\
      uint32_t pa[8][4];
      float sa[64], sb[64];
      mbar_wait(&k_full[stage], phase);
      wgmma_fence();
      issue_s<D>(sa, q_addr,
                 smem_u32(kv_tiles + (size_t)stage * 2 * W::TILE));
      wgmma_commit();
      wgmma_wait_all();
#define FLASH_STEP(CUR, NXT)                                                  \\
  {                                                                           \\
    const int k0 = j * W_BK;                                                  \\
    const int nst = stage + 1 == W::STAGES ? 0 : stage + 1;                   \\
    const uint32_t nph = stage + 1 == W::STAGES ? phase ^ 1 : phase;          \\
    if (j + 1 < ntiles) {                                                     \\
      mbar_wait(&k_full[nst], nph);                                           \\
      wgmma_fence();                                                          \\
      issue_s<D>(NXT, q_addr,                                                 \\
                 smem_u32(kv_tiles + (size_t)nst * 2 * W::TILE));             \\
      wgmma_commit();                                                         \\
    }                                                                         \\
    if (j == ntiles - 1 && lane == 0) mbar_arrive(&q_empty[qb]);             \\
    const bool whole =                                                        \\
        k0 + W_BK <= sk &&                                                    \\
        (!causal || k_off + k0 + W_BK - 1 <= q_off + wg_row0);                \\
    float corr[2];                                                            \\
    softmax_tile(CUR, m, l, corr, whole, k0, sk, causal, k_off, qpos, t,      \\
                 scale_log2);                                                 \\
    rescale_o<D>(o, corr);                                                    \\
    pack_p(CUR, pa);                                                          \\
    mbar_wait(&v_full[stage], phase);                                         \\
    wgmma_fence();                                                            \\
    issue_pv<D>(o, pa, smem_u32(kv_tiles + (size_t)stage * 2 * W::TILE +      \\
                                W::TILE));                                    \\
    wgmma_commit();                                                           \\
    wgmma_wait_all();                                                         \\
    if (lane == 0) mbar_arrive(&empty[stage]);                                \\
    stage = nst;                                                              \\
    phase = nph;                                                              \\
  }
      for (int j = 0; j < ntiles; ++j) {
        if (j % 2 == 0)
          FLASH_STEP(sa, sb)
        else
          FLASH_STEP(sb, sa)
      }
#undef FLASH_STEP
"""

VARIANTS = {
    "warpgroups take turns": (LOOP_START, LOOP_END, _TURNS),
    "P V under the next softmax": (LOOP_START, LOOP_END, _UNDER),
    "S of the next tile under the softmax": (LOOP_START, LOOP_END, _S_AHEAD),
}

# cuts that take work out of the kernel to show where its time goes; their
# output is not the function, so only their time is read
PROBES = {
    "no softmax": (
        "        softmax_tile(s, m, l, corr, whole, k0, sk, causal, k_off, "
        "qpos, t,\n",
        "        pack_p(s, pa);\n",
        "        (void)whole;\n        (void)corr;\n"),
    "loads only": (LOOP_START, LOOP_END, """\
      for (int j = 0; j < ntiles; ++j) {
        mbar_wait(&k_full[stage], phase);
        mbar_wait(&v_full[stage], phase);
        if (j == ntiles - 1 && lane == 0) mbar_arrive(&q_empty[qb]);
        if (lane == 0) mbar_arrive(&empty[stage]);
        if (++stage == W::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      (void)q_addr;
"""),
}


def build_variant(K, name: str, start: str, end: str, text: str):
    """The flash library built from the source with [start, end) replaced
    by ``text``; returns (library, nvcc's messages)."""
    with open(os.path.join(K.CSRC_DIR, "flash_attention.cu")) as f:
        src = f.read()
    if src.count(start) != 1 or src.count(end) != 1:
        raise RuntimeError(f"variant {name!r}: a marker is not in the source "
                           "once")
    i, j = src.index(start), src.index(end)
    src = src[:i] + text + src[j:]
    out = os.path.join(K.BUILD_DIR, "variants")
    os.makedirs(out, exist_ok=True)
    stem = os.path.join(out, "flash_" + name.replace(" ", "_"))
    with open(stem + ".cu", "w") as f:
        f.write(src)
    proc = subprocess.run([K.nvcc_path(), *K.NVCC_FLAGS, "-o", stem + ".so",
                           stem + ".cu"], capture_output=True, text=True,
                          check=True)
    lib = ctypes.CDLL(stem + ".so")
    K._bind("flash_attention", lib)
    return lib, proc.stderr


def event_ms(torch, fn, iters: int, warmup: int = 3) -> float:
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import fmt_ms, profiled_ms
    from parsec_tpu_torch.ops import cuda_kernels as K
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    libs = {"base": K._library("flash_attention")}
    for name, (start, end, text) in {**VARIANTS, **PROBES}.items():
        libs[name], msgs = build_variant(K, name, start, end, text)
        for line in msgs.splitlines():
            print(f"nvcc {name}: {line}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {}
    for bh, d in ((96, 64), (32, 128)):
        q, k, v = (torch.randn(bh, 1024, d, device="cuda", generator=gen
                               ).to(torch.bfloat16) for _ in range(3))
        cases[f"flash bf16 ({bh}, 1024, {d}) causal"] = (
            lambda q=q, k=k, v=v: K.flash_attention(q, k, v, causal=True))
    names = list(libs)
    order = names + names[1:][::-1] + names[:1]
    try:
        for case, fn in cases.items():
            K._libs["flash_attention"] = libs["base"]
            want = fn()
            for name in VARIANTS:
                K._libs["flash_attention"] = libs[name]
                if not torch.equal(fn(), want):
                    raise AssertionError(f"variant {name!r} changes the "
                                         f"output of {case}")
            for name in order:
                K._libs["flash_attention"] = libs[name]
                line_ms = event_ms(torch, fn, 50)
                device_ms = profiled_ms(torch, fn, "flash_bf16_wgmma")
                print(f"{case}: {name}: {line_ms:.4f} ms, device "
                      f"{fmt_ms(device_ms)}", flush=True)
    finally:
        K._libs["flash_attention"] = libs["base"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
