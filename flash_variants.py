#!/usr/bin/env python3
"""Times the flash kernel's routes (``parsec_tpu_torch/csrc/
flash_attention.cu``) against variants of its source and SDPA, on one
CUDA card.

    python3 flash_variants.py [GROUP ...]

GROUP is ``256``, ``128`` or ``f32`` (all three, in that order, by
default). Each variant is the source with some texts replaced (a list of
(old, new) pairs; ``span`` names a region between two markers), built with
the same nvcc flags into ``parsec_tpu_torch/build/variants/``, all builds
started together. Before any timing, the unchanged kernel and then each
variant run once, each launch followed by a synchronize, so that a fault
names the launch that made it. Every variant's output must equal the
unchanged kernel's bit for bit, except where it says otherwise. The
libraries and SDPA then take turns (base, variants, SDPA, SDPA, variants
reversed, base). Each gets two times, as in ``chip_smoke.py``: the kernel
line (CUDA events over back-to-back calls, which the host's enqueue
bounds from below) and the kernel's device time (torch.profiler; SDPA's
longest kernel, named).

``256``: the wgmma kernel built at 256, at (96, 1024, 256) bf16 causal,
against one variant (bit-equal output), ``units over every head at 256``
(the units in rounds over every head, the order before the heads went in
groups that fit the L2), and three probes, which cut work out of the
kernel to show where its time goes (their output is not the function and
only their time is printed): ``no softmax at 256`` (P is S packed as it
is), ``loads only at 256`` (the consumers wait for each K and V tile and
release it), and ``Q buffer released at once`` (each consumer warp
releases the one Q buffer as soon as the unit's Q tile has landed, so the
producer loads the next unit's Q under the unit's S; the time it saves is
the time the wait for the buffer costs). A probe keeps every wait of the
barriers' protocol: a producer that skipped its wait for the Q buffer
could complete two phases of the Q barrier before a consumer warp waited
on the first (where the unit after the current one has at most two key
tiles, which the ring's two stages take whole), and that warp's parity
wait would then never return.

``128``: the wgmma kernel built at 64 and 128, at the LM path's shape,
(96, 1024, 64) bf16 causal, and at (32, 1024, 128), against the three
variants of its consumers' loop below and the probes ``no softmax`` and
``loads only``.

``f32``: the tiled float32 kernel at (96, 1024, 64) and (16, 1024, 512)
float32 causal, against two variants held to the plain version (rtol/atol
2e-4; each one's largest error is printed beside the kernel's and
SDPA's): ``parent f32``, the kernel it replaced (``_PARENT_F32``, spliced
in place of the float32 section), and ``expf in place of ex2`` (its
weights and corrections as CUDA's ``expf`` in place of the MUFU's
``ex2.approx.ftz``);
and against three bit-equal ones: its S threads laid out 2 x 16 a warp,
the S loop unrolled by 4, and one block an SM.

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
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

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


def span(start: str, end: str):
    """A variant's ``old`` text: the source from ``start`` up to ``end``
    (each found once)."""
    def text(src: str) -> str:
        if src.count(start) != 1 or src.count(end) != 1:
            raise RuntimeError(f"a marker is not in the source once: "
                               f"{start!r} .. {end!r}")
        return src[src.index(start):src.index(end)]
    return text


VARIANTS = {
    "warpgroups take turns": [(span(LOOP_START, LOOP_END), _TURNS)],
    "P V under the next softmax": [(span(LOOP_START, LOOP_END), _UNDER)],
    "S of the next tile under the softmax": [(span(LOOP_START, LOOP_END),
                                              _S_AHEAD)],
}

# cuts that take work out of the kernel to show where its time goes; their
# output is not the function, so only their time is read
PROBES = {
    "no softmax": [(span(
        "        softmax_tile(s, m, l, corr, whole, k0, sk, causal, k_off, "
        "qpos, t,\n",
        "        pack_p(s, pa);\n"),
        "        (void)whole;\n        (void)corr;\n")],
    "loads only": [(span(LOOP_START, LOOP_END), """\
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
""")],
}


# the float32 section of the source (the tiled SIMT kernel and its launcher)
F32_START = ("// ----------------------------------------------------------------"
             " float32\n")
F32_END = ("// ----------------------------------------------------------- bf16:"
           " wgmma\n")
# the float32 kernel it replaced (flash_f32<D, STEPS>: TPR threads a q row,
# scores joined by shuffles, q reread from device memory each step past
# 256, a grid axis over 256-column output chunks) with its launcher, to time
# the two in turns
_PARENT_F32 = r"""// ---------------------------------------------------------------- float32

// The SIMT kernel's layout at built size D: TPR threads share a q row (2, and
// 4 at D = 256, so q and O stay at 64 registers each), 64 rows a block, and
// K and V tiles of BKF keys (32, and 16 at D = 256: 32 KB of shared memory).
template <int D>
struct Simt {
  static constexpr int TPR = D > 128 ? 4 : 2;
  static constexpr int THREADS = BQ * TPR;
  static constexpr int BKF = D > 128 ? 16 : 32;
  static constexpr int P = D / (2 * TPR);   // float2 pairs a thread owns
};

// Rows [r0, r0 + BKF) and columns [c0, c0 + D) of a (nrows, d) row-major
// matrix into shared memory (leading dim D), zero-filling rows past nrows
// and columns past d. `vec`: 16-byte loads (aligned base and d % 4 == 0; c0
// is 0 or a multiple of D).
template <int D>
__device__ __forceinline__ void stage_f32(float* dst,
                                          const float* __restrict__ src,
                                          int r0, int nrows, int d, int c0,
                                          bool vec) {
  using S = Simt<D>;
  constexpr int VPR = D / 4;
  for (int i = threadIdx.x; i < S::BKF * VPR; i += S::THREADS) {
    const int r = i / VPR, c = c0 + (i % VPR) * 4, gr = r0 + r;
    float* dp = dst + r * D + (c - c0);
    if (gr >= nrows || c >= d) {
      *reinterpret_cast<float4*>(dp) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else if (vec) {
      *reinterpret_cast<float4*>(dp) =
          *reinterpret_cast<const float4*>(src + (size_t)gr * d + c);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[e] = c + e < d ? src[(size_t)gr * d + c + e] : 0.f;
    }
  }
}

// Thread part `hf` of a row owns the columns 2 TPR i + 2 hf and
// 2 TPR i + 2 hf + 1 (i < P), so the parts read neighbouring words of a
// shared row and each dot is TPR part-sums joined by shuffles. STEPS as in
// flash_bf16: a thread reads its part of q's step from device memory
// (scaled in float32, as the TPU kernel scales q) and adds the step's
// part-dot to its running part-sum; the parts join after the last step.
template <int D, bool STEPS>
__global__ void __launch_bounds__(Simt<D>::THREADS)
flash_f32(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ out, int sq,
          int sk, int d, int causal, float scale, int q_off, int k_off,
          bool vec) {
  using S = Simt<D>;
  constexpr int TPR = S::TPR, P = S::P, BKF = S::BKF;
  __shared__ __align__(16) float Ks[BKF * D];
  __shared__ __align__(16) float Vs[BKF * D];

  const int bh = blockIdx.x;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest first
  const int c0 = STEPS ? blockIdx.z * D : 0;            // the output chunk
  const int hf = threadIdx.x % TPR;
  const int row = row0 + threadIdx.x / TPR;
  const bool live = row < sq;
  const float* qrow = q + ((size_t)bh * sq + (live ? row : 0)) * d;
  const float* kb = k + (size_t)bh * sk * d;
  const float* vb = v + (size_t)bh * sk * d;

  // q's columns [d0, d0 + D) of this thread's part, scaled
  float2 qr[P], o[P];
  auto load_q = [&](int d0) {
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int c = d0 + 2 * TPR * i + 2 * hf;
      qr[i] = make_float2(live && c < d ? qrow[c] * scale : 0.f,
                          live && c + 1 < d ? qrow[c + 1] * scale : 0.f);
    }
  };
  if constexpr (!STEPS) load_q(0);
#pragma unroll
  for (int i = 0; i < P; ++i) o[i] = make_float2(0.f, 0.f);
  float m = NEG, l = 0.f;
  const int qpos = q_off + row;

  const int kend = key_end(sq, sk, causal, row0, BQ, q_off, k_off);
  for (int k0 = 0; k0 < kend; k0 += BKF) {
    float s[BKF];
#pragma unroll
    for (int j = 0; j < BKF; ++j) s[j] = 0.f;
    for (int d0 = 0; d0 < (STEPS ? d : 1); d0 += D) {
      stage_f32<D>(Ks, kb, k0, sk, d, d0, vec);
      if constexpr (STEPS) load_q(d0);
      else stage_f32<D>(Vs, vb, k0, sk, d, 0, vec);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < BKF; ++j) {
        const float2* kr = reinterpret_cast<const float2*>(Ks + j * D) + hf;
        float part = s[j];
#pragma unroll
        for (int i = 0; i < P; ++i) {
          const float2 kv = kr[TPR * i];
          part = fmaf(qr[i].x, kv.x, part);
          part = fmaf(qr[i].y, kv.y, part);
        }
        s[j] = part;
      }
      if constexpr (STEPS) __syncthreads();
    }
    if constexpr (STEPS) stage_f32<D>(Vs, vb, k0, sk, d, c0, vec);

    float mx = m;
#pragma unroll
    for (int j = 0; j < BKF; ++j) {
      float x = s[j] + __shfl_xor_sync(FULL, s[j], 1);
      if (TPR == 4) x += __shfl_xor_sync(FULL, x, 2);
      const int col = k0 + j;
      const bool keep = col < sk && (!causal || k_off + col <= qpos);
      s[j] = keep ? x : NEG;
      mx = fmaxf(mx, s[j]);
    }
    const float corr = expf(m - mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BKF; ++j) {
      s[j] = s[j] > 0.5f * NEG ? expf(s[j] - mx) : 0.f;
      sum += s[j];
    }
    l = l * corr + sum;
    m = mx;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      o[i].x *= corr;
      o[i].y *= corr;
    }
    if constexpr (STEPS) __syncthreads();   // V staged
#pragma unroll
    for (int j = 0; j < BKF; ++j) {
      const float2* vr = reinterpret_cast<const float2*>(Vs + j * D) + hf;
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const float2 vv = vr[TPR * i];
        o[i].x = fmaf(s[j], vv.x, o[i].x);
        o[i].y = fmaf(s[j], vv.y, o[i].y);
      }
    }
    __syncthreads();
  }

  if (!live) return;
  const float den = fmaxf(l, 1e-30f);
  float* dst = out + ((size_t)bh * sq + row) * d;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int c = c0 + 2 * TPR * i + 2 * hf;
    if (d % 2 == 0) {
      if (c < d)
        *reinterpret_cast<float2*>(dst + c) =
            make_float2(o[i].x / den, o[i].y / den);
    } else {
      if (c < d) dst[c] = o[i].x / den;
      if (c + 1 < d) dst[c + 1] = o[i].y / den;
    }
  }
}

// the parent's dispatch: the smallest built size D >= d of {16, ..., 256},
// and past 256 the D = 256 kernel with STEPS over 256-column output chunks
template <int D, bool STEPS>
int launch_simt(const void* q, const void* k, const void* v, void* out,
                dim3 grid, int sq, int sk, int d, int causal, float scale,
                int q_off, int k_off, bool vec, cudaStream_t st) {
  flash_f32<D, STEPS><<<grid, Simt<D>::THREADS, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), sq, sk, d,
      causal, scale, q_off, k_off, vec);
  return (int)cudaGetLastError();
}

int launch_f32(const void* q, const void* k, const void* v, void* out,
               int bh, int sq, int sk, int d, int causal, float scale,
               int q_off, int k_off, bool vec, bool, cudaStream_t st) {
  if ((sq + BQ - 1) / BQ > 65535 || (d + CW - 1) / CW > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(bh, (sq + BQ - 1) / BQ, d > CW ? (d + CW - 1) / CW : 1);
#define FLASH_SIMT(D, STEPS)                                                \
  return launch_simt<D, STEPS>(q, k, v, out, grid, sq, sk, d, causal, scale, \
                               q_off, k_off, vec, st)
  if (d <= 16) FLASH_SIMT(16, false);
  if (d <= 32) FLASH_SIMT(32, false);
  if (d <= 64) FLASH_SIMT(64, false);
  if (d <= 128) FLASH_SIMT(128, false);
  if (d <= 256) FLASH_SIMT(256, false);
  FLASH_SIMT(256, true);
#undef FLASH_SIMT
}

"""
# float32 variants held to the plain version (rtol/atol 2e-4), not to the
# kernel's bits: the kernel it replaced, and its weights and corrections
# as CUDA's expf in place of the MUFU's ex2
F32_TO_PLAIN = {
    "parent f32": [(span(F32_START, F32_END), _PARENT_F32)],
    "expf in place of ex2": [
        ("        const float corr = ex2((m - mx) * LOG2E);\n"
         "        const float ref = mx * LOG2E;\n",
         "        const float corr = expf(m - mx);\n"),
        ("x[e][u] > 0.5f * NEG ? ex2(fmaf(x[e][u], LOG2E, -ref)) : 0.f;",
         "x[e][u] > 0.5f * NEG ? expf(x[e][u] - mx) : 0.f;")],
}
# float32, bit-equal: the tiled kernel's S threads laid out 2 x 16 a warp
# (a float4 load of K then spans 16 keys: two wavefronts) in place of
# 4 x 8; the S loop unrolled by 4 (fewer live registers than a full
# unroll); one block an SM (no register cap, so no spills)
F32_VARIANTS = {
    "S warps 2 x 16": [(span(
        "  const int g = tid / (4 * BQ), wl = tid % (4 * BQ) / 32, "
        "lane = tid % 32;\n",
        "  // softmax: thread `part` of row srow owns float4 keys part NF + e\n"),
        "  const int g = tid / (4 * BQ), sy = tid % (4 * BQ) / 16, "
        "sx = tid % 16;\n")],
    "S loop unrolled by 4": [(
        "#pragma unroll\n      for (int ff = 0; ff < GC4; ++ff) {",
        "#pragma unroll 4\n      for (int ff = 0; ff < GC4; ++ff) {")],
    "one block an SM": [("__global__ void __launch_bounds__(F_THREADS, 2)",
                         "__global__ void __launch_bounds__(F_THREADS, 1)")],
}

# the wgmma kernel built at 256: its consumers' loop over a unit's key
# tiles
LOOP256_START = "      uint32_t pa[4][4];\n"
LOOP256_END = "      ++qi;\n    }\n    // O / l into the unit's rows"

VARIANTS_256 = {
    # units in rounds over every head, heaviest q tile first (the order
    # before the heads went in groups that fit the L2)
    "units over every head at 256": [(
        "  const int group = l2_group(bh, sk, d, 2, l2);",
        "  const int group = bh;")],
}
PROBES_256 = {
    # each consumer warp releases the Q buffer as soon as the unit's Q tile
    # has landed, not after the unit's last S: the producer's wait for the
    # buffer stays, so the Q loads keep the barriers' phases in step
    "Q buffer released at once": [
        ("        // the unit's last S read the Q tile: the buffer is free\n"
         "        if (j == ntiles - 1 && lane == 0) mbar_arrive(q_empty);\n",
         ""),
        ("      mbar_wait(q_full, qi & 1);\n",
         "      mbar_wait(q_full, qi & 1);\n"
         "      if (lane == 0) mbar_arrive(q_empty);\n")],
    "no softmax at 256": [(span(
        "        softmax_tile<32>(s, m, l, corr, whole, k0, sk, causal, k_off,"
        " qpos,\n",
        "        pack_p<4>(s, pa);\n"),
        "        (void)whole;\n        (void)corr;\n")],
    "loads only at 256": [(span(LOOP256_START, LOOP256_END), """\
      for (int j = 0; j < ntiles; ++j) {
        mbar_wait(&k_full[stage], phase);
        mbar_wait(&v_full[stage], phase);
        if (j == ntiles - 1 && lane == 0) mbar_arrive(q_empty);
        if (lane == 0) mbar_arrive(&empty[stage]);
        if (++stage == X_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      (void)q_addr;
""")],
}


def build_variant(K, name: str, subs):
    """The flash library built from the source with each (old, new) of
    ``subs`` applied: ``old`` is a text found once in the source, or a
    function of the source that gives one (:func:`span`); returns
    (library, nvcc's messages)."""
    with open(os.path.join(K.CSRC_DIR, "flash_attention.cu")) as f:
        src = f.read()
    for old, new in subs:
        if callable(old):
            old = old(src)
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name!r}: the text to replace is not "
                               f"in the source once:\n{old}")
        src = src.replace(old, new)
    out = os.path.join(K.BUILD_DIR, "variants")
    os.makedirs(out, exist_ok=True)
    stem = os.path.join(out, "flash_" + re.sub(r"\W+", "_", name))
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


def main(argv) -> int:
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import fmt_ms, profiled_kernels, profiled_ms, sdpa_view
    from parsec_tpu_torch.ops import cuda_kernels as K
    bf16, f32 = torch.bfloat16, torch.float32
    # group: (the kernel's profiler name, members, shapes (dtype, bh, d))
    groups = {
        "256": ("flash_bf16_wgmma256", {**VARIANTS_256, **PROBES_256},
                ((bf16, 96, 256),)),
        "128": ("flash_bf16_wgmma<", {**VARIANTS, **PROBES},
                ((bf16, 96, 64), (bf16, 32, 128))),
        "f32": ("flash_f32", {**F32_TO_PLAIN, **F32_VARIANTS},
                ((f32, 96, 64), (f32, 16, 512)))}
    chosen = argv or list(groups)
    if not set(chosen) <= set(groups):
        print(f"flash_variants: groups are {', '.join(groups)}",
              file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    K.dot_precision()                      # no TF32 for SDPA either
    base = K._library("flash_attention")
    libs = {}
    # one nvcc a variant, all started together
    with ThreadPoolExecutor(8) as pool:
        jobs = {name: pool.submit(build_variant, K, name, subs)
                for g in chosen for name, subs in groups[g][1].items()}
        for name, job in jobs.items():
            try:
                libs[name], msgs = job.result()
            except subprocess.CalledProcessError as e:
                print(f"nvcc {name} failed, left out: {e.stderr[-2000:]}")
                continue
            for line in msgs.splitlines():
                print(f"nvcc {name}: {line}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    try:
        for g in chosen:
            kernel, members, shapes = groups[g]
            members = [n for n in members if n in libs]
            names = ["base", *members, "SDPA"]
            order = names + names[1:][::-1] + names[:1]
            for dtype, bh, d in shapes:
                q, k, v = (torch.randn(bh, 1024, d, device="cuda",
                                       generator=gen).to(dtype)
                           for _ in range(3))
                q4, k4, v4 = (sdpa_view(t, bh) for t in (q, k, v))
                case = f"flash {str(dtype)[6:]} ({bh}, 1024, {d}) causal"

                def fn():
                    return K.flash_attention(q, k, v, causal=True)

                def sdpa():
                    return F.scaled_dot_product_attention(
                        q4, k4, v4, is_causal=True).reshape(q.shape)

                def checked(name):
                    # synchronised, so that a fault names its own launch
                    K._libs["flash_attention"] = libs.get(name, base)
                    try:
                        out = sdpa() if name == "SDPA" else fn()
                        torch.cuda.synchronize()
                    except RuntimeError as e:
                        raise RuntimeError(f"{case}: {name}: {e}") from e
                    return out
                want = checked("base")
                plain = K.flash_attention_plain(q, k, v, causal=True)
                for name in members:
                    got = checked(name)
                    if name in F32_TO_PLAIN or dtype == f32:
                        err = (got.float() - plain.float()).abs().max()
                        print(f"{case}: {name}: max abs err against plain "
                              f"{err.item():.3e}")
                    if name in F32_TO_PLAIN:
                        torch.testing.assert_close(got, plain, rtol=2e-4,
                                                   atol=2e-4)
                    elif name not in {**PROBES, **PROBES_256} and \
                            not torch.equal(got, want):
                        raise AssertionError(f"variant {name!r} changes the "
                                             f"output of {case}")
                if dtype == f32:
                    torch.testing.assert_close(want, plain, rtol=2e-4,
                                               atol=2e-4)
                    for name, got in (("base", want), ("SDPA",
                                                       checked("SDPA"))):
                        err = (got - plain).abs().max()
                        print(f"{case}: {name}: max abs err against plain "
                              f"{err.item():.3e}")
                for name in order:
                    K._libs["flash_attention"] = libs.get(name, base)
                    run = sdpa if name == "SDPA" else fn
                    line_ms = event_ms(torch, run, 50)
                    if name == "SDPA":
                        times = profiled_kernels(torch, run)
                        device_ms = max(times.values()) if times else None
                        label = f"SDPA ({max(times, key=times.get)[:80]})" \
                            if times else "SDPA"
                    else:
                        device_ms, label = profiled_ms(torch, run, kernel), name
                    print(f"{case}: {label}: {line_ms:.4f} ms, device "
                          f"{fmt_ms(device_ms)}", flush=True)
                del q, k, v, q4, k4, v4, want, plain
    finally:
        K._libs["flash_attention"] = base
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
