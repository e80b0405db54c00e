// flash_attention: out = softmax(q k^T * scale) v, one launch per call.
//
// Replaces the TPU kernel `_flash_attn_call` / `flash_attention` of the
// reference package's ops/pallas_kernels.py (pallas_call at :400): there the
// grid (bh, sq/bq, sk/bk) runs its k dimension in order on one core, with the
// online-softmax state (running max m, running sum l, accumulator acc) in
// VMEM scratch across it. Here one thread block owns (bh, a 64-row q tile)
// and the k dimension is a loop inside the block; m, l and acc stay in f32
// registers, and neither the scores nor the probabilities reach device
// memory.
//
// Semantics (shared with the TPU kernel):
// * q (bh, sq, d), k and v (bh, sk, d); sk may differ from sq. out has q's
//   shape and dtype.
// * Causal masking on GLOBAL positions: key j is kept for query i when
//   k_off + j <= q_off + i. A masked score is NEG = -1e30 (not -inf).
// * m starts at NEG, l at 0. A weight is p = exp(s - m_new), forced to 0
//   where s <= NEG / 2, so a row that is masked everywhere carries no weight
//   (without the guard, s == m_new == NEG would give p = 1). The correction
//   is exp(m - m_new).
// * out = acc / max(l, 1e-30): a fully masked row is exactly zero.
// * Causal key tiles wholly above the block's diagonal are never visited:
//   the loop ends at the last key the block's last row can see.
// * Ragged tails of sq and sk are masked here (zero-filled tiles, padded
//   keys scored NEG), so any sq, sk >= 1 runs.
// * Any head dim d >= 1. A launch runs the instantiation at the smallest
//   built size D >= d (bf16: {16, 32, 64, 128, 256} on mma.sync, 64, 128
//   and 256 on the wgmma route; float32: {16, 32, ..., 1024}): the loads of
//   q, k and v fill columns d .. D - 1 with zeros in shared memory or
//   registers (TMA's out-of-bounds fill on the wgmma route), never in a
//   padded copy in device memory, and the store writes the d real columns.
//   Zero columns change neither q k^T nor the first d columns of P V, and
//   the default scale is 1/sqrt(d) from the caller. A launch at d > 256
//   takes the chunked route (below).
//
// Precision.
// * float32: every product and sum is a float32 FMA on the SIMT cores, never
//   TF32. q is multiplied by `scale` in float32 before the dot, as the TPU
//   kernel does. The weights and the corrections are not expf: each is
//   2^y on the MUFU (ex2.approx.ftz: relative error about 2^-22, a result
//   below 2^-126 flushed to 0) of y = s log2(e) - m log2(e), one FMA on the
//   rounded m log2(e), as the bf16 wgmma route takes them.
// * bf16: q k^T runs on the tensor cores (bf16 in, f32 accumulation), so
//   every product is exact, as in the TPU kernel, where q and k are cast to
//   f32. The scale is applied to the f32 scores after the dot, where the TPU
//   kernel scales f32 q before it: one f32 rounding apart (the wgmma route
//   takes exp(s scale - m) as 2^(s c - m c) with c = scale * log2(e), one
//   FMA and the MUFU's ex2: f32 roundings again). The softmax runs in
//   f32. For P V, P is rounded to bf16 (it lies in [0, 1], relative error
//   at most 2^-8) and multiplied on the tensor cores with f32
//   accumulation; l sums the unrounded f32 weights. The output therefore
//   lies within 2^-8 * sum_j p_j |v_j| / l of the f32 result before its own
//   rounding (flash_attention_bf16_tolerance in ops/cuda_kernels.py).
//
// Bound. At the LM path's shape, q k v o of (96, 1024, 64) bf16, causal,
// the function moves 4 * 96 * 1024 * 64 * 2 B = 50.3 MB (15.0 us at the
// H100's 3.35 TB/s) and does 4 * 64 * 96 * (1024 * 1025 / 2) = 12.9 GFLOP of
// products on the causal triangle (13.0 us at 989 TFLOP/s bf16): the bytes
// bound it, and only just. float32 runs outside the tensor cores (67
// TFLOP/s), where the operations bound it (193 us).
//
// Routes, chosen by the caller from dtype, head dim and alignment before the
// launch (ops/cuda_kernels.py flash_route); a route whose preconditions do
// not hold is refused with cudaErrorInvalidValue, never exchanged:
//
// * wgmma (bf16, 32 < d <= 256 with d % 8 == 0, 16-byte aligned bases, at
//   D = 64 or 128, and past 128 the D = 256 kernel below): Hopper's path. A
//   work unit is (bh, a 128-row q tile); a block has 288 threads, two
//   consumer warpgroups of 64 q rows each and one producer warp. The
//   producer's first lane loads each unit's Q tile into the free one of two
//   buffers and streams its 128-key K and V tiles through a ring of STAGES
//   stages (3 at D = 64, 2 at D = 128: 128 and 192 KB of shared memory) with
//   TMA: 3-D tensor maps over (d, s, bh), boxes of 64 columns x 128 rows x 1
//   with 128-byte swizzle (two boxes a row block at D = 128), so the zero
//   fill of a ragged tail stays inside its head. K and V of a stage have a
//   full mbarrier each, so S can start before V has landed; an empty
//   mbarrier a stage or Q buffer takes an arrival from each of the 8
//   consumer warps. A consumer warpgroup computes S = Q K^T with wgmma
//   m64n128k16 (both from shared memory; K is K-major), runs the online
//   softmax on the accumulator in registers (in base 2, see softmax_tile),
//   masks only the tiles that cross the causal diagonal of its 64 rows or
//   the ragged sk tail, and adds P V with the register-A wgmma m64n{d}k16:
//   the S accumulator of m64n128 has the per-warp layout of mma.sync's C
//   fragments and the A operand that of its A fragments, so P is the S
//   registers packed to bf16x2; V is MN-major (transpose bit 1; LBO = one
//   16 KB box, the next 64 columns; SBO = 1024 B, the next 8 keys). 288
//   threads leave 224 registers a thread (S 64, O up to 64, P 32), so no
//   warpgroup needs setmaxnreg.
//   Grid: persistent, one block an SM. A block runs one unit after another
//   and the producer loads the next unit's Q, K and V while the consumers
//   finish the last one, which a block a unit (768 blocks at the main
//   shape, one resident an SM) left exposed at every start. Units go out
//   heaviest causal tile first in rounds of the grid, every other round in
//   reverse: at the main shape the busiest SM gets 27 key tiles where the
//   mean is 26.2 (30 with every round in order).
//   The two consumer warpgroups run side by side. FA3's overlaps (the two
//   warpgroups taking turns on the tensor cores; P V of one tile under the
//   softmax of the next; S of the next tile under the softmax) measured
//   slower here (flash_variants.py).
//   At 128 < d <= 256 (flash_bf16_wgmma256), O is 64 x 256 float32 a
//   consumer warpgroup, 128 registers a thread, so the block is FA3's shape
//   for head dim 256: 384 threads, a producer warpgroup that gives its
//   registers up with setmaxnreg (24 a thread) and two consumer warpgroups
//   that take them (240 a thread), one Q buffer (128 x 256, 64 KB) and a
//   ring of 2 stages of 64-key K and V tiles (32 KB each): 192 KB. S =
//   Q K^T is wgmma m64n64k16 from shared memory, the softmax as above on
//   32 scores a thread, and P V one register-A wgmma m64n256k16 a k16 step.
//   With one Q buffer the next unit's Q load waits for the consumers'
//   last S of a unit (flash_variants.py's probe "Q buffer released at
//   once" measures that wait). Its loads bound it: a head's K and V are 1 MB at
//   d = 256 and sequence 1024, so units go out in groups of heads whose K
//   and V fit half the L2 (unit_head_tile), each group's heaviest q tile
//   first; over all heads at once the q tiles of a head came long apart
//   and reread its K and V from device memory.
// * mma (the other bf16 launches: d <= 32, d % 8 != 0 or unaligned bases,
//   up to D = 256): 4 warps a block, 16 q rows each; the Q tile is loaded
//   once into mma A fragments held in registers (at D = 256 into shared
//   memory, where each k16 step loads its fragment, as O's 128 registers
//   leave no room); K and V tiles of 64 rows are staged through shared
//   memory with 16-byte loads (scalar loads on unaligned bases or rows) and
//   shared by the 4 warps; mma.sync m16n8k16. Staging and math alternate
//   behind barriers. Its grid is (bh, 64-row q tiles), heaviest first.
// * simt (float32, d <= 256) and chunked (float32, d > 256): the tiled
//   SIMT kernel flash_f32_tiled, built at D = 16 .. 1024. A block of 256
//   threads owns (bh, a q tile of 64 rows, 32 at D = 512, 16 at D = 1024)
//   and holds the tile, scaled, in shared memory: it reads q from device
//   memory once. K and V stream through a double-buffered cp.async ring in
//   chunks of 16 KB (64 keys x 64 columns of K, or 4096 / D keys x D
//   columns of V). Each thread computes a 4 x 4 register block of S
//   (rows x keys; at D = 512 and 1024 the columns of each K chunk are
//   split over 2 or 4 groups of threads whose partial S are summed in
//   shared memory) and a block of O of up to 4 rows x 16 columns, every
//   product an FMA on operands read as float4 from shared memory, so no
//   score needs a shuffle. S goes through shared memory to the softmax,
//   which a few threads a row run (max and sum across them by shuffles, a
//   row at a time), and P back to the O blocks. S is computed once per
//   (q tile, key tile) for all of the output's columns. Its grid is (bh,
//   q tiles[, output chunks]), heaviest first over every head: it is not
//   bound by its loads, and the heads in groups of the D = 256 kernel's
//   order measured slower. Past D = 1024 the
//   block would not hold its q tile: there the D = 1024 kernel reloads the
//   q tile for each 1024-column step of S, and a third grid axis splits
//   the output into 1024-column chunks, each recomputing S.
// * chunked (bf16, d > 256): the mma kernel built at D = 256 with STEPS,
//   and a third grid axis over the output's 256-column chunks. A block
//   owns (bh, a 64-row q tile, a chunk c): it computes the full S = q k^T
//   over all d in 256-column steps, loaded in turn into shared memory, runs
//   the online softmax per row, and accumulates only its own chunk of P V.
//   S is recomputed once per chunk. Every chunk of a row computes the same
//   S in the same order, so the rows' max and sum agree across chunks.
//
// C entry point (ctypes): flash_attention(q, k, v, out, bh, sq, sk, d,
// causal, scale, q_off, k_off, dtype, route, sms, stream) with dtype 0 =
// float32, 1 = bf16, route 0 = simt, 1 = mma, 2 = wgmma, 3 = chunked and
// sms the card's SM count; returns a cudaError_t.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 64;          // q rows per block
constexpr int THREADS = 128;    // 4 warps
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// Last key index (exclusive) a block of q rows [row0, row0 + rows) can see.
__device__ __forceinline__ int key_end(int sq, int sk, int causal, int row0,
                                       int rows, int q_off, int k_off) {
  if (!causal) return sk;
  const int last_row = min(row0 + rows, sq) - 1;
  return min(sk, q_off + last_row - k_off + 1);   // <= 0: nothing visible
}

// Work unit u of bh heads x nqt q tiles, the heads taken in groups of
// `group`: a group's units run together, so the group's K and V stay in L2
// while its q tiles read them, and within a group the heaviest q tile
// comes first, head after head (group = bh: one group, heaviest first over
// every head). Sets the head and the q tile.
__device__ __forceinline__ void unit_head_tile(int u, int bh, int nqt,
                                               int group, int& head,
                                               int& qt) {
  const int g = u / (group * nqt), r = u - g * group * nqt;
  const int hg = min(group, bh - g * group);
  qt = nqt - 1 - r / hg;
  head = g * group + r % hg;
}

// Heads a group holds so that its K and V (sk x d each a head, `elem`
// bytes an element) take at most half of an L2 of `l2` bytes
inline int l2_group(int bh, int sk, int d, int elem, int l2) {
  const long long g = (l2 / 2) / (2ll * sk * d * elem);
  return (int)(g < 1 ? 1 : g > bh ? bh : g);
}

// 2^x on the MUFU, one instruction (results below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------------- bf16: mma

using bf16 = __nv_bfloat16;
constexpr int BK = 64;          // keys per shared-memory tile
constexpr int CW = 256;         // the widest single pass; a step or a chunk

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two values into one register, the first in the low half (the element of
// lower index in an mma fragment)
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Rows [r0, r0 + 64) and columns [c0, c0 + D) of a (nrows, d) row-major
// matrix into shared memory (leading dim D + 8), zero-filling rows past nrows
// and columns past d. `vec`: 16-byte loads (aligned base and d % 8 == 0; c0
// is 0 or a multiple of D).
template <int D>
__device__ __forceinline__ void stage_bf16(bf16* dst,
                                           const bf16* __restrict__ src,
                                           int r0, int nrows, int d, int c0,
                                           bool vec) {
  constexpr int LD = D + 8, VPR = D / 8;
  for (int i = threadIdx.x; i < 64 * VPR; i += THREADS) {
    const int r = i / VPR, c = c0 + (i % VPR) * 8, gr = r0 + r;
    bf16* dp = dst + r * LD + (c - c0);
    if (gr >= nrows || c >= d) {
      *reinterpret_cast<uint4*>(dp) = make_uint4(0u, 0u, 0u, 0u);
    } else if (vec) {
      *reinterpret_cast<uint4*>(dp) =
          *reinterpret_cast<const uint4*>(src + (size_t)gr * d + c);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dp[e] = c + e < d ? src[(size_t)gr * d + c + e] : __float2bfloat16(0.f);
    }
  }
}

// The mma kernel's layout at built size D: at D = 256 the warp's Q fragments
// (64 registers) would not fit beside O's 128, so Q stays in shared memory
// and each k16 step of S loads its fragment there.
template <int D>
struct Mma {
  static constexpr bool Q_SHARED = D > 128;
  static constexpr int LD = D + 8;
  static constexpr size_t SMEM = sizeof(bf16) * BK * LD * (Q_SHARED ? 3 : 2);
};

// STEPS (d > 256, the chunked route, built at D = 256): the grid's third
// axis picks the output's column chunk [c0, c0 + D), and S = Q K^T sums
// over all d in D-column steps, Q and K staged a step at a time. Without
// STEPS there is one step and the chunk is 0.
template <int D, bool STEPS>
__global__ void __launch_bounds__(THREADS)
flash_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, bf16* __restrict__ out, int sq,
           int sk, int d, int causal, float scale, int q_off, int k_off,
           bool vec) {
  using M = Mma<D>;
  static_assert(!STEPS || M::Q_SHARED, "steps stage Q in shared memory");
  constexpr int LD = M::LD;
  constexpr int KC = D / 16;    // k steps of the q k^T product
  constexpr int NT = D / 8;     // 8-column tiles of the output
  extern __shared__ __align__(16) uint8_t mma_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(mma_smem);
  bf16* Vs = Ks + BK * LD;
  bf16* Qs = Vs + BK * LD;      // Q_SHARED only

  const int bh = blockIdx.x;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest first
  const int c0 = STEPS ? blockIdx.z * D : 0;            // the output chunk
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;   // fragment row, pair within a row
  const int wr = warp * 16;               // the warp's first row in the tile
  const bf16* qb = q + (size_t)bh * sq * d;
  const bf16* kb = k + (size_t)bh * sk * d;
  const bf16* vb = v + (size_t)bh * sk * d;

  // the Q tile: into A fragments held for the block (through the K buffer),
  // or into its own buffer at D = 256 (a step at a time under STEPS)
  uint32_t qa[M::Q_SHARED ? 1 : KC][4];
  if constexpr (M::Q_SHARED) {
    if constexpr (!STEPS) stage_bf16<D>(Qs, qb, row0, sq, d, 0, vec);
  } else {
    stage_bf16<D>(Ks, qb, row0, sq, d, 0, vec);
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      const bf16* p = Ks + (wr + g) * LD + kc * 16 + 2 * t;
      qa[kc][0] = ld32(p);
      qa[kc][1] = ld32(p + 8 * LD);
      qa[kc][2] = ld32(p + 8);
      qa[kc][3] = ld32(p + 8 * LD + 8);
    }
  }
  __syncthreads();

  // this thread holds rows g and g + 8 of the warp's 16 (index h = 0, 1)
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  const int qpos = q_off + row0 + wr + g;

  const int kend = key_end(sq, sk, causal, row0, BQ, q_off, k_off);
  for (int k0 = 0; k0 < kend; k0 += BK) {
    // S = Q K^T for 16 rows x 64 keys: 8 tiles of 8 keys, each summed over
    // the k16 steps (and the D-column steps) in order
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    for (int d0 = 0; d0 < (STEPS ? d : 1); d0 += D) {
      if constexpr (STEPS) stage_bf16<D>(Qs, qb, row0, sq, d, d0, vec);
      stage_bf16<D>(Ks, kb, k0, sk, d, d0, vec);
      if constexpr (!STEPS) stage_bf16<D>(Vs, vb, k0, sk, d, 0, vec);
      __syncthreads();
      if constexpr (M::Q_SHARED) {
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          const bf16* p = Qs + (wr + g) * LD + kc * 16 + 2 * t;
          const uint32_t a[4] = {ld32(p), ld32(p + 8 * LD), ld32(p + 8),
                                 ld32(p + 8 * LD + 8)};
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const bf16* kp = Ks + (j * 8 + g) * LD + kc * 16 + 2 * t;
            mma_bf16(s[j], a, ld32(kp), ld32(kp + 8));
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int kc = 0; kc < KC; ++kc) {
            const bf16* p = Ks + (j * 8 + g) * LD + kc * 16 + 2 * t;
            mma_bf16(s[j], qa[kc], ld32(p), ld32(p + 8));
          }
        }
      }
      if constexpr (STEPS) __syncthreads();
    }
    if constexpr (STEPS) stage_bf16<D>(Vs, vb, k0, sk, d, c0, vec);

    // scale, mask, online softmax; s becomes p
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m[h];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + j * 8 + 2 * t + e;
          const bool keep = col < sk &&
                            (!causal || k_off + col <= qpos + 8 * h);
          const float x = keep ? s[j][2 * h + e] * scale : NEG;
          s[j][2 * h + e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float corr = expf(m[h] - mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = s[j][2 * h + e];
          const float p = x > 0.5f * NEG ? expf(x - mx) : 0.f;
          s[j][2 * h + e] = p;
          sum += p;
        }
      }
      sum += __shfl_xor_sync(FULL, sum, 1);
      sum += __shfl_xor_sync(FULL, sum, 2);
      l[h] = l[h] * corr + sum;
      m[h] = mx;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][2 * h] *= corr;
        o[n][2 * h + 1] *= corr;
      }
    }
    if constexpr (STEPS) __syncthreads();   // V staged

    // O[:, chunk] += P V[:, chunk]: the S accumulators are the A fragments
    // of P (16 keys each)
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      const uint32_t pa[4] = {
          pack_f32(s[2 * kc][0], s[2 * kc][1]),
          pack_f32(s[2 * kc][2], s[2 * kc][3]),
          pack_f32(s[2 * kc + 1][0], s[2 * kc + 1][1]),
          pack_f32(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const bf16* p = Vs + (kc * 16 + 2 * t) * LD + n * 8 + g;
        mma_bf16(o[n], pa, pack_bf16(p[0], p[LD]),
                 pack_bf16(p[8 * LD], p[9 * LD]));
      }
    }
    __syncthreads();
  }

  // only the chunk's real columns are written: pairs where d is even, else
  // one element at a time
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + wr + g + 8 * h;
    if (r >= sq) continue;
    const float den = fmaxf(l[h], 1e-30f);
    bf16* dst = out + ((size_t)bh * sq + r) * d;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = c0 + n * 8 + 2 * t;
      const float y0 = o[n][2 * h] / den, y1 = o[n][2 * h + 1] / den;
      if (d % 2 == 0) {
        if (col < d)
          *reinterpret_cast<__nv_bfloat162*>(dst + col) =
              __floats2bfloat162_rn(y0, y1);
      } else {
        if (col < d) dst[col] = __float2bfloat16(y0);
        if (col + 1 < d) dst[col + 1] = __float2bfloat16(y1);
      }
    }
  }
}

// ---------------------------------------------------------------- float32

constexpr int F_THREADS = 256;
constexpr int F_BK = 64;                    // keys a tile
constexpr float LOG2E = 1.4426950408889634f;

// The tiled kernel's layout at built size D (d <= D; past 1024, D = 1024
// in steps): BQ q rows a block, so that the q tile is 64 KB at D >= 256 and
// O is 64 registers a thread; KG groups of threads that split the columns
// of each K chunk, so that every S block stays 4 x 4; a ring stage holds
// 64 keys x DC columns of K, or KC keys x D columns of V (16 KB from
// D = 64 on); a thread's block of O is OR rows x OC columns, CT threads
// side by side along a row.
template <int D>
struct Tiled {
  static constexpr int BQ = D <= 256 ? 64 : 16384 / D;
  static constexpr int KG = 64 / BQ;
  static constexpr int DC = D < 64 ? D : 64;
  static constexpr int KC = 64 * DC / D;
  static constexpr int NKC = D / DC;           // K chunks a step
  static constexpr int NVC = F_BK / KC;        // V chunks a key tile
  static constexpr int OC = D <= 64 ? 4 : (D <= 256 ? D / 16 : 16);
  static constexpr int CT = D / OC;
  static constexpr int RT = F_THREADS / CT;
  static constexpr int OR = BQ / RT;
  static constexpr int TR = F_THREADS / BQ;    // softmax threads a row
  static constexpr int CHUNK = F_BK * DC;      // floats a ring stage
  // float4 swizzles of the q tile's and a K chunk's rows
  static constexpr int QM = (D / 4 < 8 ? D / 4 : 8) - 1;
  static constexpr int KM = (DC / 4 < 8 ? DC / 4 : 8) - 1;
  // the q tile, two ring stages, KG partial S tiles (P in the first), and
  // each row's correction and sum
  static constexpr size_t SMEM =
      sizeof(float) * (BQ * D + 2 * CHUNK + KG * BQ * F_BK + 2 * BQ);
  static_assert(KG * 4 * BQ == F_THREADS && RT * OR == BQ && OC % 4 == 0,
                "the thread blocks must tile S and O");
};

// float4 f of row r, its low bits exchanged with the row's: rows that
// neighbouring threads read at the same column land in different banks
__device__ __forceinline__ int swz(int r, int f, int mask) {
  return f ^ (r & mask);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Four floats of row gk, columns gc .. gc + 3, of a (rows, d) matrix into
// shared memory; what lies past row `rows` or column d - 1 is zero-filled.
// `vec`: one 16-byte copy (aligned base and d % 4 == 0).
__device__ __forceinline__ void copy4(float* dst, const float* base, int gk,
                                      int gc, int rows, int d, bool vec) {
  const float* src = base + (size_t)gk * d + gc;
  if (vec) {
    const bool ok = gk < rows && gc < d;
    cp_async16(dst, ok ? src : base, ok);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = gk < rows && gc + e < d;
      cp_async4(dst + e, ok ? src + e : base, ok);
    }
  }
}

// One block a (bh, q tile[, output chunk]). The ring runs through a key
// tile's chunks in order: the K chunks of every step (S = Q K^T), then the
// V chunks (O += P V); one barrier a chunk, the next chunk's copy in flight
// under the current one's math. After the last K chunk the partial S go to
// shared memory and the softmax threads turn them into P.
template <int D>
__global__ void __launch_bounds__(F_THREADS, 2)
flash_f32_tiled(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ out, int sq,
                int sk, int d, int causal, float scale, int q_off, int k_off,
                bool vec, bool vec_out) {
  using T = Tiled<D>;
  constexpr int BQ = T::BQ, DC = T::DC, KC = T::KC, NKC = T::NKC;
  constexpr int OR = T::OR, OC = T::OC, CT = T::CT, RT = T::RT, TR = T::TR;
  constexpr int GC4 = DC / 4 / T::KG;     // float4 columns of a group
  constexpr int NF = F_BK / 4 / TR;       // float4 keys of a softmax thread
  extern __shared__ __align__(16) float f_smem[];
  float* Qs = f_smem;                         // BQ x D, scaled
  float* ring = Qs + BQ * D;                  // 2 stages
  float* Sp = ring + 2 * T::CHUNK;            // KG x BQ x F_BK
  float* corr_s = Sp + T::KG * BQ * F_BK;     // BQ
  float* l_s = corr_s + BQ;                   // BQ

  const int tid = threadIdx.x, bh = blockIdx.x;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest first
  const int steps = (d + D - 1) / D, c_out = blockIdx.z * D;
  const float* qb = q + (size_t)bh * sq * d;
  const float* kb = k + (size_t)bh * sk * d;
  const float* vb = v + (size_t)bh * sk * d;

  // the q tile's columns [c0, c0 + D), scaled in float32
  auto load_q = [&](int c0) {
    for (int e = tid; e < BQ * D / 4; e += F_THREADS) {
      const int r = e / (D / 4), f = e % (D / 4), gr = row0 + r;
      const int gc = c0 + 4 * f;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gr < sq) {
        const float* src = qb + (size_t)gr * d + gc;
        if (vec) {
          if (gc < d) x = *reinterpret_cast<const float4*>(src);
        } else {
          x.x = gc < d ? src[0] : 0.f;
          x.y = gc + 1 < d ? src[1] : 0.f;
          x.z = gc + 2 < d ? src[2] : 0.f;
          x.w = gc + 3 < d ? src[3] : 0.f;
        }
      }
      x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
      *reinterpret_cast<float4*>(Qs + r * D + 4 * swz(r, f, T::QM)) = x;
    }
  };

  const int kend = key_end(sq, sk, causal, row0, BQ, q_off, k_off);
  const int ntiles = kend > 0 ? (kend + F_BK - 1) / F_BK : 0;
  const int nkc = steps * NKC, nch = nkc + T::NVC;   // chunks a key tile
  const int total = ntiles * nch;

  // chunk n of the run into its stage
  auto load = [&](int n) {
    float* st = ring + (n & 1) * T::CHUNK;
    const int k0 = (n / nch) * F_BK, c = n % nch;
    if (c < nkc) {            // K: 64 keys x columns [c DC, c DC + DC)
      for (int e = tid; e < F_BK * DC / 4; e += F_THREADS) {
        const int r = e / (DC / 4), f = e % (DC / 4);
        copy4(st + r * DC + 4 * swz(r, f, T::KM), kb, k0 + r,
              c * DC + 4 * f, sk, d, vec);
      }
    } else {                  // V: KC keys x the output chunk's columns
      const int r0 = k0 + (c - nkc) * KC;
      for (int e = tid; e < KC * D / 4; e += F_THREADS) {
        const int r = e / (D / 4), f = e % (D / 4);
        copy4(st + r * D + 4 * f, vb, r0 + r, c_out + 4 * f, sk, d, vec);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // S: group g, thread (sy, sx) owns rows sy + BQ/4 i and keys sx + 16 j;
  // a warp spans 4 values of sy and 8 of sx, so each float4 load of q
  // (4 rows) and of K (8 keys) is one shared-memory wavefront
  const int g = tid / (4 * BQ), wl = tid % (4 * BQ) / 32, lane = tid % 32;
  const int sy = 4 * (wl / 2) + lane / 8, sx = 8 * (wl % 2) + lane % 8;
  // softmax: thread `part` of row srow owns float4 keys part NF + e
  const int srow = tid / TR, part = tid % TR;
  // O: thread (ry, cx) owns rows ry + RT i and float4 columns cx + CT j
  const int ry = tid / CT, cx = tid % CT;
  float o[OR][OC];
#pragma unroll
  for (int i = 0; i < OR; ++i) {
#pragma unroll
    for (int j = 0; j < OC; ++j) o[i][j] = 0.f;
  }
  float s[4][4];
  float m = NEG, l = 0.f;      // row srow's running max and sum

  if (tid < BQ) l_s[tid] = 0.f;   // a row that sees no key sums to 0
  if (steps == 1) load_q(0);
  if (total > 0) load(0);
  for (int n = 0; n < total; ++n) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();    // chunk n landed; every thread is done with n - 1
    if (n + 1 < total) load(n + 1);
    const float* st = ring + (n & 1) * T::CHUNK;
    const int c = n % nch, k0 = (n / nch) * F_BK;
    if (c < nkc) {
      if (steps > 1 && c % NKC == 0) {   // the q tile's next D columns
        load_q((c / NKC) * D);
        __syncthreads();
      }
      if (c == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
        }
      }
      // S += Q[:, chunk] K[keys, chunk]^T over the group's columns
      const int qf0 = (c % NKC) * (DC / 4);
#pragma unroll
      for (int ff = 0; ff < GC4; ++ff) {
        const int f = g * GC4 + ff;
        float4 qv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = sy + BQ / 4 * i;
          qv[i] = *reinterpret_cast<const float4*>(
              Qs + r * D + 4 * swz(r, qf0 + f, T::QM));
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = sx + 16 * j;
          const float4 kv = *reinterpret_cast<const float4*>(
              st + key * DC + 4 * swz(key, f, T::KM));
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
            s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
            s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
            s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
          }
        }
      }
      if (c == nkc - 1) {
        // the partial S to shared memory, then the softmax of row srow
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = sy + BQ / 4 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int key = sx + 16 * j;
            Sp[(g * BQ + r) * F_BK + 4 * swz(r, key / 4, 7) + key % 4] =
                s[i][j];
          }
        }
        __syncthreads();
        const int qpos = q_off + row0 + srow;
        float x[NF][4];
        float mx = m;
#pragma unroll
        for (int e = 0; e < NF; ++e) {
          const int at = 4 * swz(srow, part * NF + e, 7);
          float4 a = *reinterpret_cast<const float4*>(Sp + srow * F_BK + at);
#pragma unroll
          for (int gg = 1; gg < T::KG; ++gg) {
            const float4 b = *reinterpret_cast<const float4*>(
                Sp + (gg * BQ + srow) * F_BK + at);
            a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
          }
          const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int col = k0 + 4 * (part * NF + e) + u;
            const bool keep = col < sk && (!causal || k_off + col <= qpos);
            x[e][u] = keep ? av[u] : NEG;
            mx = fmaxf(mx, x[e][u]);
          }
        }
#pragma unroll
        for (int w = 1; w < TR; w *= 2)
          mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, w));
        const float corr = ex2((m - mx) * LOG2E);
        const float ref = mx * LOG2E;
        float sum = 0.f;
#pragma unroll
        for (int e = 0; e < NF; ++e) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float p =
                x[e][u] > 0.5f * NEG ? ex2(fmaf(x[e][u], LOG2E, -ref)) : 0.f;
            x[e][u] = p;
            sum += p;
          }
          *reinterpret_cast<float4*>(
              Sp + srow * F_BK + 4 * swz(srow, part * NF + e, 7)) =
              make_float4(x[e][0], x[e][1], x[e][2], x[e][3]);
        }
#pragma unroll
        for (int w = 1; w < TR; w *= 2)
          sum += __shfl_xor_sync(FULL, sum, w);
        l = l * corr + sum;
        m = mx;
        if (part == 0) {
          corr_s[srow] = corr;
          l_s[srow] = l;
        }
      }
    } else {
      // O[:, chunk] = O corr + P[:, the chunk's keys] V[chunk]
      const int vc = c - nkc;
      if (vc == 0) {
#pragma unroll
        for (int i = 0; i < OR; ++i) {
          const float cr = corr_s[ry + RT * i];
#pragma unroll
          for (int j = 0; j < OC; ++j) o[i][j] *= cr;
        }
      }
#pragma unroll
      for (int kk = 0; kk < KC / 4; ++kk) {
        float4 pv[OR];
#pragma unroll
        for (int i = 0; i < OR; ++i) {
          const int r = ry + RT * i;
          pv[i] = *reinterpret_cast<const float4*>(
              Sp + r * F_BK + 4 * swz(r, vc * (KC / 4) + kk, 7));
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float* vr = st + (4 * kk + u) * D;
#pragma unroll
          for (int j = 0; j < OC / 4; ++j) {
            const float4 vv =
                *reinterpret_cast<const float4*>(vr + 4 * (cx + CT * j));
#pragma unroll
            for (int i = 0; i < OR; ++i) {
              const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y
                            : u == 2 ? pv[i].z : pv[i].w;
              o[i][4 * j] = fmaf(p, vv.x, o[i][4 * j]);
              o[i][4 * j + 1] = fmaf(p, vv.y, o[i][4 * j + 1]);
              o[i][4 * j + 2] = fmaf(p, vv.z, o[i][4 * j + 2]);
              o[i][4 * j + 3] = fmaf(p, vv.w, o[i][4 * j + 3]);
            }
          }
        }
      }
    }
  }
  __syncthreads();      // l_s holds every row's sum

  // the output chunk's real columns: float4 where d % 4 == 0 and the base
  // is aligned, else one element at a time
#pragma unroll
  for (int i = 0; i < OR; ++i) {
    const int r = ry + RT * i, gr = row0 + r;
    if (gr >= sq) continue;
    const float den = fmaxf(l_s[r], 1e-30f);
    float* dst = out + ((size_t)bh * sq + gr) * d;
#pragma unroll
    for (int j = 0; j < OC / 4; ++j) {
      const int col = c_out + 4 * (cx + CT * j);
      const float y[4] = {o[i][4 * j] / den, o[i][4 * j + 1] / den,
                          o[i][4 * j + 2] / den, o[i][4 * j + 3] / den};
      if (vec_out) {
        if (col < d)
          *reinterpret_cast<float4*>(dst + col) =
              make_float4(y[0], y[1], y[2], y[3]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (col + u < d) dst[col + u] = y[u];
      }
    }
  }
}

template <int D>
int launch_tiled(const float* q, const float* k, const float* v, float* out,
                 int bh, int sq, int sk, int d, int causal, float scale,
                 int q_off, int k_off, bool vec, bool vec_out,
                 cudaStream_t st) {
  using T = Tiled<D>;
  const dim3 grid(bh, (sq + T::BQ - 1) / T::BQ, (d + D - 1) / D);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_f32_tiled<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)T::SMEM);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  flash_f32_tiled<D><<<grid, F_THREADS, T::SMEM, st>>>(
      q, k, v, out, sq, sk, d, causal, scale, q_off, k_off, vec, vec_out);
  return (int)cudaGetLastError();
}

// float32 at any d >= 1: the smallest built size D >= d, and past 1024
// the D = 1024 kernel in steps
int launch_f32(const void* q_, const void* k_, const void* v_, void* out_,
               int bh, int sq, int sk, int d, int causal, float scale,
               int q_off, int k_off, bool vec, bool vec_out,
               cudaStream_t st) {
  const float* q = static_cast<const float*>(q_);
  const float* k = static_cast<const float*>(k_);
  const float* v = static_cast<const float*>(v_);
  float* out = static_cast<float*>(out_);
#define FLASH_F32(D)                                                       \
  return launch_tiled<D>(q, k, v, out, bh, sq, sk, d, causal, scale, q_off, \
                         k_off, vec, vec_out, st)
  if (d <= 16) FLASH_F32(16);
  if (d <= 32) FLASH_F32(32);
  if (d <= 64) FLASH_F32(64);
  if (d <= 128) FLASH_F32(128);
  if (d <= 256) FLASH_F32(256);
  if (d <= 512) FLASH_F32(512);
  FLASH_F32(1024);
#undef FLASH_F32
}

// ----------------------------------------------------------- bf16: wgmma

constexpr int W_BQ = 128;           // q rows a block, 64 a consumer warpgroup
constexpr int W_BK = 128;           // keys a K or V tile
constexpr int W_THREADS = 288;      // 2 consumer warpgroups + 1 producer warp
constexpr int BOX_BYTES = 128 * 128;   // 128 rows x 64 bf16 columns

template <int D>
struct Wgmma {
  static constexpr int BOXES = D / 64;                 // boxes a row block
  static constexpr int TILE = BOXES * BOX_BYTES;       // a Q, K or V tile
  static constexpr int STAGES = D == 64 ? 3 : 2;       // K/V ring
  static constexpr int BARRIERS = 4 + 3 * STAGES;
  // two Q tiles, the ring, 1024 bytes of slack to align the tiles for the
  // swizzle, the barriers
  static constexpr size_t SMEM =
      (size_t)TILE * (2 + 2 * STAGES) + 1024 + 8 * BARRIERS;
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// D (64 x 64, float32) += A (64 x 16, bf16 in registers: the mma.sync A
// fragment layout, one 16-row slice a warp) * B (16 x 64, MN-major, shared)
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, float32) += A (64 x 16, bf16 in registers: the mma.sync A
// fragment layout, one 16-row slice a warp) * B (16 x 128, MN-major, shared)
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x D) += P (64 x 16 keys) V (16 keys x D)
template <int D>
__device__ __forceinline__ void pv_step(float (&o)[D / 2],
                                        const uint32_t (&p)[4], uint64_t dv);
template <>
__device__ __forceinline__ void pv_step<64>(float (&o)[32],
                                            const uint32_t (&p)[4],
                                            uint64_t dv) {
  wgmma_rs_m64n64k16(o, p, dv);
}
template <>
__device__ __forceinline__ void pv_step<128>(float (&o)[64],
                                             const uint32_t (&p)[4],
                                             uint64_t dv) {
  wgmma_rs_m64n128k16(o, p, dv);
}

// the tensor map's descriptor into the TMA unit's cache, ahead of its use
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// S = Q K^T for 64 rows x 128 keys, issued: K-major A and B, 8-row groups
// 1024 B apart, a k16 step 32 B along a 128-byte row, the next 64 columns
// of d in the next box
template <int D>
__device__ __forceinline__ void issue_s(float (&s)[64], uint32_t q_addr,
                                        uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
    wgmma_m64n128k16<0>(s, gmma_desc(q_addr + off, 16, 1024),
                        gmma_desc(k_addr + off, 16, 1024), kk != 0);
  }
}

// O += P V, issued: V is MN-major, a k16 step 16 rows of 128 B
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[8][4],
                                         uint32_t v_addr) {
#pragma unroll
  for (int kc = 0; kc < 8; ++kc)
    pv_step<D>(o, pa[kc], gmma_desc(v_addr + kc * 2048, BOX_BYTES, 1024));
}

// One key tile's online softmax on the S accumulator of this thread's two
// rows (h = 0, 1). Scores stay unscaled: a masked one (only where `whole`
// is false) is NEG, m and the max are taken on them, and the scale enters
// with log2(e) in the exponent: p = 2^(s c - m c), c = scale log2(e), one
// FMA and one MUFU op a score. The guard is the row's: a row whose max is
// still NEG (masked everywhere so far) takes 0 as its reference, so its
// masked scores weigh 2^(NEG c) = 0, as everywhere else they weigh
// 2^((NEG - m) c) = 0. The max and the sum run in four chains a row. Leaves
// p in s, updates m and l, and returns each row's correction of O in corr.
// N: the accumulator's registers (64 on a 128-key tile, 32 on 64 keys).
template <int N>
__device__ __forceinline__ void softmax_tile(
    float (&s)[N], float (&m)[2], float (&l)[2], float (&corr)[2],
    bool whole, int k0, int sk, int causal, int k_off, int qpos, int t,
    float scale_log2) {
  if (!whole) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int col = k0 + 8 * (i / 4) + 2 * t + i % 2;
      const int h = (i / 2) % 2;
      if (col >= sk || (causal && k_off + col > qpos + 8 * h)) s[i] = NEG;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx4[4] = {m[h], m[h], m[h], m[h]};
#pragma unroll
    for (int jj = 0; jj < N / 4; ++jj)
      mx4[jj % 4] = fmaxf(mx4[jj % 4],
                          fmaxf(s[4 * jj + 2 * h], s[4 * jj + 2 * h + 1]));
    float mx = fmaxf(fmaxf(mx4[0], mx4[1]), fmaxf(mx4[2], mx4[3]));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
    corr[h] = ex2((m[h] - mx) * scale_log2);
    const float ref = mx > 0.5f * NEG ? mx * scale_log2 : 0.f;
    float sum4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int jj = 0; jj < N / 4; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = ex2(fmaf(s[4 * jj + 2 * h + e], scale_log2, -ref));
        s[4 * jj + 2 * h + e] = p;
        sum4[jj % 4] += p;
      }
    }
    float sum = (sum4[0] + sum4[1]) + (sum4[2] + sum4[3]);
    sum += __shfl_xor_sync(FULL, sum, 1);
    sum += __shfl_xor_sync(FULL, sum, 2);
    l[h] = l[h] * corr[h] + sum;
    m[h] = mx;
  }
}

// O's two rows times their corrections
template <int D>
__device__ __forceinline__ void rescale_o(float (&o)[D / 2],
                                          const float (&corr)[2]) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      o[4 * n + 2 * h] *= corr[h];
      o[4 * n + 2 * h + 1] *= corr[h];
    }
  }
}

// P to bf16 A fragments: k16 step kc holds keys 16 kc .. 16 kc + 15
template <int NK>
__device__ __forceinline__ void pack_p(const float (&s)[8 * NK],
                                       uint32_t (&pa)[NK][4]) {
#pragma unroll
  for (int kc = 0; kc < NK; ++kc) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kc][r] = pack_f32(s[8 * kc + 2 * r], s[8 * kc + 2 * r + 1]);
  }
}

// The key tiles that the q tile at row0 visits: up to the last key its last
// row sees
__device__ __forceinline__ int key_tiles(int sq, int sk, int causal,
                                         int row0, int q_off, int k_off) {
  const int kend = key_end(sq, sk, causal, row0, W_BQ, q_off, k_off);
  return kend > 0 ? (kend + W_BK - 1) / W_BK : 0;
}

// The k-th work unit of block b of G, or -1 past the end: units go out in
// rounds of G, heaviest first, and every other round runs in reverse, so a
// block that takes a heavy unit in one round takes a light one in the next.
// Unit u is q tile nqt - 1 - u / bh of head u % bh.
__device__ __forceinline__ int unit_of(int k, int b, int G, int units) {
  const int u = k * G + (k % 2 == 0 ? b : G - 1 - b);
  return u < units ? u : -1;
}

// Thread layout of a consumer warpgroup: element i of an m64nN accumulator
// of thread (warp w, lane l), g = l / 4, t = l % 4, lies at row 16 w + g +
// 8 h with h = (i / 2) % 2, column 8 (i / 4) + 2 t + i % 2. So a thread
// holds two rows of S (h = 0, 1), 32 scores of each, and the same two rows
// of O.
template <int D>
__global__ void __launch_bounds__(W_THREADS, 1)
flash_bf16_wgmma(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 bf16* __restrict__ out, int bh_count, int sq, int sk,
                 int d, int causal, float scale_log2, int q_off, int k_off) {
  using W = Wgmma<D>;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzled tiles want 1024-byte aligned buffers
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* q_tiles = smem;                  // two, by unit parity
  uint8_t* kv_tiles = smem + 2 * W::TILE;   // stage s: K, then V
  uint64_t* q_full = reinterpret_cast<uint64_t*>(
      smem + (size_t)W::TILE * (2 + 2 * W::STAGES));
  uint64_t* q_empty = q_full + 2;
  uint64_t* k_full = q_empty + 2;
  uint64_t* v_full = k_full + W::STAGES;
  uint64_t* empty = v_full + W::STAGES;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], 8);        // one arrival per consumer warp
    }
    for (int i = 0; i < W::STAGES; ++i) {
      mbar_init(&k_full[i], 1);
      mbar_init(&v_full[i], 1);
      mbar_init(&empty[i], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int nqt = (sq + W_BQ - 1) / W_BQ, units = bh_count * nqt;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the ring's stage and phase, and the count of units with keys to see,
  // run on across this block's units, alike in producer and consumers
  int stage = 0, qi = 0;
  uint32_t phase = 0;

  if (warp == 8) {
    // ---- producer: one lane loads each unit's Q tile into the free one of
    // two buffers and streams its K/V tiles through the ring
    if (lane != 0) return;
    prefetch_map(&tm_q);
    prefetch_map(&tm_k);
    prefetch_map(&tm_v);
    for (int k = 0; k * (int)gridDim.x < units; ++k) {
      const int u = unit_of(k, blockIdx.x, gridDim.x, units);
      if (u < 0) continue;
      const int bh = u % bh_count, row0 = (nqt - 1 - u / bh_count) * W_BQ;
      const int ntiles = key_tiles(sq, sk, causal, row0, q_off, k_off);
      if (ntiles == 0) continue;
      const int qb = qi & 1;
      mbar_wait(&q_empty[qb], ((qi >> 1) & 1) ^ 1);
      mbar_expect_tx(&q_full[qb], W::TILE);
      for (int b = 0; b < W::BOXES; ++b)
        tma_load_3d(q_tiles + qb * W::TILE + b * BOX_BYTES, &tm_q,
                    &q_full[qb], 64 * b, row0, bh);
      ++qi;
      for (int j = 0; j < ntiles; ++j) {
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* kt = kv_tiles + (size_t)stage * 2 * W::TILE;
        mbar_expect_tx(&k_full[stage], W::TILE);
        for (int b = 0; b < W::BOXES; ++b)
          tma_load_3d(kt + b * BOX_BYTES, &tm_k, &k_full[stage], 64 * b,
                      j * W_BK, bh);
        mbar_expect_tx(&v_full[stage], W::TILE);
        for (int b = 0; b < W::BOXES; ++b)
          tma_load_3d(kt + W::TILE + b * BOX_BYTES, &tm_v, &v_full[stage],
                      64 * b, j * W_BK, bh);
        if (++stage == W::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup `half` owns rows [wg_row0, wg_row0 + 64) of
  // each unit's q tile
  const int half = warp / 4, w = warp % 4;
  const int g = lane / 4, t = lane % 4;
  for (int k = 0; k * (int)gridDim.x < units; ++k) {
    const int u = unit_of(k, blockIdx.x, gridDim.x, units);
    if (u < 0) continue;
    const int bh = u % bh_count, row0 = (nqt - 1 - u / bh_count) * W_BQ;
    const int ntiles = key_tiles(sq, sk, causal, row0, q_off, k_off);
    const int wg_row0 = row0 + 64 * half;
    const int qpos = q_off + wg_row0 + 16 * w + g;   // + 8 h for row h
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
    if (ntiles > 0) {
      const int qb = qi & 1;
      mbar_wait(&q_full[qb], (qi >> 1) & 1);
      const uint32_t q_addr =
          smem_u32(q_tiles + qb * W::TILE + half * 64 * 128);
      uint32_t pa[8][4];
      for (int j = 0; j < ntiles; ++j) {
        const int k0 = j * W_BK;
        const uint32_t k_addr =
            smem_u32(kv_tiles + (size_t)stage * 2 * W::TILE);
        float s[64];
        mbar_wait(&k_full[stage], phase);
        wgmma_fence();
        issue_s<D>(s, q_addr, k_addr);
        wgmma_commit();
        wgmma_wait_all();
        // the unit's last S read its Q tile: the buffer is free
        if (j == ntiles - 1 && lane == 0) mbar_arrive(&q_empty[qb]);
        // mask only a tile that crosses the diagonal of this warpgroup's
        // rows or the ragged end of k
        const bool whole =
            k0 + W_BK <= sk &&
            (!causal || k_off + k0 + W_BK - 1 <= q_off + wg_row0);
        float corr[2];
        softmax_tile(s, m, l, corr, whole, k0, sk, causal, k_off, qpos, t,
                     scale_log2);
        rescale_o<D>(o, corr);
        pack_p(s, pa);
        mbar_wait(&v_full[stage], phase);
        wgmma_fence();
        issue_pv<D>(o, pa, k_addr + W::TILE);
        wgmma_commit();
        wgmma_wait_all();
        if (lane == 0) mbar_arrive(&empty[stage]);
        if (++stage == W::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      ++qi;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wg_row0 + 16 * w + g + 8 * h;
      if (r >= sq) continue;
      const float den = fmaxf(l[h], 1e-30f);
      bf16* dst = out + ((size_t)bh * sq + r) * d + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        if (n * 8 >= d) break;   // d % 8 == 0: only real columns
        *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
            __floats2bfloat162_rn(o[4 * n + 2 * h] / den,
                                  o[4 * n + 2 * h + 1] / den);
      }
    }
  }
}

// ------------------------------------------------ bf16: wgmma at d <= 256

constexpr int X_BQ = 128;           // q rows a unit, 64 a consumer warpgroup
constexpr int X_BK = 64;            // keys a K or V tile
constexpr int X_THREADS = 384;      // 2 consumer warpgroups + 1 producer
constexpr int X_STAGES = 2;         // K/V ring
constexpr int X_QBOX = 128 * 128;   // a Q box: 128 rows x 64 columns
constexpr int X_KBOX = 64 * 128;    // a K or V box: 64 rows x 64 columns
constexpr int X_QTILE = 4 * X_QBOX;
constexpr int X_KTILE = 4 * X_KBOX;
constexpr int X_BARRIERS = 2 + 3 * X_STAGES;
// the Q tile, the ring (K then V a stage), 1024 bytes of slack to align
// the tiles for the swizzle, the barriers
constexpr size_t X_SMEM = (size_t)X_QTILE + 2 * X_STAGES * X_KTILE + 1024 +
                          8 * X_BARRIERS;
// registers a thread at launch: 65536 / 384 rounded down to a multiple of
// 8. setmaxnreg moves them: 128 x (168 - 24) from the producer make
// 256 x (240 - 168) for the consumers
constexpr int X_REGS = 168;

// D (64 x 64, float32) [+]= A (64 x 16, K-major) * B (16 x 64, K-major),
// both from shared memory; D is overwritten where `accumulate` is 0
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32],
                                                   uint64_t da, uint64_t db,
                                                   uint32_t accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 256, float32) += A (64 x 16, bf16 in registers: the mma.sync A
// fragment layout, one 16-row slice a warp) * B (16 x 256, MN-major, shared)
__device__ __forceinline__ void wgmma_rs_m64n256k16(float (&d)[128],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, "
      "%109, %110, %111, %112, %113, %114, %115, %116, %117, %118, "
      "%119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S = Q K^T for 64 rows x 64 keys, issued: K-major A and B, 8-row groups
// 1024 B apart, a k16 step 32 B along a 128-byte row, the next 64 columns
// of d in the next box (16 KB on for Q's 128 rows, 8 KB for K's 64)
__device__ __forceinline__ void issue_s256(float (&s)[32], uint32_t q_addr,
                                           uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    wgmma_ss_m64n64k16(s, gmma_desc(q_addr + (kk / 4) * X_QBOX + col, 16,
                                    1024),
                       gmma_desc(k_addr + (kk / 4) * X_KBOX + col, 16, 1024),
                       kk != 0);
  }
}

// O += P V, issued: V is MN-major, a k16 step 16 rows of 128 B, the next 64
// columns in the next 8 KB box
__device__ __forceinline__ void issue_pv256(float (&o)[128],
                                            const uint32_t (&pa)[4][4],
                                            uint32_t v_addr) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
    wgmma_rs_m64n256k16(o, pa[kc], gmma_desc(v_addr + kc * 2048, X_KBOX,
                                             1024));
}

// The 64-key tiles that the q tile at row0 visits
__device__ __forceinline__ int key_tiles64(int sq, int sk, int causal,
                                           int row0, int q_off, int k_off) {
  const int kend = key_end(sq, sk, causal, row0, X_BQ, q_off, k_off);
  return kend > 0 ? (kend + X_BK - 1) / X_BK : 0;
}

// The thread layout of flash_bf16_wgmma, on 64-key tiles: a thread holds
// two rows of S (h = 0, 1), 16 scores of each, and the same two rows of O
// (128 columns of each).
__global__ void __launch_bounds__(X_THREADS, 1)
flash_bf16_wgmma256(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    bf16* __restrict__ out, int bh_count, int sq, int sk,
                    int d, int causal, float scale_log2, int q_off,
                    int k_off, int group) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* q_tile = smem;
  uint8_t* kv_tiles = smem + X_QTILE;       // stage s: K, then V
  uint64_t* q_full = reinterpret_cast<uint64_t*>(
      smem + X_QTILE + 2 * X_STAGES * X_KTILE);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_empty + 1;
  uint64_t* v_full = k_full + X_STAGES;
  uint64_t* empty = v_full + X_STAGES;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);              // one arrival per consumer warp
    for (int i = 0; i < X_STAGES; ++i) {
      mbar_init(&k_full[i], 1);
      mbar_init(&v_full[i], 1);
      mbar_init(&empty[i], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int nqt = (sq + X_BQ - 1) / X_BQ, units = bh_count * nqt;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the ring's stage and phase, and the count of Q loads, run on across
  // this block's units, alike in producer and consumers
  int stage = 0, qi = 0;
  uint32_t phase = 0;

  if (warp >= 8) {
    // ---- producer warpgroup: gives its registers to the consumers; one
    // lane loads each unit's Q tile once the last one is released, and
    // streams its K/V tiles through the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp != 8 || lane != 0) return;
    prefetch_map(&tm_q);
    prefetch_map(&tm_k);
    prefetch_map(&tm_v);
    for (int k = 0; k * (int)gridDim.x < units; ++k) {
      const int u = unit_of(k, blockIdx.x, gridDim.x, units);
      if (u < 0) continue;
      int bh, qt;
      unit_head_tile(u, bh_count, nqt, group, bh, qt);
      const int row0 = qt * X_BQ;
      const int ntiles = key_tiles64(sq, sk, causal, row0, q_off, k_off);
      if (ntiles == 0) continue;
      mbar_wait(q_empty, (qi & 1) ^ 1);
      mbar_expect_tx(q_full, X_QTILE);
      for (int b = 0; b < 4; ++b)
        tma_load_3d(q_tile + b * X_QBOX, &tm_q, q_full, 64 * b, row0, bh);
      ++qi;
      for (int j = 0; j < ntiles; ++j) {
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* kt = kv_tiles + (size_t)stage * 2 * X_KTILE;
        mbar_expect_tx(&k_full[stage], X_KTILE);
        for (int b = 0; b < 4; ++b)
          tma_load_3d(kt + b * X_KBOX, &tm_k, &k_full[stage], 64 * b,
                      j * X_BK, bh);
        mbar_expect_tx(&v_full[stage], X_KTILE);
        for (int b = 0; b < 4; ++b)
          tma_load_3d(kt + X_KTILE + b * X_KBOX, &tm_v, &v_full[stage],
                      64 * b, j * X_BK, bh);
        if (++stage == X_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup `half` owns rows [wg_row0, wg_row0 + 64) of
  // each unit's q tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int half = warp / 4, w = warp % 4;
  const int g = lane / 4, t = lane % 4;
  const uint32_t q_addr = smem_u32(q_tile + half * 64 * 128);
  for (int k = 0; k * (int)gridDim.x < units; ++k) {
    const int u = unit_of(k, blockIdx.x, gridDim.x, units);
    if (u < 0) continue;
    int bh, qt;
    unit_head_tile(u, bh_count, nqt, group, bh, qt);
    const int row0 = qt * X_BQ;
    const int ntiles = key_tiles64(sq, sk, causal, row0, q_off, k_off);
    const int wg_row0 = row0 + 64 * half;
    const int qpos = q_off + wg_row0 + 16 * w + g;   // + 8 h for row h
    float o[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) o[i] = 0.f;
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
    if (ntiles > 0) {
      mbar_wait(q_full, qi & 1);
      uint32_t pa[4][4];
      for (int j = 0; j < ntiles; ++j) {
        const int k0 = j * X_BK;
        const uint32_t k_addr =
            smem_u32(kv_tiles + (size_t)stage * 2 * X_KTILE);
        float s[32];
        mbar_wait(&k_full[stage], phase);
        wgmma_fence();
        issue_s256(s, q_addr, k_addr);
        wgmma_commit();
        wgmma_wait_all();
        // the unit's last S read the Q tile: the buffer is free
        if (j == ntiles - 1 && lane == 0) mbar_arrive(q_empty);
        const bool whole =
            k0 + X_BK <= sk &&
            (!causal || k_off + k0 + X_BK - 1 <= q_off + wg_row0);
        float corr[2];
        softmax_tile<32>(s, m, l, corr, whole, k0, sk, causal, k_off, qpos,
                         t, scale_log2);
        rescale_o<256>(o, corr);
        pack_p<4>(s, pa);
        mbar_wait(&v_full[stage], phase);
        wgmma_fence();
        issue_pv256(o, pa, k_addr + X_KTILE);
        wgmma_commit();
        wgmma_wait_all();
        if (lane == 0) mbar_arrive(&empty[stage]);
        if (++stage == X_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      ++qi;
    }
    // O / l into the unit's rows, the d real columns
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wg_row0 + 16 * w + g + 8 * h;
      if (r >= sq) continue;
      const float den = fmaxf(l[h], 1e-30f);
      bf16* dst = out + ((size_t)bh * sq + r) * d + 2 * t;
#pragma unroll
      for (int n = 0; n < 32; ++n) {
        if (n * 8 >= d) break;   // d % 8 == 0: only real columns
        *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
            __floats2bfloat162_rn(o[4 * n + 2 * h] / den,
                                  o[4 * n + 2 * h + 1] / den);
      }
    }
  }
}

// ------------------------------------------------------------------- host

constexpr int ROUTE_SIMT = 0, ROUTE_MMA = 1, ROUTE_WGMMA = 2, ROUTE_CHUNKED = 3;

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int bh, int sq, int sk, int d, int causal, float scale,
                 int q_off, int k_off, int sms, cudaStream_t st) {
  using W = Wgmma<D>;
  CUtensorMap tm_q, tm_k, tm_v;
  // the maps span the d real columns; a box's columns past d are out of
  // bounds, and TMA fills them with zeros
  const uint64_t row = (uint64_t)d * 2;
  if (!encode3(&tm_q, q, d, sq, bh, row, row * sq, 64, W_BQ, 1) ||
      !encode3(&tm_k, k, d, sk, bh, row, row * sk, 64, W_BK, 1) ||
      !encode3(&tm_v, v, d, sk, bh, row, row * sk, 64, W_BK, 1))
    return (int)cudaErrorInvalidValue;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bf16_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)W::SMEM);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  // persistent: one block an SM, or one a unit where there are fewer
  const int units = bh * ((sq + W_BQ - 1) / W_BQ);
  const int grid = units < sms ? units : sms;
  flash_bf16_wgmma<D><<<grid, W_THREADS, W::SMEM, st>>>(
      tm_q, tm_k, tm_v, static_cast<bf16*>(out), bh, sq, sk, d, causal,
      (float)((double)scale * 1.4426950408889634), q_off, k_off);
  return (int)cudaGetLastError();
}

int launch_wgmma256(const void* q, const void* k, const void* v, void* out,
                    int bh, int sq, int sk, int d, int causal, float scale,
                    int q_off, int k_off, int sms, cudaStream_t st) {
  CUtensorMap tm_q, tm_k, tm_v;
  // the maps span the d real columns; a box past d (columns 192 .. 255 at
  // d = 136) lies out of bounds, and TMA fills it with zeros
  const uint64_t row = (uint64_t)d * 2;
  if (!encode3(&tm_q, q, d, sq, bh, row, row * sq, 64, X_BQ, 1) ||
      !encode3(&tm_k, k, d, sk, bh, row, row * sk, 64, X_BK, 1) ||
      !encode3(&tm_v, v, d, sk, bh, row, row * sk, 64, X_BK, 1))
    return (int)cudaErrorInvalidValue;
  static int regs = 0;
  if (regs == 0) {
    cudaFuncAttributes fa;
    cudaError_t e = cudaFuncGetAttributes(&fa, flash_bf16_wgmma256);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(flash_bf16_wgmma256,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)X_SMEM);
    if (e != cudaSuccess) return (int)e;
    regs = fa.numRegs;
  }
  // the consumers' setmaxnreg.inc takes what the producer's .dec gives up
  // only where the launch holds X_REGS a thread; a build that holds fewer
  // would wait for registers that never come, so it is refused
  if (regs != X_REGS) return (int)cudaErrorLaunchOutOfResources;
  int dev = 0, l2 = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev);
  if (e != cudaSuccess) return (int)e;
  const int units = bh * ((sq + X_BQ - 1) / X_BQ);
  const int grid = units < sms ? units : sms;
  const int group = l2_group(bh, sk, d, 2, l2);
  flash_bf16_wgmma256<<<grid, X_THREADS, X_SMEM, st>>>(
      tm_q, tm_k, tm_v, static_cast<bf16*>(out), bh, sq, sk, d, causal,
      (float)((double)scale * 1.4426950408889634), q_off, k_off, group);
  return (int)cudaGetLastError();
}

// the mma route, and the chunked route's bf16 steps (STEPS)
template <int D, bool STEPS = false>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               dim3 grid, int sq, int sk, int d, int causal, float scale,
               int q_off, int k_off, bool vec, cudaStream_t st) {
  constexpr size_t smem = Mma<D>::SMEM;
  if (smem > 48 * 1024) {
    static bool attr = false;
    if (!attr) {
      const cudaError_t e = cudaFuncSetAttribute(
          flash_bf16<D, STEPS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
      attr = true;
    }
  }
  flash_bf16<D, STEPS><<<grid, THREADS, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), sq, sk, d,
      causal, scale, q_off, k_off, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int bh, int sq, int sk, int d,
                               int causal, float scale, int q_off, int k_off,
                               int dtype, int route, int sms, void* stream) {
  if (bh < 1 || sq < 1 || sk < 1 || d < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 16-byte loads and TMA need every row start aligned: aligned bases and a
  // row of d * 2 or d * 4 bytes that is a multiple of 16
  const bool vec = aligned16(q) && aligned16(k) && aligned16(v) &&
                   d % (dtype == 1 ? 8 : 4) == 0;
  // the chunked route takes exactly the head dims past one step
  if ((route == ROUTE_CHUNKED) != (d > CW)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {             // float32: the tiled SIMT kernel
    if (route != ROUTE_SIMT && route != ROUTE_CHUNKED)
      return (int)cudaErrorInvalidValue;
    return launch_f32(q, k, v, out, bh, sq, sk, d, causal, scale, q_off,
                      k_off, vec, vec && aligned16(out), st);
  }
  if ((sq + BQ - 1) / BQ > 65535 || (d + CW - 1) / CW > 65535)
    return (int)cudaErrorInvalidValue;
  if (route == ROUTE_CHUNKED)   // the D = 256 kernel over output chunks
    return launch_mma<CW, true>(
        q, k, v, out, dim3(bh, (sq + BQ - 1) / BQ, (d + CW - 1) / CW), sq,
        sk, d, causal, scale, q_off, k_off, vec, st);
  if (route == ROUTE_WGMMA) {
    if (!vec || d <= 32 || d > CW || sms < 1 ||
        (long)bh * ((sq + W_BQ - 1) / W_BQ) > 0x7fffffff)
      return (int)cudaErrorInvalidValue;
    if (d <= 64)
      return launch_wgmma<64>(q, k, v, out, bh, sq, sk, d, causal, scale,
                              q_off, k_off, sms, st);
    if (d <= 128)
      return launch_wgmma<128>(q, k, v, out, bh, sq, sk, d, causal, scale,
                               q_off, k_off, sms, st);
    return launch_wgmma256(q, k, v, out, bh, sq, sk, d, causal, scale, q_off,
                           k_off, sms, st);
  }
  if (route != ROUTE_MMA) return (int)cudaErrorInvalidValue;
  // the smallest built size D >= d; the loads zero-fill columns d .. D - 1
  const dim3 grid(bh, (sq + BQ - 1) / BQ);
#define FLASH_MMA(D)                                                        \
  return launch_mma<D>(q, k, v, out, grid, sq, sk, d, causal, scale, q_off, \
                       k_off, vec, st)
  if (d <= 16) FLASH_MMA(16);
  if (d <= 32) FLASH_MMA(32);
  if (d <= 64) FLASH_MMA(64);
  if (d <= 128) FLASH_MMA(128);
  FLASH_MMA(256);
#undef FLASH_MMA
}
