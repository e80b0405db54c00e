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
//   keys scored NEG), so any sq, sk >= 1 runs; head dims 16, 32, 64, 128.
//
// Precision.
// * float32: every product and sum is a float32 FMA on the SIMT cores, never
//   TF32. q is multiplied by `scale` in float32 before the dot, as the TPU
//   kernel does.
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
// * wgmma (bf16, d = 64 or 128, 16-byte aligned bases): Hopper's path. A
//   work unit is (bh, a 128-row q tile); a block has 288 threads, two
//   consumer warpgroups of 64 q rows each and one producer warp. The
//   producer's first lane loads each unit's Q tile into the free one of two
//   buffers and streams its 128-key K and V tiles through a ring of STAGES
//   stages (3 at d = 64, 2 at d = 128: 128 and 192 KB of shared memory) with
//   TMA: 3-D tensor maps over (d, s, bh), boxes of 64 columns x 128 rows x 1
//   with 128-byte swizzle (two boxes a row block at d = 128), so the zero
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
// * mma (bf16 at d = 16 or 32, or on bases not 16-byte aligned): 4 warps a
//   block, 16 q rows each; the Q tile is loaded once into mma A fragments
//   held in registers; K and V tiles of 64 rows are staged through shared
//   memory with 16-byte loads (scalar loads on unaligned bases) and shared
//   by the 4 warps; mma.sync m16n8k16. Staging and math alternate behind
//   barriers.
// * simt (float32): the same block shape, 32-key K and V tiles in shared
//   memory, FMA on the SIMT cores.
// The mma and simt grids are (bh, 64-row q tiles), heaviest first.
//
// C entry point (ctypes): flash_attention(q, k, v, out, bh, sq, sk, d,
// causal, scale, q_off, k_off, dtype, route, sms, stream) with dtype 0 =
// float32, 1 = bf16, route 0 = simt, 1 = mma, 2 = wgmma and sms the card's
// SM count; returns a cudaError_t.

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

// ------------------------------------------------------------- bf16: mma

using bf16 = __nv_bfloat16;
constexpr int BK = 64;          // keys per shared-memory tile

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

// Rows [r0, r0 + 64) of a (nrows, D) row-major matrix into shared memory
// (leading dim D + 8), zero-filling rows past nrows.
template <int D>
__device__ __forceinline__ void stage_bf16(bf16* dst,
                                           const bf16* __restrict__ src,
                                           int r0, int nrows, bool vec) {
  constexpr int LD = D + 8, VPR = D / 8;
  for (int i = threadIdx.x; i < 64 * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * 8, gr = r0 + r;
    bf16* d = dst + r * LD + c;
    if (gr >= nrows) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    } else if (vec) {
      *reinterpret_cast<uint4*>(d) =
          *reinterpret_cast<const uint4*>(src + (size_t)gr * D + c);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = src[(size_t)gr * D + c + e];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, bf16* __restrict__ out, int sq,
           int sk, int causal, float scale, int q_off, int k_off, bool vec) {
  constexpr int LD = D + 8;
  constexpr int KC = D / 16;    // k steps of the q k^T product
  constexpr int NT = D / 8;     // 8-column tiles of the output
  __shared__ __align__(16) bf16 Ks[BK * LD];
  __shared__ __align__(16) bf16 Vs[BK * LD];

  const int bh = blockIdx.x;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;   // fragment row, pair within a row
  const int wr = warp * 16;               // the warp's first row in the tile
  const bf16* qb = q + (size_t)bh * sq * D;
  const bf16* kb = k + (size_t)bh * sk * D;
  const bf16* vb = v + (size_t)bh * sk * D;

  // the Q tile, through the K buffer, into A fragments held for the block
  stage_bf16<D>(Ks, qb, row0, sq, vec);
  __syncthreads();
  uint32_t qa[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const bf16* p = Ks + (wr + g) * LD + kc * 16 + 2 * t;
    qa[kc][0] = ld32(p);
    qa[kc][1] = ld32(p + 8 * LD);
    qa[kc][2] = ld32(p + 8);
    qa[kc][3] = ld32(p + 8 * LD + 8);
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
    stage_bf16<D>(Ks, kb, k0, sk, vec);
    stage_bf16<D>(Vs, vb, k0, sk, vec);
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys: 8 tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        const bf16* p = Ks + (j * 8 + g) * LD + kc * 16 + 2 * t;
        mma_bf16(s[j], qa[kc], ld32(p), ld32(p + 8));
      }
    }

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

    // O += P V: the S accumulators are the A fragments of P (16 keys each)
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

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + wr + g + 8 * h;
    if (r >= sq) continue;
    const float den = fmaxf(l[h], 1e-30f);
    bf16* dst = out + ((size_t)bh * sq + r) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) = __floats2bfloat162_rn(
          o[n][2 * h] / den, o[n][2 * h + 1] / den);
    }
  }
}

// ---------------------------------------------------------------- float32

constexpr int F_BK = 32;        // keys per shared-memory tile

// Rows [r0, r0 + F_BK) of a (nrows, D) row-major matrix into shared memory,
// zero-filling rows past nrows.
template <int D>
__device__ __forceinline__ void stage_f32(float* dst,
                                          const float* __restrict__ src,
                                          int r0, int nrows, bool vec) {
  constexpr int VPR = D / 4;
  for (int i = threadIdx.x; i < F_BK * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * 4, gr = r0 + r;
    float* d = dst + r * D + c;
    if (gr >= nrows) {
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else if (vec) {
      *reinterpret_cast<float4*>(d) =
          *reinterpret_cast<const float4*>(src + (size_t)gr * D + c);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) d[e] = src[(size_t)gr * D + c + e];
    }
  }
}

// Two threads share a q row: thread half `hf` owns the columns 4i + 2hf and
// 4i + 2hf + 1 (i < D/4), so the two halves read neighbouring words of a
// shared row and each dot is two half-sums joined by one shuffle.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_f32(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ out, int sq,
          int sk, int causal, float scale, int q_off, int k_off, bool vec) {
  constexpr int P = D / 4;      // float2 pairs a thread owns
  __shared__ __align__(16) float Ks[F_BK * D];
  __shared__ __align__(16) float Vs[F_BK * D];

  const int bh = blockIdx.x;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest first
  const int hf = threadIdx.x % 2;
  const int row = row0 + threadIdx.x / 2;
  const bool live = row < sq;
  const float* kb = k + (size_t)bh * sk * D;
  const float* vb = v + (size_t)bh * sk * D;

  float2 qr[P], o[P];
  {
    const float* qrow = q + ((size_t)bh * sq + (live ? row : 0)) * D;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int c = 4 * i + 2 * hf;
      qr[i] = live ? make_float2(qrow[c] * scale, qrow[c + 1] * scale)
                   : make_float2(0.f, 0.f);
      o[i] = make_float2(0.f, 0.f);
    }
  }
  float m = NEG, l = 0.f;
  const int qpos = q_off + row;

  const int kend = key_end(sq, sk, causal, row0, BQ, q_off, k_off);
  for (int k0 = 0; k0 < kend; k0 += F_BK) {
    stage_f32<D>(Ks, kb, k0, sk, vec);
    stage_f32<D>(Vs, vb, k0, sk, vec);
    __syncthreads();

    float s[F_BK];
    float mx = m;
#pragma unroll
    for (int j = 0; j < F_BK; ++j) {
      const float2* kr = reinterpret_cast<const float2*>(Ks + j * D) + hf;
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const float2 kv = kr[2 * i];
        part = fmaf(qr[i].x, kv.x, part);
        part = fmaf(qr[i].y, kv.y, part);
      }
      const float x = part + __shfl_xor_sync(FULL, part, 1);
      const int col = k0 + j;
      const bool keep = col < sk && (!causal || k_off + col <= qpos);
      s[j] = keep ? x : NEG;
      mx = fmaxf(mx, s[j]);
    }
    const float corr = expf(m - mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < F_BK; ++j) {
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
#pragma unroll
    for (int j = 0; j < F_BK; ++j) {
      const float2* vr = reinterpret_cast<const float2*>(Vs + j * D) + hf;
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const float2 vv = vr[2 * i];
        o[i].x = fmaf(s[j], vv.x, o[i].x);
        o[i].y = fmaf(s[j], vv.y, o[i].y);
      }
    }
    __syncthreads();
  }

  if (!live) return;
  const float den = fmaxf(l, 1e-30f);
  float* dst = out + ((size_t)bh * sq + row) * D + 2 * hf;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    *reinterpret_cast<float2*>(dst + 4 * i) =
        make_float2(o[i].x / den, o[i].y / den);
  }
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

// 2^x on the MUFU, one instruction (results below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
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
__device__ __forceinline__ void softmax_tile(
    float (&s)[64], float (&m)[2], float (&l)[2], float (&corr)[2],
    bool whole, int k0, int sk, int causal, int k_off, int qpos, int t,
    float scale_log2) {
  if (!whole) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int col = k0 + 8 * (i / 4) + 2 * t + i % 2;
      const int h = (i / 2) % 2;
      if (col >= sk || (causal && k_off + col > qpos + 8 * h)) s[i] = NEG;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx4[4] = {m[h], m[h], m[h], m[h]};
#pragma unroll
    for (int jj = 0; jj < 16; ++jj)
      mx4[jj % 4] = fmaxf(mx4[jj % 4],
                          fmaxf(s[4 * jj + 2 * h], s[4 * jj + 2 * h + 1]));
    float mx = fmaxf(fmaxf(mx4[0], mx4[1]), fmaxf(mx4[2], mx4[3]));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
    corr[h] = ex2((m[h] - mx) * scale_log2);
    const float ref = mx > 0.5f * NEG ? mx * scale_log2 : 0.f;
    float sum4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
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
__device__ __forceinline__ void pack_p(const float (&s)[64],
                                       uint32_t (&pa)[8][4]) {
#pragma unroll
  for (int kc = 0; kc < 8; ++kc) {
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
                 int causal, float scale_log2, int q_off, int k_off) {
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
      bf16* dst = out + ((size_t)bh * sq + r) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
            __floats2bfloat162_rn(o[4 * n + 2 * h] / den,
                                  o[4 * n + 2 * h + 1] / den);
      }
    }
  }
}

// ------------------------------------------------------------------- host

constexpr int ROUTE_SIMT = 0, ROUTE_MMA = 1, ROUTE_WGMMA = 2;

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int bh, int sq, int sk, int causal, float scale, int q_off,
                 int k_off, int sms, cudaStream_t st) {
  using W = Wgmma<D>;
  CUtensorMap tm_q, tm_k, tm_v;
  const uint64_t row = (uint64_t)D * 2;
  if (!encode3(&tm_q, q, D, sq, bh, row, row * sq, 64, W_BQ, 1) ||
      !encode3(&tm_k, k, D, sk, bh, row, row * sk, 64, W_BK, 1) ||
      !encode3(&tm_v, v, D, sk, bh, row, row * sk, 64, W_BK, 1))
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
      tm_q, tm_k, tm_v, static_cast<bf16*>(out), bh, sq, sk, causal,
      (float)((double)scale * 1.4426950408889634), q_off, k_off);
  return (int)cudaGetLastError();
}

template <int D>
void launch(const void* q, const void* k, const void* v, void* out, dim3 grid,
            int sq, int sk, int causal, float scale, int q_off, int k_off,
            int dtype, bool vec, cudaStream_t st) {
  if (dtype == 0) {
    flash_f32<D><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), sq, sk,
        causal, scale, q_off, k_off, vec);
  } else {
    flash_bf16<D><<<grid, THREADS, 0, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(out), sq, sk, causal,
        scale, q_off, k_off, vec);
  }
}

}  // namespace

extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int bh, int sq, int sk, int d,
                               int causal, float scale, int q_off, int k_off,
                               int dtype, int route, int sms, void* stream) {
  if (bh < 1 || sq < 1 || sk < 1 || (sq + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 16-byte loads and TMA need every row start aligned: aligned bases
  // suffice, as a row is d * 2 or d * 4 bytes, a multiple of 16 for every
  // supported d
  const bool vec = aligned16(q) && aligned16(k) && aligned16(v);
  if (route == ROUTE_WGMMA) {
    if (dtype != 1 || !vec || sms < 1 ||
        (long)bh * ((sq + W_BQ - 1) / W_BQ) > 0x7fffffff)
      return (int)cudaErrorInvalidValue;
    if (d == 64)
      return launch_wgmma<64>(q, k, v, out, bh, sq, sk, causal, scale, q_off,
                              k_off, sms, st);
    if (d == 128)
      return launch_wgmma<128>(q, k, v, out, bh, sq, sk, causal, scale,
                               q_off, k_off, sms, st);
    return (int)cudaErrorInvalidValue;
  }
  if (!(route == ROUTE_SIMT && dtype == 0) &&
      !(route == ROUTE_MMA && dtype == 1))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(bh, (sq + BQ - 1) / BQ);
  switch (d) {
    case 16: launch<16>(q, k, v, out, grid, sq, sk, causal, scale, q_off,
                        k_off, dtype, vec, st); break;
    case 32: launch<32>(q, k, v, out, grid, sq, sk, causal, scale, q_off,
                        k_off, dtype, vec, st); break;
    case 64: launch<64>(q, k, v, out, grid, sq, sk, causal, scale, q_off,
                        k_off, dtype, vec, st); break;
    case 128: launch<128>(q, k, v, out, grid, sq, sk, causal, scale, q_off,
                          k_off, dtype, vec, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
