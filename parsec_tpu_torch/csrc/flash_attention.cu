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
// * bf16: q k^T runs on the tensor cores (mma.sync m16n8k16, bf16 in, f32
//   accumulation), so every product is exact, as in the TPU kernel, where q
//   and k are cast to f32. `scale` is applied to the f32 scores after the
//   dot, where the TPU kernel scales f32 q before it: one f32 rounding apart.
//   The softmax runs in f32. For P V, P is rounded to bf16 (it lies in
//   [0, 1], relative error at most 2^-8) and multiplied on the tensor cores
//   with f32 accumulation; l sums the unrounded f32 weights. The output
//   therefore lies within 2^-8 * sum_j p_j |v_j| / l of the f32 result before
//   its own rounding (flash_attention_bf16_tolerance in ops/cuda_kernels.py).
//
// Bound. At the LM path's shape, q k v o of (96, 1024, 64) bf16, causal,
// the function moves 4 * 96 * 1024 * 64 * 2 B = 50.3 MB (15.0 us at the
// H100's 3.35 TB/s) and does 4 * 64 * 96 * (1024 * 1025 / 2) = 12.9 GFLOP of
// products on the causal triangle (13.0 us at 989 TFLOP/s bf16): the bytes
// bound it, and only just. float32 runs outside the tensor cores (67
// TFLOP/s), where the operations bound it (193 us).
//
// Design, simple first. 4 warps a block, 16 q rows each; the Q tile is
// loaded once (bf16: into mma A fragments held in registers). K and V tiles
// of 64 rows (32 for float32) are staged through shared memory with 16-byte
// loads and shared by the 4 warps. At the main shape the grid is
// 96 x 16 = 1536 blocks over 132 SMs, issued heaviest causal tiles first.
// No cp.async/TMA pipelining, wgmma or warp specialisation yet: staging and
// math alternate behind barriers, which is what a later optimisation
// removes.
//
// C entry point (ctypes): flash_attention(q, k, v, out, bh, sq, sk, d,
// causal, scale, q_off, k_off, dtype, stream) with dtype 0 = float32,
// 1 = bf16; returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // q rows per block
constexpr int THREADS = 128;    // 4 warps
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// Last key index (exclusive) a block of q rows [row0, row0 + BQ) can see.
__device__ __forceinline__ int key_end(int sq, int sk, int causal, int row0,
                                       int q_off, int k_off) {
  if (!causal) return sk;
  const int last_row = min(row0 + BQ, sq) - 1;
  return min(sk, q_off + last_row - k_off + 1);   // <= 0: nothing visible
}

// ------------------------------------------------------------------- bf16

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

  const int kend = key_end(sq, sk, causal, row0, q_off, k_off);
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

  const int kend = key_end(sq, sk, causal, row0, q_off, k_off);
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

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
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
                               int dtype, void* stream) {
  const int nqt = (sq + BQ - 1) / BQ;
  if (bh < 1 || sq < 1 || sk < 1 || nqt > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(bh, nqt);
  // 16-byte loads need every row start aligned: aligned bases suffice, as a
  // row is d * 2 or d * 4 bytes, a multiple of 16 for every supported d
  const bool vec = aligned16(q) && aligned16(k) && aligned16(v);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
