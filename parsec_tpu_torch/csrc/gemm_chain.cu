// gemm_chain: out = C + sum_k A[k] @ B[k], one launch per task tile.
//
// Replaces the TPU kernel `_gemm_chain_call` / `gemm_chain` of the reference
// package's ops/pallas_kernels.py (pallas_call at :175): there the grid runs
// the kt steps in order on one core with C resident in VMEM. Here the k
// chain is a loop inside each thread block, and a block owns one BM x BN
// sub-tile of the output, held in registers for the whole chain.
//
// Semantics (shared with the TPU kernel, per-step rounding included): each
// step's product A[k] @ B[k] is summed in float32, rounded to C's dtype and
// added to the running C in C's dtype. For float32 that is plain float32 FMA
// (never TF32); for bf16 the running C rounds to bf16 at every k.
//
// Bound. The work is 2 * kt * ts_m * ts_k * ts_n operations on
// kt * (ts_m * ts_k + ts_k * ts_n) + 2 * ts_m * ts_n elements. At the main
// path's shape (C 512 x 512, kt = 32, bf16) that is 8.6 GFLOP on 34.6 MB:
// 8.7 us at the H100's 989 TFLOP/s bf16 tensor rate against 10.3 us at its
// 3.35 TB/s memory rate, so the least time is set by the bytes, and only
// just: the kernel has to read each stack about once from device memory and
// keep the tensor cores busy at the same time. float32 runs outside the
// tensor cores (67 TFLOP/s), where the operations bound it.
//
// Design, simple first. BM x BN = 32 x 64 output blocks: at ts = 512 one
// launch is 16 x 8 = 128 blocks, about one per SM of the 132 (64 x 64 would
// leave half the card idle). A and B sub-tiles are staged through shared
// memory, 16-byte vector loads where the rows allow it; the stacks are
// re-read by the 8 (A) and 16 (B) blocks that share them, from L2 (the 32 MB
// of the two stacks fit its 50 MB), so device memory sees them about once.
// bf16 multiplies on the tensor cores through WMMA 16x16x16 fragments
// (8 warps, one fragment each) with float32 accumulation; float32 is a
// SIMT FMA loop (2 x 4 outputs a thread). No TMA, wgmma or software
// pipelining yet: loads and math alternate, separated by barriers, which is
// what a later optimisation removes.
//
// C entry point (ctypes): gemm_chain(c, a, b, out, kt, m, k, n, dtype,
// stream) with dtype 0 = float32, 1 = bf16; returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;          // output rows per block
constexpr int BN = 64;          // output cols per block
constexpr int THREADS = 256;    // 8 warps

// ----------------------------------------------------------------- float32

constexpr int F_BK = 32;        // k depth per shared-memory stage

__global__ void __launch_bounds__(THREADS)
gemm_chain_f32(const float* __restrict__ c, const float* __restrict__ a,
               const float* __restrict__ b, float* __restrict__ out,
               int kt, int m, int kdim, int n) {
  __shared__ float As[BM][F_BK + 1];   // +1: conflict-free column reads
  __shared__ float Bs[F_BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;   // 16 x 16 threads
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  // thread (ty, tx) owns rows row0 + 2*ty + {0,1}, cols col0 + tx + 16*j
  float run[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = row0 + 2 * ty + i, cc = col0 + tx + 16 * j;
      run[i][j] = (r < m && cc < n) ? c[(size_t)r * n + cc] : 0.f;
    }
  }

  for (int s = 0; s < kt; ++s) {
    const float* as = a + (size_t)s * m * kdim;
    const float* bs = b + (size_t)s * kdim * n;
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int k0 = 0; k0 < kdim; k0 += F_BK) {
      for (int e = tid; e < BM * F_BK; e += THREADS) {
        const int r = e / F_BK, kk = e % F_BK;
        const int gr = row0 + r, gk = k0 + kk;
        As[r][kk] = (gr < m && gk < kdim) ? as[(size_t)gr * kdim + gk] : 0.f;
      }
      for (int e = tid; e < F_BK * BN; e += THREADS) {
        const int kk = e / BN, cc = e % BN;
        const int gk = k0 + kk, gc = col0 + cc;
        Bs[kk][cc] = (gk < kdim && gc < n) ? bs[(size_t)gk * n + gc] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < F_BK; ++kk) {
        const float a0 = As[2 * ty][kk], a1 = As[2 * ty + 1][kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float bv = Bs[kk][tx + 16 * j];
          acc[0][j] = fmaf(a0, bv, acc[0][j]);
          acc[1][j] = fmaf(a1, bv, acc[1][j]);
        }
      }
      __syncthreads();
    }
    // the step's float32 sum joins the running C (float32: no rounding)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) run[i][j] += acc[i][j];
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = row0 + 2 * ty + i, cc = col0 + tx + 16 * j;
      if (r < m && cc < n) out[(size_t)r * n + cc] = run[i][j];
    }
  }
}

// -------------------------------------------------------------------- bf16

using namespace nvcuda;

constexpr int H_BK = 64;          // k depth per shared-memory stage
constexpr int A_LD = H_BK + 8;    // padded leading dims (multiples of 8
constexpr int B_LD = BN + 8;      //   bf16 / 4 float, rows 16-byte aligned)
constexpr int C_LD = BN + 4;

// Stage a rows x cols sub-tile of a row-major matrix (leading dim ld,
// extent rmax x cmax) at (r0, c0) into shared memory, zero-filling the
// ragged edge. 8 consecutive bf16 per thread step: one 16-byte load where
// `vec` says every row start is 16-byte aligned and the vector is in range.
__device__ __forceinline__ void stage_bf16(
    __nv_bfloat16* dst, int ld_dst, const __nv_bfloat16* __restrict__ src,
    int ld, int r0, int c0, int rows, int cols, int rmax, int cmax,
    bool vec) {
  const int vpr = cols / 8;   // vectors per row
  for (int v = threadIdx.x; v < rows * vpr; v += THREADS) {
    const int r = v / vpr, cc = (v % vpr) * 8;
    const int gr = r0 + r, gc = c0 + cc;
    __nv_bfloat16* d = dst + r * ld_dst + cc;
    if (vec && gr < rmax && gc + 8 <= cmax) {
      *reinterpret_cast<uint4*>(d) =
          *reinterpret_cast<const uint4*>(src + (size_t)gr * ld + gc);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        d[e] = (gr < rmax && gc + e < cmax) ? src[(size_t)gr * ld + gc + e]
                                             : __float2bfloat16(0.f);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
gemm_chain_bf16(const __nv_bfloat16* __restrict__ c,
                const __nv_bfloat16* __restrict__ a,
                const __nv_bfloat16* __restrict__ b,
                __nv_bfloat16* __restrict__ out,
                int kt, int m, int kdim, int n, bool vec) {
  __shared__ __align__(32) __nv_bfloat16 As[BM * A_LD];
  __shared__ __align__(32) __nv_bfloat16 Bs[H_BK * B_LD];
  __shared__ __align__(32) float Cs[BM * C_LD];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wr = warp / 4, wc = warp % 4;   // 2 x 4 warps of 16 x 16
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  // C -> shared (float, exact) -> the running accumulator fragment
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int r = e / BN, cc = e % BN;
    const int gr = row0 + r, gc = col0 + cc;
    Cs[r * C_LD + cc] =
        (gr < m && gc < n) ? __bfloat162float(c[(size_t)gr * n + gc]) : 0.f;
  }
  __syncthreads();
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> run, acc;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
  wmma::load_matrix_sync(run, Cs + (wr * 16) * C_LD + wc * 16, C_LD,
                         wmma::mem_row_major);

  for (int s = 0; s < kt; ++s) {
    const __nv_bfloat16* as = a + (size_t)s * m * kdim;
    const __nv_bfloat16* bs = b + (size_t)s * kdim * n;
    wmma::fill_fragment(acc, 0.f);
    for (int k0 = 0; k0 < kdim; k0 += H_BK) {
      stage_bf16(As, A_LD, as, kdim, row0, k0, BM, H_BK, m, kdim, vec);
      stage_bf16(Bs, B_LD, bs, n, k0, col0, H_BK, BN, kdim, n, vec);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < H_BK; kk += 16) {
        wmma::load_matrix_sync(fa, As + (wr * 16) * A_LD + kk, A_LD);
        wmma::load_matrix_sync(fb, Bs + kk * B_LD + wc * 16, B_LD);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      __syncthreads();
    }
    // per-step rounding: the step's float32 sum to bf16, then the add in
    // bf16 (float add, one rounding — what a bf16 + bf16 add computes).
    // Both fragments share one type, so element i is the same matrix
    // position in each
#pragma unroll
    for (int i = 0; i < acc.num_elements; ++i) {
      const float d = __bfloat162float(__float2bfloat16(acc.x[i]));
      run.x[i] = __bfloat162float(__float2bfloat16(run.x[i] + d));
    }
  }

  wmma::store_matrix_sync(Cs + (wr * 16) * C_LD + wc * 16, run, C_LD,
                          wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int r = e / BN, cc = e % BN;
    const int gr = row0 + r, gc = col0 + cc;
    if (gr < m && gc < n)
      out[(size_t)gr * n + gc] = __float2bfloat16(Cs[r * C_LD + cc]);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" int gemm_chain(const void* c, const void* a, const void* b,
                          void* out, int kt, int m, int k, int n, int dtype,
                          void* stream) {
  if (kt < 1 || m < 1 || k < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    gemm_chain_f32<<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(c), static_cast<const float*>(a),
        static_cast<const float*>(b), static_cast<float*>(out), kt, m, k, n);
  } else if (dtype == 1) {
    // vector loads need every row start of A (ld k) and B (ld n) 16-byte
    // aligned: aligned bases and row lengths that are multiples of 8
    const bool vec = aligned16(a) && aligned16(b) && k % 8 == 0 && n % 8 == 0;
    gemm_chain_bf16<<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(c),
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b),
        static_cast<__nv_bfloat16*>(out), kt, m, k, n, vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
