// gemm_chain: out = C + sum_s A[s] @ B[s], and blocked_matmul, the same
// chain with C = 0 over the k blocks of one product.
//
// Replaces the TPU kernels `_gemm_chain_call` / `gemm_chain` (pallas_call at
// :175) and `_matmul_call` / `matmul` (pallas_call at :236) of the reference
// package's ops/pallas_kernels.py. There the grid runs the steps in order on
// one core with the output resident in VMEM. Here blocks run in parallel in
// no order, so the steps become either a loop inside a block or, when the
// output is too small to fill the card, work units of their own whose
// results a second pass sums in step order.
//
// Semantics (the TPU kernel's, per-step rounding included): each step's
// product A[s] @ B[s] is summed in float32, rounded to C's dtype and added to
// the running C in C's dtype: run = bf16(run + bf16(P_s)) for bf16, and
// plain float32 FMA sums (never TF32) with run = run + P_s for float32.
// The mixed form, bf16 A and B with a float32 C, is the float32 chain on the
// exact float32 values of the bf16 operands: the bf16 products are exact in
// float32, so each step is a float32 sum of exact products, added to the
// float32 C unrounded.
//
// Bound. The chain does 2 * kt * m * k * n operations on
// kt * (m * k + k * n) + 2 * m * n elements. At the DTD GEMM's shape (C 512
// x 512, kt = 32, bf16) that is 8.6 GFLOP on 34.6 MB: 8.7 us at 989 TFLOP/s
// against 10.3 us at 3.35 TB/s, so bytes bound it, just. blocked_matmul at
// bf16 8192^3 is bound by the tensor cores (1.11 ms); float32 runs outside
// them (67 TFLOP/s), where the operations bound it.
//
// Routes, chosen by the caller from the shapes before the launch (never
// after a failure; a route whose preconditions do not hold is refused with
// cudaErrorInvalidValue):
//
// * tile (bf16): Hopper's path. A persistent block per SM walks 128 x 128
//   output tiles. One producer thread streams 128 x 64 A and 64 x 128 B
//   slices with TMA (cp.async.bulk.tensor, 128-byte swizzle, zero fill past
//   the edges) into a ring of STAGES shared-memory stages guarded by full
//   and empty mbarriers; two consumer warpgroups, 64 rows each, multiply
//   every slice with four wgmma.mma_async m64n128k16 (bf16 in, float32 out,
//   both operands read from shared memory; B is row-major (k, n), i.e.
//   MN-major, hence the transpose bit and the MN-major descriptor). At each
//   step boundary a consumer rounds its float32 accumulator to bf16 and adds
//   it into the running tile (packed bf16 registers) while the producer
//   keeps loading the next step. Why 128 x 128: 128 x 256 would halve the
//   tiles of a 512^2 chain tile (4 instead of 16) and double the registers
//   the running tile takes beside the accumulator; 128 x 128 keeps 96
//   registers of tile state a consumer thread and a 32 KB stage.
// * split (bf16 and float32): the same tile loop where the output has too
//   few tiles for the card (a 512^2 chain tile is 16 tiles for 132 SMs).
//   A work unit is one (output tile, step) pair, 512 units at kt = 32.
//   Phase 1 writes each unit's rounded step product bf16(P_s) (float32:
//   P_s) to a scratch tensor (kt, m, n) that the wrapper allocates; phase 2,
//   a memory-bound pass, starts from C and adds the kt products in step
//   order, which is the chain's function to the bit. Two kernels on one
//   stream, so no unit waits for another and nothing can deadlock.
// * tile and split (float32): a register-tiled SIMT kernel, 128 x 128
//   outputs a block, 8 x 8 a thread, A and B slices double-buffered in
//   shared memory with cp.async and read back as float4 (16 loads for 256
//   FMAs).
// * general: the first kernels (WMMA bf16, 2 x 4 outputs a thread float32),
//   for what TMA and cp.async cannot address: row pitches or step offsets
//   that are not a multiple of 16 bytes, or bases not 16-byte aligned.
// * mixed (bf16 A and B, float32 C): the tile and split routes run the bf16
//   kernel (same TMA ring and wgmma mainloop, float32 accumulators) with a
//   float32 epilogue: the tile route adds each step's float32 sum into the
//   float32 output in place (each consumer thread owns its elements, so the
//   running C lives in global memory, not in 64 more registers beside the
//   accumulator), the split route stores float32 step products for the
//   float32 phase 2; the general route is the float32 kernel converting A
//   and B to float32 as it loads them.
//
// The mbarrier, TMA and wgmma helpers and the tensor-map encoding (through
// cudaGetDriverEntryPoint, so no -lcuda) are in hopper.cuh. The tensor maps
// are encoded on the host at every launch (each DTD task stacks its tiles
// into new buffers) and passed as __grid_constant__.
//
// C entry points (ctypes), dtype 0 = float32, 1 = bf16, 2 = bf16 A and B
// with a float32 C and output (gemm_chain only), route 0 = general, 1 =
// tile, 2 = split (scratch: kt * m * n elements of C's dtype, else null),
// sms the card's SM count; each returns a cudaError_t:
//   gemm_chain(c, a, b, out, scratch, kt, m, k, n, dtype, route, sms, stream)
//   blocked_matmul(a, b, out, scratch, m, k, n, bk, dtype, route, sms,
//                  stream)

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

// ================================================================ general

constexpr int BM = 32;          // output rows per block
constexpr int BN = 64;          // output cols per block
constexpr int THREADS = 256;    // 8 warps

constexpr int F_BK = 32;        // k depth per shared-memory stage

// an operand element as float32 (exact for bf16)
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// TIn: A's and B's element type, float (the float32 chain) or bf16 (the
// mixed form, converted to float32 on load)
template <typename TIn>
__global__ void __launch_bounds__(THREADS)
gemm_chain_f32(const float* __restrict__ c, const TIn* __restrict__ a,
               const TIn* __restrict__ b, float* __restrict__ out,
               int kt, int m, int kdim, int n, int lda, size_t a_step) {
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
      run[i][j] = (c != nullptr && r < m && cc < n) ? c[(size_t)r * n + cc]
                                                    : 0.f;
    }
  }

  for (int s = 0; s < kt; ++s) {
    const TIn* as = a + (size_t)s * a_step;
    const TIn* bs = b + (size_t)s * kdim * n;
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int k0 = 0; k0 < kdim; k0 += F_BK) {
      for (int e = tid; e < BM * F_BK; e += THREADS) {
        const int r = e / F_BK, kk = e % F_BK;
        const int gr = row0 + r, gk = k0 + kk;
        As[r][kk] = (gr < m && gk < kdim) ? to_f32(as[(size_t)gr * lda + gk])
                                          : 0.f;
      }
      for (int e = tid; e < F_BK * BN; e += THREADS) {
        const int kk = e / BN, cc = e % BN;
        const int gk = k0 + kk, gc = col0 + cc;
        Bs[kk][cc] = (gk < kdim && gc < n) ? to_f32(bs[(size_t)gk * n + gc])
                                           : 0.f;
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

using namespace nvcuda;

constexpr int H_BK = 64;          // k depth per shared-memory stage
constexpr int A_LD = H_BK + 8;    // padded leading dims (multiples of 8
constexpr int B_LD = BN + 8;      //   bf16 / 4 float, rows 16-byte aligned)
constexpr int C_LD = BN + 4;

// Stage a rows x cols sub-tile of a row-major matrix (leading dim ld,
// extent rmax x cmax) at (r0, c0) into shared memory, zero-filling the
// ragged edge, one element at a time (the general route's shapes allow no
// vector loads).
__device__ __forceinline__ void stage_bf16(
    __nv_bfloat16* dst, int ld_dst, const __nv_bfloat16* __restrict__ src,
    int ld, int r0, int c0, int rows, int cols, int rmax, int cmax) {
  for (int e = threadIdx.x; e < rows * cols; e += THREADS) {
    const int r = e / cols, cc = e % cols;
    const int gr = r0 + r, gc = c0 + cc;
    dst[r * ld_dst + cc] = (gr < rmax && gc < cmax)
                               ? src[(size_t)gr * ld + gc]
                               : __float2bfloat16(0.f);
  }
}

__global__ void __launch_bounds__(THREADS)
gemm_chain_bf16(const __nv_bfloat16* __restrict__ c,
                const __nv_bfloat16* __restrict__ a,
                const __nv_bfloat16* __restrict__ b,
                __nv_bfloat16* __restrict__ out,
                int kt, int m, int kdim, int n, int lda, size_t a_step) {
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
    Cs[r * C_LD + cc] = (c != nullptr && gr < m && gc < n)
                            ? __bfloat162float(c[(size_t)gr * n + gc])
                            : 0.f;
  }
  __syncthreads();
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> run, acc;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
  wmma::load_matrix_sync(run, Cs + (wr * 16) * C_LD + wc * 16, C_LD,
                         wmma::mem_row_major);

  for (int s = 0; s < kt; ++s) {
    const __nv_bfloat16* as = a + (size_t)s * a_step;
    const __nv_bfloat16* bs = b + (size_t)s * kdim * n;
    wmma::fill_fragment(acc, 0.f);
    for (int k0 = 0; k0 < kdim; k0 += H_BK) {
      stage_bf16(As, A_LD, as, lda, row0, k0, BM, H_BK, m, kdim);
      stage_bf16(Bs, B_LD, bs, n, k0, col0, H_BK, BN, kdim, n);
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

// ============================================================ work units

constexpr int TILE = 128;        // output tile of the tile and split routes
constexpr int GROUP_M = 8;       // tile rows a persistent wave walks together

struct Unit {
  int tm, tn, s0, s1;
};

// Unit u of a launch: split gives one (tile, step) pair a unit, step-major
// so that neighbouring blocks share a step's A and B in L2; tile gives one
// output tile with all kt steps. Tiles go in groups of GROUP_M tile rows,
// column by column, so a wave of blocks shares A rows and B columns in L2.
__device__ __forceinline__ Unit unit_of(int u, bool split, int kt,
                                        int tiles_m, int tiles_n) {
  const int tiles = tiles_m * tiles_n;
  Unit w;
  int t = u;
  if (split) {
    t = u % tiles;
    w.s0 = u / tiles;
    w.s1 = w.s0 + 1;
  } else {
    w.s0 = 0;
    w.s1 = kt;
  }
  const int group = t / (GROUP_M * tiles_n);
  const int first = group * GROUP_M;
  const int rows = min(GROUP_M, tiles_m - first);
  const int r = t - group * GROUP_M * tiles_n;
  w.tm = first + r % rows;
  w.tn = r / rows;
  return w;
}

// ================================================= bf16: TMA ring + wgmma

// Two adjacent output elements in C's dtype (bf16x2, or float2 for the
// mixed form), made from two float32 values: rounded, or as they are.
template <typename T> struct PairOf;
template <> struct PairOf<__nv_bfloat16> { using type = __nv_bfloat162; };
template <> struct PairOf<float> { using type = float2; };

template <typename P> __device__ __forceinline__ P pair_of(float x, float y);
template <> __device__ __forceinline__ __nv_bfloat162 pair_of(float x,
                                                              float y) {
  return __floats2bfloat162_rn(x, y);
}
template <> __device__ __forceinline__ float2 pair_of(float x, float y) {
  return make_float2(x, y);
}

constexpr int HK = 64;                          // k depth of a slice
constexpr int STAGES = 5;
constexpr int A_BYTES = TILE * HK * 2;          // 128 rows x 128 B
constexpr int B_BYTES = HK * TILE * 2;          // two 64 x 64 boxes
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int H_THREADS = 384;                  // producer + 2 consumer WGs
constexpr size_t H_SMEM = (size_t)STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;

// Tile and split routes, bf16. The A map is 3-D: (kdim, m, kt) for the
// chain's stacked A (a_rows_inner = 1: coordinates k, row, step) or
// (bk, kt, m) for matmul's one (m, k) matrix (coordinates k, step, row), so
// each step's zero fill stays inside its own k extent. The B map is
// (n, kdim, kt) for both. Consumer thread layout: the wgmma accumulator of
// m64n128: element i of thread (warp w, lane l) of a consumer warpgroup
// lies at row 16 w + l / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (l % 4)
// + i % 2, so element pair j = i / 2 is a pair of C's dtype at row 16 w +
// l / 4 + 8 (j % 2), column 8 (j / 2) + 2 (l % 4).
//
// OutT is C's (and the output's and the scratch's) dtype: bf16, or float
// for the mixed form.
template <typename OutT>
__global__ void __launch_bounds__(H_THREADS, 1)
chain_bf16_wgmma(const __grid_constant__ CUtensorMap tm_a,
                 const __grid_constant__ CUtensorMap tm_b,
                 const OutT* __restrict__ c, OutT* __restrict__ out,
                 OutT* __restrict__ scratch, int kt, int m,
                 int kdim, int n, int a_rows_inner, int split, int nunits,
                 int tiles_m, int tiles_n) {
  using Pair = typename PairOf<OutT>::type;
  constexpr bool F32_OUT = std::is_same<OutT, float>::value;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzled tiles want 1024-byte aligned stages
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);          // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int nks = (kdim + HK - 1) / HK;
  const int wg = threadIdx.x / 128;
  int stage = 0;
  uint32_t phase = 0;

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full
    if (threadIdx.x != 0) return;
    for (int u = blockIdx.x; u < nunits; u += gridDim.x) {
      const Unit w = unit_of(u, split, kt, tiles_m, tiles_n);
      const int row0 = w.tm * TILE, col0 = w.tn * TILE;
      for (int s = w.s0; s < w.s1; ++s) {
        for (int ks = 0; ks < nks; ++ks) {
          mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* sa = smem + stage * STAGE_BYTES;
          mbar_expect_tx(&full[stage], STAGE_BYTES);
          if (a_rows_inner)
            tma_load_3d(sa, &tm_a, &full[stage], ks * HK, row0, s);
          else
            tma_load_3d(sa, &tm_a, &full[stage], ks * HK, s, row0);
          tma_load_3d(sa + A_BYTES, &tm_b, &full[stage], col0, ks * HK, s);
          tma_load_3d(sa + A_BYTES + B_BYTES / 2, &tm_b, &full[stage],
                      col0 + 64, ks * HK, s);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup half = wg - 1 owns rows [64 half, 64 half + 64)
  const int half = wg - 1;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const size_t mn = (size_t)m * n;
  for (int u = blockIdx.x; u < nunits; u += gridDim.x) {
    const Unit w = unit_of(u, split, kt, tiles_m, tiles_n);
    const int rbase = w.tm * TILE + half * 64 + warp * 16 + lane / 4;
    const int cbase = w.tn * TILE + 2 * (lane % 4);
    // the running tile: bf16 pairs in registers (unused, so not allocated,
    // for a float32 C, which runs in the output itself, read and written
    // by this thread alone)
    __nv_bfloat162 run[32];
    if (!split && !F32_OUT) {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int r = rbase + 8 * (j % 2), col = cbase + 8 * (j / 2);
        run[j] = (c != nullptr && r < m && col < n)
                     ? *reinterpret_cast<const __nv_bfloat162*>(
                           c + (size_t)r * n + col)
                     : __floats2bfloat162_rn(0.f, 0.f);
      }
    }
    float acc[64];
    for (int s = w.s0; s < w.s1; ++s) {
      for (int ks = 0; ks < nks; ++ks) {
        mbar_wait(&full[stage], phase);
        const uint32_t a_addr =
            smem_u32(smem + stage * STAGE_BYTES + half * (A_BYTES / 2));
        const uint32_t b_addr = smem_u32(smem + stage * STAGE_BYTES + A_BYTES);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < HK / 16; ++kk) {
          // A: K-major, 8-row groups 1024 B apart, k16 = 32 B along a row.
          // B: MN-major, 8-row (k) groups 1024 B apart (SBO), the second
          // 64-column box 8192 B on (LBO), k16 = 16 rows of 128 B.
          wgmma_m64n128k16<1>(acc, gmma_desc(a_addr + kk * 32, 16, 1024),
                           gmma_desc(b_addr + kk * 2048, 8192, 1024),
                           (ks | kk) != 0);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        // waiting for this slice's wgmmas before the next slice's issue
        // measured faster than keeping one slice in flight as
        // chain_variants.py writes it (bf16 8192^3: 2.13 against 2.47-2.62
        // ms, in turns on one H100), whose branches make ptxas serialize
        // the wgmmas (warning C7518)
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        if (lane == 0) mbar_arrive(&empty[stage]);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      // the step boundary: its float32 sum rounded to C's dtype ...
      if (split) {
        OutT* dst = scratch + (size_t)s * mn;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int r = rbase + 8 * (j % 2), col = cbase + 8 * (j / 2);
          if (r < m && col < n)
            *reinterpret_cast<Pair*>(dst + (size_t)r * n + col) =
                pair_of<Pair>(acc[2 * j], acc[2 * j + 1]);
        }
      } else if constexpr (F32_OUT) {
        // ... added to the float32 running tile in the output (C at the
        // first step), unrounded
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int r = rbase + 8 * (j % 2), col = cbase + 8 * (j / 2);
          if (r < m && col < n) {
            float2* o = reinterpret_cast<float2*>(out + (size_t)r * n + col);
            float2 q = make_float2(0.f, 0.f);
            if (s != w.s0)
              q = *o;
            else if (c != nullptr)
              q = *reinterpret_cast<const float2*>(c + (size_t)r * n + col);
            *o = make_float2(q.x + acc[2 * j], q.y + acc[2 * j + 1]);
          }
        }
      } else {
        // ... and added to the running tile with one bf16 rounding
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const float2 p = __bfloat1622float2(
              __floats2bfloat162_rn(acc[2 * j], acc[2 * j + 1]));
          const float2 q = __bfloat1622float2(run[j]);
          run[j] = __floats2bfloat162_rn(q.x + p.x, q.y + p.y);
        }
      }
    }
    if (!split && !F32_OUT) {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int r = rbase + 8 * (j % 2), col = cbase + 8 * (j / 2);
        if (r < m && col < n)
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * n + col) =
              run[j];
      }
    }
  }
}

// ===================================== float32: register-tiled SIMT, cp.async

constexpr int FK = 16;            // k depth of a shared-memory slice
constexpr int F_THREADS = 256;    // 16 x 16 threads, 8 x 8 outputs each

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// One unit a block. Thread (ty, tx) owns rows row0 + ty + 16 i (i < 8) and
// columns col0 + 4 tx + {0..3} and col0 + 64 + 4 tx + {0..3}: A is read as
// float4 along k (the two rows of a warp broadcast), B as float4 along n.
__global__ void __launch_bounds__(F_THREADS, 1)
chain_f32_tiled(const float* __restrict__ c, const float* __restrict__ a,
                const float* __restrict__ b, float* __restrict__ out,
                float* __restrict__ scratch, int kt, int m, int kdim, int n,
                int lda, size_t a_step, int split, int tiles_m, int tiles_n) {
  __shared__ __align__(16) float As[2][TILE][FK];
  __shared__ __align__(16) float Bs[2][FK][TILE];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const Unit w = unit_of(blockIdx.x, split, kt, tiles_m, tiles_n);
  const int row0 = w.tm * TILE, col0 = w.tn * TILE;
  const int kps = (kdim + FK - 1) / FK;
  const int total = (w.s1 - w.s0) * kps;
  const size_t mn = (size_t)m * n;

  auto load = [&](int t, int buf) {
    const int s = w.s0 + t / kps, k0 = (t % kps) * FK;
    const float* as = a + (size_t)s * a_step;
    const float* bs = b + (size_t)s * kdim * n;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = tid + i * F_THREADS;
      const int r = e / (FK / 4), k4 = (e % (FK / 4)) * 4;
      const int gr = row0 + r, gk = k0 + k4;
      const bool ok = gr < m && gk < kdim;
      cp_async16(&As[buf][r][k4], ok ? as + (size_t)gr * lda + gk : a, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = tid + i * F_THREADS;
      const int kr = e / (TILE / 4), c4 = (e % (TILE / 4)) * 4;
      const int gk = k0 + kr, gc = col0 + c4;
      const bool ok = gk < kdim && gc < n;
      cp_async16(&Bs[buf][kr][c4], ok ? bs + (size_t)gk * n + gc : b, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  float run[8][8], acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + ty + 16 * i;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = col0 + 64 * h + 4 * tx;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (!split && c != nullptr && r < m && col < n)
        v = *reinterpret_cast<const float4*>(c + (size_t)r * n + col);
      run[i][4 * h] = v.x; run[i][4 * h + 1] = v.y;
      run[i][4 * h + 2] = v.z; run[i][4 * h + 3] = v.w;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  load(0, 0);
  for (int t = 0; t < total; ++t) {
    const int buf = t & 1;
    if (t + 1 < total) {
      load(t + 1, buf ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
#pragma unroll
    for (int k4 = 0; k4 < FK; k4 += 4) {
      float bv[4][8];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b0 =
            *reinterpret_cast<const float4*>(&Bs[buf][k4 + kk][4 * tx]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&Bs[buf][k4 + kk][64 + 4 * tx]);
        bv[kk][0] = b0.x; bv[kk][1] = b0.y; bv[kk][2] = b0.z;
        bv[kk][3] = b0.w; bv[kk][4] = b1.x; bv[kk][5] = b1.y;
        bv[kk][6] = b1.z; bv[kk][7] = b1.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 av =
            *reinterpret_cast<const float4*>(&As[buf][ty + 16 * i][k4]);
        const float ak[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(ak[kk], bv[kk][j], acc[i][j]);
        }
      }
    }
    if ((t + 1) % kps == 0) {
      // the step boundary: P_s to scratch (split) or into the running C
      const int s = w.s0 + t / kps;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = row0 + ty + 16 * i;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = col0 + 64 * h + 4 * tx;
          if (split) {
            if (r < m && col < n)
              *reinterpret_cast<float4*>(scratch + s * mn + (size_t)r * n +
                                         col) =
                  make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                              acc[i][4 * h + 2], acc[i][4 * h + 3]);
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q) run[i][4 * h + q] += acc[i][4 * h + q];
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      }
    }
    __syncthreads();      // the next load overwrites this buffer
  }

  if (!split) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = row0 + ty + 16 * i;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = col0 + 64 * h + 4 * tx;
        if (r < m && col < n)
          *reinterpret_cast<float4*>(out + (size_t)r * n + col) =
              make_float4(run[i][4 * h], run[i][4 * h + 1],
                          run[i][4 * h + 2], run[i][4 * h + 3]);
      }
    }
  }
}

// ========================================= split, phase 2: the ordered sum

// out = C, then out = out + P_s for s = 0, 1, ..., kt - 1 in that order, in
// the output's dtype (bf16: one float add and one rounding a step). Four
// elements a thread; m * n is a multiple of four on the split route (n is).
// The loads of BATCH steps are issued before their adds, so each thread
// keeps several L2 reads in flight.
constexpr int BATCH = 8;

__device__ __forceinline__ void add_rounded(uint2& r, uint2 p) {
  __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(&r);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&p);
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const float2 a = __bfloat1622float2(x[q]), b = __bfloat1622float2(y[q]);
    x[q] = __floats2bfloat162_rn(a.x + b.x, a.y + b.y);
  }
}

__device__ __forceinline__ void add_rounded(float4& r, float4 p) {
  r.x += p.x; r.y += p.y; r.z += p.z; r.w += p.w;
}

// V: four elements of the dtype (uint2 for bf16, float4 for float32)
template <typename V>
__global__ void ordered_sum(const V* __restrict__ c,
                            const V* __restrict__ parts, V* __restrict__ out,
                            int kt, size_t nv) {
  for (size_t v = blockIdx.x * (size_t)blockDim.x + threadIdx.x; v < nv;
       v += (size_t)gridDim.x * blockDim.x) {
    V r{};
    if (c != nullptr) r = c[v];
    int s = 0;
    for (; s + BATCH <= kt; s += BATCH) {
      V p[BATCH];
#pragma unroll
      for (int q = 0; q < BATCH; ++q) p[q] = parts[(size_t)(s + q) * nv + v];
#pragma unroll
      for (int q = 0; q < BATCH; ++q) add_rounded(r, p[q]);
    }
    for (; s < kt; ++s) add_rounded(r, parts[(size_t)s * nv + v]);
    out[v] = r;
  }
}

// ================================================================== host

constexpr int ROUTE_GENERAL = 0, ROUTE_TILE = 1, ROUTE_SPLIT = 2;
constexpr int DT_F32 = 0, DT_BF16 = 1, DT_MIXED = 2;

// chain_bf16_wgmma<OutT>'s launch; its shared-memory opt-in is set once a
// process (before any stream capture: the first launch of an instantiation
// is never a captured one, since capture is preceded by a warm-up run)
template <typename OutT>
cudaError_t launch_wgmma(int grid, cudaStream_t st, const CUtensorMap& tm_a,
                         const CUtensorMap& tm_b, const void* c, void* out,
                         void* scratch, int kt, int m, int kdim, int n,
                         int a_rows_inner, int split, int nunits, int tiles_m,
                         int tiles_n) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        chain_bf16_wgmma<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)H_SMEM);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  chain_bf16_wgmma<OutT><<<grid, H_THREADS, H_SMEM, st>>>(
      tm_a, tm_b, static_cast<const OutT*>(c), static_cast<OutT*>(out),
      static_cast<OutT*>(scratch), kt, m, kdim, n, a_rows_inner, split,
      nunits, tiles_m, tiles_n);
  return cudaSuccess;
}

// The chain over kt steps of (m x kdim) A blocks, row i of step s at
// a + s * a_step + i * lda, and (kdim x n) B blocks stored one after the
// other; c == nullptr starts the output at zero. a_rows_inner says which
// of lda (the chain: row pitch inside a step) and a_step (matmul: the step
// a column offset inside a row) is the smaller stride.
int launch_chain(const void* c, const void* a, const void* b, void* out,
                 void* scratch, int kt, int m, int kdim, int n, int lda,
                 size_t a_step, int a_rows_inner, int dtype, int route,
                 int sms, cudaStream_t st) {
  if (dtype != DT_F32 && dtype != DT_BF16 && dtype != DT_MIXED)
    return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  if (route == ROUTE_GENERAL) {
    const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
    if (dtype == DT_F32) {
      gemm_chain_f32<float><<<grid, THREADS, 0, st>>>(
          static_cast<const float*>(c), static_cast<const float*>(a),
          static_cast<const float*>(b), static_cast<float*>(out), kt, m, kdim,
          n, lda, a_step);
    } else if (dtype == DT_MIXED) {
      gemm_chain_f32<bf16><<<grid, THREADS, 0, st>>>(
          static_cast<const float*>(c), static_cast<const bf16*>(a),
          static_cast<const bf16*>(b), static_cast<float*>(out), kt, m, kdim,
          n, lda, a_step);
    } else {
      gemm_chain_bf16<<<grid, THREADS, 0, st>>>(
          static_cast<const bf16*>(c), static_cast<const bf16*>(a),
          static_cast<const bf16*>(b), static_cast<bf16*>(out), kt, m, kdim,
          n, lda, a_step);
    }
    return (int)cudaGetLastError();
  }
  // the tile and split routes' preconditions: 16-byte row pitches (of A and
  // B's elements), step offsets and bases (TMA's and cp.async's), scratch
  // for the split
  const size_t es = dtype == DT_F32 ? 4 : 2;
  const bool split = route == ROUTE_SPLIT;
  if ((route != ROUTE_TILE && !split) || sms < 1 ||
      ((size_t)kdim * es) % 16 || ((size_t)n * es) % 16 ||
      ((size_t)lda * es) % 16 || (a_step * es) % 16 || !aligned16(a) ||
      !aligned16(b) || !aligned16(out) || (c != nullptr && !aligned16(c)) ||
      (split && (scratch == nullptr || !aligned16(scratch))))
    return (int)cudaErrorInvalidValue;
  const int tiles_m = (m + TILE - 1) / TILE, tiles_n = (n + TILE - 1) / TILE;
  const int nunits = tiles_m * tiles_n * (split ? kt : 1);
  if (dtype == DT_F32) {
    chain_f32_tiled<<<nunits, F_THREADS, 0, st>>>(
        static_cast<const float*>(c), static_cast<const float*>(a),
        static_cast<const float*>(b), static_cast<float*>(out),
        static_cast<float*>(scratch), kt, m, kdim, n, lda, a_step, split,
        tiles_m, tiles_n);
  } else {
    CUtensorMap tm_a, tm_b;
    const bool ok =
        (a_rows_inner
             ? encode3(&tm_a, a, kdim, m, kt, (uint64_t)lda * 2, a_step * 2,
                       HK, TILE, 1)
             : encode3(&tm_a, a, kdim, kt, m, a_step * 2, (uint64_t)lda * 2,
                       HK, 1, TILE)) &&
        encode3(&tm_b, b, n, kdim, kt, (uint64_t)n * 2,
                (uint64_t)kdim * n * 2, 64, HK, 1);
    if (!ok) return (int)cudaErrorInvalidValue;
    const int grid = nunits < sms ? nunits : sms;
    cudaError_t e;
    if (dtype == DT_MIXED) {
      e = launch_wgmma<float>(grid, st, tm_a, tm_b, c, out, scratch, kt, m,
                              kdim, n, a_rows_inner, split, nunits, tiles_m,
                              tiles_n);
    } else {
      e = launch_wgmma<bf16>(grid, st, tm_a, tm_b, c, out, scratch, kt, m,
                             kdim, n, a_rows_inner, split, nunits, tiles_m,
                             tiles_n);
    }
    if (e != cudaSuccess) return (int)e;
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !split) return (int)e;
  const size_t nv = (size_t)m * n / 4;
  const int grid = (int)((nv + 255) / 256 < (size_t)sms * 16
                             ? (nv + 255) / 256
                             : (size_t)sms * 16);
  if (dtype == DT_BF16) {
    ordered_sum<uint2><<<grid, 256, 0, st>>>(
        static_cast<const uint2*>(c), static_cast<const uint2*>(scratch),
        static_cast<uint2*>(out), kt, nv);
  } else {
    ordered_sum<float4><<<grid, 256, 0, st>>>(
        static_cast<const float4*>(c), static_cast<const float4*>(scratch),
        static_cast<float4*>(out), kt, nv);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gemm_chain(const void* c, const void* a, const void* b,
                          void* out, void* scratch, int kt, int m, int k,
                          int n, int dtype, int route, int sms,
                          void* stream) {
  if (kt < 1 || m < 1 || k < 1 || n < 1) return (int)cudaErrorInvalidValue;
  return launch_chain(c, a, b, out, scratch, kt, m, k, n, k, (size_t)m * k,
                      1, dtype, route, sms, static_cast<cudaStream_t>(stream));
}

extern "C" int blocked_matmul(const void* a, const void* b, void* out,
                              void* scratch, int m, int k, int n, int bk,
                              int dtype, int route, int sms, void* stream) {
  if (m < 1 || k < 1 || n < 1 || bk < 1 || k % bk != 0 || dtype == DT_MIXED)
    return (int)cudaErrorInvalidValue;
  return launch_chain(nullptr, a, b, out, scratch, k / bk, m, bk, n, k,
                      (size_t)bk, 0, dtype, route, sms,
                      static_cast<cudaStream_t>(stream));
}
