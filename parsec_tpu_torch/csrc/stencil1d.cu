// stencil1d: out = w0 * xm + w1 * x + w2 * xp over a (rows, cols) tile, one
// launch per task tile.
//
// Replaces the TPU kernel `_stencil_call` / `stencil1d` of the reference
// package's ops/pallas_kernels.py (pallas_call at :287): there one grid step
// holds the whole tile in VMEM, builds xm = [left[:, -1], x[:, :-1]] and
// xp = [x[:, 1:], right[:, 0]] by concatenation and writes the weighted sum.
// Here nothing is concatenated: each thread reads the elements it needs, and
// only the threads at a row's two ends read a neighbour tile's edge column.
// A null neighbour pointer is a zero column (the domain boundary), so the
// boundary tiles need no zero tiles.
//
// Semantics, bit for bit those of the plain version (stencil1d_plain): the
// weights are rounded to the element type, and every product and sum is
// rounded to it, in the order (w0*xm + w1*x) + w2*xp. __fmul_rn/__fadd_rn
// keep nvcc from contracting a product and a sum into one FMA, which would
// round once where the plain version rounds twice. bf16 converts to float,
// operates, and rounds to bf16 after each operation (the product of two
// bf16 values is exact in float, so only the rounding to bf16 matters).
//
// Bound. The work is 5 operations per element on one read of x and one
// write of out (the halos add a column each): 2 * 4 bytes a float32
// element, so the memory rate bounds it by far (at the smoke run's
// (1, 2^24) float32 tile, 128 MiB in 0.040 ms at 3.35 TB/s, against 0.001 ms
// of float32 operations). Design, simple first: a thread owns VEC
// consecutive elements (16 bytes: 4 float32 or 8 bf16), loads them with one
// vector load where the row start is 16-byte aligned, reads its two
// neighbours with scalar loads (served by L1, since the neighbouring threads
// load the same lines), and stores its outputs with one vector store. No
// shared memory: each element is read from device memory about once.
//
// C entry point (ctypes): stencil1d(x, left, right, out, rows, cols, lcols,
// rcols, w0, w1, w2, dtype, stream), dtype 0 = float32, 1 = bf16; left is
// (rows, lcols) and right (rows, rcols), either may be null; returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int VEC = 4;
  __device__ static float get(float v) { return v; }
  __device__ static float round(float v) { return v; }
  __device__ static float put(float v) { return v; }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int VEC = 8;
  __device__ static float get(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ static __nv_bfloat16 put(float v) {
    return __float2bfloat16_rn(v);
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
stencil1d_kernel(const T* __restrict__ x, const T* __restrict__ left,
                 const T* __restrict__ right, T* __restrict__ out, int cols,
                 int lcols, int rcols, float w0, float w1, float w2,
                 bool vec) {
  using E = Elem<T>;
  constexpr int V = E::VEC;
  const int r = blockIdx.y;
  const long long j0 = ((long long)blockIdx.x * THREADS + threadIdx.x) * V;
  if (j0 >= cols) return;
  const T* xr = x + (size_t)r * cols;
  T* orow = out + (size_t)r * cols;

  // v[i] holds the row's element j0 - 1 + i, the halo columns standing at
  // -1 and cols; entries past the row's end are never used
  float v[V + 2];
  v[0] = j0 > 0 ? E::get(xr[j0 - 1])
                : (left != nullptr
                       ? E::get(left[(size_t)r * lcols + lcols - 1]) : 0.f);
  const bool full = j0 + V <= cols;
  if (vec && full) {
    const uint4 u = *reinterpret_cast<const uint4*>(xr + j0);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < V; ++i) v[1 + i] = E::get(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i)
      v[1 + i] = j0 + i < cols ? E::get(xr[j0 + i]) : 0.f;
  }
  v[V + 1] = j0 + V < cols ? E::get(xr[j0 + V]) : 0.f;
  // the right halo stands at column cols, where the row ends inside or
  // just after this thread's run
#pragma unroll
  for (int i = 1; i <= V; ++i) {
    if (j0 + i == cols)
      v[1 + i] = right != nullptr ? E::get(right[(size_t)r * rcols]) : 0.f;
  }

  float o[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float a = E::round(__fmul_rn(w0, v[i]));
    const float b = E::round(__fmul_rn(w1, v[i + 1]));
    const float s = E::round(__fadd_rn(a, b));
    const float c = E::round(__fmul_rn(w2, v[i + 2]));
    o[i] = E::round(__fadd_rn(s, c));
  }
  if (vec && full) {
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = E::put(o[i]);
    *reinterpret_cast<uint4*>(orow + j0) = u;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (j0 + i < cols) orow[j0 + i] = E::put(o[i]);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
int launch(const void* x, const void* left, const void* right, void* out,
           int rows, int cols, int lcols, int rcols, float w0, float w1,
           float w2, cudaStream_t st) {
  constexpr int V = Elem<T>::VEC;
  const long long per_block = (long long)THREADS * V;
  const dim3 grid((unsigned)((cols + per_block - 1) / per_block), rows);
  // vector loads and stores need every row start 16-byte aligned
  const bool vec = aligned16(x) && aligned16(out) &&
                   (rows == 1 || cols % V == 0);
  stencil1d_kernel<T><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(left),
      static_cast<const T*>(right), static_cast<T*>(out), cols, lcols, rcols,
      w0, w1, w2, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int stencil1d(const void* x, const void* left, const void* right,
                         void* out, int rows, int cols, int lcols, int rcols,
                         float w0, float w1, float w2, int dtype,
                         void* stream) {
  if (rows < 1 || rows > 65535 || cols < 1 || (left != nullptr && lcols < 1) ||
      (right != nullptr && rcols < 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, left, right, out, rows, cols, lcols, rcols, w0,
                         w1, w2, st);
  if (dtype == 1) {
    // the weights in the element type, as the plain version rounds them
    const float r0 = __bfloat162float(__float2bfloat16_rn(w0));
    const float r1 = __bfloat162float(__float2bfloat16_rn(w1));
    const float r2 = __bfloat162float(__float2bfloat16_rn(w2));
    return launch<__nv_bfloat16>(x, left, right, out, rows, cols, lcols,
                                 rcols, r0, r1, r2, st);
  }
  return (int)cudaErrorInvalidValue;
}
