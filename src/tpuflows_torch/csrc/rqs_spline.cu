// K4 and K5 of tpuflows_torch: the elementwise rational-quadratic spline
// and its pullback.
//
// K4 replaces the Pallas kernel `_pallas_eval`
// (src/tpuflows/kernels/rqs_pallas.py:195, pallas_call at :204): y and the
// elementwise log-derivative of the forward or inverse spline. K5 replaces
// `_pallas_grad` (:227, pallas_call at :240): the pullback (gy, gladj) ->
// (dx, draw), recomputing the spline in the kernel, so no residual goes to
// device memory. The math is in rqs_math.cuh; the plain PyTorch version is
// `_fwd_tile_math` / `_inv_tile_math` in kernels/rqs_cuda.py with autograd.
//
// Design. Both read the raw values in the conditioner's own (N, d, 3K-1)
// layout (the Pallas wrapper's relayout to (P, M, 128) tiles exists for
// the TPU's lanes and is not copied); forward and inverse are a template
// parameter. K4 (`rqs_eval_kernel`) is one thread per element. K5
// (`rqs_grad_lanes_kernel`, rqs_lanes.cuh) gives each element a group of
// L lanes that hold its bins, and stages each block's contiguous span of
// raw values in shared memory with 16-byte copies, so that its loads and
// stores are coalesced and each exponential and softplus is computed once;
// the sums rqs_math.cuh orders are taken in its order, so its outputs can
// equal the one-thread pullback's to the bit. That one-thread kernel
// (`rqs_grad_kernel`, entry point `rqs_grad_thread_f32`: 3K-1 values read
// at a stride of 3K-1 floats, three walks over the knots with the
// exponentials recomputed in each) stays built as the oracle and
// yardstick of `chip_smoke.py`, on no path.
//
// Bound on this card: bytes. At the fit's shape (1024 x 64 elements,
// K = 8) K4 moves 104 B per element and K5 200 B, 6.8 MB and 13.1 MB, 2-4
// us at 3.35 TB/s.

#include <cuda_runtime.h>

#include "rqs_lanes.cuh"
#include "rqs_math.cuh"

namespace {

using namespace tpuflows_rqs;

constexpr int kThreads = 256;

template <bool kInverse>
__global__ void __launch_bounds__(kThreads)
    rqs_eval_kernel(const float* __restrict__ x, const float* __restrict__ raw,
                    float* __restrict__ y, float* __restrict__ ladj,
                    long long n, int K, float B) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float* r = raw + i * (3 * K - 1);
  float yo, lo;
  if (kInverse)
    rqs_inverse(x[i], r, 1, K, B, yo, lo);
  else
    rqs_forward(x[i], r, 1, K, B, yo, lo);
  y[i] = yo;
  ladj[i] = lo;
}

template <bool kInverse>
__global__ void __launch_bounds__(kThreads)
    rqs_grad_kernel(const float* __restrict__ x, const float* __restrict__ raw,
                    const float* __restrict__ gy, const float* __restrict__ gl,
                    float* __restrict__ dx, float* __restrict__ draw,
                    long long n, int K, float B) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int P = 3 * K - 1;
  float d;
  if (kInverse)
    rqs_inverse_vjp(x[i], raw + i * P, 1, K, B, gy[i], gl[i], d,
                    draw + i * P, 1);
  else
    rqs_forward_vjp(x[i], raw + i * P, 1, K, B, gy[i], gl[i], d,
                    draw + i * P, 1);
  dx[i] = d;
}

template <bool kInverse, int L>
__global__ void __launch_bounds__(tpuflows_rqs_lanes::kLaneThreads)
    rqs_grad_lanes_kernel(const float* __restrict__ x,
                          const float* __restrict__ raw,
                          const float* __restrict__ gy,
                          const float* __restrict__ gl,
                          float* __restrict__ dx, float* __restrict__ draw,
                          long long n, int K, float B) {
  extern __shared__ float4 smem4[];
  tpuflows_rqs_lanes::grad_lanes<kInverse, L>(
      x, raw, gy, gl, dx, draw, n, K, B, reinterpret_cast<float*>(smem4));
}

bool args_ok(long long n, int knots, float range_limit) {
  return n >= 0 && knots >= 2 && knots <= kMaxKnots && range_limit > 0.0f;
}

unsigned blocks(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

template <bool kInverse, int L>
cudaError_t launch_lanes(const float* x, const float* raw, const float* gy,
                         const float* gl, float* dx, float* draw, long long n,
                         int K, float B, cudaStream_t s) {
  using namespace tpuflows_rqs_lanes;
  constexpr int E = block_elements(L);
  const long long nb = (n + E - 1) / E;
  if (nb >= (1LL << 31)) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * block_floats(K);
  if (smem > 48 * 1024) {  // above 48 KB only when asked for
    const cudaError_t e = cudaFuncSetAttribute(
        rqs_grad_lanes_kernel<kInverse, L>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  rqs_grad_lanes_kernel<kInverse, L><<<(unsigned)nb, kLaneThreads, smem, s>>>(
      x, raw, gy, gl, dx, draw, n, K, B);
  return cudaGetLastError();
}

// the instantiation for K knots, L = lanes_for(K); only the lane counts
// some K takes are built
template <bool kInverse, int L = 1>
cudaError_t launch_grad(const float* x, const float* raw, const float* gy,
                        const float* gl, float* dx, float* draw, long long n,
                        int K, float B, cudaStream_t s) {
  using namespace tpuflows_rqs_lanes;
  if constexpr (L > 32) {
    return cudaErrorInvalidValue;
  } else {
    if constexpr (lanes_used(L)) {
      if (lanes_for(K) == L)
        return launch_lanes<kInverse, L>(x, raw, gy, gl, dx, draw, n, K, B,
                                         s);
    }
    return launch_grad<kInverse, 2 * L>(x, raw, gy, gl, dx, draw, n, K, B,
                                        s);
  }
}

}  // namespace

// Each returns a cudaError_t (0 = launched). n is the number of elements
// of x; raw holds 3 knots - 1 values per element after it. The Python
// wrapper checks device, dtype, shapes and contiguity before calling.
// K4:
extern "C" int rqs_eval_f32(const void* x, const void* raw, void* y,
                            void* ladj, long long n, int knots,
                            float range_limit, int inverse, void* stream) {
  if (!args_ok(n, knots, range_limit)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* rp = static_cast<const float*>(raw);
  float* yp = static_cast<float*>(y);
  float* lp = static_cast<float*>(ladj);
  if (inverse)
    rqs_eval_kernel<true><<<blocks(n), kThreads, 0, s>>>(
        xp, rp, yp, lp, n, knots, range_limit);
  else
    rqs_eval_kernel<false><<<blocks(n), kThreads, 0, s>>>(
        xp, rp, yp, lp, n, knots, range_limit);
  return (int)cudaGetLastError();
}

// K5: each returns a cudaError_t (0 = launched). Any pointer may sit at
// any 4-byte offset; the kernel copies 16 bytes at a time where it can.
extern "C" int rqs_grad_f32(const void* x, const void* raw, const void* gy,
                            const void* gl, void* dx, void* draw,
                            long long n, int knots, float range_limit,
                            int inverse, void* stream) {
  if (!args_ok(n, knots, range_limit)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* rp = static_cast<const float*>(raw);
  const float* gyp = static_cast<const float*>(gy);
  const float* glp = static_cast<const float*>(gl);
  float* dxp = static_cast<float*>(dx);
  float* drp = static_cast<float*>(draw);
  return (int)(inverse ? launch_grad<true>(xp, rp, gyp, glp, dxp, drp, n,
                                           knots, range_limit, s)
                       : launch_grad<false>(xp, rp, gyp, glp, dxp, drp, n,
                                            knots, range_limit, s));
}

// The one-thread pullback (`rqs_grad_kernel`) that K5's group kernel
// replaced: chip_smoke.py's oracle and yardstick, on no path. Same
// arguments as rqs_grad_f32.
extern "C" int rqs_grad_thread_f32(const void* x, const void* raw,
                                   const void* gy, const void* gl, void* dx,
                                   void* draw, long long n, int knots,
                                   float range_limit, int inverse,
                                   void* stream) {
  if (!args_ok(n, knots, range_limit)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* rp = static_cast<const float*>(raw);
  const float* gyp = static_cast<const float*>(gy);
  const float* glp = static_cast<const float*>(gl);
  float* dxp = static_cast<float*>(dx);
  float* drp = static_cast<float*>(draw);
  if (inverse)
    rqs_grad_kernel<true><<<blocks(n), kThreads, 0, s>>>(
        xp, rp, gyp, glp, dxp, drp, n, knots, range_limit);
  else
    rqs_grad_kernel<false><<<blocks(n), kThreads, 0, s>>>(
        xp, rp, gyp, glp, dxp, drp, n, knots, range_limit);
  return (int)cudaGetLastError();
}
