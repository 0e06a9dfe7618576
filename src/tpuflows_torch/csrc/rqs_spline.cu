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
// Design: one thread per element of x, reading its 3K-1 raw values in the
// conditioner's own (N, d, 3K-1) layout (the Pallas wrapper's relayout to
// (P, M, 128) tiles exists for the TPU's lanes and is not copied). Forward
// and inverse are a template parameter. Bound on this card: bytes. At the
// fit's shape (1024 x 64 elements, K = 8) K4 moves 104 B per element and
// K5 200 B, 6.8 MB and 13.1 MB, 2-4 us at 3.35 TB/s: both are expected to
// be launch-bound there.

#include <cuda_runtime.h>

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

bool args_ok(long long n, int knots, float range_limit) {
  return n >= 0 && knots >= 2 && knots <= kMaxKnots && range_limit > 0.0f;
}

unsigned blocks(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// Each returns a cudaError_t (0 = launched). n is the number of elements
// of x; raw holds 3 knots - 1 values per element after it. The Python
// wrapper checks device, dtype, shapes and contiguity before calling.
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
  if (inverse)
    rqs_grad_kernel<true><<<blocks(n), kThreads, 0, s>>>(
        xp, rp, gyp, glp, dxp, drp, n, knots, range_limit);
  else
    rqs_grad_kernel<false><<<blocks(n), kThreads, 0, s>>>(
        xp, rp, gyp, glp, dxp, drp, n, knots, range_limit);
  return (int)cudaGetLastError();
}
