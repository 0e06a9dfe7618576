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
// parameter. K4 (`rqs_eval_lanes_kernel`) and K5 (`rqs_grad_lanes_kernel`,
// both in rqs_lanes.cuh) give each element a group of L lanes that hold
// its bins (K4: one lane up to K = 8, its exponentials in registers), and
// stage each block's contiguous span of raw values in shared memory with
// 16-byte copies (K4 a warp's part at a time), so that their loads and
// stores are coalesced and each exponential (K5: and softplus) is
// computed once; the sums rqs_math.cuh orders are taken in its order and
// the bin's arithmetic is rounded as the one-thread kernels' is compiled,
// so their outputs equal those kernels' to the bit. Those one-thread kernels
// (`rqs_eval_kernel`, `rqs_grad_kernel`, entry points
// `rqs_eval_thread_f32`, `rqs_grad_thread_f32`: 3K-1 values read at a
// stride of 3K-1 floats, the exponentials recomputed in each walk over the
// knots) stay built as the oracles and yardsticks of `chip_smoke.py`, on
// no path.
//
// Bound on this card: bytes. At the fit's shape (1024 x 64 elements,
// K = 8) K4 moves 104 B per element and K5 200 B, 6.8 MB and 13.1 MB, 2-4
// us at 3.35 TB/s. A launch that only stages K4's inputs and stores x
// back takes 2.5 us with them in L2 and 4.1 us from device memory (PERF.md
// §6): launch, latency and the copy's rate, not the spline, set most of
// K4's time.

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

template <bool kInverse, int L, int E>
__global__ void __launch_bounds__(L * E)
    rqs_grad_lanes_kernel(const float* __restrict__ x,
                          const float* __restrict__ raw,
                          const float* __restrict__ gy,
                          const float* __restrict__ gl,
                          float* __restrict__ dx, float* __restrict__ draw,
                          long long n, int K, float B) {
  extern __shared__ float4 smem4[];
  tpuflows_rqs_lanes::grad_lanes<kInverse, L, E>(
      x, raw, gy, gl, dx, draw, n, K, B, reinterpret_cast<float*>(smem4));
}

template <bool kInverse, int L, int E>
__global__ void __launch_bounds__(L * E)
    rqs_eval_lanes_kernel(const float* __restrict__ x,
                          const float* __restrict__ raw,
                          float* __restrict__ y, float* __restrict__ ladj,
                          long long n, int K, float B) {
  extern __shared__ float4 smem4[];
  tpuflows_rqs_lanes::eval_lanes<kInverse, L, E>(
      x, raw, y, ladj, n, K, B, reinterpret_cast<float*>(smem4));
}

bool args_ok(long long n, int knots, float range_limit) {
  return n >= 0 && knots >= 2 && range_limit > 0.0f;
}

unsigned blocks(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

// One launch of a group kernel with L lanes an element and E elements a
// block over n elements, `floats` floats of dynamic shared memory a block
// (asked for above 48 KB).
template <int L, int E, class... P, class... A>
cudaError_t launch_groups(void (*kernel)(P...), int floats, long long n,
                          cudaStream_t s, A... args) {
  const long long nb = (n + E - 1) / E;
  if (nb >= (1LL << 31)) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * floats;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<(unsigned)nb, L * E, smem, s>>>(args...);
  return cudaGetLastError();
}

// a lane count and a block's elements as a type, for a generic lambda
template <int L, int E>
struct Group {
  static constexpr int lanes = L, elements = E;
};

// f(Group<L, E>()) for the plan of K knots (`plan_elements`: 256 / L
// elements a block below 32 lanes, 8, 4, 2 or 1 at 32), K5's where grad,
// else K4's; cudaErrorInvalidValue where no block fits the shared memory
template <int L = 1, class F>
cudaError_t with_plan(int K, bool grad, F f) {
  using namespace tpuflows_rqs_lanes;
  if constexpr (L < 32) {
    if ((grad ? lanes_for(K) : eval_lanes_for(K)) == L)
      return f(Group<L, block_elements(L)>());
    return with_plan<2 * L>(K, grad, f);
  } else {
    switch (plan_elements(K, grad)) {
      case 8: return f(Group<32, 8>());
      case 4: return f(Group<32, 4>());
      case 2: return f(Group<32, 2>());
      case 1: return f(Group<32, 1>());
      default: return cudaErrorInvalidValue;
    }
  }
}

}  // namespace

// Each returns a cudaError_t (0 = launched). n is the number of elements
// of x; raw holds 3 knots - 1 values per element after it. The Python
// wrapper checks device, dtype, shapes and contiguity before calling. Any
// pointer may sit at any 4-byte offset; the kernels copy 16 bytes at a
// time where they can.
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
  // L = eval_lanes_for(K): one lane only where K <= kEvalBinsPerLane,
  // the bins `walk_own` holds
  return (int)with_plan(knots, false, [&](auto group) {
    constexpr int L = decltype(group)::lanes, E = decltype(group)::elements;
    const int floats = tpuflows_rqs_lanes::eval_block_floats(knots, E);
    return inverse ? launch_groups<L, E>(rqs_eval_lanes_kernel<true, L, E>,
                                         floats, n, s, xp, rp, yp, lp, n,
                                         knots, range_limit)
                   : launch_groups<L, E>(rqs_eval_lanes_kernel<false, L, E>,
                                         floats, n, s, xp, rp, yp, lp, n,
                                         knots, range_limit);
  });
}

// The one-thread K4 (`rqs_eval_kernel`) that the group kernel replaced:
// chip_smoke.py's oracle and yardstick, on no path. Same arguments as
// rqs_eval_f32.
extern "C" int rqs_eval_thread_f32(const void* x, const void* raw, void* y,
                                   void* ladj, long long n, int knots,
                                   float range_limit, int inverse,
                                   void* stream) {
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

// K5:
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
  return (int)with_plan(knots, true, [&](auto group) {
    constexpr int L = decltype(group)::lanes, E = decltype(group)::elements;
    const int floats = tpuflows_rqs_lanes::block_floats(knots, E);
    return inverse ? launch_groups<L, E>(rqs_grad_lanes_kernel<true, L, E>,
                                         floats, n, s, xp, rp, gyp, glp,
                                         dxp, drp, n, knots, range_limit)
                   : launch_groups<L, E>(rqs_grad_lanes_kernel<false, L, E>,
                                         floats, n, s, xp, rp, gyp, glp,
                                         dxp, drp, n, knots, range_limit);
  });
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
