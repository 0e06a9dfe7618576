// What K6 and K7's tile kernels (coupling_tile.cu) and their wide unit
// (coupling_wide.cu) share: the cluster's split of a layer's units, the
// blocks of a product's sums, and the conditioner's activations and bf16
// rounding, so that the two compute each value with the same code.
#pragma once

#include <cuda_bf16.h>
#include <math.h>

namespace tpuflows_coupling {

constexpr int kCluster = 2;    // CTAs of a cluster, over a tile
constexpr int kSumBlock = 16;  // terms of a partial sum

// the units of a layer of w that each CTA of a cluster computes
__host__ __device__ inline int slice_width(int w) {
  return (w + kCluster - 1) / kCluster;
}

enum Activation { kSilu = 0, kTanh = 1, kRelu = 2, kGelu = 3 };
// jax.nn.gelu's default, the tanh approximation
constexpr float kGeluK0 = 0.7978845608028654f;  // sqrt(2 / pi)
constexpr float kGeluK1 = 0.044715f;

__device__ __forceinline__ float activate(float a, int act) {
  if (act == kSilu) return a / (1.0f + expf(-a));
  if (act == kTanh) return tanhf(a);
  if (act == kGelu)
    return 0.5f * a * (1.0f + tanhf(kGeluK0 * (a + kGeluK1 * a * a * a)));
  return a > 0.0f ? a : 0.0f;
}

// d act / da, as torch's (and jax.grad's) silu, tanh, relu and gelu give it
__device__ __forceinline__ float activate_grad(float a, int act) {
  if (act == kSilu) {
    const float s = 1.0f / (1.0f + expf(-a));
    return s * (1.0f + a * (1.0f - s));
  }
  if (act == kTanh) {
    const float t = tanhf(a);
    return 1.0f - t * t;
  }
  if (act == kGelu) {
    const float t = tanhf(kGeluK0 * (a + kGeluK1 * a * a * a));
    return 0.5f * (1.0f + t) + 0.5f * a * (1.0f - t * t) * kGeluK0 *
                                   (1.0f + 3.0f * kGeluK1 * a * a);
  }
  return a > 0.0f ? 1.0f : 0.0f;
}

// x rounded to the nearest bfloat16 (ties to even), held as a float
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// a layer input (or an input's cotangent) as a bf16 conditioner rounds
// it; K6 and K7's pass 1 take kBf16 as a template argument, so that their
// float32 instantiations hold none of the rounding
template <bool kBf16>
__device__ __forceinline__ float operand(float x) {
  if constexpr (kBf16) return bf16_round(x);
  return x;
}

}  // namespace tpuflows_coupling
