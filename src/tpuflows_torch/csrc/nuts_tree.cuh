// The device helpers of the NUTS tree code, shared by K1
// (nuts_transition.cu) and K2 (nuts_window.cu): log-sum-exp, the kinetic
// energy, the generalized U-turn test and a register copy, for one chain
// held by one warp in the lane layout of latent_grad.cuh. A fragment, not
// a self-contained header: each source includes it inside its anonymous
// namespace, after latent_grad.cuh (warp_sum), at the place where K1 once
// defined these functions, so K1 compiles from the same tokens as before.
#pragma once

__device__ __forceinline__ float logaddexp(float a, float b) {
  const float delta = a - b;
  if (isnan(delta)) return a + b;  // both -inf
  return fmaxf(a, b) + log1pf(expf(-fabsf(delta)));
}

template <int DPL>
__device__ __forceinline__ float kinetic(const float (&p)[DPL],
                                         const float (&im)[DPL]) {
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < DPL; ++j) s += p[j] * p[j] * im[j];
  return 0.5f * warp_sum(s);
}

// generalized U-turn: rho . M^-1 p <= 0 at either end
template <int DPL>
__device__ __forceinline__ bool is_turning(const float (&pl)[DPL],
                                           const float (&pr)[DPL],
                                           const float (&rho)[DPL],
                                           const float (&im)[DPL]) {
  float sl = 0.0f, sr = 0.0f;
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    const float v = rho[j] * im[j];
    sl += v * pl[j];
    sr += v * pr[j];
  }
  return warp_sum(sl) <= 0.0f || warp_sum(sr) <= 0.0f;
}

template <int DPL>
__device__ __forceinline__ void copy(float (&dst)[DPL],
                                     const float (&src)[DPL]) {
#pragma unroll
  for (int j = 0; j < DPL; ++j) dst[j] = src[j];
}
