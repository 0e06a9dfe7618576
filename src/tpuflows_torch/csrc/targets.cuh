// The targets' log densities and their gradients on the device, one warp
// per row: lane l holds dims l + 32 j (j < DPL) of x, and the lanes at or
// past the target's width a.dim hold zeros and get a gradient of exactly
// 0. One function per closed-form target of the port (targets/), each
// reading its parameters from one packed float buffer, a.target, that
// kernels/nuts_cuda.py `pack_target` writes (its layout is given at each
// function; every d-wide vector is padded with neutral values to the lane
// width a.d); `target_logp_grad` dispatches on a.kind. The plain PyTorch
// mirror is `nuts_cuda.packed_log_density`, which reads the same buffer.
//
// Every product, sum and quotient is rounded as written (__fmaf_rn,
// __fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn), so that a function gives
// the same bits wherever it is inlined: K2's carried gradient (a leaf's)
// equals K1's start gradient at the same point only so (ROADMAP Queue 2's
// invariant: K2 equals chained K1 launches to the bit). Constants that do
// not depend on x (log normalisers) come precomputed in float64 on the
// host, rounded once to float32.
//
// A fragment, not a self-contained header: latent_grad.cuh includes it
// inside its anonymous namespace, after warp_sum and Args.
#pragma once

// a.kind (kernels/nuts_cuda.py TARGET_KIND)
enum TargetKind {
  kStdNormal = 0,
  kDiagNormal = 1,
  kCorrelated = 2,
  kMixture = 3,
  kFunnel = 4,
  kHierarchical = 5,
  kBanana = 6,
  kRosenbrock = 7,
  kCauchy = 8,
  kTargetKinds = 9
};

// log(exp(p) + exp(q)) as torch.logaddexp computes it
__device__ __forceinline__ float target_logaddexp(float p, float q) {
  const float m = fmaxf(p, q);
  if (isinf(m) && p == q) return p;
  return __fadd_rn(m, log1pf(expf(-fabsf(__fsub_rn(p, q)))));
}

// Each function is written once over the row's views (latent_grad.cuh
// `InRegs`, `InMem`): x and g are the lane's elements j < x.count(a) of
// the row, dim lane + 32 j, in registers for the per-warp and tile
// kernels, in memory for the wide units (wide_grad.cuh), which so compute
// the same operations in the same order at any lane width.

// N(0, I): [c0 = -dim log(2 pi) / 2]
template <class X, class G>
__device__ __noinline__ float std_normal_logp_grad(const Args& a, X x, G g,
                                                   int lane) {
  const int n = x.count(a);
  float sq = 0.0f;
#pragma unroll
  for (int j = 0; j < n; ++j) {
    const float xj = x[j];
    sq = __fmaf_rn(xj, xj, sq);
    g[j] = -xj;
  }
  sq = warp_sum(sq);
  return __fadd_rn(__fmul_rn(-0.5f, sq), __ldg(a.target));
}

// N(loc, diag(scale^2)): [c0, loc (a.d, 0 past dim), scale (a.d, 1 past
// dim)], c0 = -sum log scale - dim log(2 pi) / 2
template <class X, class G>
__device__ __noinline__ float diag_normal_logp_grad(const Args& a, X x, G g,
                                                    int lane) {
  const float* loc = a.target + 1;
  const float* scale = loc + a.d;
  const int n = x.count(a);
  float sq = 0.0f;
#pragma unroll
  for (int j = 0; j < n; ++j) {
    const int i = lane + 32 * j;
    const float s = __ldg(scale + i);
    const float z = __fdiv_rn(__fsub_rn(x[j], __ldg(loc + i)), s);
    sq = __fmaf_rn(z, z, sq);
    g[j] = -__fdiv_rn(z, s);
  }
  sq = warp_sum(sq);
  return __fadd_rn(__fmul_rn(-0.5f, sq), __ldg(a.target));
}

// N(loc, Sigma) through its precision P = Sigma^-1: g = -P (x - loc),
// lp = c0 - (x - loc) . P (x - loc) / 2. [c0, loc (a.d), P (a.d x a.d,
// zero past dim)], c0 = -sum log diag chol - dim log(2 pi) / 2. P is read
// from global memory (L2) one row per dim k, every lane its own dims'
// columns (P is symmetric), x_k - loc_k broadcast from its lane: d^2
// products per row; for each of the lane's dims j in turn, the sum over
// k ascending, then its term of the quadratic form.
template <class X, class G>
__device__ __noinline__ float correlated_logp_grad(const Args& a, X x, G g,
                                                   int lane) {
  const float* loc = a.target + 1;
  const float* P = loc + a.d;
  const int n = x.count(a);
  float quad = 0.0f;
#pragma unroll
  for (int j = 0; j < n; ++j) {
    float pr = 0.0f;
#pragma unroll
    for (int jk = 0; jk < n; ++jk) {
      const int kn = min(32, a.dim - 32 * jk);  // uniform over the warp
      const float r_own = __fsub_rn(x[jk], __ldg(loc + lane + 32 * jk));
      for (int src = 0; src < kn; ++src) {
        const float rk = __shfl_sync(kFull, r_own, src);
        pr = __fmaf_rn(
            __ldg(P + (size_t)(32 * jk + src) * a.d + lane + 32 * j), rk, pr);
      }
    }
    const float r = __fsub_rn(x[j], __ldg(loc + lane + 32 * j));
    quad = __fmaf_rn(r, pr, quad);
    g[j] = -pr;
  }
  quad = warp_sum(quad);
  return __fadd_rn(__fmul_rn(-0.5f, quad), __ldg(a.target));
}

// component k of a mixture at the lane's dims: its log weight plus its
// normal's log density
template <class X>
__device__ __forceinline__ float mixture_component(const Args& a,
                                                   const float* lw,
                                                   const float* mean,
                                                   const float* scale, int k,
                                                   X x, int lane) {
  const int n = x.count(a);
  float sq = 0.0f;
#pragma unroll
  for (int j = 0; j < n; ++j) {
    const size_t o = (size_t)k * a.d + lane + 32 * j;
    const float z = __fdiv_rn(__fsub_rn(x[j], __ldg(mean + o)),
                              __ldg(scale + o));
    sq = __fmaf_rn(z, z, sq);
  }
  sq = warp_sum(sq);
  return __fadd_rn(__fmul_rn(-0.5f, sq), __ldg(lw + k));
}

// sum_k w_k N(mean_k, diag(scale_k^2)): lp = logsumexp_k comp_k, with
// torch.logsumexp's shift (the max, 0 where it is infinite), and g =
// sum_k softmax(comp)_k (-z_k / scale_k), z_k = (x - mean_k) / scale_k.
// [K, lw (K), means (K x a.d, 0 past dim), scales (K x a.d, 1 past dim)],
// lw_k = log w_k - sum log scale_k - dim log(2 pi) / 2. Three passes over
// the components, each recomputing comp_k and z_k (K is not bounded, so
// nothing is kept per component).
template <class X, class G>
__device__ __noinline__ float mixture_logp_grad(const Args& a, X x, G g,
                                                int lane) {
  const int K = (int)__ldg(a.target);
  const float* lw = a.target + 1;
  const float* mean = lw + K;
  const float* scale = mean + (size_t)K * a.d;
  const int n = x.count(a);
  float m = -INFINITY;
  for (int k = 0; k < K; ++k)
    m = fmaxf(m, mixture_component(a, lw, mean, scale, k, x, lane));
  if (isinf(m)) m = 0.0f;
  float s = 0.0f;
  for (int k = 0; k < K; ++k)
    s = __fadd_rn(s, expf(__fsub_rn(
        mixture_component(a, lw, mean, scale, k, x, lane), m)));
  const float lp = __fadd_rn(logf(s), m);
#pragma unroll
  for (int j = 0; j < n; ++j) g[j] = 0.0f;
  for (int k = 0; k < K; ++k) {
    const float w = expf(__fsub_rn(
        mixture_component(a, lw, mean, scale, k, x, lane), lp));
#pragma unroll
    for (int j = 0; j < n; ++j) {
      const size_t o = (size_t)k * a.d + lane + 32 * j;
      const float sc = __ldg(scale + o);
      const float z = __fdiv_rn(__fsub_rn(x[j], __ldg(mean + o)), sc);
      g[j] = __fmaf_rn(w, -__fdiv_rn(z, sc), g[j]);
    }
  }
  return lp;
}

// Neal's funnel, v = x[0] ~ N(0, sigma_v^2), x[1:] | v ~ N(0, exp(v) I):
// [sigma_v, log sigma_v (for the plain mirror; this reads sigma_v)]. With plain operators the compiler fused its products into
// FMAs differently at a tree's start and at its leaves, so that K2's
// carried gradient (a leaf's) parted from K1's at the same point (its
// start) at rounding level, and the ceiling window's draws by up to
// 2.4e-4 from K1's in one transition; rounded as written, K2 equals
// chained K1 launches to the bit on every flow. Not inlining it did that
// too, but cost K1's tile kernel 5-20% (PERF.md), so it stays inlined.
template <class X, class G>
__device__ float funnel_logp_grad(const Args& a, X x, G g, int lane) {
  const int n = x.count(a);
  float sq = 0.0f;
#pragma unroll
  for (int j = 0; j < n; ++j)
    if (lane + 32 * j != 0) sq = __fmaf_rn(x[j], x[j], sq);
  sq = warp_sum(sq);
  const float v = __shfl_sync(kFull, x[0], 0);
  const float sv = __ldg(a.target);
  const float hk = 0.5f * (float)(a.dim - 1);
  const float env = expf(-v);
  const float vs = v / sv;
  const float hse = __fmul_rn(__fmul_rn(0.5f, sq), env);
  const float lp_v = __fsub_rn(
      __fsub_rn(__fmul_rn(__fmul_rn(-0.5f, vs), vs), logf(sv)),
      0.5f * kLog2Pi);
  const float lp_rest =
      __fsub_rn(__fsub_rn(-hse, __fmul_rn(hk, v)), __fmul_rn(hk, kLog2Pi));
  const float gv = __fsub_rn(__fadd_rn(-v / __fmul_rn(sv, sv), hse), hk);
#pragma unroll
  for (int j = 0; j < n; ++j)
    g[j] = (lane + 32 * j == 0) ? gv : __fmul_rn(-x[j], env);
  return __fadd_rn(lp_v, lp_rest);
}

// The hierarchical Gaussian, x = [mu, log_tau, theta_1..theta_J] (J =
// dim - 2): mu ~ N(0, s_mu^2), log_tau ~ N(0, 1), theta_i ~ N(mu, tau^2),
// y_i ~ N(theta_i, noise^2). [c0, s_mu, noise, y (a.d: y_k at dim k + 2,
// zeros elsewhere)], c0 = -log s_mu - J log noise - (J + 1) log(2 pi).
// mu and log_tau are broadcast from lanes 0 and 1. exp(-2 log_tau)
// overflows to inf at log_tau < -44: lp is then -inf (or NaN) and the
// leaf diverges, as in the JAX math; lanes past dim are selected out,
// never multiplied by it.
template <class X, class G>
__device__ __noinline__ float hierarchical_logp_grad(const Args& a, X x,
                                                     G g, int lane) {
  const float c0 = __ldg(a.target);
  const float s_mu = __ldg(a.target + 1);
  const float noise = __ldg(a.target + 2);
  const float* y = a.target + 3;
  const int n = x.count(a);
  const float mu = __shfl_sync(kFull, x[0], 0);
  const float lt = __shfl_sync(kFull, x[0], 1);
  const float e2 = expf(__fmul_rn(-2.0f, lt));
  const float n2 = __fmul_rn(noise, noise);
  float st = 0.0f, sy = 0.0f, sd = 0.0f;
#pragma unroll
  for (int j = 0; j < n; ++j) {
    const int i = lane + 32 * j;
    if (i >= 2 && i < a.dim) {
      const float dt = __fsub_rn(x[j], mu);
      const float dy = __fsub_rn(__ldg(y + i), x[j]);
      st = __fmaf_rn(dt, dt, st);
      sy = __fmaf_rn(dy, dy, sy);
      sd = __fadd_rn(sd, dt);
    }
  }
  st = warp_sum(st);
  sy = warp_sum(sy);
  sd = warp_sum(sd);
  const float J = (float)(a.dim - 2);
  const float ms = __fdiv_rn(mu, s_mu);
  float lp = __fadd_rn(c0, __fmul_rn(__fmul_rn(-0.5f, ms), ms));
  lp = __fadd_rn(lp, __fmul_rn(__fmul_rn(-0.5f, lt), lt));
  lp = __fadd_rn(lp, __fmul_rn(__fmul_rn(-0.5f, st), e2));
  lp = __fsub_rn(lp, __fmul_rn(J, lt));
  lp = __fadd_rn(lp, __fmul_rn(-0.5f, __fdiv_rn(sy, n2)));
  const float g_mu = __fadd_rn(-__fdiv_rn(ms, s_mu), __fmul_rn(e2, sd));
  const float g_lt = __fsub_rn(__fadd_rn(-lt, __fmul_rn(st, e2)), J);
#pragma unroll
  for (int j = 0; j < n; ++j) {
    const int i = lane + 32 * j;
    float gi = 0.0f;
    if (i == 0) {
      gi = g_mu;
    } else if (i == 1) {
      gi = g_lt;
    } else if (i < a.dim) {
      const float dt = __fsub_rn(x[j], mu);
      const float dy = __fsub_rn(__ldg(y + i), x[j]);
      gi = __fadd_rn(__fmul_rn(-dt, e2), __fdiv_rn(dy, n2));
    }
    g[j] = gi;
  }
  return lp;
}

// The banana: z ~ N(0, diag(s1^2, 1, ..)) twisted as x1 = z1 + b (x0^2 -
// s1^2) (unit Jacobian). [c0, b, s1], c0 = -log s1 - dim log(2 pi) / 2.
template <class X, class G>
__device__ __noinline__ float banana_logp_grad(const Args& a, X x, G g,
                                               int lane) {
  const float b = __ldg(a.target + 1);
  const float s1 = __ldg(a.target + 2);
  const int n = x.count(a);
  const float x0 = __shfl_sync(kFull, x[0], 0);
  const float x1 = __shfl_sync(kFull, x[0], 1);
  const float z1 = __fsub_rn(
      x1, __fmul_rn(b, __fsub_rn(__fmul_rn(x0, x0), __fmul_rn(s1, s1))));
  const float u = __fdiv_rn(x0, s1);
  float sq = 0.0f;
#pragma unroll
  for (int j = 0; j < n; ++j)
    if (lane + 32 * j >= 2) sq = __fmaf_rn(x[j], x[j], sq);
  sq = warp_sum(sq);
  const float quad = __fadd_rn(
      __fadd_rn(__fmul_rn(u, u), __fmul_rn(z1, z1)), sq);
  const float g0 = __fadd_rn(-__fdiv_rn(u, s1),
                             __fmul_rn(__fmul_rn(__fmul_rn(2.0f, b), x0), z1));
#pragma unroll
  for (int j = 0; j < n; ++j) {
    const int i = lane + 32 * j;
    g[j] = i == 0 ? g0 : i == 1 ? -z1 : -x[j];
  }
  return __fadd_rn(__fmul_rn(-0.5f, quad), __ldg(a.target));
}

// Rosenbrock over the (even, odd) pairs: x_2i ~ N(mu, s1^2), x_2i+1 |
// x_2i ~ N(x_2i^2, s2^2); dim even, so a pair never straddles two
// elements j and its partner is the neighbouring lane. [c0, mu, s1, s2],
// c0 = -(dim / 2) (log s1 + log s2) - dim log(2 pi) / 2.
template <class X, class G>
__device__ __noinline__ float rosenbrock_logp_grad(const Args& a, X x, G g,
                                                   int lane) {
  const float mu = __ldg(a.target + 1);
  const float s1 = __ldg(a.target + 2);
  const float s2 = __ldg(a.target + 3);
  const int n = x.count(a);
  const bool even = (lane & 1) == 0;
  float quad = 0.0f;
#pragma unroll
  for (int j = 0; j < n; ++j) {
    const float xj = x[j];
    const float other = __shfl_xor_sync(kFull, xj, 1);
    const float xe = even ? xj : other;
    const float xo = even ? other : xj;
    const float u = __fdiv_rn(__fsub_rn(xe, mu), s1);
    const float t = __fdiv_rn(__fsub_rn(xo, __fmul_rn(xe, xe)), s2);
    const bool on = lane + 32 * j - (lane & 1) < a.dim;
    if (on && even)
      quad = __fadd_rn(quad, __fadd_rn(__fmul_rn(u, u), __fmul_rn(t, t)));
    g[j] = !on ? 0.0f
         : even ? __fadd_rn(-__fdiv_rn(u, s1),
                            __fdiv_rn(__fmul_rn(__fmul_rn(2.0f, xe), t), s2))
                : -__fdiv_rn(t, s2);
  }
  quad = warp_sum(quad);
  return __fadd_rn(__fmul_rn(-0.5f, quad), __ldg(a.target));
}

// -log1p(z^2) of a Cauchy at z = (x - loc) / s, and its x-derivative
__device__ __forceinline__ float cauchy_term(float x, float loc, float s,
                                             float& dx) {
  const float z = __fdiv_rn(__fsub_rn(x, loc), s);
  const float zz = __fmul_rn(z, z);
  dx = -__fdiv_rn(__fmul_rn(2.0f, z), __fmul_rn(s, __fadd_rn(1.0f, zz)));
  return -log1pf(zz);
}

// The multimodal Cauchy: dims 0 and 1 each 1/2 Cauchy(-mu, s) + 1/2
// Cauchy(mu, s) (a logaddexp), the rest Cauchy(0, s). [c0, mu, s], c0 =
// -dim log(pi s) - min(dim, 2) log 2.
template <class X, class G>
__device__ __noinline__ float cauchy_logp_grad(const Args& a, X x, G g,
                                               int lane) {
  const float mu = __ldg(a.target + 1);
  const float s = __ldg(a.target + 2);
  const int n = x.count(a);
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < n; ++j) {
    const int i = lane + 32 * j;
    float gi = 0.0f;
    if (i < 2 && i < a.dim) {
      float gm, gp;
      const float tm = cauchy_term(x[j], -mu, s, gm);
      const float tp = cauchy_term(x[j], mu, s, gp);
      const float t = target_logaddexp(tm, tp);
      gi = __fadd_rn(__fmul_rn(expf(__fsub_rn(tm, t)), gm),
                     __fmul_rn(expf(__fsub_rn(tp, t)), gp));
      sum = __fadd_rn(sum, t);
    } else if (i < a.dim) {
      sum = __fadd_rn(sum, cauchy_term(x[j], 0.0f, s, gi));
    }
    g[j] = gi;
  }
  sum = warp_sum(sum);
  return __fadd_rn(sum, __ldg(a.target));
}

// log p(x) of the target a.kind names and its gradient g (x and g
// distinct); 0 past a.dim. Built with TARGETS_FUNNEL_ONLY (K1's and K3's
// funnel units, which their entry points launch for a funnel), the
// funnel's alone: the eight other kinds' calls, though never taken for a
// funnel, cost K1's and K3's tile kernels 3-6% there (PERF.md,
// scripts/target_dispatch_ab.py).
template <class X, class G>
__device__ __forceinline__ float row_target_logp_grad(const Args& a, X x,
                                                      G g, int lane) {
#ifdef TARGETS_FUNNEL_ONLY
  return funnel_logp_grad(a, x, g, lane);
#else
  switch (a.kind) {
    case kFunnel: return funnel_logp_grad(a, x, g, lane);
    case kStdNormal: return std_normal_logp_grad(a, x, g, lane);
    case kDiagNormal: return diag_normal_logp_grad(a, x, g, lane);
    case kCorrelated: return correlated_logp_grad(a, x, g, lane);
    case kMixture: return mixture_logp_grad(a, x, g, lane);
    case kHierarchical: return hierarchical_logp_grad(a, x, g, lane);
    case kBanana: return banana_logp_grad(a, x, g, lane);
    case kRosenbrock: return rosenbrock_logp_grad(a, x, g, lane);
    default: return cauchy_logp_grad(a, x, g, lane);
  }
#endif
}

// the same on a row in registers (the per-warp and tile kernels)
template <int DPL>
__device__ __forceinline__ float target_logp_grad(const Args& a,
                                                  const float (&x)[DPL],
                                                  float (&g)[DPL],
                                                  int lane) {
  return row_target_logp_grad(a, InRegs<DPL, const float>{x},
                              InRegs<DPL>{g}, lane);
}
