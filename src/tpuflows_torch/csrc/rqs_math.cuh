// Rational-quadratic spline math for one element, as __device__ functions:
// the knot normalisation, the bin select, the forward and inverse
// evaluation with exact log-derivative, and the pullback of each, written
// out by hand.
//
// Shared by K4/K5 (rqs_spline.cu), K6/K7 (coupling_block.cu) and the
// latent gradient of K1 and K3 (latent_grad.cuh). It computes what the Pallas tile math of
// src/tpuflows/kernels/rqs_pallas.py computes: `_normalize_tiles` (:53),
// `_select_bin_params` (:96), `_fwd_tile_math` (:118), `_inv_tile_math`
// (:136), and what `jax.vjp` of those functions returns. The plain PyTorch
// version is `_fwd_tile_math` / `_inv_tile_math` in kernels/rqs_cuda.py
// with torch.autograd; tests/test_torch_rqs.py mirrors the pullbacks below
// line by line in torch and holds them against autograd.
//
// An element's 3K-1 raw values are read as r[p * st], p < 3K-1: K widths,
// K heights, K-1 interior derivatives. K4/K5 pass the conditioner's own
// (N, d, 3K-1) layout (st = 1); K1 passes its p-major shared-memory head
// (st = d). Nothing is kept in arrays: the knots are walked in one running
// pass, so the math needs a few dozen registers for any K.
//
// The reverse-mode rules that JAX applies at ties are kept: a value equal
// to a bound of jnp.clip (or to the 0 of jnp.maximum) passes half of its
// cotangent. Outside [-B, B] the map is the identity, the raw values get a
// zero cotangent, and no value of the branch not taken is computed.
#pragma once

#include <math.h>

namespace tpuflows_rqs {

// the knots the earlier K6/K7 take (coupling_block.cu); every other
// kernel takes any K
constexpr int kMaxKnots = 64;
constexpr float kMinBin = 1e-3f;
constexpr float kMinDeriv = 1e-3f;
constexpr float kSoftplusUnit = 0.5413248546129181f;  // softplus(U) = 1

// min_bin + (1 - min_bin K) * softmax: the factor is formed in double and
// rounded once, as the Python float of the tile math is
__device__ __forceinline__ float bin_scale(int K) {
  return (float)(1.0 - 1e-3 * K);
}

// jax.nn.softplus = logaddexp(x, 0); its derivative is exp(x - softplus)
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// d clip(v, lo, hi) / dv under JAX's rules: 1 inside, 1/2 on a bound
__device__ __forceinline__ float clip_grad(float v, float lo, float hi) {
  if (v > lo && v < hi) return 1.0f;
  return (v == lo || v == hi) ? 0.5f : 0.0f;
}

// softmax state of widths and heights: max, and 1 / sum exp(raw - max)
struct Norm {
  float mw, iw, mh, ih;
};

__device__ __forceinline__ Norm normalize(const float* r, int st, int K) {
  float mw = r[0], mh = r[K * st];
  for (int k = 1; k < K; ++k) {
    mw = fmaxf(mw, r[k * st]);
    mh = fmaxf(mh, r[(K + k) * st]);
  }
  float tw = 0.0f, th = 0.0f;
  for (int k = 0; k < K; ++k) {
    tw += expf(r[k * st] - mw);
    th += expf(r[(K + k) * st] - mh);
  }
  Norm n;
  n.mw = mw;
  n.iw = 1.0f / tw;
  n.mh = mh;
  n.ih = 1.0f / th;
  return n;
}

// the bin holding t and its parameters; b is its index
struct Bin {
  float x0, w, y0, h, d0, d1;
  int b;
};

// Running select over the knots (`_select_bin_params`): bin k is taken
// when t >= knot k, the last such k wins; the search walks yk when kByY.
// Knot k + 1 = knot k + 2B width k, with the end knot pinned to B.
template <bool kByY>
__device__ __forceinline__ Bin select_bin(float t, const float* r, int st,
                                          int K, float B, const Norm& n) {
  const float cw = bin_scale(K);
  const float two_b = 2.0f * B;
  const float* rd = r + 2 * K * st;
  float xk = -B, yk = -B, dk = 1.0f;
  Bin bin;
  for (int k = 0; k < K; ++k) {
    const bool last = k == K - 1;
    const float wk = kMinBin + cw * (expf(r[k * st] - n.mw) * n.iw);
    const float hk = kMinBin + cw * (expf(r[(K + k) * st] - n.mh) * n.ih);
    const float xn = last ? B : xk + two_b * wk;
    const float yn = last ? B : yk + two_b * hk;
    const float dn =
        last ? 1.0f : kMinDeriv + softplus(rd[k * st] + kSoftplusUnit);
    if (k == 0 || t >= (kByY ? yk : xk)) {
      bin.x0 = xk;
      bin.w = xn - xk;
      bin.y0 = yk;
      bin.h = yn - yk;
      bin.d0 = dk;
      bin.d1 = dn;
      bin.b = k;
    }
    xk = xn;
    yk = yn;
    dk = dn;
  }
  return bin;
}

// Forward spline x -> (y, log|dy/dx|).
__device__ __forceinline__ void rqs_forward(float x, const float* r, int st,
                                            int K, float B, float& y,
                                            float& ladj) {
  if (!(fabsf(x) <= B)) {
    y = x;
    ladj = 0.0f;
    return;
  }
  const Norm n = normalize(r, st, K);
  const Bin bn = select_bin<false>(x, r, st, K, B, n);
  const float s = bn.h / bn.w;
  const float xi = (x - bn.x0) / bn.w;
  const float xi1m = 1.0f - xi;
  const float q = xi * xi1m;
  const float denom = s + (bn.d1 + bn.d0 - 2.0f * s) * q;
  y = bn.y0 + bn.h * (s * xi * xi + bn.d0 * q) / denom;
  const float num =
      s * s * (bn.d1 * xi * xi + 2.0f * s * q + bn.d0 * xi1m * xi1m);
  ladj = logf(num) - 2.0f * logf(denom);
}

// The stable root of the inverse (Durkan et al. eqs. 25-29), unclipped.
struct InvRoot {
  float s, dy, t, a, bq, c, disc_raw, sq, den, xi_raw, xi;
};

__device__ __forceinline__ InvRoot inverse_root(float y, const Bin& bn) {
  InvRoot v;
  v.s = bn.h / bn.w;
  v.dy = y - bn.y0;
  v.t = bn.d1 + bn.d0 - 2.0f * v.s;
  v.a = bn.h * (v.s - bn.d0) + v.dy * v.t;
  v.bq = bn.h * bn.d0 - v.dy * v.t;
  v.c = -v.s * v.dy;
  v.disc_raw = v.bq * v.bq - 4.0f * v.a * v.c;
  v.sq = sqrtf(fmaxf(v.disc_raw, 0.0f));  // roundoff guard at bin edges
  v.den = -v.bq - v.sq;
  v.xi_raw = 2.0f * v.c / v.den;
  v.xi = fminf(fmaxf(v.xi_raw, 0.0f), 1.0f);
  return v;
}

// Inverse spline y -> (x, log|dx/dy|).
__device__ __forceinline__ void rqs_inverse(float y, const float* r, int st,
                                            int K, float B, float& x,
                                            float& ladj) {
  if (!(fabsf(y) <= B)) {
    x = y;
    ladj = 0.0f;
    return;
  }
  const Norm n = normalize(r, st, K);
  const Bin bn = select_bin<true>(y, r, st, K, B, n);
  const InvRoot v = inverse_root(y, bn);
  const float xi = v.xi, s = v.s;
  x = bn.x0 + bn.w * xi;
  const float xi1m = 1.0f - xi;
  const float q = xi * xi1m;
  const float denom = s + v.t * q;
  const float num =
      s * s * (bn.d1 * xi * xi + 2.0f * s * q + bn.d0 * xi1m * xi1m);
  ladj = 2.0f * logf(denom) - logf(num);
}

// Pulls the cotangents of the bin's parameters (x0, w, y0, h, d0, d1) back
// through the knots, the softmaxes and the softpluses to the raw values,
// and writes them to draw[p * dst], p < 3K-1. `draw` may alias `r` (K1
// writes the cotangents over its raw head): r[p] is read only before
// draw[p] is written.
//
// Knot k (0 < k < K) is -B + 2B (width 0 + ... + width k-1); knots 0 and K
// are constants, so width i gets 2B times the cotangents of knots i+1..K-1
// and the last width none. Only knots b and b+1 have a cotangent, so the
// cotangent of the softmax output is constant below b, another value at
// b and 0 above, and the softmax pullback sm_i (g_i - sum_j sm_j g_j)
// needs two partial sums.
__device__ __forceinline__ void knots_vjp(const float* r, int st, int K,
                                          float B, const Norm& n,
                                          const Bin& bn, float g_x0,
                                          float g_w, float g_y0, float g_h,
                                          float g_d0, float g_d1,
                                          float* draw, int dst) {
  const int b = bn.b;
  const bool inner = b + 1 < K;  // knot b+1 is not the pinned end
  const float gxb = g_x0 - g_w, gxn = inner ? g_w : 0.0f;
  const float gyb = g_y0 - g_h, gyn = inner ? g_h : 0.0f;
  float sw_lt = 0.0f, sh_lt = 0.0f, sw_b = 0.0f, sh_b = 0.0f;
  for (int i = 0; i <= b; ++i) {
    const float sw = expf(r[i * st] - n.mw) * n.iw;
    const float sh = expf(r[(K + i) * st] - n.mh) * n.ih;
    if (i < b) {
      sw_lt += sw;
      sh_lt += sh;
    } else {
      sw_b = sw;
      sh_b = sh;
    }
  }
  const float c2 = bin_scale(K) * 2.0f * B;
  const float dot_w = c2 * (gxb * sw_lt + gxn * (sw_lt + sw_b));
  const float dot_h = c2 * (gyb * sh_lt + gyn * (sh_lt + sh_b));
  for (int i = 0; i < K; ++i) {
    const float sw = expf(r[i * st] - n.mw) * n.iw;
    const float sh = expf(r[(K + i) * st] - n.mh) * n.ih;
    const float gsw = c2 * ((i < b ? gxb : 0.0f) + (i <= b ? gxn : 0.0f));
    const float gsh = c2 * ((i < b ? gyb : 0.0f) + (i <= b ? gyn : 0.0f));
    draw[i * dst] = sw * (gsw - dot_w);
    draw[(K + i) * dst] = sh * (gsh - dot_h);
  }
  // interior derivative k (0 < k < K) = min_deriv + softplus(raw + U)
  for (int k = 1; k < K; ++k) {
    const float u = r[(2 * K + k - 1) * st] + kSoftplusUnit;
    const float gd = (k == b ? g_d0 : 0.0f) + (k == b + 1 ? g_d1 : 0.0f);
    draw[(2 * K + k - 1) * dst] = gd * expf(u - softplus(u));
  }
}

__device__ __forceinline__ void zero_draw(float* draw, int dst, int K) {
  for (int p = 0; p < 3 * K - 1; ++p) draw[p * dst] = 0.0f;
}

// Pullback of rqs_forward: (gy, gl) -> (dx, draw).
__device__ __forceinline__ void rqs_forward_vjp(float x, const float* r,
                                                int st, int K, float B,
                                                float gy, float gl,
                                                float& dx, float* draw,
                                                int dst) {
  if (!(fabsf(x) <= B)) {
    dx = gy;
    zero_draw(draw, dst, K);
    return;
  }
  const Norm n = normalize(r, st, K);
  const Bin bn = select_bin<false>(x, r, st, K, B, n);
  const float h = bn.h, w = bn.w, d0 = bn.d0, d1 = bn.d1;
  const float s = h / w;
  const float xi = (x - bn.x0) / w;
  const float xi1m = 1.0f - xi;
  const float q = xi * xi1m;
  const float t = d1 + d0 - 2.0f * s;
  const float denom = s + t * q;
  const float A = s * xi * xi + d0 * q;
  const float hA = h * A;
  const float C = d1 * xi * xi + 2.0f * s * q + d0 * xi1m * xi1m;
  const float num = s * s * C;
  // y = y0 + h A / denom
  const float g_y0 = gy;
  const float g_hA = gy / denom;
  float g_denom = -g_hA * (hA / denom);
  float g_h = g_hA * A;
  const float g_A = g_hA * h;
  // ladj = log(num) - 2 log(denom), num = s^2 C
  const float g_num = gl / num;
  g_denom -= 2.0f * gl / denom;
  float g_s = g_num * 2.0f * s * C;
  const float g_C = g_num * s * s;
  float g_d1 = g_C * xi * xi;
  float g_xi = g_C * 2.0f * d1 * xi;
  g_s += g_C * 2.0f * q;
  float g_q = g_C * 2.0f * s;
  float g_d0 = g_C * xi1m * xi1m;
  float g_xi1m = g_C * 2.0f * d0 * xi1m;
  // A = s xi^2 + d0 q
  g_s += g_A * xi * xi;
  g_xi += g_A * 2.0f * s * xi;
  g_d0 += g_A * q;
  g_q += g_A * d0;
  // denom = s + t q, t = d1 + d0 - 2 s
  g_s += g_denom;
  const float g_t = g_denom * q;
  g_q += g_denom * t;
  g_d1 += g_t;
  g_d0 += g_t;
  g_s -= 2.0f * g_t;
  // q = xi (1 - xi)
  g_xi += g_q * xi1m;
  g_xi1m += g_q * xi;
  g_xi -= g_xi1m;
  // xi = (x - x0) / w, s = h / w
  const float g_x = g_xi / w;
  const float g_x0 = -g_xi / w;
  float g_w = -g_xi * xi / w;
  g_h += g_s / w;
  g_w -= g_s * s / w;
  dx = g_x * clip_grad(x, -B, B);
  knots_vjp(r, st, K, B, n, bn, g_x0, g_w, g_y0, g_h, g_d0, g_d1, draw, dst);
}

// Pullback of rqs_inverse: (gx, gl) -> (dy, draw).
__device__ __forceinline__ void rqs_inverse_vjp(float y, const float* r,
                                                int st, int K, float B,
                                                float gx, float gl,
                                                float& dy_out, float* draw,
                                                int dst) {
  if (!(fabsf(y) <= B)) {
    dy_out = gx;
    zero_draw(draw, dst, K);
    return;
  }
  const Norm n = normalize(r, st, K);
  const Bin bn = select_bin<true>(y, r, st, K, B, n);
  const InvRoot v = inverse_root(y, bn);
  const float h = bn.h, w = bn.w, d0 = bn.d0, d1 = bn.d1;
  const float s = v.s, t = v.t, xi = v.xi, dy = v.dy;
  const float xi1m = 1.0f - xi;
  const float q = xi * xi1m;
  const float denom = s + t * q;
  const float C = d1 * xi * xi + 2.0f * s * q + d0 * xi1m * xi1m;
  const float num = s * s * C;
  // x = x0 + w xi
  const float g_x0 = gx;
  float g_w = gx * xi;
  float g_xi = gx * w;
  // ladj = 2 log(denom) - log(num), num = s^2 C
  const float g_denom = 2.0f * gl / denom;
  const float g_num = -gl / num;
  float g_s = g_num * 2.0f * s * C;
  const float g_C = g_num * s * s;
  float g_d1 = g_C * xi * xi;
  g_xi += g_C * 2.0f * d1 * xi;
  g_s += g_C * 2.0f * q;
  float g_q = g_C * 2.0f * s;
  float g_d0 = g_C * xi1m * xi1m;
  float g_xi1m = g_C * 2.0f * d0 * xi1m;
  // denom = s + t q
  g_s += g_denom;
  float g_t = g_denom * q;
  g_q += g_denom * t;
  // q = xi (1 - xi)
  g_xi += g_q * xi1m;
  g_xi1m += g_q * xi;
  g_xi -= g_xi1m;
  // xi = clip(xi_raw, 0, 1), xi_raw = 2 c / den, den = -bq - sqrt(disc)
  const float g_xr = g_xi * clip_grad(v.xi_raw, 0.0f, 1.0f);
  float g_c = g_xr * 2.0f / v.den;
  const float g_den = -g_xr * v.xi_raw / v.den;
  float g_bq = -g_den;
  // sqrt has no finite derivative at 0; there the cotangent stops
  const float g_disc = v.sq > 0.0f ? -g_den * 0.5f / v.sq : 0.0f;
  const float g_dr =
      g_disc * (v.disc_raw > 0.0f ? 1.0f : (v.disc_raw == 0.0f ? 0.5f : 0.0f));
  // disc_raw = bq^2 - 4 a c
  g_bq += g_dr * 2.0f * v.bq;
  const float g_a = -g_dr * 4.0f * v.c;
  g_c -= g_dr * 4.0f * v.a;
  // c = -s dy
  g_s -= g_c * dy;
  float g_dy = -g_c * s;
  // bq = h d0 - dy t
  float g_h = g_bq * d0;
  g_d0 += g_bq * h;
  g_dy -= g_bq * t;
  g_t -= g_bq * dy;
  // a = h (s - d0) + dy t
  g_h += g_a * (s - d0);
  g_s += g_a * h;
  g_d0 -= g_a * h;
  g_dy += g_a * t;
  g_t += g_a * dy;
  // t = d1 + d0 - 2 s
  g_d1 += g_t;
  g_d0 += g_t;
  g_s -= 2.0f * g_t;
  // dy = y - y0, s = h / w
  const float g_y0 = -g_dy;
  g_h += g_s / w;
  g_w -= g_s * s / w;
  dy_out = g_dy * clip_grad(y, -B, B);
  knots_vjp(r, st, K, B, n, bn, g_x0, g_w, g_y0, g_h, g_d0, g_d1, draw, dst);
}

}  // namespace tpuflows_rqs
