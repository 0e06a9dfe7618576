// K5's device code on Hopper: the pullback of the elementwise
// rational-quadratic spline with a group of L lanes per element, its
// block's span staged in shared memory. Only rqs_spline.cu includes it
// (`rqs_grad_lanes_kernel`); rqs_math.cuh, which K1, K2, K3, K4 and K6/K7
// share, is left as it is.
//
// Layout. A block of kLaneThreads threads takes E = kLaneThreads / L
// consecutive elements (E is a multiple of 4). Their raw values are one
// contiguous span of the (N, d, 3K-1) layout, E (3K-1) floats whose size
// is a multiple of 16 bytes; the block copies it into shared memory with
// 16-byte cp.async, with x, gy and gl (4-byte copies where a pointer is
// not 16-byte aligned, such as a view at an offset), writes draw over it
// in place, and stores it back with 16-byte stores (4-byte where draw is
// not aligned). Behind them each element has three rows of `row_stride`
// floats: the exponentials of its widths and of its heights and the
// derivatives at knots 1..K, rows padded to whole 16-byte words, 8
// consecutive elements' rows in 8 different groups of banks. The last
// block may hold fewer than E elements; its other groups idle.
//
// Lanes. Element e of the block is lanes [L e, L e + L) of it; L is the
// least power of two with L kBinsPerLane >= K, at most 32 (`lanes_for`):
// 2 at the fit's K = 8, 16 at K = 64. Lane l holds bins k = l, l + L, ...:
// bin k's width and height and the interior derivative at its left knot
// (k >= 1), so every raw value has one owner. The group's maxima come
// from xor shuffles; each lane writes the exponentials of its own widths
// and heights and the derivatives at its own knots to the rows, computing
// each once (the one-thread kernel recomputes them in each of its three
// walks over the knots), and keeps the softplus' derivative over its raw
// value. Then every lane of the group reads the rows, 16 bytes at a time,
// and takes the sums whose order rqs_math.cuh fixes in that order: the
// softmax denominators, then in one walk the knots x_{k+1} = x_k + 2B w_k
// and y_{k+1} with the running select of `select_bin` (the last bin whose
// left knot is <= t) and the prefix sums of the softmax outputs below it,
// which the pullback's dot products need. So every lane of the group
// holds the chosen bin; it reads the bin's derivatives and own softmax
// outputs back from the rows, runs the bin's local pullback (the same
// instructions on every lane of the group, no divergence within it), and
// writes its own bins' cotangents of widths, heights and derivatives.
// kBinsPerLane was measured (PERF.md §6): one bin a lane
// up to 32 lanes (L = 8 at K = 8) runs the knot walk and the local
// pullback on every lane of a group, and took twice as long.
//
// Bits. The walk and the dot products round each operation as the
// one-thread kernel's PTX does (`__fmul_rn`, `__fmaf_rn`, `__fadd_rn`:
// in rqs_math.cuh nvcc contracts a product into an fma or not depending
// on the code around it, which differs here); the bin's local pullback is
// rqs_math.cuh's, copied (`forward_local`, `inverse_local`), with C =
// d1 xi^2 + 2 s q + d0 (1 - xi)^2 pinned to the one-thread kernel's form
// (nvcc fuses one of two products and picks which by how often each is
// used: one form forward, the other inverse). The knots, the chosen bin
// and the outputs then equal the one-thread kernel's (`rqs_grad_kernel`,
// kept built as the oracle) to the bit; chip_smoke.py's `k5_vs_earlier`
// counts the elements that do not.
#pragma once

#include "rqs_math.cuh"

namespace tpuflows_rqs_lanes {

using namespace tpuflows_rqs;

constexpr int kLaneThreads = 256;
// the bins a lane holds up to 32 lanes an element
constexpr int kBinsPerLane = 4;

// lanes per element: the least power of two L with L kBinsPerLane >= K,
// at most 32
__host__ __device__ constexpr int lanes_for(int K) {
  int L = 1;
  while (L < 32 && L * kBinsPerLane < K) L *= 2;
  return L;
}

// elements a block takes
__host__ __device__ constexpr int block_elements(int L) {
  return kLaneThreads / L;
}

// whether some K <= kMaxKnots takes L lanes (the instantiations to build)
__host__ __device__ constexpr bool lanes_used(int L) {
  for (int K = 2; K <= kMaxKnots; ++K)
    if (lanes_for(K) == L) return true;
  return false;
}

// floats between two elements' rows of exponentials and derivatives: K
// rounded up to a multiple of 4 (16-byte loads), and an odd number of
// 16-byte words, so that the rows of 8 elements fill the 32 banks
__host__ __device__ constexpr int row_stride(int K) {
  return ((K + 3) / 4) % 2 == 1 ? (K + 3) / 4 * 4 : (K + 3) / 4 * 4 + 4;
}

// floats of a block's dynamic shared memory: the raw span, x, gy, gl,
// and three rows an element (exponentials of widths and heights, the
// derivatives at knots 1..K)
__host__ __device__ constexpr int block_floats(int K) {
  return block_elements(lanes_for(K)) * (3 * K - 1 + 3 + 3 * row_stride(K));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(s), "l"(src) : "memory");
}

// `count` floats from global `src` to shared `dst` (16-byte aligned) by
// the block's threads: 16 bytes a copy where src is aligned, then the
// tail; 4 bytes a copy where it is not. Completed by cp.async.wait_all.
__device__ __forceinline__ void stage_in(float* dst, const float* src,
                                         int count, int tid) {
  int done = 0;
  if (aligned16(src)) {
    done = count & ~3;
    for (int i = 4 * tid; i < done; i += 4 * kLaneThreads)
      cp_async16(dst + i, src + i);
  }
  for (int i = done + tid; i < count; i += kLaneThreads)
    cp_async4(dst + i, src + i);
}

// `count` floats from shared `src` (16-byte aligned) to global `dst`
__device__ __forceinline__ void store_out(float* dst, const float* src,
                                          int count, int tid) {
  int done = 0;
  if (aligned16(dst)) {
    done = count & ~3;
    for (int i = 4 * tid; i < done; i += 4 * kLaneThreads)
      *reinterpret_cast<float4*>(dst + i) =
          *reinterpret_cast<const float4*>(src + i);
  }
  for (int i = done + tid; i < count; i += kLaneThreads) dst[i] = src[i];
}

// The cotangents of the bin's parameters and of t that the local
// pullback gives.
struct BinGrad {
  float dt, x0, w, y0, h, d0, d1;
};

// rqs_forward_vjp's pullback through the bin (rqs_math.cuh), as written
// there, up to knots_vjp.
__device__ __forceinline__ BinGrad forward_local(float x, const Bin& bn,
                                                 float B, float gy,
                                                 float gl) {
  const float h = bn.h, w = bn.w, d0 = bn.d0, d1 = bn.d1;
  const float s = h / w;
  const float xi = (x - bn.x0) / w;
  const float xi1m = 1.0f - xi;
  const float q = xi * xi1m;
  const float t = d1 + d0 - 2.0f * s;
  const float denom = s + t * q;
  const float A = s * xi * xi + d0 * q;
  const float hA = h * A;
  // as nvcc contracts it in the one-thread forward pullback
  const float C = __fmaf_rn(d0 * xi1m, xi1m,
                            __fmaf_rn(2.0f * s, q, d1 * xi * xi));
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
  BinGrad g;
  g.dt = g_x * clip_grad(x, -B, B);
  g.x0 = g_x0;
  g.w = g_w;
  g.y0 = g_y0;
  g.h = g_h;
  g.d0 = g_d0;
  g.d1 = g_d1;
  return g;
}

// rqs_inverse_vjp's pullback through the bin (rqs_math.cuh), as written
// there, up to knots_vjp.
__device__ __forceinline__ BinGrad inverse_local(float y, const Bin& bn,
                                                 float B, float gx,
                                                 float gl) {
  const InvRoot v = inverse_root(y, bn);
  const float h = bn.h, w = bn.w, d0 = bn.d0, d1 = bn.d1;
  const float s = v.s, t = v.t, xi = v.xi, dy = v.dy;
  const float xi1m = 1.0f - xi;
  const float q = xi * xi1m;
  const float denom = s + t * q;
  // as nvcc contracts it in the one-thread inverse pullback
  const float C = __fmaf_rn(d0 * xi1m, xi1m,
                            __fmaf_rn(d1 * xi, xi, 2.0f * s * q));
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
  BinGrad g;
  g.dt = g_dy * clip_grad(y, -B, B);
  g.x0 = g_x0;
  g.w = g_w;
  g.y0 = g_y0;
  g.h = g_h;
  g.d0 = g_d0;
  g.d1 = g_d1;
  return g;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The pullback of the block's elements (see the top of this file): dx of
// element i at dx[i], its 3K-1 raw cotangents at draw[i (3K-1) + p].
// `smem`: block_floats(K) floats, 16-byte aligned.
template <bool kInverse, int L>
__device__ __forceinline__ void grad_lanes(
    const float* __restrict__ x, const float* __restrict__ raw,
    const float* __restrict__ gy, const float* __restrict__ gl,
    float* __restrict__ dx, float* __restrict__ draw, long long n, int K,
    float B, float* smem) {
  constexpr int E = block_elements(L);
  const int P = 3 * K - 1;
  const int S = row_stride(K);
  const int tid = threadIdx.x;
  const long long e0 = (long long)blockIdx.x * E;
  const int ne = (int)(n - e0 < E ? n - e0 : E);
  float* s_raw = smem;
  float* s_x = smem + E * P;  // E P is a multiple of 4
  float* s_gy = s_x + E;
  float* s_gl = s_gy + E;
  float* s_rows = s_gl + E;
  stage_in(s_raw, raw + e0 * P, ne * P, tid);
  stage_in(s_x, x + e0, ne, tid);
  stage_in(s_gy, gy + e0, ne, tid);
  stage_in(s_gl, gl + e0, ne, tid);
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  const int e = tid / L;
  const int l = tid & (L - 1);
  if (e < ne) {
    // the group's lanes of the warp
    const unsigned group =
        L == 32 ? 0xffffffffu
                : ((1u << L) - 1u) << ((tid & 31) & ~(L - 1));
    float* r = s_raw + e * P;
    float* ew = s_rows + e * 3 * S;  // exp(width raw - max), K of them
    float* eh = ew + S;              // exp(height raw - max)
    float* dr = eh + S;              // dr[m]: the derivative at knot m + 1
    const float t = s_x[e];

    // the maxima over the group
    float mw = -INFINITY, mh = -INFINITY;
    for (int k = l; k < K; k += L) {
      mw = fmaxf(mw, r[k]);
      mh = fmaxf(mh, r[K + k]);
    }
#pragma unroll
    for (int o = L / 2; o > 0; o >>= 1) {
      mw = fmaxf(mw, __shfl_xor_sync(group, mw, o, L));
      mh = fmaxf(mh, __shfl_xor_sync(group, mh, o, L));
    }
    // each lane's own bins: the exponentials, the derivative at the left
    // knot, and over its raw value the softplus' derivative there; zeros
    // pad the rows to whole 16-byte words
    for (int k = l; k < K; k += L) {
      ew[k] = expf(r[k] - mw);
      eh[k] = expf(r[K + k] - mh);
      if (k >= 1) {
        const float u = r[2 * K + k - 1] + kSoftplusUnit;
        const float sp = softplus(u);
        dr[k - 1] = kMinDeriv + sp;
        r[2 * K + k - 1] = expf(u - sp);
      }
    }
    for (int k = K + l; k < S; k += L) {
      ew[k] = 0.0f;
      eh[k] = 0.0f;
    }
    if (l == 0) dr[K - 1] = 1.0f;  // the end knot's, pinned
    __syncwarp(group);

    // the softmax denominators, in knot order (`normalize`); the zeros
    // of the padding add nothing
    float tw = 0.0f, th = 0.0f;
    for (int k = 0; k < K; k += 4) {
      const float4 a = ld4(ew + k), b = ld4(eh + k);
      tw += a.x;
      th += b.x;
      tw += a.y;
      th += b.y;
      tw += a.z;
      th += b.z;
      tw += a.w;
      th += b.w;
    }
    const float iw = 1.0f / tw;
    const float ih = 1.0f / th;

    // the knots and the running select (`select_bin`), with the prefix
    // sums of the softmax outputs below each knot (`knots_vjp`'s sw_lt,
    // sh_lt); the bin's derivatives and own softmax outputs are read back
    // after the walk
    const float cw = bin_scale(K);
    const float two_b = 2.0f * B;
    float xk = -B, yk = -B, pw = 0.0f, ph = 0.0f;
    int b = 0;
    float x0 = -B, x1 = B, y0 = -B, y1 = B, sw_lt = 0.0f, sh_lt = 0.0f;
    for (int k0 = 0; k0 < K - 1; k0 += 4) {
      const float4 a = ld4(ew + k0), c = ld4(eh + k0);
      const float ea[4] = {a.x, a.y, a.z, a.w};
      const float ec[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k0 + i;
        if (k < K - 1) {
          const float sw = __fmul_rn(ea[i], iw);
          const float sh = __fmul_rn(ec[i], ih);
          const float wk = __fmaf_rn(cw, sw, kMinBin);
          const float hk = __fmaf_rn(cw, sh, kMinBin);
          const float xn = __fmaf_rn(two_b, wk, xk);
          const float yn = __fmaf_rn(two_b, hk, yk);
          if (k == 0 || t >= (kInverse ? yk : xk)) {
            b = k;
            x0 = xk;
            x1 = xn;
            y0 = yk;
            y1 = yn;
            sw_lt = pw;
            sh_lt = ph;
          }
          pw = __fadd_rn(pw, sw);
          ph = __fadd_rn(ph, sh);
          xk = xn;
          yk = yn;
        }
      }
    }
    if (t >= (kInverse ? yk : xk)) {  // the last bin
      b = K - 1;
      x0 = xk;
      x1 = B;
      y0 = yk;
      y1 = B;
      sw_lt = pw;
      sh_lt = ph;
    }
    Bin bn;
    bn.x0 = x0;
    bn.w = x1 - x0;
    bn.y0 = y0;
    bn.h = y1 - y0;
    bn.d0 = b == 0 ? 1.0f : dr[b - 1];
    bn.d1 = dr[b];
    bn.b = b;
    const float sw_b = ew[b] * iw;
    const float sh_b = eh[b] * ih;

    // the bin's local pullback, then back through the knot sums and the
    // softmaxes (`knots_vjp`), each lane to its own bins
    const float gyv = s_gy[e], glv = s_gl[e];
    const bool inside = fabsf(t) <= B;
    const BinGrad g = kInverse ? inverse_local(t, bn, B, gyv, glv)
                               : forward_local(t, bn, B, gyv, glv);
    const bool inner = b + 1 < K;  // knot b+1 is not the pinned end
    const float gxb = g.x0 - g.w, gxn = inner ? g.w : 0.0f;
    const float gyb = g.y0 - g.h, gyn = inner ? g.h : 0.0f;
    const float c2 = bin_scale(K) * 2.0f * B;
    const float dot_w =
        c2 * __fmaf_rn(gxb, sw_lt, gxn * __fadd_rn(sw_lt, sw_b));
    const float dot_h =
        c2 * __fmaf_rn(gyb, sh_lt, gyn * __fadd_rn(sh_lt, sh_b));
    for (int k = l; k < K; k += L) {
      float dw = 0.0f, dh = 0.0f, dd = 0.0f;
      if (inside) {
        const float sw = ew[k] * iw;
        const float sh = eh[k] * ih;
        const float gsw = c2 * ((k < b ? gxb : 0.0f) + (k <= b ? gxn : 0.0f));
        const float gsh = c2 * ((k < b ? gyb : 0.0f) + (k <= b ? gyn : 0.0f));
        dw = sw * (gsw - dot_w);
        dh = sh * (gsh - dot_h);
        if (k >= 1) {
          const float gd =
              (k == b ? g.d0 : 0.0f) + (k == b + 1 ? g.d1 : 0.0f);
          dd = gd * r[2 * K + k - 1];
        }
      }
      r[k] = dw;
      r[K + k] = dh;
      if (k >= 1) r[2 * K + k - 1] = dd;
    }
    if (l == 0) dx[e0 + e] = inside ? g.dt : gyv;
  }
  __syncthreads();
  store_out(draw + e0 * P, s_raw, ne * P, tid);
}

}  // namespace tpuflows_rqs_lanes
