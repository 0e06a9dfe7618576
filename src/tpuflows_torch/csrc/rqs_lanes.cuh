// K4's and K5's device code on Hopper: the elementwise rational-quadratic
// spline (`eval_lanes`) and its pullback (`grad_lanes`) with a group of L
// lanes per element, its block's span staged in shared memory. Only
// rqs_spline.cu includes it (`rqs_eval_lanes_kernel`,
// `rqs_grad_lanes_kernel`); rqs_math.cuh, which K1, K2, K3 and K6/K7
// share, is left as it is.
//
// Layout. A block of kLaneThreads threads takes E = kLaneThreads / L
// consecutive elements (E is a multiple of 4), but at 32 lanes an element
// E is the most of 8, 4, 2 and 1 whose block fits the 227 KB of shared
// memory a block may have (`plan_elements`: K5 takes 8 elements a block
// up to K = 1,208 and one up to K = 9,684, K4 8 up to K = 1,452 and one up
// to K = 11,620; past that the kernels refuse the launch), the block then
// L E threads. Their raw values are one
// contiguous span of the (N, d, 3K-1) layout, E (3K-1) floats whose size
// is a multiple of 16 bytes where E is a multiple of 4, copied into shared
// memory with 16-byte
// cp.async (4-byte copies where a pointer is not 16-byte aligned, such as
// a view at an offset): by the whole block in K5, with x, gy and gl; in
// K4 each warp copies its own 32 / L elements' part and x and starts as
// soon as they have arrived. K5 writes draw over the span in place and
// stores it back with 16-byte stores (4-byte where draw is not aligned).
// Behind them each element has rows in shared memory, each padded to
// whole 16-byte words: K5 three rows of `row_stride` floats (the
// exponentials of its widths and of its heights and the derivatives at
// knots 1..K), K4 at L > 1 two (the exponentials) in `eval_stride`
// floats; either way 8 consecutive elements' rows start in 8 different
// groups of banks. Each region starts at a whole 16-byte word
// (`rows_offset`). The last block may hold fewer than E elements; its
// other groups idle.
//
// Lanes. Element e of the block is lanes [L e, L e + L) of it; L is the
// least power of two with L kBinsPerLane >= K, at most 32 (`lanes_for`):
// 2 at the fit's K = 8, 16 at K = 64; K4 takes its own, with
// kEvalBinsPerLane bins a lane (`eval_lanes_for`: 1 at K = 8, 8 at K =
// 64; past K = 32 kBinsPerLane, resp. 32 kEvalBinsPerLane, 32 lanes that
// hold ceil(K / 32) bins each). Lane l holds bins k = l, l + L, ...: bin
// k's width and height and
// (K5) the interior derivative at its left knot (k >= 1), so every raw
// value has one owner. The group's maxima come from xor shuffles
// (`group_maxima`); each lane writes the exponentials of its own widths
// and heights (K5: and the derivatives at its own knots) to the rows,
// computing each once (the one-thread kernels recompute them in each walk
// over the knots), and K5 keeps the softplus' derivative
// over its raw value. Then every lane of the group reads the rows, 16
// bytes at a time, and takes the sums whose order rqs_math.cuh fixes in
// that order: the softmax denominators (`softmax_sums`), then in one walk
// the knots x_{k+1} = x_k + 2B w_k and y_{k+1} with the running select of
// `select_bin` (the last bin whose left knot is <= t) and the prefix sums
// of the softmax outputs below it, which only the pullback's dot products
// need (`walk_knots`, `walk_step`). So every lane of the group holds the
// chosen bin. K4 at one lane an element (K <= kEvalBinsPerLane) keeps its
// exponentials in registers and walks them there (`walk_own`): no rows,
// whose scalar stores at that stride meet 4-way bank conflicts.
//
// K4 then computes the bin's two derivatives from their raw values (two
// softpluses a lane, where writing every knot's takes K - 1 over the
// group) and evaluates the bin (`forward_eval`, `inverse_eval`); lane 0
// of each group writes y and ladj, so the lanes of a warp store
// consecutive elements. Elements outside [-B, B] skip the walk: y = x,
// ladj = 0. K5 reads the bin's derivatives and own softmax outputs back
// from the rows, runs the bin's local pullback (the same instructions on
// every lane of the group, no divergence within it), and writes its own
// bins' cotangents of widths, heights and derivatives. Both lane counts
// were measured (PERF.md §6): K5's one bin a lane (L = 8 at K = 8) runs
// the knot walk and the local pullback on every lane of a group and took
// twice as long as 4; K4, whose work after the walk is all on every lane
// of a group, is fastest at one lane up to K = 8 (with rows, 2 and 4
// lanes took 1.11 and 1.66 times as long as one; registers then took a
// quarter off one lane's time).
//
// Bits. The walk and the dot products round each operation as the
// one-thread kernels' code does (`__fmul_rn`, `__fmaf_rn`, `__fadd_rn`:
// in rqs_math.cuh nvcc contracts a product into an fma or not depending
// on the code around it, which differs here); so do K4's evaluation of the
// bin and the inverse's root, written in the forms of the one-thread K4's
// SASS (ptxas also fuses a PTX mul.f32 and add.f32 that carry no rounding
// mode: bq in the inverse). K5's local pullback is rqs_math.cuh's, copied
// (`forward_local`, `inverse_local`), with C = d1 xi^2 + 2 s q + d0 (1 -
// xi)^2 pinned to the one-thread kernel's form (nvcc fuses one of two
// products and picks which by how often each is used: one form forward,
// the other inverse). The knots, the chosen bin and the outputs then equal
// the one-thread kernels' (`rqs_eval_kernel`, `rqs_grad_kernel`, kept
// built as the oracles) to the bit; chip_smoke.py's `k4_vs_earlier` and
// `k5_vs_earlier` count the elements that do not.
#pragma once

#include "rqs_math.cuh"

namespace tpuflows_rqs_lanes {

using namespace tpuflows_rqs;

constexpr int kLaneThreads = 256;
// the bins a lane holds up to 32 lanes an element: K5's, K4's
constexpr int kBinsPerLane = 4;
constexpr int kEvalBinsPerLane = 8;
// bytes of shared memory a block may opt in to
constexpr int kMaxSmem = 232448;

// lanes per element: the least power of two L with L bins >= K, at most
// 32
__host__ __device__ constexpr int lanes_for(int K,
                                            int bins = kBinsPerLane) {
  int L = 1;
  while (L < 32 && L * bins < K) L *= 2;
  return L;
}

// K4's lanes per element
__host__ __device__ constexpr int eval_lanes_for(int K) {
  return lanes_for(K, kEvalBinsPerLane);
}

// elements a block of kLaneThreads threads takes
__host__ __device__ constexpr int block_elements(int L) {
  return kLaneThreads / L;
}

__host__ __device__ constexpr int up4(int n) { return (n + 3) & ~3; }

// floats between two elements' rows of exponentials and derivatives: K
// rounded up to a multiple of 4 (16-byte loads), and an odd number of
// 16-byte words, so that the rows of 8 elements fill the 32 banks
__host__ __device__ constexpr int row_stride(int K) {
  return ((K + 3) / 4) % 2 == 1 ? (K + 3) / 4 * 4 : (K + 3) / 4 * 4 + 4;
}

// floats of a block of E elements before its rows: the raw span (3K - 1
// an element) and `extra` floats an element (x; K5 also gy and gl), each
// region rounded up to whole 16-byte words (where E is a multiple of 4
// they are whole words already)
__host__ __device__ constexpr int rows_offset(int K, int E, int extra) {
  return up4(up4(E * (3 * K - 1)) + extra * E);
}

// floats of a K5 block's dynamic shared memory at E elements: the raw
// span, x, gy, gl, and three rows an element (exponentials of widths and
// heights, the derivatives at knots 1..K)
__host__ __device__ constexpr int block_floats(int K, int E) {
  return rows_offset(K, E, 3) + E * 3 * row_stride(K);
}

// K4: floats between two elements' rows, the exponentials of widths and
// of heights, each K rounded up to whole 16-byte words, and one word more:
// an odd number of words, so that the rows of 8 elements fill the banks
__host__ __device__ constexpr int eval_stride(int K) {
  return 4 * (2 * ((K + 3) / 4) + 1);
}

// K4: floats of a block's dynamic shared memory at E elements: the raw
// span, x, and each element's rows where it has lanes to share them (at
// one lane its exponentials stay in registers)
__host__ __device__ constexpr int eval_block_floats(int K, int E) {
  return rows_offset(K, E, 1) +
         (eval_lanes_for(K) == 1 ? 0 : E * eval_stride(K));
}

// Elements a block (of L E threads) takes: 256 / L below 32 lanes, where
// every block up to that lane count's largest K fits; at 32 lanes the
// most of 8, 4, 2 and 1 whose block fits the shared memory; 0 where not
// even one element's does. K5's (grad) or K4's; kernels/rqs_cuda.py
// `spline_plan` is the host's copy.
__host__ __device__ constexpr int plan_elements(int K, bool grad) {
  const int L = grad ? lanes_for(K) : eval_lanes_for(K);
  if (L < 32) return block_elements(L);
  for (int E = block_elements(32); E >= 1; E /= 2) {
    const long long floats = grad ? block_floats(K, E)
                                  : eval_block_floats(K, E);
    if (4 * floats <= kMaxSmem) return E;
  }
  return 0;
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

// `count` floats from global `src` to shared `dst` by kThreads threads
// (the block's, or a warp's 32): 16 bytes a copy where both are 16-byte
// aligned, then the tail; 4 bytes a copy where they are not. Completed by
// cp.async.wait_all.
template <int kThreads = kLaneThreads>
__device__ __forceinline__ void stage_in(float* dst, const float* src,
                                         int count, int tid) {
  int done = 0;
  if (aligned16(src) && aligned16(dst)) {
    done = count & ~3;
    for (int i = 4 * tid; i < done; i += 4 * kThreads)
      cp_async16(dst + i, src + i);
  }
  for (int i = done + tid; i < count; i += kThreads)
    cp_async4(dst + i, src + i);
}

// `count` floats from shared `src` (16-byte aligned) to global `dst` by
// kThreads threads
template <int kThreads = kLaneThreads>
__device__ __forceinline__ void store_out(float* dst, const float* src,
                                          int count, int tid) {
  int done = 0;
  if (aligned16(dst)) {
    done = count & ~3;
    for (int i = 4 * tid; i < done; i += 4 * kThreads)
      *reinterpret_cast<float4*>(dst + i) =
          *reinterpret_cast<const float4*>(src + i);
  }
  for (int i = done + tid; i < count; i += kThreads) dst[i] = src[i];
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

// the lanes of the warp that hold thread `tid`'s element
template <int L>
__device__ __forceinline__ unsigned group_mask(int tid) {
  return L == 32 ? 0xffffffffu
                 : ((1u << L) - 1u) << ((tid & 31) & ~(L - 1));
}

// the maxima of an element's width and height raw values `r` over the
// group, lane l reading its own bins
template <int L>
__device__ __forceinline__ void group_maxima(const float* r, int K, int l,
                                             unsigned group, float& mw,
                                             float& mh) {
  mw = -INFINITY;
  mh = -INFINITY;
  for (int k = l; k < K; k += L) {
    mw = fmaxf(mw, r[k]);
    mh = fmaxf(mh, r[K + k]);
  }
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) {
    mw = fmaxf(mw, __shfl_xor_sync(group, mw, o, L));
    mh = fmaxf(mh, __shfl_xor_sync(group, mh, o, L));
  }
}

// the reciprocals of the softmax denominators, summed in knot order
// (`normalize`); the zeros of the padding add nothing
__device__ __forceinline__ void softmax_sums(const float* ew, const float* eh,
                                             int K, float& iw, float& ih) {
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
  iw = 1.0f / tw;
  ih = 1.0f / th;
}

// the chosen bin b, its knots, and the prefix sums of the softmax outputs
// below it
struct Walk {
  int b;
  float x0, x1, y0, y1, sw_lt, sh_lt;
};

// The walk's running state: knot k's x and y, and the prefix sums of the
// softmax outputs below it.
struct Knot {
  float xk, yk, pw, ph;
};

__device__ __forceinline__ void walk_start(float B, Walk& w, Knot& c) {
  w.b = 0;
  w.x0 = -B;
  w.x1 = B;
  w.y0 = -B;
  w.y1 = B;
  w.sw_lt = 0.0f;
  w.sh_lt = 0.0f;
  c.xk = -B;
  c.yk = -B;
  c.pw = 0.0f;
  c.ph = 0.0f;
}

// One step of the running select (`select_bin`; by y where kByY) at knot k
// < K - 1 from its exponentials ea, ec: knot k + 1 = knot k + 2B width k,
// bin k taken when t >= knot k, the last such k wins.
template <bool kByY>
__device__ __forceinline__ void walk_step(int k, float ea, float ec,
                                          float iw, float ih, float cw,
                                          float two_b, float t, Walk& w,
                                          Knot& c) {
  const float sw = __fmul_rn(ea, iw);
  const float sh = __fmul_rn(ec, ih);
  const float wk = __fmaf_rn(cw, sw, kMinBin);
  const float hk = __fmaf_rn(cw, sh, kMinBin);
  const float xn = __fmaf_rn(two_b, wk, c.xk);
  const float yn = __fmaf_rn(two_b, hk, c.yk);
  if (k == 0 || t >= (kByY ? c.yk : c.xk)) {
    w.b = k;
    w.x0 = c.xk;
    w.x1 = xn;
    w.y0 = c.yk;
    w.y1 = yn;
    w.sw_lt = c.pw;
    w.sh_lt = c.ph;
  }
  c.pw = __fadd_rn(c.pw, sw);
  c.ph = __fadd_rn(c.ph, sh);
  c.xk = xn;
  c.yk = yn;
}

// the last bin, whose right knot is pinned to B
template <bool kByY>
__device__ __forceinline__ void walk_last(int K, float B, float t,
                                          const Knot& c, Walk& w) {
  if (t >= (kByY ? c.yk : c.xk)) {
    w.b = K - 1;
    w.x0 = c.xk;
    w.x1 = B;
    w.y0 = c.yk;
    w.y1 = B;
    w.sw_lt = c.pw;
    w.sh_lt = c.ph;
  }
}

// The knots and the running select over the rows, with the prefix sums
// of the softmax outputs below each knot (`knots_vjp`'s sw_lt, sh_lt; K4
// leaves them unused).
template <bool kByY>
__device__ __forceinline__ Walk walk_knots(const float* ew, const float* eh,
                                           float iw, float ih, int K,
                                           float B, float t) {
  const float cw = bin_scale(K);
  const float two_b = 2.0f * B;
  Walk w;
  Knot c;
  walk_start(B, w, c);
  for (int k0 = 0; k0 < K - 1; k0 += 4) {
    const float4 a = ld4(ew + k0), h = ld4(eh + k0);
    const float ea[4] = {a.x, a.y, a.z, a.w};
    const float ec[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (k0 + i < K - 1)
        walk_step<kByY>(k0 + i, ea[i], ec[i], iw, ih, cw, two_b, t, w, c);
  }
  walk_last<kByY>(K, B, t, c, w);
  return w;
}

// K4 at one lane an element (K <= kEvalBinsPerLane): the maxima, the
// exponentials, the softmax sums in knot order and the walk of
// `walk_knots`, with the exponentials in registers instead of rows; a bin
// k >= K reads -inf, whose exponential is 0 and adds nothing.
template <bool kByY>
__device__ __forceinline__ Walk walk_own(const float* r, int K, float B,
                                         float t) {
  constexpr int N = kEvalBinsPerLane;
  float ew[N], eh[N];
  float mw = -INFINITY, mh = -INFINITY;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    ew[k] = k < K ? r[k] : -INFINITY;
    eh[k] = k < K ? r[K + k] : -INFINITY;
    mw = fmaxf(mw, ew[k]);
    mh = fmaxf(mh, eh[k]);
  }
  float tw = 0.0f, th = 0.0f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    ew[k] = expf(ew[k] - mw);
    eh[k] = expf(eh[k] - mh);
    tw += ew[k];
    th += eh[k];
  }
  const float iw = 1.0f / tw;
  const float ih = 1.0f / th;
  const float cw = bin_scale(K);
  const float two_b = 2.0f * B;
  Walk w;
  Knot c;
  walk_start(B, w, c);
#pragma unroll
  for (int k = 0; k < N - 1; ++k)
    if (k < K - 1)
      walk_step<kByY>(k, ew[k], eh[k], iw, ih, cw, two_b, t, w, c);
  walk_last<kByY>(K, B, t, c, w);
  return w;
}

// rqs_forward's evaluation of the bin (rqs_math.cuh), each operation
// rounded as the one-thread K4 is compiled (its SASS): y and ladj
__device__ __forceinline__ void forward_eval(float x, const Bin& bn,
                                             float& y, float& ladj) {
  const float h = bn.h, w = bn.w, d0 = bn.d0, d1 = bn.d1;
  const float s = __fdiv_rn(h, w);
  const float s2 = __fadd_rn(s, s);
  const float xi = __fdiv_rn(__fsub_rn(x, bn.x0), w);
  const float xi1m = __fsub_rn(1.0f, xi);
  const float q = __fmul_rn(xi, xi1m);
  const float t = __fsub_rn(__fadd_rn(d1, d0), s2);
  const float denom = __fmaf_rn(q, t, s);
  // A = s xi^2 + d0 q
  const float A = __fmaf_rn(d0, q, __fmul_rn(__fmul_rn(s, xi), xi));
  y = __fadd_rn(bn.y0, __fdiv_rn(__fmul_rn(h, A), denom));
  // C = d1 xi^2 + 2 s q + d0 (1 - xi)^2
  const float C =
      __fmaf_rn(xi1m, __fmul_rn(d0, xi1m),
                __fmaf_rn(q, s2, __fmul_rn(__fmul_rn(d1, xi), xi)));
  const float num = __fmul_rn(__fmul_rn(s, s), C);
  ladj = __fsub_rn(logf(num), __fmul_rn(2.0f, logf(denom)));
}

// rqs_inverse's root (`inverse_root`) and evaluation of the bin, each
// operation rounded as the one-thread K4 is compiled: x and ladj. bq =
// h d0 - dy t is an fma there although its PTX is a mul.f32 and a
// sub.f32: ptxas fuses a PTX product and sum that carry no rounding mode
__device__ __forceinline__ void inverse_eval(float y, const Bin& bn,
                                             float& x, float& ladj) {
  const float h = bn.h, w = bn.w, d0 = bn.d0, d1 = bn.d1;
  const float s = __fdiv_rn(h, w);
  const float s2 = __fadd_rn(s, s);
  const float t = __fsub_rn(__fadd_rn(d1, d0), s2);
  const float dy = __fsub_rn(y, bn.y0);
  const float dyt = __fmul_rn(dy, t);
  const float a = __fmaf_rn(h, __fsub_rn(s, d0), dyt);
  const float bq = __fmaf_rn(h, d0, -dyt);
  const float sdy = __fmul_rn(dy, s);  // -c
  // disc = bq^2 - 4 a c
  const float disc = __fmaf_rn(bq, bq, __fmul_rn(sdy, __fmul_rn(a, 4.0f)));
  const float sq = sqrtf(fmaxf(disc, 0.0f));  // roundoff guard at bin edges
  const float den = __fsub_rn(-bq, sq);
  const float xi_raw = __fdiv_rn(__fmul_rn(sdy, -2.0f), den);  // 2 c / den
  const float xi = fminf(fmaxf(xi_raw, 0.0f), 1.0f);
  x = __fmaf_rn(w, xi, bn.x0);
  const float xi1m = __fsub_rn(1.0f, xi);
  const float q = __fmul_rn(xi, xi1m);
  const float denom = __fmaf_rn(t, q, s);
  // C = d1 xi^2 + 2 s q + d0 (1 - xi)^2
  const float C =
      __fmaf_rn(xi1m, __fmul_rn(d0, xi1m),
                __fmaf_rn(xi, __fmul_rn(d1, xi), __fmul_rn(s2, q)));
  const float num = __fmul_rn(__fmul_rn(s, s), C);
  ladj = __fsub_rn(__fmul_rn(2.0f, logf(denom)), logf(num));
}

// The spline of the block's elements (see the top of this file): y of
// element i at y[i], its ladj at ladj[i]. Each warp stages its own
// elements' span and x, so that it starts as soon as they have arrived;
// at one lane an element the exponentials stay in registers (`walk_own`).
// A block is E elements (L E threads). `smem`: eval_block_floats(K, E)
// floats, 16-byte aligned.
template <bool kInverse, int L, int E>
__device__ __forceinline__ void eval_lanes(
    const float* __restrict__ x, const float* __restrict__ raw,
    float* __restrict__ y, float* __restrict__ ladj, long long n, int K,
    float B, float* smem) {
  constexpr int EW = 32 / L;  // elements a warp
  const int P = 3 * K - 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const long long e0 = (long long)blockIdx.x * E;
  const long long w0 = e0 + (tid - lane) / L;  // the warp's first element
  if (w0 >= n) return;
  const int nw = (int)(n - w0 < EW ? n - w0 : EW);
  const int ew0 = (int)(w0 - e0);
  float* s_raw = smem;
  float* s_x = smem + up4(E * P);
  float* s_rows = smem + rows_offset(K, E, 1);
  stage_in<32>(s_raw + ew0 * P, raw + w0 * P, nw * P, lane);
  stage_in<32>(s_x + ew0, x + w0, nw, lane);
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncwarp();

  const int e = tid / L;
  const int l = tid & (L - 1);
  if (e - ew0 >= nw) return;
  const float t = s_x[e];
  float yo = t, lo = 0.0f;  // the identity outside [-B, B]
  if (fabsf(t) <= B) {
    float* r = s_raw + e * P;
    Walk wk;
    if constexpr (L == 1) {
      wk = walk_own<kInverse>(r, K, B, t);
    } else {
      const unsigned group = group_mask<L>(tid);
      const int W = (K + 3) / 4 * 4;  // a row: K floats in 16-byte words
      float* ew = s_rows + e * eval_stride(K);  // exp(width raw - max)
      float* eh = ew + W;                        // exp(height raw - max)
      float mw, mh;
      group_maxima<L>(r, K, l, group, mw, mh);
      // each lane's own bins; zeros pad the rows to whole 16-byte words
      for (int k = l; k < K; k += L) {
        ew[k] = expf(r[k] - mw);
        eh[k] = expf(r[K + k] - mh);
      }
      for (int k = K + l; k < W; k += L) {
        ew[k] = 0.0f;
        eh[k] = 0.0f;
      }
      __syncwarp(group);
      float iw, ih;
      softmax_sums(ew, eh, K, iw, ih);
      wk = walk_knots<kInverse>(ew, eh, iw, ih, K, B, t);
    }
    // the bin's derivatives from their raw values, as `select_bin`
    // computes them; the end knots' are pinned to 1
    Bin bn;
    bn.x0 = wk.x0;
    bn.w = wk.x1 - wk.x0;
    bn.y0 = wk.y0;
    bn.h = wk.y1 - wk.y0;
    bn.d0 = wk.b == 0
                ? 1.0f
                : kMinDeriv + softplus(r[2 * K + wk.b - 1] + kSoftplusUnit);
    bn.d1 = wk.b == K - 1
                ? 1.0f
                : kMinDeriv + softplus(r[2 * K + wk.b] + kSoftplusUnit);
    bn.b = wk.b;
    if (kInverse)
      inverse_eval(t, bn, yo, lo);
    else
      forward_eval(t, bn, yo, lo);
  }
  if (l == 0) {
    y[e0 + e] = yo;
    ladj[e0 + e] = lo;
  }
}

// The pullback of the block's elements (see the top of this file): dx of
// element i at dx[i], its 3K-1 raw cotangents at draw[i (3K-1) + p].
// A block is E elements (L E threads). `smem`: block_floats(K, E) floats,
// 16-byte aligned.
template <bool kInverse, int L, int E>
__device__ __forceinline__ void grad_lanes(
    const float* __restrict__ x, const float* __restrict__ raw,
    const float* __restrict__ gy, const float* __restrict__ gl,
    float* __restrict__ dx, float* __restrict__ draw, long long n, int K,
    float B, float* smem) {
  constexpr int kThreads = L * E;
  const int P = 3 * K - 1;
  const int S = row_stride(K);
  const int tid = threadIdx.x;
  const long long e0 = (long long)blockIdx.x * E;
  const int ne = (int)(n - e0 < E ? n - e0 : E);
  float* s_raw = smem;
  float* s_x = smem + up4(E * P);
  float* s_gy = s_x + E;
  float* s_gl = s_gy + E;
  float* s_rows = smem + rows_offset(K, E, 3);
  stage_in<kThreads>(s_raw, raw + e0 * P, ne * P, tid);
  stage_in<kThreads>(s_x, x + e0, ne, tid);
  stage_in<kThreads>(s_gy, gy + e0, ne, tid);
  stage_in<kThreads>(s_gl, gl + e0, ne, tid);
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  const int e = tid / L;
  const int l = tid & (L - 1);
  if (e < ne) {
    const unsigned group = group_mask<L>(tid);
    float* r = s_raw + e * P;
    float* ew = s_rows + e * 3 * S;  // exp(width raw - max), K of them
    float* eh = ew + S;              // exp(height raw - max)
    float* dr = eh + S;              // dr[m]: the derivative at knot m + 1
    const float t = s_x[e];
    float mw, mh;
    group_maxima<L>(r, K, l, group, mw, mh);
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
    float iw, ih;
    softmax_sums(ew, eh, K, iw, ih);
    // the bin's derivatives and own softmax outputs are read back after
    // the walk
    const Walk wk = walk_knots<kInverse>(ew, eh, iw, ih, K, B, t);
    const int b = wk.b;
    const float sw_lt = wk.sw_lt, sh_lt = wk.sh_lt;
    Bin bn;
    bn.x0 = wk.x0;
    bn.w = wk.x1 - wk.x0;
    bn.y0 = wk.y0;
    bn.h = wk.y1 - wk.y0;
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
  store_out<kThreads>(draw + e0 * P, s_raw, ne * P, tid);
}

}  // namespace tpuflows_rqs_lanes
