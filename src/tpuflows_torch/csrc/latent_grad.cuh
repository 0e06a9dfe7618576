// The latent log density and its gradient, one warp per row:
//   lp = log p(f^-1(z)) + ladj(z) and g = d lp / dz
// over a target of targets.cuh (`target_logp_grad`, on a.kind):
//  * `chain_logp_grad`: any Chain of Standardize, Whiten, AffineCoupling
//    and RQSCouplingBlock modules whose conditioners are MLPs of 1 to 8
//    layers d -> h_1 -> ... -> n with a silu, tanh, relu or gelu
//    activation and float32 or bf16 operands, given as a module list
//    (`ChainList`): the per-warp module-list kernels of K1, K2 and K3,
//    which no path runs any more and which stay built as chip_smoke.py's
//    oracle for the tile gradient. It follows
//    `tile_logp_and_grad_streamed` (src/tpuflows/kernels/tile_flow.py:107):
//    sweep 1 applies the inverse chain and keeps only each module's d-wide
//    input in the warp's shared memory; sweep 2 walks back, recomputes each
//    module's conditioner from its stored input and pulls the cotangent
//    through the module with the spline pullback of rqs_math.cuh and the
//    MLP backward. The module whose conditioner ran last in sweep 1 is
//    pulled back first and is not recomputed. Spline conditioners come
//    with p-major last layers (`permute_for_tiles`), so lane l reads
//    parameter p of its dims at p d + l + 32 j, which it wrote itself.
// K1's, K2's and K3's tile kernels run the tile gradient of
// tile_grad.cuh instead: the same per-row code and order of sums, with
// the MLP products shared over a tile of rows.
//
// Lane layout: lane l holds dims l + 32 j (j < DPL = d / 32) of every
// d-vector in registers, and units l + 32 k of every hidden vector. Dot
// products and sums reduce with a __shfl_xor_sync butterfly, which leaves
// the same bits in every lane, so every branch is uniform across the warp.
// The MLP reads its inputs from a per-warp shared-memory buffer guarded by
// __syncwarp(); its weights (and transposed copies for the backward pass,
// so that its reads coalesce too) are read from global memory with __ldg
// for each row and stay resident in L2. That is what bounds this design:
// at the generic arqs flow's widths (d = 64; three affine conditioners 64
// -> 128 -> 128 -> 128, ~41 k forward weights each, three spline
// conditioners 64 -> 128 -> 128 -> 1472, ~213 k each) one row's gradient
// reads the forward weights in sweep 1, again in sweep 2's recomputation
// (all but the first module pulled back) and the transposed copies in the
// backward pass: ~2.2 M floats, ~9 MB per row, ~9 GB for 1,024 rows, which
// at K3's 1.98 ms is ~4.6 TB/s of L2 reads, about what the H100's L2
// delivers, while the FMAs alone would take 26 us; 32-thread blocks leave
// ~7.8 warps per SM to hide L2 latency. The products stay in float32 on the
// FMA pipes: the bars against the plain versions (q within 2.3e-4, at most
// 5 flips of 1,024) leave no room for TF32 rounding, and wgmma takes
// float32 operands only as TF32. The gradients are written out by hand:
// the target's log p (targets.cuh), Standardize and Whiten inverses,
// coupling inverse with the tanh clamp, spline inverse and its pullback,
// and the MLP backward through the activation. No autograd.
//
// bf16 conditioners round where the JAX package's `MLP` rounds
// (jax.lax.dot_general of bf16 operands with float32 accumulation) and
// nowhere else: the weights are packed already rounded, each layer's input
// is rounded to bf16 (`bf16_round`) and the product summed in float32; in
// the backward pass each layer's input cotangent is the float32 sum of the
// unrounded cotangent times the rounded weights, rounded once. Biases,
// activations and their derivatives stay float32.
//
// Widths. The flow is packed at the lane width d, a multiple of 32 (kernels/
// nuts_cuda.py `pack_flow` pads it once): a padded dim has Standardize loc
// 0 and log scale 0, mask 1 (it passes through every coupling), zero rows
// of W1 and zero head columns, and no place among the compact layers'
// pass-through dims (tile_grad.cuh). Its lane holds exact zeros throughout:
// z, x, every cotangent and g; they add exact zeros to every sum.
//
// K1, K2 and K3 share these functions, so K3 computes the gradient that K1
// computes inside its trajectory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "rqs_math.cuh"

namespace tpuflows_nuts {

struct Args {
  const float* q;         // (n, d)
  const float* p0;        // (n, d)
  const float* dirs;      // (n, depth), +-1
  const float* u_acc;     // (n, depth)
  const float* u_take;    // (n, 2^depth)
  const float* eps;       // (1,)
  const float* inv_mass;  // (d,)
  const float* params;    // packed flow, see the module-list gradient
  const float* target;    // packed target, see targets.cuh
  // d: the lane width, a multiple of 32 (DPL = d / 32), at which the flow
  // is packed; dim <= d: the target's width, the row length of q, p0,
  // inv_mass and q_out, and the width every log normaliser counts. Lanes
  // at or past dim load zeros and store nothing.
  int n, d, dim, kind, depth;
  float max_delta_energy;
  float* q_out;  // (n, dim)
  float* info;   // (7, n): lp, sum_accept, n_steps, depth, diverging,
                 //         turning, h0
};
// K3 fills q (z in), params, target, n, d, dim and kind, and writes g to
// q_out and lp to info (n,).

// The module list of the module-list kernels: kModInts ints per module and
// kFormInts ints of its conditioner's form (see the module-list gradient),
// the widest hidden layer, the most hidden layers of any conditioner
// (nhid), the widest conditioner output (at least d with a Whiten), and
// whether any module leaves the main paths' form (`general`: a Whiten, or
// a conditioner that is not a 3-layer float32 silu MLP), which the
// funnel's own units (-DTARGETS_FUNNEL_ONLY) do not compute.
struct ChainList {
  const int* mods;
  const int* forms;
  int n_mods, hmax, nhid, head, general;
};

constexpr int kMaxModules = 16;
constexpr int kModInts = 8;
constexpr int kFormInts = 10;
constexpr int kMaxLayers = 8;
enum ModuleKind { kStandardize = 0, kAffine = 1, kSpline = 2, kWhiten = 3 };
// the activations (kernels/nuts_cuda.py ACTIVATION_CODES)
enum Activation { kSilu = 0, kTanh = 1, kRelu = 2, kGelu = 3 };
// a conditioner's flags (forms column 2; kernels/nuts_cuda.py FORM_BF16,
// FORM_GENERAL)
constexpr int kFormBf16 = 1;
constexpr int kFormGeneral = 2;

// floats of one row's scratch (`Scratch`): each module's input and the
// conditioner's, two buffers of hmax per hidden layer, the head
__host__ __device__ inline size_t row_floats(const Args& a,
                                             const ChainList& c) {
  return (size_t)(c.n_mods + 1) * a.d + 2 * (size_t)c.nhid * c.hmax + c.head;
}

inline ChainList chain_list(const void* mods, const void* forms, int n_mods,
                            int hmax, int nhid, int head, int general) {
  ChainList c;
  c.mods = static_cast<const int*>(mods);
  c.forms = static_cast<const int*>(forms);
  c.n_mods = n_mods;
  c.hmax = hmax;
  c.nhid = nhid;
  c.head = head;
  c.general = general;
  return c;
}

}  // namespace tpuflows_nuts

namespace {

using tpuflows_nuts::Args;
using tpuflows_nuts::ChainList;
using tpuflows_nuts::kFormInts;
using tpuflows_nuts::kModInts;

constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2Pi = 1.8378770664093453f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// x rounded to the nearest bfloat16 (ties to even), held as a float
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// jax.nn.gelu's default, the tanh approximation
constexpr float kGeluK0 = 0.7978845608028654f;  // sqrt(2 / pi)
constexpr float kGeluK1 = 0.044715f;

__device__ __forceinline__ float activate(float x, int act) {
  if (act == tpuflows_nuts::kTanh) return tanhf(x);
  if (act == tpuflows_nuts::kRelu) return x > 0.0f ? x : 0.0f;
  if (act == tpuflows_nuts::kGelu)
    return 0.5f * x * (1.0f + tanhf(kGeluK0 * (x + kGeluK1 * x * x * x)));
  return x * sigmoid(x);
}

// d act / dx, as jax.grad and torch.autograd give it (relu's 0 at 0)
__device__ __forceinline__ float activate_grad(float x, int act) {
  if (act == tpuflows_nuts::kTanh) {
    const float t = tanhf(x);
    return 1.0f - t * t;
  }
  if (act == tpuflows_nuts::kRelu) return x > 0.0f ? 1.0f : 0.0f;
  if (act == tpuflows_nuts::kGelu) {
    const float t = tanhf(kGeluK0 * (x + kGeluK1 * x * x * x));
    return 0.5f * (1.0f + t) + 0.5f * x * (1.0f - t * t) * kGeluK0 *
                                   (1.0f + 3.0f * kGeluK1 * x * x);
  }
  const float s = sigmoid(x);
  return s * (1.0f + x * (1.0f - s));
}

// A layer's product on the general path (`matvec`, tile_grad.cuh's
// `tile_matvec_any`): mode's low bits the activation, and flags: kRoundAct
// rounds the activation a forward layer hands on to bf16 (the next layer's
// operand), kRoundOut rounds a backward product (an input's cotangent) to
// bf16, kWide sums the product in double (every product of the general
// path: a funnel-fitted Whiten hands the coupling behind it cotangents of
// 1e4, where the float32 sums in the main paths' order lost twice the
// float32 plain version's accuracy on the card, PERF.md; the rounding
// points stay JAX's).
constexpr int kActBits = 7;
constexpr int kRoundAct = 8;
constexpr int kRoundOut = 16;
constexpr int kWide = 32;

__device__ __forceinline__ float epilogue_out(float v, int mode) {
  return (mode & kRoundOut) ? bf16_round(v) : v;
}

__device__ __forceinline__ float epilogue_act(float v, int mode) {
  const float h = activate(v, mode & kActBits);
  return (mode & kRoundAct) ? bf16_round(h) : h;
}

// out[c] = bias[c] + sum_r in[r] * W[r * n_out + c] for the lane's columns
// c = c0 + lane + 32 k; `in` is the warp's shared buffer. When `act` is
// given it also receives the activation of out[c] (in a loop of its own,
// each activation's code once); `mode` as `epilogue_out` /
// `epilogue_act` take it, kWide summing in double. n_out is a multiple of
// 32.
__device__ void matvec(const float* __restrict__ W,
                       const float* __restrict__ bias, const float* in,
                       int n_in, int n_out, float* out, float* act, int mode,
                       int lane) {
  if (mode & kWide) {  // the bias (or 0), then fma over r ascending, in double
    for (int c = lane; c < n_out; c += 32) {
      double acc = bias != nullptr ? (double)__ldg(bias + c) : 0.0;
      for (int r = 0; r < n_in; ++r)
        acc = fma((double)in[r], (double)__ldg(W + (size_t)r * n_out + c),
                  acc);
      out[c] = epilogue_out((float)acc, mode);
      if (act != nullptr) act[c] = epilogue_act(out[c], mode);
    }
    return;
  }
  for (int c0 = 0; c0 < n_out; c0 += 256) {
    const int kc = min(8, (n_out - c0) >> 5);
    float acc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      acc[k] = (k < kc && bias != nullptr)
                   ? __ldg(bias + c0 + lane + 32 * k) : 0.0f;
    const float* col = W + c0 + lane;
#pragma unroll 4
    for (int r = 0; r < n_in; ++r) {
      const float x = in[r];
      const float* row = col + (size_t)r * n_out;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (k < kc) acc[k] = fmaf(x, __ldg(row + 32 * k), acc[k]);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (k < kc) {
        out[c0 + lane + 32 * k] = epilogue_out(acc[k], mode);
      }
    }
    if (act != nullptr)
      for (int c = c0 + lane; c < c0 + 32 * kc; c += 32)
        act[c] = epilogue_act(out[c], mode);
  }
}

// g[c] *= silu'(pre[c]) on the lane's units (the lane wrote them itself).
__device__ __forceinline__ void silu_backward(float* g, const float* pre,
                                              int n, int lane) {
  for (int c = lane; c < n; c += 32) {
    const float x = pre[c];
    const float s = sigmoid(x);
    g[c] *= s * (1.0f + x * (1.0f - s));
  }
}

// g[c] *= act'(pre[c]) on the lane's units: silu_backward for any
// activation
__device__ __forceinline__ void act_backward(float* g, const float* pre,
                                             int n, int act, int lane) {
  for (int c = lane; c < n; c += 32) g[c] *= activate_grad(pre[c], act);
}

// ---------------------------------------------------------------------------
// The module-list gradient (nuts_chain_kernel)
// ---------------------------------------------------------------------------
//
// Module k of the chain (in the chain's forward order) is described by
// mods[kModInts k + .]: kind, offset of its leaves in `params`, h1 and h2
// (its conditioner's first and last hidden widths), knots (splines), and
// a float's bits: the clamp (affine), the range B (spline) or the
// constant ladj sum(log diag chol) (Whiten); and its conditioner by
// forms[kFormInts k + .]: the number of layers L (1 to kMaxLayers), the
// activation, flags (kFormBf16: bf16 operands; kFormGeneral: the module
// belongs to a flow of another form than the main paths', whose every
// coupling runs the general path) and the hidden widths h_1 .. h_{L-1}.
// Its leaves, as kernels/nuts_cuda.py `pack_flow` writes them:
//   Standardize:  loc, log_scale (d each);
//   Whiten:       loc (d), chol^T (d, d), chol (d, d): x = z chol^T + loc;
//   coupling:     mask (d); W_1 (d, h_1), b_1; ...; W_L (h_{L-1}, n), b_L
//                 (n); W_1^T, ..., W_L^T, with n = 2d (affine) or (3K-1) d
//                 (spline, p-major columns p d + i); bf16 weights rounded.
// `Mlp` / `mlp_at` read the 3-layer layout (the main paths' form, which
// the funnel's own units compute), and the mask and n_out of any depth;
// `mlp_layer` reads any layer of any depth.

struct Mlp {
  const float *mask, *w1, *b1, *w2, *b2, *w3, *b3, *w1t, *w2t, *w3t;
  int h1, h2, n_out;
};

__device__ __forceinline__ Mlp mlp_at(const Args& a, const int* md) {
  Mlp m;
  const int d = a.d, h1 = md[2], h2 = md[3];
  m.h1 = h1;
  m.h2 = h2;
  m.n_out = md[0] == tpuflows_nuts::kAffine ? 2 * d : (3 * md[4] - 1) * d;
  const float* p = a.params + md[1];
  m.mask = p;  p += d;
  m.w1 = p;    p += d * h1;
  m.b1 = p;    p += h1;
  m.w2 = p;    p += h1 * h2;
  m.b2 = p;    p += h2;
  m.w3 = p;    p += h2 * m.n_out;
  m.b3 = p;    p += m.n_out;
  m.w1t = p;   p += h1 * d;
  m.w2t = p;   p += h2 * h1;
  m.w3t = p;
  return m;
}

// Layer k (0 .. L-1) of a coupling's conditioner as packed: its weight W
// (n_in x n_out, row-major), bias and transposed copy W^T.
struct Layer {
  const float *w, *b, *wt;
  int n_in, n_out;
};

// width k of the conditioner d -> h_1 -> ... -> h_{L-1} -> n_out
__device__ __forceinline__ int mlp_width(const int* fm, int k, int d,
                                         int n_out) {
  return k == 0 ? d : (k == fm[0] ? n_out : fm[2 + k]);
}

__device__ __forceinline__ int head_width(const Args& a, const int* md) {
  return md[0] == tpuflows_nuts::kAffine ? 2 * a.d : (3 * md[4] - 1) * a.d;
}

__device__ __forceinline__ Layer mlp_layer(const Args& a, const int* md,
                                           const int* fm, int k) {
  const int d = a.d, L = fm[0], n_out = head_width(a, md);
  size_t before = 0, all = 0, before_t = 0;
  for (int j = 0; j < L; ++j) {
    const size_t i = mlp_width(fm, j, d, n_out);
    const size_t o = mlp_width(fm, j + 1, d, n_out);
    if (j < k) {
      before += i * o + o;
      before_t += i * o;
    }
    all += i * o + o;
  }
  const float* p = a.params + md[1] + d;  // past the mask
  Layer y;
  y.n_in = mlp_width(fm, k, d, n_out);
  y.n_out = mlp_width(fm, k + 1, d, n_out);
  y.w = p + before;
  y.b = y.w + (size_t)y.n_in * y.n_out;
  y.wt = p + all + before_t;
  return y;
}

// the warp's scratch: each module's input (sweep 1), the conditioner's
// input xin, then for each hidden layer k = 1 .. nhid its pre-activation
// (`hidden_pre`) and activation (`hidden_act`), hmax floats each, and the
// head; a1, v1, a2, v2 are the first two hidden layers' buffers, which
// the 3-layer functions of tile_grad.cuh name
struct Scratch {
  float *bounds, *xin, *a1, *v1, *a2, *v2, *head;
  int hmax;
};

__device__ __forceinline__ Scratch scratch_at(const Args& a,
                                              const ChainList& c, float* sm) {
  Scratch s;
  s.bounds = sm;
  s.xin = s.bounds + c.n_mods * a.d;
  s.a1 = s.xin + a.d;
  s.v1 = s.a1 + c.hmax;
  s.a2 = s.v1 + c.hmax;
  s.v2 = s.a2 + c.hmax;
  s.head = s.a1 + 2 * c.nhid * c.hmax;
  s.hmax = c.hmax;
  return s;
}

__device__ __forceinline__ float* hidden_pre(const Scratch& s, int k) {
  return s.a1 + 2 * (k - 1) * s.hmax;
}

__device__ __forceinline__ float* hidden_act(const Scratch& s, int k) {
  return s.a1 + (2 * k - 1) * s.hmax;
}

// the products' mode of a conditioner's forward pass: its activation, bf16
// rounding of each layer's input, double sums on the general path
__device__ __forceinline__ int forward_mode(const int* fm) {
  return fm[1] | ((fm[2] & tpuflows_nuts::kFormBf16) ? kRoundAct : 0) |
         ((fm[2] & tpuflows_nuts::kFormGeneral) ? kWide : 0);
}

// ... and of its backward pass: bf16 rounding of each input cotangent
__device__ __forceinline__ int backward_mode(const int* fm) {
  return ((fm[2] & tpuflows_nuts::kFormBf16) ? kRoundOut : 0) |
         ((fm[2] & tpuflows_nuts::kFormGeneral) ? kWide : 0);
}

// head = MLP(xin), keeping each hidden layer's pre-activation for the
// backward; a bf16 conditioner rounds xin first (each lane its own units,
// those it wrote). `sums`: flags added to every product's mode (kWide on
// the wide units)
__device__ void mlp_forward(const Args& a, const int* md, const int* fm,
                            const Scratch& s, int lane, int sums = 0) {
  const int L = fm[0];
  const int mode = forward_mode(fm) | sums;
  if (fm[2] & tpuflows_nuts::kFormBf16)
    for (int c = lane; c < a.d; c += 32) s.xin[c] = bf16_round(s.xin[c]);
  __syncwarp();
  const float* in = s.xin;
  for (int k = 0; k < L; ++k) {
    const Layer y = mlp_layer(a, md, fm, k);
    const bool last = k == L - 1;
    float* pre = last ? s.head : hidden_pre(s, k + 1);
    float* act = last ? nullptr : hidden_act(s, k + 1);
    matvec(y.w, y.b, in, y.n_in, y.n_out, pre, act, mode, lane);
    __syncwarp();
    in = act;
  }
}

// xin = d (head . MLP) / d input for the cotangent in head; the hidden
// activations' buffers hold the hidden cotangents on the way
__device__ void mlp_backward(const Args& a, const int* md, const int* fm,
                             const Scratch& s, int lane, int sums = 0) {
  const int L = fm[0], act = fm[1];
  const int mode = backward_mode(fm) | sums;
  __syncwarp();
  const float* g = s.head;
  for (int k = L - 1; k >= 0; --k) {
    const Layer y = mlp_layer(a, md, fm, k);
    float* out = k > 0 ? hidden_act(s, k) : s.xin;
    matvec(y.wt, nullptr, g, y.n_out, y.n_in, out, nullptr, mode, lane);
    if (k > 0) act_backward(out, hidden_pre(s, k), y.n_in, act, lane);
    __syncwarp();
    g = out;
  }
}

// A d-vector of one row as lane `lane` of the row's warp holds it:
// element j < count(a) is dim lane + 32 j. The per-warp and tile kernels
// hold it in registers, DPL = d / 32 elements a lane (`InRegs`); the wide
// units (wide_grad.cuh) in memory at the runtime lane width a.d
// (`InMem`). targets.cuh and the module functions below are written once
// over either, so that the wide units compute what the register units
// compute, operation for operation. kSums: the flags a row's conditioner
// products add to their mode (`matvec`): the wide units sum every product
// in double.
template <int DPL, class T = float>
struct InRegs {
  static constexpr int kSums = 0;
  T (&v)[DPL];
  __device__ __forceinline__ int count(const Args&) const { return DPL; }
  __device__ __forceinline__ T& operator[](int j) const { return v[j]; }
};

template <class T = float>
struct InMem {
  static constexpr int kSums = kWide;
  T* v;
  int lane;
  __device__ __forceinline__ int count(const Args& a) const {
    return a.d >> 5;
  }
  __device__ __forceinline__ T& operator[](int j) const {
    return v[lane + 32 * j];
  }
};

// a view's elements read-only: every caller passes the targets x so, so
// that a unit compiles each target function once for its views
template <int DPL, class T>
__device__ __forceinline__ InRegs<DPL, const T> read_only(InRegs<DPL, T> r) {
  return {r.v};
}

template <class T>
__device__ __forceinline__ InMem<const T> read_only(InMem<T> r) {
  return {r.v, r.lane};
}

// y = y chol^T + loc (Whiten's inverse, W = chol^T and bias = loc; its
// constant ladj comes from the host) or g = g chol (its pullback, W =
// chol, no bias) on the lane's dims, through xin and head, summed in
// double as the general path's products
template <class Y>
__device__ __forceinline__ void whiten_matvec(const Args& a, const float* W,
                                              const float* bias,
                                              const Scratch& s, Y y,
                                              int lane) {
  const int n = y.count(a);
#pragma unroll
  for (int j = 0; j < n; ++j) s.xin[lane + 32 * j] = y[j];
  __syncwarp();
  matvec(W, bias, s.xin, a.d, a.d, s.head, nullptr, kWide, lane);
  __syncwarp();
#pragma unroll
  for (int j = 0; j < n; ++j) y[j] = s.head[lane + 32 * j];
  __syncwarp();
}

// One module's inverse on the lane's dims of y, in place; returns the
// lane's part of its ladj. Not inlined (nor module_vjp): with the tree
// state live around the call, inlining both into the kernel cost spills
// and 30% of the time (PERF.md).
template <class Y>
__device__ __noinline__ float module_inverse(const Args& a, const int* md,
                                             const int* fm, const Scratch& s,
                                             Y y, int lane) {
  const int d = a.d, n = y.count(a);
  const float* p = a.params + md[1];
  float ladj = 0.0f;
  if (md[0] == tpuflows_nuts::kWhiten) {
    whiten_matvec(a, p + d, p, s, y, lane);
    return lane == 0 ? __int_as_float(md[5]) : 0.0f;  // once a row
  }
  if (md[0] == tpuflows_nuts::kStandardize) {
#pragma unroll
    for (int j = 0; j < n; ++j) {
      const int i = lane + 32 * j;
      const float ls = __ldg(p + d + i);
      y[j] = y[j] * expf(ls) + __ldg(p + i);
      ladj += ls;
    }
    return ladj;
  }
  const Mlp m = mlp_at(a, md);
#pragma unroll
  for (int j = 0; j < n; ++j) {
    const int i = lane + 32 * j;
    s.xin[i] = y[j] * __ldg(m.mask + i);
  }
  mlp_forward(a, md, fm, s, lane, Y::kSums);
  const float c = __int_as_float(md[5]);
  if (md[0] == tpuflows_nuts::kAffine) {
    // y' = m y + (1 - m) (y - shift) exp(-s), s = clamp tanh(raw / clamp)
#pragma unroll
    for (int j = 0; j < n; ++j) {
      const int i = lane + 32 * j;
      const float mk = __ldg(m.mask + i);
      const float om = 1.0f - mk;
      const float sc = c * tanhf(s.head[d + i] / c);
      y[j] = mk * y[j] + om * ((y[j] - s.head[i]) * expf(-sc));
      ladj -= om * sc;
    }
  } else {
    // the spline on the transformed dims; pass-through dims keep y
    const int K = md[4];
#pragma unroll
    for (int j = 0; j < n; ++j) {
      const int i = lane + 32 * j;
      if (__ldg(m.mask + i) == 0.0f) {
        float x, l;
        tpuflows_rqs::rqs_inverse(y[j], s.head + i, d, K, c, x, l);
        y[j] = x;
        ladj += l;
      }
    }
  }
  __syncwarp();
  return ladj;
}

// Pulls g (the cotangent of a module's output) back to its input y_in
// (ladj's cotangent is 1), in place; the input dims' direct part is kept
// in g while the MLP's backward runs. Recomputes the conditioner unless
// `live` says that its buffers still hold it.
template <class G>
__device__ __noinline__ void module_vjp(const Args& a, const int* md,
                                        const int* fm, const Scratch& s,
                                        const float* y_in, bool& live, G g,
                                        int lane) {
  const int d = a.d, n = g.count(a);
  if (md[0] == tpuflows_nuts::kWhiten) {  // g_z = g_x chol
    const float* p = a.params + md[1];
    whiten_matvec(a, p + d + d * d, nullptr, s, g, lane);
    live = false;  // xin and head no longer hold a conditioner
    return;
  }
  if (md[0] == tpuflows_nuts::kStandardize) {
    const float* p = a.params + md[1];
#pragma unroll
    for (int j = 0; j < n; ++j)
      g[j] *= expf(__ldg(p + d + lane + 32 * j));
    return;
  }
  const Mlp m = mlp_at(a, md);
  if (!live) {
#pragma unroll
    for (int j = 0; j < n; ++j) {
      const int i = lane + 32 * j;
      s.xin[i] = y_in[i] * __ldg(m.mask + i);
    }
    mlp_forward(a, md, fm, s, lane, G::kSums);
  }
  live = false;
  const float c = __int_as_float(md[5]);
  if (md[0] == tpuflows_nuts::kAffine) {
    // the head's cotangent is written over the head, lane by lane
#pragma unroll
    for (int j = 0; j < n; ++j) {
      const int i = lane + 32 * j;
      const float mk = __ldg(m.mask + i);
      const float om = 1.0f - mk;
      const float shift = s.head[i];
      const float th = tanhf(s.head[d + i] / c);
      const float e = expf(-(c * th));
      const float yt = (y_in[i] - shift) * e;
      const float gy = g[j];
      s.head[i] = -om * gy * e;
      s.head[d + i] = -om * (gy * yt + 1.0f) * (1.0f - th * th);
      g[j] = gy * (mk + om * e);
    }
  } else {
    const int K = md[4], P = 3 * K - 1;
#pragma unroll
    for (int j = 0; j < n; ++j) {
      const int i = lane + 32 * j;
      float* col = s.head + i;
      if (__ldg(m.mask + i) == 0.0f) {
        float gd;
        tpuflows_rqs::rqs_inverse_vjp(y_in[i], col, d, K, c, g[j], 1.0f,
                                      gd, col, d);
        g[j] = gd;
      } else {
        for (int q = 0; q < P; ++q) col[q * d] = 0.0f;
      }
    }
  }
  mlp_backward(a, md, fm, s, lane, G::kSums);
#pragma unroll
  for (int j = 0; j < n; ++j) {
    const int i = lane + 32 * j;
    g[j] = g[j] + __ldg(m.mask + i) * s.xin[i];
  }
  __syncwarp();  // xin and head are written again by the next module
}

#include "targets.cuh"

// lp = log p(f^-1(z)) + ladj and g = d lp / dz through the module list, z,
// g and x (the inverse's working row) distinct rows of one view type
template <class Z, class G>
__device__ __forceinline__ float row_logp_grad(const Args& a,
                                               const ChainList& c,
                                               const Scratch& s, Z z, G g,
                                               G x, int lane) {
  const int d = a.d, n = x.count(a);
  float ladj = 0.0f;
#pragma unroll
  for (int j = 0; j < n; ++j) x[j] = z[j];
  // sweep 1: the inverse chain, last module first; keep each input
  for (int k = c.n_mods - 1; k >= 0; --k) {
#pragma unroll
    for (int j = 0; j < n; ++j) s.bounds[k * d + lane + 32 * j] = x[j];
    ladj += module_inverse(a, c.mods + kModInts * k,
                           c.forms + kFormInts * k, s, x, lane);
  }
  const float lp =
      row_target_logp_grad(a, read_only(x), g, lane) + warp_sum(ladj);
  // sweep 2: first module first; its conditioner ran last in sweep 1
  bool live = true;
  for (int k = 0; k < c.n_mods; ++k)
    module_vjp(a, c.mods + kModInts * k, c.forms + kFormInts * k, s,
               s.bounds + k * d, live, g, lane);
  return lp;
}

// the same on a row in registers (the per-warp kernels)
template <int DPL>
__device__ float chain_logp_grad(const Args& a, const ChainList& c,
                                 float* sm, const float (&z)[DPL],
                                 float (&g)[DPL], int lane) {
  float x[DPL];
  return row_logp_grad(a, c, scratch_at(a, c, sm),
                       InRegs<DPL, const float>{z}, InRegs<DPL>{g},
                       InRegs<DPL>{x}, lane);
}

}  // namespace
