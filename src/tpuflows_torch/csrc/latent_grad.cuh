// The latent log density and its gradient, one warp per row:
//   lp = log p(f^-1(z)) + ladj(z) and g = d lp / dz
// over a target of targets.cuh (`target_logp_grad`, on a.kind):
//  * `chain_logp_grad`: any Chain of Standardize, AffineCoupling and
//    RQSCouplingBlock modules with 3-layer silu MLPs d -> h1 -> h2 -> n,
//    given as a module list
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
// the target's log p (targets.cuh), Standardize inverse, coupling inverse
// with the tanh clamp, spline inverse and its pullback, and the MLP
// backward through silu. No autograd.
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

// The module list of the module-list kernels: kModInts ints per module (see
// the module-list gradient), the widest hidden layer and conditioner output.
struct ChainList {
  const int* mods;
  int n_mods, hmax, head;
};

constexpr int kMaxModules = 16;
constexpr int kModInts = 8;
enum ModuleKind { kStandardize = 0, kAffine = 1, kSpline = 2 };

}  // namespace tpuflows_nuts

namespace {

using tpuflows_nuts::Args;
using tpuflows_nuts::ChainList;
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

// out[c] = bias[c] + sum_r in[r] * W[r * n_out + c] for the lane's columns
// c = c0 + lane + 32 k; `in` is the warp's shared buffer. When `act` is
// given it also receives silu(out[c]). n_out is a multiple of 32.
__device__ void matvec(const float* __restrict__ W,
                       const float* __restrict__ bias, const float* in,
                       int n_in, int n_out, float* out, float* act,
                       int lane) {
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
        const int c = c0 + lane + 32 * k;
        out[c] = acc[k];
        if (act != nullptr) act[c] = acc[k] * sigmoid(acc[k]);
      }
    }
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

// ---------------------------------------------------------------------------
// The module-list gradient (nuts_chain_kernel)
// ---------------------------------------------------------------------------
//
// Module k of the chain (in the chain's forward order) is described by
// mods[kModInts k + .]: kind, offset of its leaves in `params`, h1, h2,
// knots (splines), and a float's bits: the clamp (affine) or the range B
// (spline). Its leaves, as kernels/nuts_cuda.py `pack_flow` writes them:
//   Standardize:  loc, log_scale (d each);
//   coupling:     mask (d); W1 (d, h1), b1; W2 (h1, h2), b2; W3 (h2, n),
//                 b3 (n); W1^T, W2^T, W3^T, with n = 2d (affine) or
//                 (3K-1) d (spline, p-major columns p d + i).

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

// the warp's scratch: each module's input (sweep 1), then the MLP buffers
struct Scratch {
  float *bounds, *xin, *a1, *v1, *a2, *v2, *head;
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
  s.head = s.v2 + c.hmax;
  return s;
}

// head = MLP(xin), keeping the pre-activations a1, a2 for the backward
__device__ void mlp_forward(const Mlp& m, int d, const Scratch& s,
                            int lane) {
  __syncwarp();
  matvec(m.w1, m.b1, s.xin, d, m.h1, s.a1, s.v1, lane);
  __syncwarp();
  matvec(m.w2, m.b2, s.v1, m.h1, m.h2, s.a2, s.v2, lane);
  __syncwarp();
  matvec(m.w3, m.b3, s.v2, m.h2, m.n_out, s.head, nullptr, lane);
  __syncwarp();
}

// xin = d (head . MLP) / d input for the cotangent in head; v2 and v1
// hold the hidden cotangents on the way
__device__ void mlp_backward(const Mlp& m, int d, const Scratch& s,
                             int lane) {
  __syncwarp();
  matvec(m.w3t, nullptr, s.head, m.n_out, m.h2, s.v2, nullptr, lane);
  silu_backward(s.v2, s.a2, m.h2, lane);
  __syncwarp();
  matvec(m.w2t, nullptr, s.v2, m.h2, m.h1, s.v1, nullptr, lane);
  silu_backward(s.v1, s.a1, m.h1, lane);
  __syncwarp();
  matvec(m.w1t, nullptr, s.v1, m.h1, d, s.xin, nullptr, lane);
  __syncwarp();
}

// One module's inverse on the lane's dims, in place; returns the lane's
// part of its ladj. Not inlined (nor module_vjp): with the tree state
// live around the call, inlining both into the kernel cost spills and 30%
// of the time (PERF.md).
template <int DPL>
__device__ __noinline__ float module_inverse(const Args& a, const int* md,
                                const Scratch& s, float (&y)[DPL],
                                int lane) {
  const int d = a.d;
  const float* p = a.params + md[1];
  float ladj = 0.0f;
  if (md[0] == tpuflows_nuts::kStandardize) {
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int i = lane + 32 * j;
      const float ls = __ldg(p + d + i);
      y[j] = y[j] * expf(ls) + __ldg(p + i);
      ladj += ls;
    }
    return ladj;
  }
  const Mlp m = mlp_at(a, md);
  float mk[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    const int i = lane + 32 * j;
    mk[j] = __ldg(m.mask + i);
    s.xin[i] = y[j] * mk[j];
  }
  mlp_forward(m, d, s, lane);
  const float c = __int_as_float(md[5]);
  if (md[0] == tpuflows_nuts::kAffine) {
    // y' = m y + (1 - m) (y - shift) exp(-s), s = clamp tanh(raw / clamp)
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int i = lane + 32 * j;
      const float om = 1.0f - mk[j];
      const float sc = c * tanhf(s.head[d + i] / c);
      y[j] = mk[j] * y[j] + om * ((y[j] - s.head[i]) * expf(-sc));
      ladj -= om * sc;
    }
  } else {
    // the spline on the transformed dims; pass-through dims keep y
    const int K = md[4];
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      if (mk[j] == 0.0f) {
        float x, l;
        tpuflows_rqs::rqs_inverse(y[j], s.head + lane + 32 * j, d, K, c, x,
                                  l);
        y[j] = x;
        ladj += l;
      }
    }
  }
  __syncwarp();
  return ladj;
}

// Pulls g (the cotangent of a module's output) back to its input y_in
// (ladj's cotangent is 1). Recomputes the conditioner unless `live` says
// that its buffers still hold it.
template <int DPL>
__device__ __noinline__ void module_vjp(const Args& a, const int* md, const Scratch& s,
                           const float* y_in, bool& live, float (&g)[DPL],
                           int lane) {
  const int d = a.d;
  if (md[0] == tpuflows_nuts::kStandardize) {
    const float* p = a.params + md[1];
#pragma unroll
    for (int j = 0; j < DPL; ++j)
      g[j] *= expf(__ldg(p + d + lane + 32 * j));
    return;
  }
  const Mlp m = mlp_at(a, md);
  float y[DPL], mk[DPL], gd[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    const int i = lane + 32 * j;
    y[j] = y_in[i];
    mk[j] = __ldg(m.mask + i);
  }
  if (!live) {
#pragma unroll
    for (int j = 0; j < DPL; ++j) s.xin[lane + 32 * j] = y[j] * mk[j];
    mlp_forward(m, d, s, lane);
  }
  live = false;
  const float c = __int_as_float(md[5]);
  if (md[0] == tpuflows_nuts::kAffine) {
    // the head's cotangent is written over the head, lane by lane
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int i = lane + 32 * j;
      const float om = 1.0f - mk[j];
      const float shift = s.head[i];
      const float th = tanhf(s.head[d + i] / c);
      const float e = expf(-(c * th));
      const float yt = (y[j] - shift) * e;
      const float gy = g[j];
      s.head[i] = -om * gy * e;
      s.head[d + i] = -om * (gy * yt + 1.0f) * (1.0f - th * th);
      gd[j] = gy * (mk[j] + om * e);
    }
  } else {
    const int K = md[4], P = 3 * K - 1;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      float* col = s.head + lane + 32 * j;
      if (mk[j] == 0.0f) {
        tpuflows_rqs::rqs_inverse_vjp(y[j], col, d, K, c, g[j], 1.0f, gd[j],
                                      col, d);
      } else {
        gd[j] = g[j];
        for (int q = 0; q < P; ++q) col[q * d] = 0.0f;
      }
    }
  }
  mlp_backward(m, d, s, lane);
#pragma unroll
  for (int j = 0; j < DPL; ++j) g[j] = gd[j] + mk[j] * s.xin[lane + 32 * j];
  __syncwarp();  // xin and head are written again by the next module
}

#include "targets.cuh"

// lp = log p(f^-1(z)) + ladj and g = d lp / dz through the module list.
template <int DPL>
__device__ float chain_logp_grad(const Args& a, const ChainList& c,
                                 float* sm, const float (&z)[DPL],
                                 float (&g)[DPL], int lane) {
  const int d = a.d;
  const Scratch s = scratch_at(a, c, sm);
  float x[DPL];
  float ladj = 0.0f;
#pragma unroll
  for (int j = 0; j < DPL; ++j) x[j] = z[j];
  // sweep 1: the inverse chain, last module first; keep each input
  for (int k = c.n_mods - 1; k >= 0; --k) {
#pragma unroll
    for (int j = 0; j < DPL; ++j) s.bounds[k * d + lane + 32 * j] = x[j];
    ladj += module_inverse<DPL>(a, c.mods + kModInts * k, s, x, lane);
  }
  const float lp = target_logp_grad<DPL>(a, x, g, lane) + warp_sum(ladj);
  // sweep 2: first module first; its conditioner ran last in sweep 1
  bool live = true;
  for (int k = 0; k < c.n_mods; ++k)
    module_vjp<DPL>(a, c.mods + kModInts * k, s, s.bounds + k * d, live, g,
                    lane);
  return lp;
}

}  // namespace
