// K1 of tpuflows_torch: one whole multinomial-NUTS transition per chain.
//
// Replaces the Pallas kernel `make_fused_nuts_transition`
// (src/tpuflows/kernels/nuts_pallas.py:303, pallas_call at :407) for flows
// of the affine kind: Standardize + one AffineCoupling (any 0/1 mask, any
// clamp) whose conditioner is an MLP d -> h1 -> h2 -> 2d with silu, over
// Neal's funnel. It computes what `_transition_math` (nuts_pallas.py:83-300)
// computes, under the same precomputed-randomness contract: momenta p0,
// direction signs, acceptance uniforms and one uniform per potential leaf
// come in as inputs, so the kernel is deterministic. The plain PyTorch
// version is `transition_math_torch` in kernels/nuts_cuda.py.
//
// Design (the simple one; wgmma, TMA and a tiled MLP wait for later work):
//  * One warp per chain, one warp per block. Nothing couples a chain to
//    its tile-mates in `_transition_math`: a stopped chain is frozen by the
//    masked blends, and the subtree loop ends early only when every chain
//    of the tile is done, so the u_take column of leaf j in doubling k is
//    always 2^k - 1 + j. No tile lockstep is kept, and there is no
//    __syncthreads() anywhere.
//  * Lane layout: lane l holds dims l + 32 j (j < d / 32) of every
//    d-vector in registers, and units l + 32 k of every hidden vector.
//    Dot products and sums reduce with a __shfl_xor_sync butterfly, which
//    leaves the same bits in every lane, so every branch is uniform across
//    the warp. Both loops are bounded: at most `depth` doublings and at
//    most 2^k leaves in doubling k.
//  * The MLP reads its inputs from a per-warp shared-memory buffer guarded
//    by __syncwarp(); its weights (and transposed copies for the backward
//    pass, so that its reads coalesce too) are read from global memory with
//    __ldg and stay resident in L2 (~82 k floats at d = 64, h = 128).
//  * The U-turn checkpoint pairs (2 x depth x d floats) live in registers,
//    selected by unrolled compares against the slot (no dynamic indexing).
//  * The gradient of log p(f^-1(z)) + ladj is written out by hand: funnel
//    logp, Standardize inverse, coupling inverse with the tanh clamp, and
//    the MLP backward through silu. No autograd.
//
// Bound on this card: operations. Each leapfrog costs one MLP forward and
// one input-gradient backward, 2 x 2 x (d h1 + h1 h2 + 2 d h2) flops
// (164 k at the bench shape), while a transition moves only q in and out
// plus its random inputs (about 1 KB per chain). This kernel runs its
// products on the float32 FMA pipes at one chain per warp, far from that
// bound; PERF.md keeps its measured time beside the bound.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Built by kernels/nuts_cuda.py `build` as one translation unit per
// template instantiation (-DNUTS_DPL=1..8, DPL = d / 32 dims per lane), all
// compiled in parallel, plus one unit without NUTS_DPL that holds the C
// entry point, linked into one shared library.

namespace tpuflows_nuts {

constexpr int kMaxDepth = 10;

struct Args {
  const float* q;         // (n, d)
  const float* p0;        // (n, d)
  const float* dirs;      // (n, depth), +-1
  const float* u_acc;     // (n, depth)
  const float* u_take;    // (n, 2^depth)
  const float* eps;       // (1,)
  const float* inv_mass;  // (d,)
  const float* params;    // packed flow, see Net
  int n, d, h1, h2, depth;
  float clamp, sigma_v, max_delta_energy;
  float* q_out;  // (n, d)
  float* info;   // (7, n): lp, sum_accept, n_steps, depth, diverging,
                 //         turning, h0
};

template <int DPL>
cudaError_t launch(const Args& a, cudaStream_t stream);

}  // namespace tpuflows_nuts

#ifdef NUTS_DPL

namespace {

using tpuflows_nuts::Args;
using tpuflows_nuts::kMaxDepth;

constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2Pi = 1.8378770664093453f;

// The packed parameter buffer, in this order (kernels/nuts_cuda.py
// `pack_affine_funnel` writes it): loc, log_scale, mask (d each);
// W1 (d, h1), b1; W2 (h1, h2), b2; W3 (h2, 2d), b3; W1^T, W2^T, W3^T.
struct Net {
  const float *loc, *log_scale, *mask;
  const float *w1, *b1, *w2, *b2, *w3, *b3;
  const float *w1t, *w2t, *w3t;
};

__device__ __forceinline__ Net unpack(const Args& a) {
  Net t;
  const float* p = a.params;
  const int d = a.d, h1 = a.h1, h2 = a.h2;
  t.loc = p;       p += d;
  t.log_scale = p; p += d;
  t.mask = p;      p += d;
  t.w1 = p;        p += d * h1;
  t.b1 = p;        p += h1;
  t.w2 = p;        p += h1 * h2;
  t.b2 = p;        p += h2;
  t.w3 = p;        p += h2 * 2 * d;
  t.b3 = p;        p += 2 * d;
  t.w1t = p;       p += h1 * d;
  t.w2t = p;       p += h2 * h1;
  t.w3t = p;
  return t;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float logaddexp(float a, float b) {
  const float delta = a - b;
  if (isnan(delta)) return a + b;  // both -inf
  return fmaxf(a, b) + log1pf(expf(-fabsf(delta)));
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

// lp = log p(f^-1(z)) + ladj and g = d lp / dz for the warp's chain.
// `sm` is the warp's shared buffer of 6 d + 3 h1 + 3 h2 floats.
template <int DPL>
__device__ float logp_grad(const Args& a, const Net& t, float* sm,
                           const float (&z)[DPL], float (&g)[DPL],
                           int lane) {
  const int d = a.d, h1 = a.h1, h2 = a.h2;
  float* xin = sm;
  float* a1 = xin + d;
  float* v1 = a1 + h1;
  float* a2 = v1 + h1;
  float* v2 = a2 + h2;
  float* out = v2 + h2;
  float* gout = out + 2 * d;
  float* g2 = gout + 2 * d;
  float* g1 = g2 + h2;
  float* gin = g1 + h1;

  float m[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    const int i = lane + 32 * j;
    m[j] = __ldg(t.mask + i);
    xin[i] = z[j] * m[j];
  }
  __syncwarp();
  matvec(t.w1, t.b1, xin, d, h1, a1, v1, lane);
  __syncwarp();
  matvec(t.w2, t.b2, v1, h1, h2, a2, v2, lane);
  __syncwarp();
  matvec(t.w3, t.b3, v2, h2, 2 * d, out, nullptr, lane);
  __syncwarp();

  // coupling inverse: y = m z + (1 - m) (z - shift) exp(-s),
  // s = clamp tanh(raw / clamp); then Standardize inverse
  const float c = a.clamp;
  float x[DPL], e[DPL], yt[DPL], th[DPL], sc[DPL];
  float ladj = 0.0f, sq = 0.0f;
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    const int i = lane + 32 * j;
    const float shift = out[i];
    th[j] = tanhf(out[d + i] / c);
    const float s = c * th[j];
    e[j] = expf(-s);
    yt[j] = (z[j] - shift) * e[j];
    const float y = m[j] * z[j] + (1.0f - m[j]) * yt[j];
    const float ls = __ldg(t.log_scale + i);
    sc[j] = expf(ls);
    x[j] = y * sc[j] + __ldg(t.loc + i);
    ladj += ls - (1.0f - m[j]) * s;
    if (i != 0) sq += x[j] * x[j];
  }
  ladj = warp_sum(ladj);
  sq = warp_sum(sq);

  // funnel: v = x[0] ~ N(0, sigma_v^2), x[1:] | v ~ N(0, exp(v) I)
  const float v = __shfl_sync(kFull, x[0], 0);
  const float sv = a.sigma_v;
  const float k = (float)(d - 1);
  const float env = expf(-v);
  const float vs = v / sv;
  const float lp_v = -0.5f * vs * vs - logf(sv) - 0.5f * kLog2Pi;
  const float lp_rest = -0.5f * sq * env - 0.5f * k * v - 0.5f * k * kLog2Pi;
  const float lp = lp_v + lp_rest + ladj;
  const float gv = -v / (sv * sv) + 0.5f * sq * env - 0.5f * k;

  // backward: funnel -> Standardize -> coupling (shift, s, tanh) -> z
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    const int i = lane + 32 * j;
    const float gx = (i == 0) ? gv : -x[j] * env;
    const float gy = gx * sc[j];
    const float om = 1.0f - m[j];
    gout[i] = -om * gy * e[j];
    gout[d + i] = -om * (gy * yt[j] + 1.0f) * (1.0f - th[j] * th[j]);
    g[j] = gy * (m[j] + om * e[j]);
  }
  __syncwarp();
  matvec(t.w3t, nullptr, gout, 2 * d, h2, g2, nullptr, lane);
  silu_backward(g2, a2, h2, lane);
  __syncwarp();
  matvec(t.w2t, nullptr, g2, h2, h1, g1, nullptr, lane);
  silu_backward(g1, a1, h1, lane);
  __syncwarp();
  matvec(t.w1t, nullptr, g1, h1, d, gin, nullptr, lane);
#pragma unroll
  for (int j = 0; j < DPL; ++j) g[j] += m[j] * gin[lane + 32 * j];
  __syncwarp();  // the buffers are written again by the next call
  return lp;
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

template <int DPL>
__global__ void __launch_bounds__(32) nuts_transition_kernel(Args a) {
  extern __shared__ float smem[];
  const int chain = blockIdx.x;
  const int lane = threadIdx.x;
  const Net t = unpack(a);
  const int d = a.d, D = a.depth;
  const float eps = __ldg(a.eps);
  const float* dirs = a.dirs + (size_t)chain * D;
  const float* u_acc = a.u_acc + (size_t)chain * D;
  const float* u_take = a.u_take + ((size_t)chain << D);

  float im[DPL], q0[DPL], p0[DPL], g0[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    const int i = lane + 32 * j;
    im[j] = __ldg(a.inv_mass + i);
    q0[j] = __ldg(a.q + (size_t)chain * d + i);
    p0[j] = __ldg(a.p0 + (size_t)chain * d + i);
  }
  const float lp0 = logp_grad<DPL>(a, t, smem, q0, g0, lane);
  const float h0 = -lp0 + kinetic<DPL>(p0, im);

  // trajectory: left / right ends (q, p, lp, g), proposal, weight, rho
  float zl_q[DPL], zl_p[DPL], zl_g[DPL], zr_q[DPL], zr_p[DPL], zr_g[DPL];
  float q_prop[DPL], rho[DPL];
  copy<DPL>(zl_q, q0); copy<DPL>(zl_p, p0); copy<DPL>(zl_g, g0);
  copy<DPL>(zr_q, q0); copy<DPL>(zr_p, p0); copy<DPL>(zr_g, g0);
  copy<DPL>(q_prop, q0); copy<DPL>(rho, p0);
  float zl_lp = lp0, zr_lp = lp0, lp_prop = lp0;
  float logw = 0.0f, sum_accept = 0.0f, n_steps = 0.0f, depth = 0.0f;
  bool turning = false, diverging = false;

  for (int k = 0; k < D && !(turning || diverging); ++k) {
    const float dir = __ldg(dirs + k);
    const bool fwd = dir > 0.0f;
    const float eps_s = dir * eps;
    const int n_leaves = 1 << k;
    const float* ut = u_take + (n_leaves - 1);

    // element-wise selects keep both ends in registers
    float s_q[DPL], s_p[DPL], s_g[DPL];
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      s_q[j] = fwd ? zr_q[j] : zl_q[j];
      s_p[j] = fwd ? zr_p[j] : zl_p[j];
      s_g[j] = fwd ? zr_g[j] : zl_g[j];
    }
    float s_lp = fwd ? zr_lp : zl_lp;

    // subtree state
    float st_qp[DPL], st_rho[DPL];
    copy<DPL>(st_qp, s_q);
    float st_lpp = s_lp, st_logw = -INFINITY, st_acc = 0.0f, st_n = 0.0f;
    bool st_turn = false, st_div = false;
    float ck_p[kMaxDepth][DPL], ck_r[kMaxDepth][DPL];
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      st_rho[j] = 0.0f;
#pragma unroll
      for (int i = 0; i < kMaxDepth; ++i) ck_p[i][j] = ck_r[i][j] = 0.0f;
    }

    for (int leaf = 0; leaf < n_leaves && !(st_turn || st_div); ++leaf) {
      float q_new[DPL], p_new[DPL], g_new[DPL];
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        p_new[j] = s_p[j] + 0.5f * eps_s * s_g[j];  // half step
        q_new[j] = s_q[j] + eps_s * p_new[j] * im[j];
      }
      const float lp_new = logp_grad<DPL>(a, t, smem, q_new, g_new, lane);
#pragma unroll
      for (int j = 0; j < DPL; ++j) p_new[j] = p_new[j] + 0.5f * eps_s * g_new[j];
      float dh = -lp_new + kinetic<DPL>(p_new, im) - h0;
      if (!isfinite(dh)) dh = INFINITY;
      const bool div_leaf = dh > a.max_delta_energy;
      const float logw_leaf = div_leaf ? -INFINITY : -dh;
      float accept = fminf(1.0f, expf(fminf(-dh, 0.0f)));
      if (!isfinite(accept)) accept = 0.0f;
      const float logw_new = logaddexp(st_logw, logw_leaf);
      const float u = __ldg(ut + leaf);
      // a divergent leaf may carry inf/nan; it never becomes a proposal
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        if (!isfinite(q_new[j])) q_new[j] = 0.0f;
        if (!isfinite(p_new[j])) p_new[j] = 0.0f;
        if (!isfinite(g_new[j])) g_new[j] = 0.0f;
      }
      if (logf(u) < logw_leaf - logw_new && !div_leaf) {
        copy<DPL>(st_qp, q_new);
        st_lpp = lp_new;
      }
      // checkpoint store: slot popcount(leaf), even leaves only
      if ((leaf & 1) == 0) {
        const int slot = __popc(leaf);
#pragma unroll
        for (int i = 0; i < kMaxDepth; ++i) {
          if (i == slot) {
#pragma unroll
            for (int j = 0; j < DPL; ++j) {
              ck_p[i][j] = p_new[j];
              ck_r[i][j] = st_rho[j];
            }
          }
        }
      }
      float rho_new[DPL];
#pragma unroll
      for (int j = 0; j < DPL; ++j) rho_new[j] = st_rho[j] + p_new[j];
      // U-turn over every complete subtree that ends at this leaf
      const int nl = leaf + 1;
      bool any_turn = false;
      if ((nl & 1) == 0) {
        const int pc = __popc(nl);
        const int lo = pc - 1, hi = pc - 2 + (__ffs(nl) - 1);
#pragma unroll
        for (int i = 0; i < kMaxDepth; ++i) {
          if (i >= lo && i <= hi) {
            float rho_i[DPL];
#pragma unroll
            for (int j = 0; j < DPL; ++j) rho_i[j] = rho_new[j] - ck_r[i][j];
            any_turn |= is_turning<DPL>(ck_p[i], p_new, rho_i, im);
          }
        }
      }
      st_turn = any_turn;
      st_div = div_leaf;
      st_logw = logw_new;
      copy<DPL>(st_rho, rho_new);
      st_acc += accept;
      st_n += 1.0f;
      copy<DPL>(s_q, q_new);
      copy<DPL>(s_p, p_new);
      copy<DPL>(s_g, g_new);
      s_lp = lp_new;
    }

    const bool ok = !(st_turn || st_div);
    if (ok && __ldg(u_acc + k) < fminf(1.0f, expf(st_logw - logw))) {
      copy<DPL>(q_prop, st_qp);
      lp_prop = st_lpp;
    }
    if (ok) {
      if (fwd) {
        copy<DPL>(zr_q, s_q); copy<DPL>(zr_p, s_p); copy<DPL>(zr_g, s_g);
        zr_lp = s_lp;
      } else {
        copy<DPL>(zl_q, s_q); copy<DPL>(zl_p, s_p); copy<DPL>(zl_g, s_g);
        zl_lp = s_lp;
      }
      logw = logaddexp(logw, st_logw);
#pragma unroll
      for (int j = 0; j < DPL; ++j) rho[j] += st_rho[j];
      depth = (float)(k + 1);
    }
    turning = st_turn || (ok && is_turning<DPL>(zl_p, zr_p, rho, im));
    diverging = st_div;
    sum_accept += st_acc;
    n_steps += st_n;
  }

#pragma unroll
  for (int j = 0; j < DPL; ++j)
    a.q_out[(size_t)chain * d + lane + 32 * j] = q_prop[j];
  if (lane == 0) {
    const int n = a.n;
    a.info[chain] = lp_prop;
    a.info[n + chain] = sum_accept;
    a.info[2 * n + chain] = n_steps;
    a.info[3 * n + chain] = depth;
    a.info[4 * n + chain] = diverging ? 1.0f : 0.0f;
    a.info[5 * n + chain] = turning ? 1.0f : 0.0f;
    a.info[6 * n + chain] = h0;
  }
}

}  // namespace

namespace tpuflows_nuts {

template <int DPL>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (6 * a.d + 3 * a.h1 + 3 * a.h2);
  nuts_transition_kernel<DPL><<<a.n, 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template cudaError_t launch<NUTS_DPL>(const Args&, cudaStream_t);

}  // namespace tpuflows_nuts

#else  // the C entry point

namespace {
bool width_ok(int w) { return w >= 32 && w <= 256 && w % 32 == 0; }
}  // namespace

// Returns a cudaError_t (0 = launched). Shapes are checked again here; the
// Python wrapper checks device, dtype and contiguity before calling.
extern "C" int nuts_transition_f32(
    const void* q, const void* p0, const void* dirs, const void* u_acc,
    const void* u_take, const void* eps, const void* inv_mass,
    const void* params, int n, int d, int h1, int h2, int depth,
    float clamp, float sigma_v, float max_delta_energy, void* q_out,
    void* info, void* stream) {
  using namespace tpuflows_nuts;
  if (n < 1 || !width_ok(d) || !width_ok(h1) || !width_ok(h2) || depth < 1 ||
      depth > kMaxDepth)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = static_cast<const float*>(q);
  a.p0 = static_cast<const float*>(p0);
  a.dirs = static_cast<const float*>(dirs);
  a.u_acc = static_cast<const float*>(u_acc);
  a.u_take = static_cast<const float*>(u_take);
  a.eps = static_cast<const float*>(eps);
  a.inv_mass = static_cast<const float*>(inv_mass);
  a.params = static_cast<const float*>(params);
  a.n = n; a.d = d; a.h1 = h1; a.h2 = h2; a.depth = depth;
  a.clamp = clamp; a.sigma_v = sigma_v; a.max_delta_energy = max_delta_energy;
  a.q_out = static_cast<float*>(q_out);
  a.info = static_cast<float*>(info);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d / 32) {
    case 1: return (int)launch<1>(a, s);
    case 2: return (int)launch<2>(a, s);
    case 3: return (int)launch<3>(a, s);
    case 4: return (int)launch<4>(a, s);
    case 5: return (int)launch<5>(a, s);
    case 6: return (int)launch<6>(a, s);
    case 7: return (int)launch<7>(a, s);
    default: return (int)launch<8>(a, s);
  }
}

#endif  // NUTS_DPL
