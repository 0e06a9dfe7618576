// The tree code of one multinomial-NUTS transition on the wide path, shared
// by K1's and K2's wide units (nuts_transition_wide.cu,
// nuts_window_wide.cu): nuts_tree_body.inc's tree, step for step, on a row
// whose vectors live in the launch's work buffer (wide_grad.cuh
// `WideRow`) at any lane width and at any depth up to kWideMaxDepth, its
// U-turn checkpoints indexed by slot (depth x d floats each way) where the
// register units select them by unrolled compares against kMaxDepth = 10.
// Lane l works on elements l + 32 j of every vector, as in registers, so
// the tree needs no barrier of its own. The transition always carries the
// proposal's gradient (the subtree's st_gp, the transition's g_prop), as
// K2's hooks make nuts_tree_body.inc do; K1 ignores it.
#pragma once

#include "wide_grad.cuh"

namespace {

#include "nuts_tree.cuh"  // logaddexp

// the metric's element i, 0 at and past the target's width
__device__ __forceinline__ float wide_im(const Args& a, int i) {
  return i < a.dim ? __ldg(a.inv_mass + i) : 0.0f;
}

__device__ __forceinline__ float wide_kinetic(const Args& a, const float* p,
                                              int lane) {
  float s = 0.0f;
  for (int i = lane; i < a.d; i += 32) s += p[i] * p[i] * wide_im(a, i);
  return 0.5f * warp_sum(s);
}

// generalized U-turn over rho = rho_a - rho_b (rho_b null: rho_a alone):
// rho . M^-1 p <= 0 at either end (nuts_tree.cuh `is_turning`)
__device__ __forceinline__ bool wide_is_turning(const Args& a,
                                                const float* pl,
                                                const float* pr,
                                                const float* rho_a,
                                                const float* rho_b,
                                                int lane) {
  float sl = 0.0f, sr = 0.0f;
  for (int i = lane; i < a.d; i += 32) {
    const float rho = rho_b != nullptr ? rho_a[i] - rho_b[i] : rho_a[i];
    const float v = rho * wide_im(a, i);
    sl += v * pl[i];
    sr += v * pr[i];
  }
  return warp_sum(sl) <= 0.0f || warp_sum(sr) <= 0.0f;
}

__device__ __forceinline__ void wide_copy(const Args& a, float* dst,
                                          const float* src, int lane) {
  for (int i = lane; i < a.d; i += 32) dst[i] = src[i];
}

// One transition of the row w from w.q0, with lp0 and w.g0 the latent log
// density and its gradient there: randomness from row `r` of p0, dirs,
// u_acc and u_take, the draw to row `o` of q_out and info's column `o` at
// a stride of `stride` between info's rows. Leaves the proposal in
// w.q_prop and its gradient in w.g_prop, and returns its lp.
__device__ float wide_transition(const Args& a, const ChainList& c,
                                 const WideRow& w, float lp0, int r, int o,
                                 int stride, int lane) {
  const int dim = a.dim, D = a.depth, d = a.d;
  const float eps = __ldg(a.eps);
  const float* dirs = a.dirs + (size_t)r * D;
  const float* u_acc = a.u_acc + (size_t)r * D;
  const float* u_take = a.u_take + ((size_t)r << D);

  for (int i = lane; i < d; i += 32)
    w.p0[i] = i < dim ? __ldg(a.p0 + (size_t)r * dim + i) : 0.0f;
  const float h0 = -lp0 + wide_kinetic(a, w.p0, lane);

  // trajectory: left / right ends (q, p, lp, g), proposal, weight, rho
  wide_copy(a, w.zl_q, w.q0, lane); wide_copy(a, w.zl_p, w.p0, lane);
  wide_copy(a, w.zl_g, w.g0, lane); wide_copy(a, w.zr_q, w.q0, lane);
  wide_copy(a, w.zr_p, w.p0, lane); wide_copy(a, w.zr_g, w.g0, lane);
  wide_copy(a, w.q_prop, w.q0, lane); wide_copy(a, w.rho, w.p0, lane);
  wide_copy(a, w.st_gp, w.g0, lane); wide_copy(a, w.g_prop, w.g0, lane);
  float zl_lp = lp0, zr_lp = lp0, lp_prop = lp0;
  float logw = 0.0f, sum_accept = 0.0f, n_steps = 0.0f, depth = 0.0f;
  bool turning = false, diverging = false;

  for (int k = 0; k < D && !(turning || diverging); ++k) {
    const float dir = __ldg(dirs + k);
    const bool fwd = dir > 0.0f;
    const float eps_s = dir * eps;
    const int n_leaves = 1 << k;
    const float* ut = u_take + (n_leaves - 1);

    wide_copy(a, w.s_q, fwd ? w.zr_q : w.zl_q, lane);
    wide_copy(a, w.s_p, fwd ? w.zr_p : w.zl_p, lane);
    wide_copy(a, w.s_g, fwd ? w.zr_g : w.zl_g, lane);
    float s_lp = fwd ? zr_lp : zl_lp;

    // subtree state
    wide_copy(a, w.st_qp, w.s_q, lane);
    float st_lpp = s_lp, st_logw = -INFINITY, st_acc = 0.0f, st_n = 0.0f;
    bool st_turn = false, st_div = false;
    for (int i = lane; i < d; i += 32) w.st_rho[i] = 0.0f;
    for (int i = lane; i < D * d; i += 32) w.ck_p[i] = w.ck_r[i] = 0.0f;

    for (int leaf = 0; leaf < n_leaves && !(st_turn || st_div); ++leaf) {
      for (int i = lane; i < d; i += 32) {
        w.p_new[i] = w.s_p[i] + 0.5f * eps_s * w.s_g[i];  // half step
        w.q_new[i] = w.s_q[i] + eps_s * w.p_new[i] * wide_im(a, i);
      }
      const float lp_new = wide_logp_grad(a, c, w.s, w.q_new, w.g_new, w.x,
                                          lane);
      for (int i = lane; i < d; i += 32)
        w.p_new[i] = w.p_new[i] + 0.5f * eps_s * w.g_new[i];
      float dh = -lp_new + wide_kinetic(a, w.p_new, lane) - h0;
      if (!isfinite(dh)) dh = INFINITY;
      const bool div_leaf = dh > a.max_delta_energy;
      const float logw_leaf = div_leaf ? -INFINITY : -dh;
      float accept = fminf(1.0f, expf(fminf(-dh, 0.0f)));
      if (!isfinite(accept)) accept = 0.0f;
      const float logw_new = logaddexp(st_logw, logw_leaf);
      const float u = __ldg(ut + leaf);
      // a divergent leaf may carry inf/nan; it never becomes a proposal
      for (int i = lane; i < d; i += 32) {
        if (!isfinite(w.q_new[i])) w.q_new[i] = 0.0f;
        if (!isfinite(w.p_new[i])) w.p_new[i] = 0.0f;
        if (!isfinite(w.g_new[i])) w.g_new[i] = 0.0f;
      }
      if (logf(u) < logw_leaf - logw_new && !div_leaf) {
        wide_copy(a, w.st_qp, w.q_new, lane);
        wide_copy(a, w.st_gp, w.g_new, lane);
        st_lpp = lp_new;
      }
      // checkpoint store: slot popcount(leaf), even leaves only
      if ((leaf & 1) == 0) {
        const size_t slot = (size_t)__popc(leaf) * d;
        wide_copy(a, w.ck_p + slot, w.p_new, lane);
        wide_copy(a, w.ck_r + slot, w.st_rho, lane);
      }
      for (int i = lane; i < d; i += 32)
        w.rho_new[i] = w.st_rho[i] + w.p_new[i];
      // U-turn over every complete subtree that ends at this leaf
      const int nl = leaf + 1;
      bool any_turn = false;
      if ((nl & 1) == 0) {
        const int pc = __popc(nl);
        const int lo = max(pc - 1, 0);
        const int hi = min(pc - 2 + (__ffs(nl) - 1), D - 1);
        for (int i = lo; i <= hi; ++i)
          any_turn |= wide_is_turning(a, w.ck_p + (size_t)i * d, w.p_new,
                                      w.rho_new, w.ck_r + (size_t)i * d,
                                      lane);
      }
      st_turn = any_turn;
      st_div = div_leaf;
      st_logw = logw_new;
      wide_copy(a, w.st_rho, w.rho_new, lane);
      st_acc += accept;
      st_n += 1.0f;
      wide_copy(a, w.s_q, w.q_new, lane);
      wide_copy(a, w.s_p, w.p_new, lane);
      wide_copy(a, w.s_g, w.g_new, lane);
      s_lp = lp_new;
    }

    const bool ok = !(st_turn || st_div);
    if (ok && __ldg(u_acc + k) < fminf(1.0f, expf(st_logw - logw))) {
      wide_copy(a, w.q_prop, w.st_qp, lane);
      wide_copy(a, w.g_prop, w.st_gp, lane);
      lp_prop = st_lpp;
    }
    if (ok) {
      if (fwd) {
        wide_copy(a, w.zr_q, w.s_q, lane); wide_copy(a, w.zr_p, w.s_p, lane);
        wide_copy(a, w.zr_g, w.s_g, lane);
        zr_lp = s_lp;
      } else {
        wide_copy(a, w.zl_q, w.s_q, lane); wide_copy(a, w.zl_p, w.s_p, lane);
        wide_copy(a, w.zl_g, w.s_g, lane);
        zl_lp = s_lp;
      }
      logw = logaddexp(logw, st_logw);
      for (int i = lane; i < d; i += 32) w.rho[i] += w.st_rho[i];
      depth = (float)(k + 1);
    }
    turning = st_turn ||
              (ok && wide_is_turning(a, w.zl_p, w.zr_p, w.rho, nullptr, lane));
    diverging = st_div;
    sum_accept += st_acc;
    n_steps += st_n;
  }

  for (int i = lane; i < dim; i += 32)
    a.q_out[(size_t)o * dim + i] = w.q_prop[i];
  if (lane == 0) {
    a.info[o] = lp_prop;
    a.info[stride + o] = sum_accept;
    a.info[2 * stride + o] = n_steps;
    a.info[3 * stride + o] = depth;
    a.info[4 * stride + o] = diverging ? 1.0f : 0.0f;
    a.info[5 * stride + o] = turning ? 1.0f : 0.0f;
    a.info[6 * stride + o] = h0;
  }
  return lp_prop;
}

}  // namespace
