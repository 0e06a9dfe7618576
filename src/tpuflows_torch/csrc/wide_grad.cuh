// The wide path's latent log density and gradient, one warp per row, at
// any lane width d (a multiple of 32): what latent_grad.cuh's per-warp
// `chain_logp_grad` computes, with every d-vector of the row in memory
// instead of registers. K1's, K2's and K3's wide units
// (nuts_transition_wide.cu, nuts_window_wide.cu, fused_logp_wide.cu) run
// on it; the host sends them a flow wider than the register units take (d
// > 256), a tree deeper than their checkpoints hold (max_depth > 10), or a
// row whose scratch leaves no room for a weight ring in shared memory
// (kernels/nuts_cuda.py `wide_path`).
//
// Why memory. The register units keep DPL = d / 32 floats a lane of each
// vector, instantiated per DPL; at DPL = 8 their tile kernels already use
// 254-255 registers a thread (PERF.md), so a wider row would spill, and
// every further instantiation lengthens a build that is already the
// longest phase of chip_smoke.py. Here each row owns a slice of a
// per-launch buffer in global memory (`WideRow`): the tree's vectors, its
// U-turn checkpoints (depth x d floats each way) and latent_grad.cuh's
// `Scratch` (the module inputs, the conditioner's buffers and head). Lane
// l reads and writes elements l + 32 j of every vector, as it holds them
// in registers in the other units, so the tree's element-wise work needs
// no barrier; the MLP products (latent_grad.cuh's `matvec`) read the whole
// of xin and the hidden buffers behind a __syncwarp(), which orders global
// memory among the warp's lanes as it does shared memory. L1 and L2 hold a
// row's working set.
//
// Arithmetic. The targets (targets.cuh) and the modules' inverse and
// pullback (latent_grad.cuh `module_inverse`, `module_vjp`,
// `row_logp_grad`) are written once over a row view: the register units
// instantiate them on rows in registers (`InRegs`), these units on rows
// in memory (`InMem`), whose element j of lane l is x[l + 32 j], as the
// register units hold it. So both run the same operations in the same
// order (each sum over j ascending and then the warp_sum butterfly, one
// lane's broadcast value taken by the same shuffle of its own element),
// and at a width both take a wide row's lp and g are the per-warp
// kernels' on a flow of the general path's form (chip_smoke.py
// `wide_vs_warp` holds them so, on every target kind): the wide units sum
// every MLP product in double (`InMem::kSums`), as the general path
// does. `wide_logp_grad` is not inlined: K2's carried gradient and K1's
// start gradient come from one compiled function, which is what keeps
// K2's windows equal to chained K1 launches to the bit. The tree is its
// own code (nuts_wide_tree.cuh): the register units pick their U-turn
// checkpoints by unrolled compares against kMaxDepth, at 254-255
// registers a thread, where these index them by slot at any depth.
//
// A fragment after latent_grad.cuh, inside no namespace of its own: the
// wide units include it after latent_grad.cuh.
#pragma once

#include "latent_grad.cuh"

namespace tpuflows_nuts {

// the most a wide unit takes: the lane width d and the tree's depth
// (kernels/nuts_cuda.py MAX_DIM, MAX_DEPTH) and a hidden width
// (MAX_HIDDEN)
constexpr int kWideMaxDim = 1024;
constexpr int kWideMaxDepth = 16;
constexpr int kMaxHidden = 4096;

// d-wide vectors of one row in the work buffer before its checkpoints
// (`WideRow`)
constexpr int kWideVectors = 23;

// floats of one row's slice of the work buffer: the vectors, 2 depth
// checkpoints and the gradient's scratch (kernels/nuts_cuda.py
// `wide_row_floats` is its copy; K3 runs with depth 0)
__host__ __device__ inline size_t wide_row_floats(const Args& a,
                                                  const ChainList& c) {
  return (size_t)(kWideVectors + 2 * a.depth) * a.d + row_floats(a, c);
}

}  // namespace tpuflows_nuts

namespace {

// One row's vectors in the work buffer (d floats each; ck_p and ck_r depth
// x d) and its gradient scratch
struct WideRow {
  float *q0, *p0, *g0, *zl_q, *zl_p, *zl_g, *zr_q, *zr_p, *zr_g, *q_prop,
      *g_prop, *rho, *s_q, *s_p, *s_g, *st_qp, *st_gp, *st_rho, *q_new,
      *p_new, *g_new, *rho_new, *x, *ck_p, *ck_r;
  Scratch s;
};

__device__ __forceinline__ WideRow wide_row(const Args& a, const ChainList& c,
                                            float* work, int row) {
  float* p = work + (size_t)row * tpuflows_nuts::wide_row_floats(a, c);
  const size_t d = a.d;
  auto next = [&](size_t n) {
    float* v = p;
    p += n;
    return v;
  };
  WideRow w;  // kWideVectors vectors, then the checkpoints and the scratch
  w.q0 = next(d); w.p0 = next(d); w.g0 = next(d);
  w.zl_q = next(d); w.zl_p = next(d); w.zl_g = next(d);
  w.zr_q = next(d); w.zr_p = next(d); w.zr_g = next(d);
  w.q_prop = next(d); w.g_prop = next(d); w.rho = next(d);
  w.s_q = next(d); w.s_p = next(d); w.s_g = next(d);
  w.st_qp = next(d); w.st_gp = next(d); w.st_rho = next(d);
  w.q_new = next(d); w.p_new = next(d); w.g_new = next(d);
  w.rho_new = next(d); w.x = next(d);
  w.ck_p = next(a.depth * d);
  w.ck_r = next(a.depth * d);
  w.s = scratch_at(a, c, p);
  return w;
}

// lp = log p(f^-1(z)) + ladj and g = d lp / dz through the module list
// (latent_grad.cuh `row_logp_grad` over rows in memory), z, g and x (the
// inverse's working row) d-wide vectors of the row, distinct
__device__ __noinline__ float wide_logp_grad(const Args& a,
                                             const ChainList& c,
                                             const Scratch& s,
                                             const float* z, float* g,
                                             float* x, int lane) {
  return row_logp_grad(a, c, s, InMem<const float>{z, lane},
                       InMem<float>{g, lane}, InMem<float>{x, lane}, lane);
}

}  // namespace
