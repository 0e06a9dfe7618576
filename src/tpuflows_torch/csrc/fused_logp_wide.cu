// K3's wide unit: the batched latent log density and its input gradient
// (the Pallas kernel `make_fused_logp_and_grad`,
// src/tpuflows/kernels/fused_logp.py:73, pallas_call at :140) where the
// register units of fused_logp.cu stop: a lane width d above 256, up to
// kWideMaxDim, or a row whose scratch leaves no room for a weight ring in
// shared memory (kernels/nuts_cuda.py `wide_path`). Built as a library of
// its own on the first launch that needs it (`fused_logp_cuda.
// WIDE_LIBRARY`).
//
// Design: one warp per row, four rows a block, the row's z, g, working x
// and gradient scratch in its slice of a per-launch work buffer (wide_grad.
// cuh `WideRow`, at depth 0), `wide_logp_grad` for the arithmetic: the
// per-warp kernel `fused_logp_chain_kernel`'s at any width. The plain
// PyTorch version is `nuts_cuda.plain_logp_grad`.

#include "wide_grad.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;

// z = a.q (n, dim) in; g to a.q_out (n, dim) and lp to a.info (n,)
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    fused_logp_wide_kernel(Args a, ChainList c, float* work) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= a.n) return;  // the whole warp: no barrier spans warps
  const WideRow w = wide_row(a, c, work, row);
  for (int i = lane; i < a.d; i += 32)
    w.q0[i] = i < a.dim ? __ldg(a.q + (size_t)row * a.dim + i) : 0.0f;
  const float lp = wide_logp_grad(a, c, w.s, w.q0, w.g0, w.x, lane);
  for (int i = lane; i < a.dim; i += 32)
    a.q_out[(size_t)row * a.dim + i] = w.g0[i];
  if (lane == 0) a.info[row] = lp;
}

bool target_ok(int d, int dim, int kind) {
  return dim >= 1 && dim <= d && d - dim < 32 && kind >= 0 &&
         kind < kTargetKinds;
}

}  // namespace

// fused_logp_chain_f32's arguments without rows and resident, and `work`,
// a device buffer of `work_floats` floats, at least n `wide_row_floats` at
// depth 0. Returns a cudaError_t.
extern "C" int fused_logp_wide_f32(const void* z, const void* params,
                                   const void* mods, const void* target,
                                   int n_mods, int n, int d, int dim,
                                   int kind, int hmax, int head,
                                   const void* forms, int nhid, int general,
                                   void* lp, void* g, void* work,
                                   long long work_floats, void* stream) {
  using namespace tpuflows_nuts;
  if (n < 1 || d < 32 || d > kWideMaxDim || d % 32 != 0 ||
      !target_ok(d, dim, kind) || n_mods < 0 || n_mods > kMaxModules ||
      (hmax != 0 && (hmax % 32 != 0 || hmax > kMaxHidden)) || nhid < 0 ||
      nhid >= kMaxLayers || head < 0 || head % 32 != 0)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.q = static_cast<const float*>(z);
  a.params = static_cast<const float*>(params);
  a.target = static_cast<const float*>(target);
  a.n = n; a.d = d; a.dim = dim; a.kind = kind; a.depth = 0;
  a.q_out = static_cast<float*>(g);
  a.info = static_cast<float*>(lp);
  const ChainList c = chain_list(mods, forms, n_mods, hmax, nhid, head,
                                 general);
  if (work_floats < (long long)n * (long long)wide_row_floats(a, c))
    return (int)cudaErrorInvalidValue;
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  fused_logp_wide_kernel<<<blocks, 32 * kWarpsPerBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      a, c, static_cast<float*>(work));
  return (int)cudaGetLastError();
}
