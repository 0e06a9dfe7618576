// K1's wide unit: one multinomial-NUTS transition per chain (the Pallas
// kernel `make_fused_nuts_transition`, src/tpuflows/kernels/
// nuts_pallas.py:303, pallas_call at :407) where the register units of
// nuts_transition.cu stop: a lane width d above 256, up to kWideMaxDim; a
// max_depth above their kMaxDepth = 10, up to kWideMaxDepth; a row whose
// scratch leaves no room for a weight ring in shared memory. The host
// chooses it (kernels/nuts_cuda.py `wide_path`) and builds it as a library
// of its own on the first launch that needs it (`nuts_cuda.WIDE_LIBRARY`),
// so the main paths' build does not grow.
//
// Design: one warp per chain, four chains a block, no lockstep (nothing
// couples a chain to another: nuts_transition.cu says why), every vector of
// the chain in its slice of a per-launch work buffer in global memory
// (wide_grad.cuh), the tree of nuts_wide_tree.cuh and the per-warp
// gradient of wide_grad.cuh: the per-warp kernel `nuts_chain_kernel`'s
// arithmetic at any width and depth, every weight read from L2 for each
// chain's leapfrog. Parity first: it computes what `_transition_math`
// computes at any size, and the tile kernels' sharing of weight reads over
// a tile of chains is left to a later design. The plain PyTorch version is
// `transition_math_torch` in kernels/nuts_cuda.py.
//
// Bound: operations, as K1's tile kernel (chip_smoke.py `k1_bound`);
// PERF.md keeps the measured times beside it.

#include "nuts_wide_tree.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    nuts_wide_kernel(Args a, ChainList c, float* work) {
  const int lane = threadIdx.x & 31;
  const int chain = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (chain >= a.n) return;  // the whole warp: no barrier spans warps
  const WideRow w = wide_row(a, c, work, chain);
  for (int i = lane; i < a.d; i += 32)
    w.q0[i] = i < a.dim ? __ldg(a.q + (size_t)chain * a.dim + i) : 0.0f;
  const float lp0 = wide_logp_grad(a, c, w.s, w.q0, w.g0, w.x, lane);
  wide_transition(a, c, w, lp0, chain, chain, a.n, lane);
}

bool target_ok(int d, int dim, int kind) {
  return dim >= 1 && dim <= d && d - dim < 32 && kind >= 0 &&
         kind < kTargetKinds;
}

}  // namespace

// nuts_chain_transition_f32's arguments without rows and resident, and
// `work`, a device buffer of `work_floats` floats, at least n
// `wide_row_floats` (kernels/nuts_cuda.py allocates it per launch). Returns
// a cudaError_t.
extern "C" int nuts_wide_transition_f32(
    const void* q, const void* p0, const void* dirs, const void* u_acc,
    const void* u_take, const void* eps, const void* inv_mass,
    const void* params, const void* mods, const void* target, int n_mods,
    int n, int d, int dim, int kind, int hmax, int head, const void* forms,
    int nhid, int general, int depth, float max_delta_energy, void* q_out,
    void* info, void* work, long long work_floats, void* stream) {
  using namespace tpuflows_nuts;
  if (n < 1 || d < 32 || d > kWideMaxDim || d % 32 != 0 ||
      !target_ok(d, dim, kind) || n_mods < 0 || n_mods > kMaxModules ||
      (hmax != 0 && (hmax % 32 != 0 || hmax > kMaxHidden)) || nhid < 0 ||
      nhid >= kMaxLayers || head < 0 || head % 32 != 0 || depth < 1 ||
      depth > kWideMaxDepth)
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
  a.target = static_cast<const float*>(target);
  a.n = n; a.d = d; a.dim = dim; a.kind = kind; a.depth = depth;
  a.max_delta_energy = max_delta_energy;
  a.q_out = static_cast<float*>(q_out);
  a.info = static_cast<float*>(info);
  const ChainList c = chain_list(mods, forms, n_mods, hmax, nhid, head,
                                 general);
  if (work_floats < (long long)n * (long long)wide_row_floats(a, c))
    return (int)cudaErrorInvalidValue;
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  nuts_wide_kernel<<<blocks, 32 * kWarpsPerBlock, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      a, c, static_cast<float*>(work));
  return (int)cudaGetLastError();
}
