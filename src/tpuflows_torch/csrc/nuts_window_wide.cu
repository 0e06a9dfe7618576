// K2's wide unit: a window of S sequential multinomial-NUTS transitions per
// chain in one launch (the Pallas kernel `make_fused_nuts_window`,
// src/tpuflows/kernels/nuts_pallas.py:744, pallas_call at :831) where the
// register units of nuts_window.cu stop, as K1's wide unit does
// (nuts_transition_wide.cu; kernels/nuts_cuda.py `wide_path`), built as a
// library of its own on the first launch that needs it
// (`nuts_window_cuda.WIDE_LIBRARY`).
//
// Design: K1's wide unit once per slot (nuts_wide_tree.cuh), one warp per
// chain, the chain's vectors in its slice of a per-launch work buffer. A
// window computes the gradient at its start point once; every later slot
// starts from the proposal's lp and g that the tree carried (w.g_prop),
// which `wide_logp_grad` (one compiled function, not inlined) computed at
// that point as K1's wide unit computes its start gradient there. So each
// slot equals one K1 wide launch from the previous slot's draw to the bit
// (chip_smoke.py: `bitwise_k1`). The plain PyTorch version is
// `window_math_torch` in kernels/nuts_window_cuda.py.

#include "nuts_wide_tree.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;

// `a.p0` is p0c (n, S d), `a.dirs` and `a.u_acc` (n, S D), `a.u_take` (n, S
// 2^D), `a.q_out` the draws (S, n, dim) and `a.info` (7, S, n)
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    nuts_window_wide_kernel(Args a, ChainList c, float* work, int window) {
  const int lane = threadIdx.x & 31;
  const int chain = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (chain >= a.n) return;  // the whole warp: no barrier spans warps
  const WideRow w = wide_row(a, c, work, chain);
  for (int i = lane; i < a.d; i += 32)
    w.q0[i] = i < a.dim ? __ldg(a.q + (size_t)chain * a.dim + i) : 0.0f;
  float lp = wide_logp_grad(a, c, w.s, w.q0, w.g0, w.x, lane);
  for (int s = 0; s < window; ++s) {
    lp = wide_transition(a, c, w, lp, chain * window + s, s * a.n + chain,
                         window * a.n, lane);
    wide_copy(a, w.q0, w.q_prop, lane);
    wide_copy(a, w.g0, w.g_prop, lane);
  }
}

bool target_ok(int d, int dim, int kind) {
  return dim >= 1 && dim <= d && d - dim < 32 && kind >= 0 &&
         kind < kTargetKinds;
}

}  // namespace

// nuts_chain_window_f32's arguments without rows and resident, and `work`,
// a device buffer of `work_floats` floats, at least n `wide_row_floats`.
// Returns a cudaError_t.
extern "C" int nuts_wide_window_f32(
    const void* q, const void* p0c, const void* dirs, const void* u_acc,
    const void* u_take, const void* eps, const void* inv_mass,
    const void* params, const void* mods, const void* target, int n_mods,
    int n, int d, int dim, int kind, int hmax, int head, const void* forms,
    int nhid, int general, int depth, int window, float max_delta_energy,
    void* draws, void* info, void* work, long long work_floats,
    void* stream) {
  using namespace tpuflows_nuts;
  if (n < 1 || d < 32 || d > kWideMaxDim || d % 32 != 0 ||
      !target_ok(d, dim, kind) || n_mods < 0 || n_mods > kMaxModules ||
      (hmax != 0 && (hmax % 32 != 0 || hmax > kMaxHidden)) || nhid < 0 ||
      nhid >= kMaxLayers || head < 0 || head % 32 != 0 || depth < 1 ||
      depth > kWideMaxDepth || window < 1 ||
      (long long)n * window > (1 << 30))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = static_cast<const float*>(q);
  a.p0 = static_cast<const float*>(p0c);
  a.dirs = static_cast<const float*>(dirs);
  a.u_acc = static_cast<const float*>(u_acc);
  a.u_take = static_cast<const float*>(u_take);
  a.eps = static_cast<const float*>(eps);
  a.inv_mass = static_cast<const float*>(inv_mass);
  a.params = static_cast<const float*>(params);
  a.target = static_cast<const float*>(target);
  a.n = n; a.d = d; a.dim = dim; a.kind = kind; a.depth = depth;
  a.max_delta_energy = max_delta_energy;
  a.q_out = static_cast<float*>(draws);
  a.info = static_cast<float*>(info);
  const ChainList c = chain_list(mods, forms, n_mods, hmax, nhid, head,
                                 general);
  if (work_floats < (long long)n * (long long)wide_row_floats(a, c))
    return (int)cudaErrorInvalidValue;
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  nuts_window_wide_kernel<<<blocks, 32 * kWarpsPerBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      a, c, static_cast<float*>(work), window);
  return (int)cudaGetLastError();
}
