// K1 of tpuflows_torch: one whole multinomial-NUTS transition per chain.
//
// Replaces the Pallas kernel `make_fused_nuts_transition`
// (src/tpuflows/kernels/nuts_pallas.py:303, pallas_call at :407), built by
// `fused_nuts_for_flow` (:924), over Neal's funnel. It computes what
// `_transition_math` (nuts_pallas.py:83-300) computes, under the same
// precomputed-randomness contract: momenta p0, direction signs, acceptance
// uniforms and one uniform per potential leaf come in as inputs, so the
// kernel is deterministic. The plain PyTorch version is
// `transition_math_torch` in kernels/nuts_cuda.py.
//
// Two gradients of log p(f^-1(z)) + ladj, one kernel each, sharing the
// tree code (nuts_tree_body.inc); the gradients themselves live in
// latent_grad.cuh, which K3 (fused_logp.cu) shares:
//  * `nuts_transition_kernel`: the flow Standardize + one AffineCoupling
//    with a silu MLP d -> h1 -> h2 -> 2d (`logp_grad`, the ceiling path);
//  * `nuts_chain_kernel`: any Chain of Standardize, AffineCoupling and
//    RQSCouplingBlock modules with such MLPs, given as a module list
//    (`chain_logp_grad`, the generic path's arqs flow).
//
// Design (the simple one; wgmma, TMA and a tiled MLP wait for later work):
//  * One warp per chain, one warp per block. Nothing couples a chain to
//    its tile-mates in `_transition_math`: a stopped chain is frozen by the
//    masked blends, and the subtree loop ends early only when every chain
//    of the tile is done, so the u_take column of leaf j in doubling k is
//    always 2^k - 1 + j. No tile lockstep is kept, and there is no
//    __syncthreads() anywhere.
//  * Lane layout and the MLP as latent_grad.cuh says. Both loops are
//    bounded: at most `depth` doublings and at most 2^k leaves in doubling
//    k. The weights stay resident in L2 (~82 k floats for the affine flow
//    at d = 64, h = 128; ~1.5 M floats for the arqs flow of the generic
//    path). The per-warp scratch is dynamic shared memory sized by the
//    launch.
//  * The U-turn checkpoint pairs (2 x depth x d floats) live in registers,
//    selected by unrolled compares against the slot (no dynamic indexing).
//  * A divergent leaf's non-finite q, p and g are zeroed (the plain
//    version, `transition_math_torch`, does the same).
//
// Bound on this card: operations. Each leapfrog costs one latent gradient:
// one forward and one input-gradient backward of every conditioner MLP,
// counted over the work that reaches lp or g (`chip_smoke.mlp_flops`): W1
// over the mask's pass-through inputs (the conditioner sees z * mask), W3
// over the transformed dims' head columns. That is 0.1306 MFLOP for the
// affine flow at the bench shape and 1.720 MFLOP for the generic arqs flow;
// at the trained post-warmup states a transition of 1024 chains takes about
// 8,190 gradients, 1.07 / 14.09 GFLOP, 0.0160 / 0.210 ms at 67 TFLOP/s
// float32, while it moves only q in and out plus its random inputs (about
// 1 KB per chain). This kernel runs its products on the float32 FMA pipes
// at one chain per warp, far from that bound; PERF.md keeps its measured
// time beside the bound.

#include "latent_grad.cuh"

// Built by kernels/nuts_cuda.py (`LIBRARY`, kernels/cuda_build.py) as one
// translation unit per template instantiation (-DNUTS_DPL=1..8, DPL = d /
// 32 dims per lane), all compiled in parallel, plus one unit without
// NUTS_DPL that holds the C entry points, linked into one shared library.

namespace tpuflows_nuts {

constexpr int kMaxDepth = 10;

template <int DPL>
cudaError_t launch(const Args& a, cudaStream_t stream);
template <int DPL>
cudaError_t launch_chain(const Args& a, const ChainList& c,
                         cudaStream_t stream);

}  // namespace tpuflows_nuts

#ifdef NUTS_DPL

namespace {

using tpuflows_nuts::kMaxDepth;

#include "nuts_tree.cuh"

template <int DPL>
__global__ void __launch_bounds__(32) nuts_transition_kernel(Args a) {
  extern __shared__ float smem[];
  const int chain = blockIdx.x;
  const int lane = threadIdx.x;
  const Net t = unpack(a);
#define NUTS_LOGP_GRAD(z, g) logp_grad<DPL>(a, t, smem, z, g, lane)
#include "nuts_tree_body.inc"
#undef NUTS_LOGP_GRAD
}

template <int DPL>
__global__ void __launch_bounds__(32) nuts_chain_kernel(Args a, ChainList c) {
  extern __shared__ float smem[];
  const int chain = blockIdx.x;
  const int lane = threadIdx.x;
#define NUTS_LOGP_GRAD(z, g) chain_logp_grad<DPL>(a, c, smem, z, g, lane)
#include "nuts_tree_body.inc"
#undef NUTS_LOGP_GRAD
}


}  // namespace

namespace tpuflows_nuts {

template <int DPL>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (6 * a.d + 3 * a.h1 + 3 * a.h2);
  nuts_transition_kernel<DPL><<<a.n, 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int DPL>
cudaError_t launch_chain(const Args& a, const ChainList& c,
                         cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(c.n_mods + 1) * a.d + 4 * c.hmax + c.head);
  if (smem > 48 * 1024) {  // above 48 KB only when asked for
    const cudaError_t e = cudaFuncSetAttribute(
        nuts_chain_kernel<DPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  nuts_chain_kernel<DPL><<<a.n, 32, smem, stream>>>(a, c);
  return cudaGetLastError();
}

template cudaError_t launch<NUTS_DPL>(const Args&, cudaStream_t);
template cudaError_t launch_chain<NUTS_DPL>(const Args&, const ChainList&,
                                           cudaStream_t);

}  // namespace tpuflows_nuts

#else  // the C entry points

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

// A module list (nuts_chain_kernel): `mods` is a device array of
// n_mods * kModInts ints, hmax the widest hidden layer (0 without
// couplings), head the widest conditioner output. Returns a cudaError_t.
extern "C" int nuts_chain_transition_f32(
    const void* q, const void* p0, const void* dirs, const void* u_acc,
    const void* u_take, const void* eps, const void* inv_mass,
    const void* params, const void* mods, int n_mods, int n, int d,
    int hmax, int head, int depth, float sigma_v, float max_delta_energy,
    void* q_out, void* info, void* stream) {
  using namespace tpuflows_nuts;
  if (n < 1 || !width_ok(d) || n_mods < 1 || n_mods > kMaxModules ||
      (hmax != 0 && !width_ok(hmax)) || head < 0 || head % 32 != 0 ||
      depth < 1 || depth > kMaxDepth)
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
  a.n = n; a.d = d; a.h1 = 0; a.h2 = 0; a.depth = depth;
  a.clamp = 0.0f; a.sigma_v = sigma_v; a.max_delta_energy = max_delta_energy;
  a.q_out = static_cast<float*>(q_out);
  a.info = static_cast<float*>(info);
  ChainList c;
  c.mods = static_cast<const int*>(mods);
  c.n_mods = n_mods; c.hmax = hmax; c.head = head;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d / 32) {
    case 1: return (int)launch_chain<1>(a, c, s);
    case 2: return (int)launch_chain<2>(a, c, s);
    case 3: return (int)launch_chain<3>(a, c, s);
    case 4: return (int)launch_chain<4>(a, c, s);
    case 5: return (int)launch_chain<5>(a, c, s);
    case 6: return (int)launch_chain<6>(a, c, s);
    case 7: return (int)launch_chain<7>(a, c, s);
    default: return (int)launch_chain<8>(a, c, s);
  }
}

#endif  // NUTS_DPL
