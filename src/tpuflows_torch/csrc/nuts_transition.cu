// K1 of tpuflows_torch: one whole multinomial-NUTS transition per chain.
//
// Replaces the Pallas kernel `make_fused_nuts_transition`
// (src/tpuflows/kernels/nuts_pallas.py:303, pallas_call at :407), built by
// `fused_nuts_for_flow` (:924), over any closed-form target of the port
// (targets.cuh, on Args::kind) at any width d <= 256: the flow is packed
// at the lane width _pad32(d), and lanes at or past d load zeros and store
// nothing (nuts_tree_body.inc). It computes what
// `_transition_math` (nuts_pallas.py:83-300) computes, under the same
// precomputed-randomness contract: momenta p0, direction signs, acceptance
// uniforms and one uniform per potential leaf come in as inputs, so the
// kernel is deterministic. The plain PyTorch version is
// `transition_math_torch` in kernels/nuts_cuda.py.
//
// Two kernels share the tree code (nuts_tree_body.inc); the gradients
// of log p(f^-1(z)) + ladj live in latent_grad.cuh and tile_grad.cuh,
// which K3 (fused_logp.cu) shares:
//  * `nuts_chain_tile_kernel`, the one on every path: any Chain of
//    Standardize, AffineCoupling and RQSCouplingBlock modules with silu
//    MLPs d -> h1 -> h2 -> n, given as a module list (the ceiling path's
//    Standardize + one AffineCoupling and the generic path's arqs flow),
//    on tiles of R chains whose gradients share every weight read
//    (`tile_chain_logp_grad`). Two instantiations: the weights through a
//    cp.async ring, or, for a flow with one coupling whose layers fit
//    (the ceiling's), resident in shared memory for the whole launch
//    (kResident, tile_grad.cuh);
//  * `nuts_chain_kernel`: the same module list one warp per chain
//    (`chain_logp_grad`), entry point `nuts_chain_transition_warp_f32`:
//    kept only as chip_smoke.py's oracle and yardstick for the tile
//    kernel, on no path.
//
// Design:
//  * One warp per chain; each chain's tree state stays in its warp's
//    registers. Nothing couples a chain to its tile-mates in
//    `_transition_math`: a stopped chain is frozen by the masked blends,
//    and the subtree loop ends early only when every chain of the tile is
//    done, so the u_take column of leaf j in doubling k is always 2^k - 1
//    + j (tests/test_torch_nuts.py::test_chains_are_independent, and
//    tests/test_torch_tile_grad.py for module lists).
//  * The per-warp kernels are one warp per block and keep no lockstep.
//    The tile kernel is one block of R warps (R from
//    `nuts_cuda.tile_rows`, 8 at the ceiling and the generic flow), and
//    every warp must call the tile gradient the same number of times, so
//    both loops run while any chain of the tile is active (the tile
//    lockstep of `_transition_math`, at tile R instead of 256): their
//    conditions go through __syncthreads_or, a stopped chain's warp takes
//    part in the gradient at its own last point and changes none of its
//    state (nuts_tree_body.inc's hooks, whose empty defaults leave the
//    other kernels' tokens as they were). Chains past n in the last tile
//    repeat chain n - 1, so they lengthen no loop, and store nothing.
//  * Lane layout and the per-row math as latent_grad.cuh says. Both loops
//    are bounded: at most `depth` doublings and at most 2^k leaves in
//    doubling k. The weights stay resident in L2 (~1.5 M floats for the
//    arqs flow of the generic path) or, at the ceiling flow, in shared
//    memory (its compact forward layers, 37 k floats). The scratch is
//    dynamic shared memory sized by the launch (R rows of it for the tile
//    kernel: ~80 KB at the generic flow, 26 KB at the ceiling).
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
// 1 KB per chain). The per-warp kernel reads every weight from L2
// for each chain's leapfrog, far from that bound; the tile kernel reads
// them once per R chains (at the ceiling once per launch), and does the
// gradients its lockstep adds (chains that wait for their tile-mates).
// Both run in float32 on the FMA pipes (tile_grad.cuh says why). PERF.md
// keeps the measured times beside the bound.

#include "tile_grad.cuh"

// Built by kernels/nuts_cuda.py (`LIBRARY`, kernels/cuda_build.py) as one
// translation unit per template instantiation (-DNUTS_DPL=1..8, DPL = d /
// 32 dims per lane), one more per DPL with -DTARGETS_FUNNEL_ONLY that
// holds the tile kernel with the funnel alone in its target dispatch
// (`launch_tile_funnel`, which the entry point launches for a funnel:
// targets.cuh says why), all compiled in parallel, plus one unit without
// NUTS_DPL that holds the C entry points, linked into one shared library.

namespace tpuflows_nuts {

constexpr int kMaxDepth = 10;

template <int DPL>
cudaError_t launch_chain(const Args& a, const ChainList& c,
                         cudaStream_t stream);
template <int DPL>
cudaError_t launch_tile(const Args& a, const ChainList& c, int rows,
                        int resident, cudaStream_t stream);
template <int DPL>
cudaError_t launch_tile_funnel(const Args& a, const ChainList& c, int rows,
                               int resident, cudaStream_t stream);

}  // namespace tpuflows_nuts

#ifdef NUTS_DPL

#ifdef TARGETS_FUNNEL_ONLY
#define nuts_chain_tile_kernel nuts_chain_tile_funnel_kernel
#define launch_tile launch_tile_funnel
#endif

namespace {

using tpuflows_nuts::kMaxDepth;

#include "nuts_tree.cuh"

template <int DPL>
__global__ void __launch_bounds__(32) nuts_chain_kernel(Args a, ChainList c) {
  extern __shared__ float smem[];
  const int chain = blockIdx.x;
  const int lane = threadIdx.x;
#define NUTS_LOGP_GRAD(z, g) chain_logp_grad<DPL>(a, c, smem, z, g, lane)
#include "nuts_tree_body.inc"
#undef NUTS_LOGP_GRAD
}

// One tile of `rows` chains per block, warp b on chain blockIdx.x rows +
// b, its two loops in tile lockstep (nuts_tree_body.inc's hooks); the
// weights through the ring, or resident (kResident, tile_grad.cuh).
template <int DPL, bool kResident>
__global__ void __launch_bounds__(32 * kMaxTileRows)
    nuts_chain_tile_kernel(Args a, ChainList c, int rows) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * rows + warp;
  const int chain = min(row, a.n - 1);
  if constexpr (kResident) {
    tile_load_resident(a, c, rows);
  }
#define NUTS_LOGP_GRAD(z, g) \
  tile_chain_logp_grad<DPL, kResident>(a, c, smem, rows, z, g, lane, warp)
#define NUTS_DOUBLING_ON(go) __syncthreads_or(go)
#define NUTS_LEAF_ON(go) __syncthreads_or(go)
#define NUTS_SUBTREE_TURN0 turning
#define NUTS_SUBTREE_DIV0 diverging
#define NUTS_LEAF_BEGIN const bool leaf_on = !(st_turn || st_div);
#define NUTS_LEAF_GRAD(z, g)                                     \
  tile_chain_logp_grad_at<DPL, kResident>(a, c, smem, rows, leaf_on, z, \
                                          s_q, g, lane, warp)
#define NUTS_LEAF_SKIP \
  if (!leaf_on) continue;
#define NUTS_BEFORE_STORE \
  if (row >= a.n) return;
#include "nuts_tree_body.inc"
#undef NUTS_LOGP_GRAD
}

template <int DPL, bool kResident>
cudaError_t launch_tile_kernel(const Args& a, const ChainList& c, int rows,
                               size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {  // above 48 KB only when asked for
    const cudaError_t e = cudaFuncSetAttribute(
        nuts_chain_tile_kernel<DPL, kResident>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (a.n + rows - 1) / rows;
  nuts_chain_tile_kernel<DPL, kResident>
      <<<blocks, 32 * rows, smem, stream>>>(a, c, rows);
  return cudaGetLastError();
}

}  // namespace

namespace tpuflows_nuts {

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

// `resident` > 0: the resident instantiation, with that many floats of
// resident layers behind the rows (the host's `resident_floats`); 0: the
// ring
template <int DPL>
cudaError_t launch_tile(const Args& a, const ChainList& c, int rows,
                        int resident, cudaStream_t stream) {
  const size_t row = (size_t)(c.n_mods + 1) * a.d + 4 * c.hmax + c.head;
  if (resident > 0) {
    if (!tile_resident_fits(rows, row, resident))
      return cudaErrorInvalidValue;
    return launch_tile_kernel<DPL, true>(
        a, c, rows, tile_resident_smem_bytes(rows, row, resident), stream);
  }
  if (tile_ring_stage(rows, row) == 0) return cudaErrorInvalidValue;
  return launch_tile_kernel<DPL, false>(a, c, rows,
                                        tile_smem_bytes(rows, row), stream);
}

#ifndef TARGETS_FUNNEL_ONLY
template cudaError_t launch_chain<NUTS_DPL>(const Args&, const ChainList&,
                                           cudaStream_t);
#endif
template cudaError_t launch_tile<NUTS_DPL>(const Args&, const ChainList&,
                                          int, int, cudaStream_t);

}  // namespace tpuflows_nuts

#else  // the C entry points

namespace {
bool width_ok(int w) { return w >= 32 && w <= 256 && w % 32 == 0; }
// a target of width dim on lanes of width d (targets.cuh)
bool target_ok(int d, int dim, int kind) {
  return dim >= 1 && dim <= d && d - dim < 32 && kind >= 0 &&
         kind < kTargetKinds;
}
}  // namespace

namespace {

bool chain_ok(int n, int d, int dim, int kind, int n_mods, int hmax,
              int head, int depth) {
  using namespace tpuflows_nuts;
  return n >= 1 && width_ok(d) && target_ok(d, dim, kind) && n_mods >= 0 &&
         n_mods <= kMaxModules &&
         (hmax == 0 || width_ok(hmax)) && head >= 0 && head % 32 == 0 &&
         depth >= 1 && depth <= kMaxDepth;
}

tpuflows_nuts::Args chain_args(const void* q, const void* p0,
                               const void* dirs, const void* u_acc,
                               const void* u_take, const void* eps,
                               const void* inv_mass, const void* params,
                               const void* target, int n, int d, int dim,
                               int kind, int depth, float max_delta_energy,
                               void* q_out, void* info) {
  tpuflows_nuts::Args a;
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
  return a;
}

// the tile kernel for a.kind: a funnel's from its own units
template <int DPL>
cudaError_t launch_tile_for(const tpuflows_nuts::Args& a,
                            const tpuflows_nuts::ChainList& c, int rows,
                            int resident, cudaStream_t s) {
  return a.kind == kFunnel
             ? tpuflows_nuts::launch_tile_funnel<DPL>(a, c, rows, resident, s)
             : tpuflows_nuts::launch_tile<DPL>(a, c, rows, resident, s);
}

tpuflows_nuts::ChainList chain_list(const void* mods, int n_mods, int hmax,
                                    int head) {
  tpuflows_nuts::ChainList c;
  c.mods = static_cast<const int*>(mods);
  c.n_mods = n_mods; c.hmax = hmax; c.head = head;
  return c;
}

}  // namespace

// A module list on tiles of `rows` chains (a power of two up to
// kMaxTileRows, tile_grad.cuh) in lockstep, sharing every weight read
// (nuts_chain_tile_kernel): `mods` is a device array of n_mods * kModInts
// ints (none for a flow-less transition), packed at the lane width d; the
// target of kind `kind` (targets.cuh) and width dim, its parameters in
// `target`; hmax the widest hidden layer (0 without couplings), head the
// widest conditioner output; `resident` the floats of the resident
// layers (`tile_resident_floats` of the list's one coupling), 0 for the
// ring. Refused where the tile's rows leave no room for a weight ring
// (`tile_ring_stage`) or for the resident layers (`tile_resident_fits`).
// Returns a cudaError_t.
extern "C" int nuts_chain_transition_f32(
    const void* q, const void* p0, const void* dirs, const void* u_acc,
    const void* u_take, const void* eps, const void* inv_mass,
    const void* params, const void* mods, const void* target, int n_mods,
    int n, int d, int dim, int kind, int hmax, int head, int depth,
    float max_delta_energy, void* q_out, void* info, int rows, int resident, void* stream) {
  using namespace tpuflows_nuts;
  if (!chain_ok(n, d, dim, kind, n_mods, hmax, head, depth) || rows < 1 ||
      rows > kMaxTileRows || (rows & (rows - 1)) != 0 || resident < 0)
    return (int)cudaErrorInvalidValue;
  const Args a = chain_args(q, p0, dirs, u_acc, u_take, eps, inv_mass,
                            params, target, n, d, dim, kind, depth,
                            max_delta_energy, q_out, info);
  const ChainList c = chain_list(mods, n_mods, hmax, head);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d / 32) {
    case 1: return (int)launch_tile_for<1>(a, c, rows, resident, s);
    case 2: return (int)launch_tile_for<2>(a, c, rows, resident, s);
    case 3: return (int)launch_tile_for<3>(a, c, rows, resident, s);
    case 4: return (int)launch_tile_for<4>(a, c, rows, resident, s);
    case 5: return (int)launch_tile_for<5>(a, c, rows, resident, s);
    case 6: return (int)launch_tile_for<6>(a, c, rows, resident, s);
    case 7: return (int)launch_tile_for<7>(a, c, rows, resident, s);
    default: return (int)launch_tile_for<8>(a, c, rows, resident, s);
  }
}

// The per-warp module-list kernel (nuts_chain_kernel), one chain per
// block: chip_smoke.py's oracle and yardstick for the tile kernel, on no
// path. Same arguments as nuts_chain_transition_f32 without rows.
extern "C" int nuts_chain_transition_warp_f32(
    const void* q, const void* p0, const void* dirs, const void* u_acc,
    const void* u_take, const void* eps, const void* inv_mass,
    const void* params, const void* mods, const void* target, int n_mods,
    int n, int d, int dim, int kind, int hmax, int head, int depth,
    float max_delta_energy, void* q_out, void* info, void* stream) {
  using namespace tpuflows_nuts;
  if (!chain_ok(n, d, dim, kind, n_mods, hmax, head, depth))
    return (int)cudaErrorInvalidValue;
  const Args a = chain_args(q, p0, dirs, u_acc, u_take, eps, inv_mass,
                            params, target, n, d, dim, kind, depth,
                            max_delta_energy, q_out, info);
  const ChainList c = chain_list(mods, n_mods, hmax, head);
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
