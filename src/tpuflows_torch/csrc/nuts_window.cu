// K2 of tpuflows_torch: a window of S sequential multinomial-NUTS
// transitions per chain in one launch.
//
// Replaces the Pallas kernel `make_fused_nuts_window`
// (src/tpuflows/kernels/nuts_pallas.py:744, pallas_call at :831), built by
// `fused_nuts_window_for_flow` (:883), over the targets and widths K1
// takes (targets.cuh; lanes past the width masked; past K1's tile kernel's
// reach, K2's wide unit nuts_window_wide.cu). It computes the S
// transitions that `_window_math` (nuts_pallas.py:463-741) computes, under
// the same precomputed-randomness contract: per chain, slot s takes its
// momenta from p0c columns s d .., its direction signs and acceptance
// uniforms from dirs / u_acc columns s D .. and its leaf uniforms from
// u_take columns s 2^D .. (D = depth), and starts where slot s - 1's
// proposal ended. The plain PyTorch version is `window_math_torch` in
// kernels/nuts_window_cuda.py.
//
// Design. `_window_math` is a tick machine because on a TPU a tile of
// chains runs in lockstep; K2 runs K1's tree code once per slot instead:
//  * A block loops over the S slots. Each slot runs K1's tree code
//    (nuts_tree_body.inc, the same tokens, with its hooks set to the
//    slot's columns) and writes its draw to row (s, chain) of the
//    slot-major (S, n, d) output and its 7 info values to info[:, s,
//    chain] ((7, S, n)).
//  * Between slots a chain keeps the proposal's q, lp and g in registers:
//    the tree code keeps q_prop and lp_prop, and the hooks carry the
//    proposal's gradient beside them (st_gp for a subtree, g_prop for the
//    transition). A window computes the gradient at its start point once;
//    every later slot starts from the carried lp and g, which are the
//    gradient code's own output at that point.
//  * Two kernels. `nuts_window_tile_kernel`, the one on every path: the
//    flow as a module list (the ceiling path's Standardize + one
//    AffineCoupling, the generic path's arqs flow) on tiles of R chains,
//    one block of R warps (R from `nuts_cuda.tile_rows`, 8 at both
//    flows), every latent gradient through the tile gradient
//    (tile_grad.cuh `tile_chain_logp_grad`), so that each weight is read
//    from L2 once per tile; at the ceiling flow its resident
//    instantiation (kResident) reads them from L2 once per launch and
//    keeps them in shared memory for all S slots. In every slot the
//    tile runs K1's tile lockstep (the hooks of `nuts_chain_tile_kernel`:
//    both loops run while any chain of the tile is active, a stopped
//    chain joins the gradients at its last point); the window's start
//    gradient is one call that every warp makes, and later slots make
//    none, uniformly over the tile. Chains past n in the last tile repeat
//    chain n - 1 and skip the store, but stay in the slot loop: they must
//    take part in every barrier of the tile's later slots.
//    `nuts_window_chain_kernel`: the same module list one warp per chain
//    (latent_grad.cuh `chain_logp_grad`), entry point
//    `nuts_chain_window_warp_f32`: kept only as chip_smoke.py's oracle
//    and yardstick for the tile kernel, on no path.
//  * Rounding. A later slot starts from the g of the leaf call that made
//    its start point, where K1 calls the gradient at its start. The two
//    calls compute the same arithmetic: the per-module functions are not
//    inlined, every target's gradient (targets.cuh) rounds every
//    operation as written, and the rest only adds and copies. So the tile
//    window equals chained K1 tile launches to the bit, slot by slot, on
//    every flow (chip_smoke.py, window_vs_plain: `bitwise_k1`), as the
//    per-warp windows equal the per-warp K1 kernels. Every window differs
//    from `_window_math` at rounding level only: that machine sums the
//    accept statistic per leaf and writes its state through masked blends
//    b + m (a - b).
//
// Bound on this card: operations, as K1: one latent gradient per leapfrog
// plus one per chain per window at its start (`chip_smoke.mlp_flops` per
// gradient: 0.1306 MFLOP for the affine flow at the bench shape, 1.720
// MFLOP for the generic arqs flow), at 67 TFLOP/s float32. The bytes (q in,
// S slots of randomness, about 5.4 KB per chain per slot at d = 64 and
// D = 6, and S draws out) take a few microseconds at 3.35 TB/s. The
// products run on the float32 FMA pipes, the per-warp windows at one
// chain per warp, far from that bound; PERF.md keeps the measured times
// beside the bound.

#include "tile_grad.cuh"

// Built by kernels/nuts_window_cuda.py (`LIBRARY`, kernels/cuda_build.py)
// as one translation unit per instantiation (-DNUTS_DPL=1..8, DPL = d / 32
// dims per lane), all compiled in parallel, plus one unit without
// NUTS_DPL that holds the C entry points, linked into one shared library.

namespace tpuflows_window {

using tpuflows_nuts::Args;
using tpuflows_nuts::ChainList;

constexpr int kMaxDepth = 10;

template <int DPL>
cudaError_t launch_chain(const Args& a, const ChainList& c, int window,
                         cudaStream_t stream);
template <int DPL>
cudaError_t launch_tile(const Args& a, const ChainList& c, int rows,
                        int resident, int window, cudaStream_t stream);

}  // namespace tpuflows_window

#ifdef NUTS_DPL

namespace {

using tpuflows_window::kMaxDepth;

#include "nuts_tree.cuh"

// lp and g at a slot's start point: the previous slot's proposal, carried
template <int DPL>
__device__ __forceinline__ float carried(const float (&g_cur)[DPL],
                                         float lp_cur, float (&g)[DPL]) {
  copy<DPL>(g, g_cur);
  return lp_cur;
}

// The window of chain `chain`: `a.p0` is p0c (n, S d), `a.dirs` and
// `a.u_acc` (n, S D), `a.u_take` (n, S 2^D), `a.q_out` the draws (S, n, d)
// and `a.info` (7, S, n); `grad(z, g)` is the latent gradient.
template <int DPL, class Grad>
__device__ __forceinline__ void window_slots(const Args& a, int window,
                                             int chain, int lane,
                                             const Grad& grad) {
#define NUTS_LOGP_GRAD(z, g) grad(z, g)
  float q_cur[DPL], g_cur[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j)
    q_cur[j] = lane + 32 * j < a.dim
                   ? __ldg(a.q + (size_t)chain * a.dim + lane + 32 * j)
                   : 0.0f;
  float lp_cur = NUTS_LOGP_GRAD(q_cur, g_cur);
  for (int w = 0; w < window; ++w) {
    // the proposal's gradient: the subtree's (st_gp) and the transition's
    float st_gp[DPL], g_prop[DPL];
    copy<DPL>(st_gp, g_cur);
    copy<DPL>(g_prop, g_cur);
#define NUTS_ROW (chain * window + w)
#define NUTS_Q0(j, i) q_cur[j]
#define NUTS_LOGP_GRAD0(z, g) carried<DPL>(g_cur, lp_cur, g)
#define NUTS_TAKE_LEAF copy<DPL>(st_gp, g_new);
#define NUTS_TAKE_SUBTREE copy<DPL>(g_prop, st_gp);
#define NUTS_OUT_ROW (w * a.n + chain)
#define NUTS_INFO_STRIDE (window * a.n)
#include "nuts_tree_body.inc"
    copy<DPL>(q_cur, q_prop);
    copy<DPL>(g_cur, g_prop);
    lp_cur = lp_prop;
  }
#undef NUTS_LOGP_GRAD
}

template <int DPL>
struct ChainGrad {  // a module list (`chain_logp_grad`)
  const Args& a;
  const ChainList& c;
  float* smem;
  int lane;
  __device__ __forceinline__ float operator()(const float (&z)[DPL],
                                              float (&g)[DPL]) const {
    return chain_logp_grad<DPL>(a, c, smem, z, g, lane);
  }
};

template <int DPL>
__global__ void __launch_bounds__(32) nuts_window_chain_kernel(Args a,
                                                               ChainList c,
                                                               int window) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x;
  window_slots<DPL>(a, window, blockIdx.x, lane,
                    ChainGrad<DPL>{a, c, smem, lane});
}

// The window of a tile of `rows` chains per block, warp b on chain
// blockIdx.x rows + b: `window_slots` with K1's tile lockstep in every
// slot (nuts_chain_tile_kernel's hooks), a padding row past n storing
// nothing; the weights through the ring, or resident (kResident,
// tile_grad.cuh: copied once for the whole window).
template <int DPL, bool kResident>
__global__ void __launch_bounds__(32 * kMaxTileRows)
    nuts_window_tile_kernel(Args a, ChainList c, int rows, int window) {
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
  float q_cur[DPL], g_cur[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j)
    q_cur[j] = lane + 32 * j < a.dim
                   ? __ldg(a.q + (size_t)chain * a.dim + lane + 32 * j)
                   : 0.0f;
  float lp_cur = NUTS_LOGP_GRAD(q_cur, g_cur);
  for (int w = 0; w < window; ++w) {
    // the proposal's gradient: the subtree's (st_gp) and the transition's
    float st_gp[DPL], g_prop[DPL];
    copy<DPL>(st_gp, g_cur);
    copy<DPL>(g_prop, g_cur);
#define NUTS_ROW (chain * window + w)
#define NUTS_Q0(j, i) q_cur[j]
#define NUTS_LOGP_GRAD0(z, g) carried<DPL>(g_cur, lp_cur, g)
#define NUTS_TAKE_LEAF copy<DPL>(st_gp, g_new);
#define NUTS_TAKE_SUBTREE copy<DPL>(g_prop, st_gp);
#define NUTS_OUT_ROW (w * a.n + chain)
#define NUTS_INFO_STRIDE (window * a.n)
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
#define NUTS_BEFORE_STORE if (row < a.n) {
#define NUTS_AFTER_STORE }
#include "nuts_tree_body.inc"
    copy<DPL>(q_cur, q_prop);
    copy<DPL>(g_cur, g_prop);
    lp_cur = lp_prop;
  }
#undef NUTS_LOGP_GRAD
}

template <int DPL, bool kResident>
cudaError_t launch_tile_kernel(const Args& a, const ChainList& c, int rows,
                               int window, size_t smem,
                               cudaStream_t stream) {
  if (smem > 48 * 1024) {  // above 48 KB only when asked for
    const cudaError_t e = cudaFuncSetAttribute(
        nuts_window_tile_kernel<DPL, kResident>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (a.n + rows - 1) / rows;
  nuts_window_tile_kernel<DPL, kResident>
      <<<blocks, 32 * rows, smem, stream>>>(a, c, rows, window);
  return cudaGetLastError();
}

}  // namespace

namespace tpuflows_window {

template <int DPL>
cudaError_t launch_chain(const Args& a, const ChainList& c, int window,
                         cudaStream_t stream) {
  const size_t smem = sizeof(float) * tpuflows_nuts::row_floats(a, c);
  if (smem > 48 * 1024) {  // above 48 KB only when asked for
    const cudaError_t e = cudaFuncSetAttribute(
        nuts_window_chain_kernel<DPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  nuts_window_chain_kernel<DPL><<<a.n, 32, smem, stream>>>(a, c, window);
  return cudaGetLastError();
}

// `resident` > 0: the resident instantiation, with that many floats of
// resident layers behind the rows (the host's `resident_floats`); 0: the
// ring
template <int DPL>
cudaError_t launch_tile(const Args& a, const ChainList& c, int rows,
                        int resident, int window, cudaStream_t stream) {
  const size_t row = tpuflows_nuts::row_floats(a, c);
  if (resident > 0) {
    if (!tile_resident_fits(rows, row, resident))
      return cudaErrorInvalidValue;
    return launch_tile_kernel<DPL, true>(
        a, c, rows, window, tile_resident_smem_bytes(rows, row, resident),
        stream);
  }
  if (tile_ring_stage(rows, row) == 0) return cudaErrorInvalidValue;
  return launch_tile_kernel<DPL, false>(
      a, c, rows, window, tile_smem_bytes(rows, row), stream);
}

template cudaError_t launch_chain<NUTS_DPL>(const Args&, const ChainList&,
                                           int, cudaStream_t);
template cudaError_t launch_tile<NUTS_DPL>(const Args&, const ChainList&,
                                          int, int, int, cudaStream_t);

}  // namespace tpuflows_window

#else  // the C entry points

namespace {

bool width_ok(int w) { return w >= 32 && w <= 256 && w % 32 == 0; }
// a hidden width: any multiple of 32 up to 4096 (kernels/nuts_cuda.py
// MAX_HIDDEN); the launch checks that the rows fit beside the ring
bool hidden_ok(int w) { return w >= 32 && w <= 4096 && w % 32 == 0; }
// a target of width dim on lanes of width d (targets.cuh)
bool target_ok(int d, int dim, int kind) {
  return dim >= 1 && dim <= d && d - dim < 32 && kind >= 0 &&
         kind < kTargetKinds;
}

// Args of a window launch; the shapes are checked by the caller.
tpuflows_nuts::Args window_args(const void* q, const void* p0c,
                                const void* dirs, const void* u_acc,
                                const void* u_take, const void* eps,
                                const void* inv_mass, const void* params,
                                const void* target, int n, int d, int dim,
                                int kind, int depth, float max_delta_energy,
                                void* draws, void* info) {
  tpuflows_nuts::Args a;
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
  return a;
}

}  // namespace

namespace {

bool chain_window_ok(int n, int d, int dim, int kind, int n_mods,
                     int hmax, int nhid, int head, int depth, int window) {
  using namespace tpuflows_window;
  return n >= 1 && width_ok(d) && target_ok(d, dim, kind) && n_mods >= 0 &&
         n_mods <= tpuflows_nuts::kMaxModules &&
         (hmax == 0 || hidden_ok(hmax)) && nhid >= 0 &&
         nhid < tpuflows_nuts::kMaxLayers && head >= 0 && head % 32 == 0 &&
         depth >= 1 && depth <= kMaxDepth && window >= 1 &&
         (long long)n * window <= (1 << 30);
}

}  // namespace

// A module list on tiles of `rows` chains (a power of two up to
// kMaxTileRows, tile_grad.cuh) in lockstep, sharing every weight read
// (nuts_window_tile_kernel), over a target, as K1's
// nuts_chain_transition_f32 takes them (`resident` too) plus the window. Refused where the tile's rows leave
// no room for a weight ring (`tile_ring_stage`) or for the resident
// layers (`tile_resident_fits`). Returns a cudaError_t.
extern "C" int nuts_chain_window_f32(
    const void* q, const void* p0c, const void* dirs, const void* u_acc,
    const void* u_take, const void* eps, const void* inv_mass,
    const void* params, const void* mods, const void* target, int n_mods,
    int n, int d, int dim, int kind, int hmax, int head, const void* forms,
    int nhid, int general, int depth, int window,
    float max_delta_energy, void* draws, void* info, int rows, int resident,
    void* stream) {
  using namespace tpuflows_window;
  if (!chain_window_ok(n, d, dim, kind, n_mods, hmax, nhid, head, depth,
                       window) ||
      rows < 1 || rows > kMaxTileRows || (rows & (rows - 1)) != 0 ||
      resident < 0)
    return (int)cudaErrorInvalidValue;
  const Args a = window_args(q, p0c, dirs, u_acc, u_take, eps, inv_mass,
                             params, target, n, d, dim, kind, depth,
                             max_delta_energy, draws, info);
  const ChainList c = tpuflows_nuts::chain_list(mods, forms, n_mods, hmax,
                                                nhid, head, general);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d / 32) {
    case 1: return (int)launch_tile<1>(a, c, rows, resident, window, s);
    case 2: return (int)launch_tile<2>(a, c, rows, resident, window, s);
    case 3: return (int)launch_tile<3>(a, c, rows, resident, window, s);
    case 4: return (int)launch_tile<4>(a, c, rows, resident, window, s);
    case 5: return (int)launch_tile<5>(a, c, rows, resident, window, s);
    case 6: return (int)launch_tile<6>(a, c, rows, resident, window, s);
    case 7: return (int)launch_tile<7>(a, c, rows, resident, window, s);
    default: return (int)launch_tile<8>(a, c, rows, resident, window, s);
  }
}

// The per-warp module-list window (nuts_window_chain_kernel), one chain
// per block: chip_smoke.py's oracle and yardstick for the tile kernel, on
// no path. Same arguments as nuts_chain_window_f32 without rows.
extern "C" int nuts_chain_window_warp_f32(
    const void* q, const void* p0c, const void* dirs, const void* u_acc,
    const void* u_take, const void* eps, const void* inv_mass,
    const void* params, const void* mods, const void* target, int n_mods,
    int n, int d, int dim, int kind, int hmax, int head, const void* forms,
    int nhid, int general, int depth, int window,
    float max_delta_energy, void* draws, void* info, void* stream) {
  using namespace tpuflows_window;
  if (!chain_window_ok(n, d, dim, kind, n_mods, hmax, nhid, head, depth,
                       window))
    return (int)cudaErrorInvalidValue;
  const Args a = window_args(q, p0c, dirs, u_acc, u_take, eps, inv_mass,
                             params, target, n, d, dim, kind, depth,
                             max_delta_energy, draws, info);
  const ChainList c = tpuflows_nuts::chain_list(mods, forms, n_mods, hmax,
                                                nhid, head, general);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d / 32) {
    case 1: return (int)launch_chain<1>(a, c, window, s);
    case 2: return (int)launch_chain<2>(a, c, window, s);
    case 3: return (int)launch_chain<3>(a, c, window, s);
    case 4: return (int)launch_chain<4>(a, c, window, s);
    case 5: return (int)launch_chain<5>(a, c, window, s);
    case 6: return (int)launch_chain<6>(a, c, window, s);
    case 7: return (int)launch_chain<7>(a, c, window, s);
    default: return (int)launch_chain<8>(a, c, window, s);
  }
}

#endif  // NUTS_DPL
