// K3 of tpuflows_torch: the fused latent log density and its gradient.
//
// Replaces the Pallas kernel of `make_fused_logp_and_grad`
// (src/tpuflows/kernels/fused_logp.py:73, pallas_call at :140), built by
// `fused_latent_logp_and_grad` (:188). For each row z of an (n, d) float32
// batch it computes
//   lp = log p(f^-1(z)) + ladj(z)   and   g = d lp / dz
// through a flow over any closed-form target of the port (targets.cuh,
// any d <= 256, z, lp and g at the target's width and the flow at the lane
// width; past that, or for a row past shared memory, K3's wide unit
// fused_logp_wide.cu), in one launch: the flow inverse, the
// ladj, the target's log density and the whole pullback, with no
// intermediate leaving the chip. It is the `logp_and_grad` hook of the
// portable NUTS and HMC (mcmc/nuts.py, mcmc/hmc.py); the plain PyTorch
// version is `nuts_cuda.plain_logp_grad` (autograd through the flow, or the
// streamed per-block backward on the p-major relayout for flows with
// splines), called by kernels/fused_logp_cuda.py on CPU tensors.
//
// The JAX kernel traces any log density into its tile body; a kernel
// written by hand cannot, so this one takes what K1 takes (latent_grad.cuh,
// where the gradient lives): the targets whose log density and gradient
// targets.cuh writes out (not a Posterior's user code), under a module
// list of Standardize, Whiten, AffineCoupling and RQSCouplingBlock modules
// whose conditioners are MLPs of 1 to 8 layers with a silu, tanh, relu or
// gelu activation and float32 or bf16 operands, or none.
//
// Design. Every flow runs on the tile kernel (`fused_logp_tile_kernel`),
// the tile gradient of tile_grad.cuh: one block of R warps per tile of R
// rows, every weight read once per tile and used for all R rows, warp b
// owning row b with latent_grad.cuh's per-row code; R and the weight mode
// come from the host (`nuts_cuda.launch_rows`, `launch_resident`). The
// weights go through a cp.async ring in shared memory, or, for a flow
// with one coupling whose compact forward layers fit beside the rows (the
// ceiling's affine flow), they are copied once per launch behind the rows
// (template argument kResident, `tile_load_resident`, as K1 and K2 do).
// The block's dynamic shared memory is R rows of (n_mods + 1) d + 2 nhid
// hmax + head floats (`row_floats`) and the 96 KB ring (176 KB at the generic flow; less
// where one row leaves less room, tile_grad.cuh `tile_ring_stage`), or
// the rows padded by one float and the resident layers. Rows past n in
// the last tile compute on a copy of row n - 1 and store nothing. Its lp
// and g equal the per-warp module-list kernel's in value (the same
// per-row code, the same order of every sum; the compact layers it reads
// can change only a zero's sign). The per-warp kernel
// (`fused_logp_chain_kernel`, entry point `fused_logp_chain_warp_f32`)
// stays built as chip_smoke.py's oracle and yardstick for the tile
// kernel; no wrapper on a path calls it.
//
// Bound on this card: operations. A row costs one forward and one
// input-gradient backward of every conditioner MLP, counted over the work
// that reaches lp or g (`chip_smoke.mlp_flops`: W1 over the mask's
// pass-through inputs, W3 over the transformed dims' head columns): 0.1306
// MFLOP for the ceiling flow (0.134 GFLOP per 1024 rows, 2.00 us at 67
// TFLOP/s float32) and 1.720 MFLOP for the generic arqs flow (1.76 GFLOP,
// 26.3 us). Its bytes (z in, lp and g out, the flow's parameters and masks
// once, 0.69-3.6 MB) take 0.2-1.1 us at 3.35 TB/s. One warp per row reads
// every weight from L2 for each row (~9 MB per row of the generic flow,
// tile_grad.cuh), so the per-warp kernels stay far from that bound; the
// tile kernel reads them once per R rows, or once per launch and block
// when they are resident. Both stay in float32 on the FMA
// pipes (tile_grad.cuh says why). PERF.md keeps the measured times beside
// the bound.

#include "tile_grad.cuh"

// Built by kernels/fused_logp_cuda.py (`LIBRARY`, kernels/cuda_build.py)
// as one translation unit per instantiation (-DLATENT_DPL=1..8, DPL = d /
// 32 dims per lane), one more per DPL with -DTARGETS_FUNNEL_ONLY that
// holds the tile kernel with the funnel alone in its target dispatch
// (`launch_tile_funnel`, which the entry point launches for a funnel whose
// flow has the main paths' form, ChainList::general 0: targets.cuh and
// tile_grad.cuh say why), all compiled in parallel, plus one unit without
// LATENT_DPL that holds the C entry points, linked into one library.

namespace tpuflows_logp {

using tpuflows_nuts::Args;
using tpuflows_nuts::ChainList;

template <int DPL>
cudaError_t launch_chain(const Args& a, const ChainList& c,
                         cudaStream_t stream);
template <int DPL>
cudaError_t launch_tile(const Args& a, const ChainList& c, int rows,
                        int resident, cudaStream_t stream);
template <int DPL>
cudaError_t launch_tile_funnel(const Args& a, const ChainList& c, int rows,
                               int resident, cudaStream_t stream);

}  // namespace tpuflows_logp

#ifdef LATENT_DPL

#ifdef TARGETS_FUNNEL_ONLY
#define fused_logp_tile_kernel fused_logp_tile_funnel_kernel
#define launch_tile launch_tile_funnel
#endif

namespace {

// z (row `row` of a.q, a.dim wide) into the lane's registers, zeros past
// a.dim
template <int DPL>
__device__ __forceinline__ void load_row(const Args& a, int row, int lane,
                                         float (&z)[DPL]) {
#pragma unroll
  for (int j = 0; j < DPL; ++j)
    z[j] = lane + 32 * j < a.dim
               ? __ldg(a.q + (size_t)row * a.dim + lane + 32 * j)
               : 0.0f;
}

// g to row `row` of a.q_out, lp to a.info[row]
template <int DPL>
__device__ __forceinline__ void store_row(const Args& a, int row, int lane,
                                          float lp, const float (&g)[DPL]) {
#pragma unroll
  for (int j = 0; j < DPL; ++j)
    if (lane + 32 * j < a.dim)
      a.q_out[(size_t)row * a.dim + lane + 32 * j] = g[j];
  if (lane == 0) a.info[row] = lp;
}

template <int DPL>
__global__ void __launch_bounds__(32) fused_logp_chain_kernel(Args a,
                                                              ChainList c) {
  extern __shared__ float smem[];
  const int row = blockIdx.x;
  const int lane = threadIdx.x;
  float z[DPL], g[DPL];
  load_row<DPL>(a, row, lane, z);
  const float lp = chain_logp_grad<DPL>(a, c, smem, z, g, lane);
  store_row<DPL>(a, row, lane, lp, g);
}

// One tile of `rows` rows per block, warp b on row blockIdx.x rows + b;
// the weights through the ring, or resident (kResident, tile_grad.cuh:
// copied once per launch).
template <int DPL, bool kResident>
__global__ void __launch_bounds__(32 * kMaxTileRows)
    fused_logp_tile_kernel(Args a, ChainList c, int rows) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * rows + warp;
  if constexpr (kResident) {
    tile_load_resident(a, c, rows);
  }
  float z[DPL], g[DPL];
  load_row<DPL>(a, min(row, a.n - 1), lane, z);
  const float lp = tile_chain_logp_grad<DPL, kResident>(a, c, smem, rows, z,
                                                        g, lane, warp);
  if (row < a.n) store_row<DPL>(a, row, lane, lp, g);
}

template <int DPL, bool kResident>
cudaError_t launch_tile_kernel(const Args& a, const ChainList& c, int rows,
                               size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {  // above 48 KB only when asked for
    const cudaError_t e = cudaFuncSetAttribute(
        fused_logp_tile_kernel<DPL, kResident>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (a.n + rows - 1) / rows;
  fused_logp_tile_kernel<DPL, kResident>
      <<<blocks, 32 * rows, smem, stream>>>(a, c, rows);
  return cudaGetLastError();
}

}  // namespace

namespace tpuflows_logp {

template <int DPL>
cudaError_t launch_chain(const Args& a, const ChainList& c,
                         cudaStream_t stream) {
  const size_t smem = sizeof(float) * tpuflows_nuts::row_floats(a, c);
  if (smem > 48 * 1024) {  // above 48 KB only when asked for
    const cudaError_t e = cudaFuncSetAttribute(
        fused_logp_chain_kernel<DPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  fused_logp_chain_kernel<DPL><<<a.n, 32, smem, stream>>>(a, c);
  return cudaGetLastError();
}

// `resident` > 0: the resident instantiation, with that many floats of
// resident layers behind the rows (the host's `resident_floats`); 0: the
// ring
template <int DPL>
cudaError_t launch_tile(const Args& a, const ChainList& c, int rows,
                        int resident, cudaStream_t stream) {
  const size_t row = tpuflows_nuts::row_floats(a, c);
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
template cudaError_t launch_chain<LATENT_DPL>(const Args&, const ChainList&,
                                             cudaStream_t);
#endif
template cudaError_t launch_tile<LATENT_DPL>(const Args&, const ChainList&,
                                            int, int, cudaStream_t);

}  // namespace tpuflows_logp

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

tpuflows_nuts::Args rows_args(const void* z, const void* params,
                              const void* target, int n, int d, int dim,
                              int kind, void* lp, void* g) {
  tpuflows_nuts::Args a = {};
  a.q = static_cast<const float*>(z);
  a.params = static_cast<const float*>(params);
  a.target = static_cast<const float*>(target);
  a.n = n;
  a.d = d;
  a.dim = dim;
  a.kind = kind;
  a.q_out = static_cast<float*>(g);
  a.info = static_cast<float*>(lp);
  return a;
}

// the tile kernel for a.kind: a funnel's from its own units
template <int DPL>
cudaError_t launch_tile_for(const tpuflows_nuts::Args& a,
                            const tpuflows_nuts::ChainList& c, int rows,
                            int resident, cudaStream_t s) {
  return a.kind == kFunnel && !c.general
             ? tpuflows_logp::launch_tile_funnel<DPL>(a, c, rows, resident, s)
             : tpuflows_logp::launch_tile<DPL>(a, c, rows, resident, s);
}

}  // namespace

namespace {

bool chain_ok(int n, int d, int dim, int kind, int n_mods, int hmax,
              int nhid, int head) {
  return n >= 1 && width_ok(d) && target_ok(d, dim, kind) && n_mods >= 0 &&
         n_mods <= tpuflows_nuts::kMaxModules &&
         (hmax == 0 || hidden_ok(hmax)) && nhid >= 0 &&
         nhid < tpuflows_nuts::kMaxLayers && head >= 0 && head % 32 == 0;
}

}  // namespace

// The same through any module list (none: the target alone), packed at
// the lane width d, over the target of kind `kind` and width dim (z, lp
// and g dim wide; targets.cuh), on tiles of `rows` rows (a power of two
// up to kMaxTileRows, tile_grad.cuh) that share every weight read
// (`fused_logp_tile_kernel`): `mods` and `forms` are device arrays of
// n_mods * kModInts and n_mods * kFormInts ints, hmax the widest hidden
// layer (0 without couplings), nhid the most hidden layers of a
// conditioner, head the widest conditioner output, general 1 where a
// module leaves the main paths' form (latent_grad.cuh `ChainList`),
// `resident` the floats of the resident
// layers (the host's `resident_floats`) or 0 for the ring. Refused where
// the tile's rows leave no room for a weight ring (`tile_ring_stage`) or
// for the resident layers (`tile_resident_fits`). Returns a cudaError_t.
extern "C" int fused_logp_chain_f32(const void* z, const void* params,
                                    const void* mods, const void* target,
                                    int n_mods, int n, int d, int dim,
                                    int kind, int hmax, int head,
                                    const void* forms, int nhid,
                                    int general, void* lp, void* g,
                                    int rows, int resident, void* stream) {
  using namespace tpuflows_logp;
  if (!chain_ok(n, d, dim, kind, n_mods, hmax, nhid, head) || rows < 1 ||
      rows > kMaxTileRows || (rows & (rows - 1)) != 0 || resident < 0)
    return (int)cudaErrorInvalidValue;
  const Args a = rows_args(z, params, target, n, d, dim, kind, lp, g);
  const ChainList c = tpuflows_nuts::chain_list(mods, forms, n_mods, hmax,
                                                nhid, head, general);
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

// The per-warp module-list kernel (`fused_logp_chain_kernel`), one row
// per block: chip_smoke.py's oracle and yardstick for the tile kernel, on
// no path. Same arguments as fused_logp_chain_f32 without rows.
extern "C" int fused_logp_chain_warp_f32(const void* z, const void* params,
                                         const void* mods,
                                         const void* target, int n_mods,
                                         int n, int d, int dim, int kind,
                                         int hmax, int head,
                                         const void* forms, int nhid,
                                         int general, void* lp, void* g,
                                         void* stream) {
  using namespace tpuflows_logp;
  if (!chain_ok(n, d, dim, kind, n_mods, hmax, nhid, head))
    return (int)cudaErrorInvalidValue;
  const Args a = rows_args(z, params, target, n, d, dim, kind, lp, g);
  const ChainList c = tpuflows_nuts::chain_list(mods, forms, n_mods, hmax,
                                                nhid, head, general);
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

#endif  // LATENT_DPL
