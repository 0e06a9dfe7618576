// K3 of tpuflows_torch: the fused latent log density and its gradient.
//
// Replaces the Pallas kernel of `make_fused_logp_and_grad`
// (src/tpuflows/kernels/fused_logp.py:73, pallas_call at :140), built by
// `fused_latent_logp_and_grad` (:188). For each row z of an (n, d) float32
// batch it computes
//   lp = log p(f^-1(z)) + ladj(z)   and   g = d lp / dz
// through a flow over Neal's funnel, in one launch: the flow inverse, the
// ladj, the target's log density and the whole pullback, with no
// intermediate leaving the chip. It is the `logp_and_grad` hook of the
// portable NUTS and HMC (mcmc/nuts.py, mcmc/hmc.py); the plain PyTorch
// version is `nuts_cuda.plain_logp_grad` (autograd through the flow, or the
// streamed per-block backward on the p-major relayout for flows with
// splines), called by kernels/fused_logp_cuda.py on CPU tensors.
//
// The JAX kernel traces any log density into its tile body; a kernel
// written by hand cannot, so this one takes what K1 takes (latent_grad.cuh,
// where the gradient lives): Standardize + one AffineCoupling
// (`fused_logp_affine_kernel`, `logp_grad`) or a module list of
// Standardize, AffineCoupling and RQSCouplingBlock modules
// (`fused_logp_chain_kernel`, `chain_logp_grad`), with 3-layer silu MLPs.
//
// Design. The affine kernel (`fused_logp_affine_kernel`) is one warp per
// row, one warp per block, with the per-warp gradient device code
// (`logp_grad`, which K1's and K2's per-warp affine kernels share), its
// scratch 6 d + 3 h1 + 3 h2 floats of dynamic shared memory; it reads the
// `Net` prefix of the packed buffer, and is the last affine kernel on a
// path (the portable one) now that K1 and K2 run the affine flow on their
// tile kernels. The module-list kernel (`fused_logp_tile_kernel`) runs the tile
// gradient of tile_grad.cuh: one block of R warps per tile of R rows,
// every weight read once per tile (through a cp.async ring in shared
// memory) and used for all R rows, warp b owning row b with
// latent_grad.cuh's per-row code; R (`nuts_cuda.tile_rows`, 8 at the
// generic flow) comes from the host, and the block's dynamic shared
// memory is R rows of (n_mods + 1) d + 4 hmax + head floats and the 96 KB
// ring (176 KB at the generic flow; less where one row leaves less room,
// tile_grad.cuh `tile_ring_stage`). Rows past n in the last tile compute
// on a copy of row n - 1 and store nothing. Its lp and g equal the
// per-warp module-list kernel's in value (the same per-row code, the same
// order of every sum; the compact layers it reads can change only a
// zero's sign). The per-warp kernel (`fused_logp_chain_kernel`, entry
// point `fused_logp_chain_warp_f32`) stays built only as chip_smoke.py's
// oracle and yardstick for the tile kernel; no wrapper calls it.
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
// tile_grad.cuh), so the affine kernel stays far from that bound; the
// tile kernel reads them once per R rows. Both stay in float32 on the FMA
// pipes (tile_grad.cuh says why). PERF.md keeps the measured times beside
// the bound.

#include "tile_grad.cuh"

// Built by kernels/fused_logp_cuda.py (`LIBRARY`, kernels/cuda_build.py)
// as one translation unit per instantiation (-DLATENT_DPL=1..8, DPL = d /
// 32 dims per lane), all compiled in parallel, plus one unit without
// LATENT_DPL that holds the C entry points, linked into one library.

namespace tpuflows_logp {

using tpuflows_nuts::Args;
using tpuflows_nuts::ChainList;

template <int DPL>
cudaError_t launch_affine(const Args& a, cudaStream_t stream);
template <int DPL>
cudaError_t launch_chain(const Args& a, const ChainList& c,
                         cudaStream_t stream);
template <int DPL>
cudaError_t launch_tile(const Args& a, const ChainList& c, int rows,
                        cudaStream_t stream);

}  // namespace tpuflows_logp

#ifdef LATENT_DPL

namespace {

// z (row `row` of a.q) into the lane's registers
template <int DPL>
__device__ __forceinline__ void load_row(const Args& a, int row, int lane,
                                         float (&z)[DPL]) {
#pragma unroll
  for (int j = 0; j < DPL; ++j)
    z[j] = __ldg(a.q + (size_t)row * a.d + lane + 32 * j);
}

// g to row `row` of a.q_out, lp to a.info[row]
template <int DPL>
__device__ __forceinline__ void store_row(const Args& a, int row, int lane,
                                          float lp, const float (&g)[DPL]) {
#pragma unroll
  for (int j = 0; j < DPL; ++j)
    a.q_out[(size_t)row * a.d + lane + 32 * j] = g[j];
  if (lane == 0) a.info[row] = lp;
}

template <int DPL>
__global__ void __launch_bounds__(32) fused_logp_affine_kernel(Args a) {
  extern __shared__ float smem[];
  const int row = blockIdx.x;
  const int lane = threadIdx.x;
  const Net t = unpack(a);
  float z[DPL], g[DPL];
  load_row<DPL>(a, row, lane, z);
  const float lp = logp_grad<DPL>(a, t, smem, z, g, lane);
  store_row<DPL>(a, row, lane, lp, g);
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

// One tile of `rows` rows per block, warp b on row blockIdx.x rows + b.
template <int DPL>
__global__ void __launch_bounds__(32 * kMaxTileRows)
    fused_logp_tile_kernel(Args a, ChainList c, int rows) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * rows + warp;
  float z[DPL], g[DPL];
  load_row<DPL>(a, min(row, a.n - 1), lane, z);
  const float lp = tile_chain_logp_grad<DPL>(a, c, smem, rows, z, g, lane,
                                             warp);
  if (row < a.n) store_row<DPL>(a, row, lane, lp, g);
}

}  // namespace

namespace tpuflows_logp {

template <int DPL>
cudaError_t launch_affine(const Args& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (6 * a.d + 3 * a.h1 + 3 * a.h2);
  fused_logp_affine_kernel<DPL><<<a.n, 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int DPL>
cudaError_t launch_chain(const Args& a, const ChainList& c,
                         cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(c.n_mods + 1) * a.d + 4 * c.hmax + c.head);
  if (smem > 48 * 1024) {  // above 48 KB only when asked for
    const cudaError_t e = cudaFuncSetAttribute(
        fused_logp_chain_kernel<DPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  fused_logp_chain_kernel<DPL><<<a.n, 32, smem, stream>>>(a, c);
  return cudaGetLastError();
}

template <int DPL>
cudaError_t launch_tile(const Args& a, const ChainList& c, int rows,
                        cudaStream_t stream) {
  const size_t row = (size_t)(c.n_mods + 1) * a.d + 4 * c.hmax + c.head;
  if (tile_ring_stage(rows, row) == 0) return cudaErrorInvalidValue;
  const size_t smem = tile_smem_bytes(rows, row);
  if (smem > 48 * 1024) {  // above 48 KB only when asked for
    const cudaError_t e = cudaFuncSetAttribute(
        fused_logp_tile_kernel<DPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (a.n + rows - 1) / rows;
  fused_logp_tile_kernel<DPL><<<blocks, 32 * rows, smem, stream>>>(a, c,
                                                                   rows);
  return cudaGetLastError();
}

template cudaError_t launch_affine<LATENT_DPL>(const Args&, cudaStream_t);
template cudaError_t launch_chain<LATENT_DPL>(const Args&, const ChainList&,
                                             cudaStream_t);
template cudaError_t launch_tile<LATENT_DPL>(const Args&, const ChainList&,
                                            int, cudaStream_t);

}  // namespace tpuflows_logp

#else  // the C entry points

namespace {

bool width_ok(int w) { return w >= 32 && w <= 256 && w % 32 == 0; }

tpuflows_nuts::Args rows_args(const void* z, const void* params, int n,
                              int d, float sigma_v, void* lp, void* g) {
  tpuflows_nuts::Args a = {};
  a.q = static_cast<const float*>(z);
  a.params = static_cast<const float*>(params);
  a.n = n;
  a.d = d;
  a.sigma_v = sigma_v;
  a.q_out = static_cast<float*>(g);
  a.info = static_cast<float*>(lp);
  return a;
}

}  // namespace

// lp (n,) and g (n, d) of z (n, d) through Standardize + one affine
// coupling with an MLP d -> h1 -> h2 -> 2d, its leaves packed as
// latent_grad.cuh's `Net` says. Returns a cudaError_t (0 = launched).
// Shapes are checked again here; the Python wrapper checks device, dtype
// and contiguity before calling.
extern "C" int fused_logp_affine_f32(const void* z, const void* params,
                                     int n, int d, int h1, int h2,
                                     float clamp, float sigma_v, void* lp,
                                     void* g, void* stream) {
  using namespace tpuflows_logp;
  if (n < 1 || !width_ok(d) || !width_ok(h1) || !width_ok(h2))
    return (int)cudaErrorInvalidValue;
  Args a = rows_args(z, params, n, d, sigma_v, lp, g);
  a.h1 = h1;
  a.h2 = h2;
  a.clamp = clamp;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d / 32) {
    case 1: return (int)launch_affine<1>(a, s);
    case 2: return (int)launch_affine<2>(a, s);
    case 3: return (int)launch_affine<3>(a, s);
    case 4: return (int)launch_affine<4>(a, s);
    case 5: return (int)launch_affine<5>(a, s);
    case 6: return (int)launch_affine<6>(a, s);
    case 7: return (int)launch_affine<7>(a, s);
    default: return (int)launch_affine<8>(a, s);
  }
}

namespace {

bool chain_ok(int n, int d, int n_mods, int hmax, int head) {
  return n >= 1 && width_ok(d) && n_mods >= 1 &&
         n_mods <= tpuflows_nuts::kMaxModules &&
         (hmax == 0 || width_ok(hmax)) && head >= 0 && head % 32 == 0;
}

tpuflows_nuts::ChainList chain_list(const void* mods, int n_mods, int hmax,
                                    int head) {
  tpuflows_nuts::ChainList c;
  c.mods = static_cast<const int*>(mods);
  c.n_mods = n_mods;
  c.hmax = hmax;
  c.head = head;
  return c;
}

}  // namespace

// The same through a module list, on tiles of `rows` rows (a power of two
// up to kMaxTileRows, tile_grad.cuh) that share every weight read
// (`fused_logp_tile_kernel`): `mods` is a device array of n_mods *
// kModInts ints, hmax the widest hidden layer (0 without couplings), head
// the widest conditioner output. Refused where the tile's rows leave no
// room for a weight ring (`tile_ring_stage`). Returns a cudaError_t.
extern "C" int fused_logp_chain_f32(const void* z, const void* params,
                                    const void* mods, int n_mods, int n,
                                    int d, int hmax, int head, float sigma_v,
                                    void* lp, void* g, int rows,
                                    void* stream) {
  using namespace tpuflows_logp;
  if (!chain_ok(n, d, n_mods, hmax, head) || rows < 1 ||
      rows > kMaxTileRows || (rows & (rows - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const Args a = rows_args(z, params, n, d, sigma_v, lp, g);
  const ChainList c = chain_list(mods, n_mods, hmax, head);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d / 32) {
    case 1: return (int)launch_tile<1>(a, c, rows, s);
    case 2: return (int)launch_tile<2>(a, c, rows, s);
    case 3: return (int)launch_tile<3>(a, c, rows, s);
    case 4: return (int)launch_tile<4>(a, c, rows, s);
    case 5: return (int)launch_tile<5>(a, c, rows, s);
    case 6: return (int)launch_tile<6>(a, c, rows, s);
    case 7: return (int)launch_tile<7>(a, c, rows, s);
    default: return (int)launch_tile<8>(a, c, rows, s);
  }
}

// The per-warp module-list kernel (`fused_logp_chain_kernel`), one row
// per block: chip_smoke.py's oracle and yardstick for the tile kernel, on
// no path. Same arguments as fused_logp_chain_f32 without rows.
extern "C" int fused_logp_chain_warp_f32(const void* z, const void* params,
                                         const void* mods, int n_mods,
                                         int n, int d, int hmax, int head,
                                         float sigma_v, void* lp, void* g,
                                         void* stream) {
  using namespace tpuflows_logp;
  if (!chain_ok(n, d, n_mods, hmax, head)) return (int)cudaErrorInvalidValue;
  const Args a = rows_args(z, params, n, d, sigma_v, lp, g);
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

#endif  // LATENT_DPL
