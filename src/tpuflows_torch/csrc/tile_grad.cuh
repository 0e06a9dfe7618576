// The tile gradient: the module-list latent log density and its gradient
// (latent_grad.cuh `chain_logp_grad`) for a tile of R rows in one block of
// R warps, so that every weight read from L2 serves all R rows. K1's
// (nuts_transition.cu, `nuts_chain_tile_kernel`), K2's (nuts_window.cu,
// `nuts_window_tile_kernel`) and K3's (fused_logp.cu,
// `fused_logp_tile_kernel`) tile kernels run on it.
//
// Why. `chain_logp_grad` runs one row per warp, and its `matvec` reads
// every weight with __ldg for that row alone. At the generic arqs flow's
// widths (d = 64; three affine conditioners 64 -> 128 -> 128 -> 128, ~41 k
// forward weights each, and three spline conditioners 64 -> 128 -> 128 ->
// 1472, ~213 k each) one row's gradient reads the forward weights in sweep
// 1, again in sweep 2's recomputation (for all but the first module
// pulled back) and the transposed copies in the backward pass: ~2.2 M
// floats, ~9 MB per row, ~9 GB for a call of 1,024 rows. At 1.98 ms that
// is ~4.6 TB/s of L2 reads, about what the H100's L2 delivers, while the
// FMAs alone would take 26 us. A tile of R rows that reads each weight
// once and uses it R times cuts that traffic R-fold.
//
// Design.
//  * Per-row work stays per warp, with latent_grad.cuh's code and lane
//    layout: warp b of the block owns row b of the tile and keeps its
//    d-vectors in registers (lane l holds dims l + 32 j). It runs the
//    Standardize and coupling inverses with the tanh clamp, the spline
//    inverse and its pullback (rqs_math.cuh), the target's log density
//    with its warp_sum butterflies (targets.cuh), and silu_backward.
//  * The MLP products are block-wide (`tile_matvec`). Row b's buffers are
//    latent_grad.cuh's `Scratch` at smem + b ld (ld = the floats one row
//    needs: (n_mods + 1) d + 4 hmax + head), so a layer's inputs form an
//    [R][n_in] array at stride ld. Each thread owns output columns and RPT
//    rows of the tile (RPT = R, or fewer for a narrow layer, so that every
//    thread has a column) and keeps one accumulator per (column, row). It
//    loads each weight once from a ring in shared memory that cp.async
//    fills from L2 ahead of use (coalesced 16-byte copies, one barrier a
//    chunk of rows), and applies it to its RPT rows; the inputs come four
//    at a time as one broadcast shared load. __syncthreads() between
//    layers takes the place of __syncwarp(). The ring beat coalesced
//    __ldg of every weight straight from L2, which ran K3 1.46x and K1
//    1.35-1.42x slower at the generic flow (PERF.md).
//  * The accumulation order is matvec's: the bias (or 0), then fmaf over r
//    = 0 .. n_in - 1 in ascending order, for every output, over the work
//    that can reach lp or g: each coupling's first and last layers come as
//    compact copies (`pack_flow`) without the masked inputs' rows and the
//    pass-through dims' head columns, which only ever meet a zero factor
//    or a zero multiplier. So every lp and g of a tile equals the per-warp
//    kernels' in value, and can differ only in a zero's sign;
//    chip_smoke.py (`tile_vs_warp`) holds them to that. The compact layers
//    cut each gradient's MACs and weight bytes by ~45% at the generic
//    flow.
//  * Precision stays float32 on the FMA pipes: the bars against the plain
//    versions (q within 2.3e-4, at most 5 flips of 1,024) leave no room
//    for TF32 rounding, and wgmma takes float32 operands only as TF32.
//  * R is chosen on the host (kernels/nuts_cuda.py `tile_rows`): the
//    largest power of two up to 8 whose R rows of scratch and the 96 KB
//    ring fit in the 227 KB a block may use (8 at the generic flow, 176
//    KB; 2 at d = 256, K = 16). At 8 warps of K1's up to 255 registers a
//    block fills the SM's register file. Where not even one row fits
//    beside the 96 KB ring (d = 256 with K > 40 knots), R is 1 and the
//    ring shrinks to what is left (`tile_ring_stage`), so the tile
//    kernels take every flow whose row fits, as the per-warp kernels did.
//  * Resident weights, for a small flow. Where the module list has one
//    coupling and its compact forward layers (W1, W2, W3) fit beside the
//    R rows (`tile_resident_floats`, `tile_resident_fits`; the host's
//    copy is kernels/nuts_cuda.py `resident_floats`), the tile kernels'
//    resident instantiation (template argument kResident) copies them
//    once per launch into shared memory (`tile_load_resident`, coalesced
//    cp.async) in place of the ring, and every forward and backward
//    product reads them there (`tile_matvec_resident`): no ring, no
//    barrier a chunk, no L2 read after the first, and no W^T copies. The
//    backward product reads a forward layer transposed: each layer's rows
//    are padded by one float, so the 32 lanes of a warp, each on a column
//    of the transposed layer (a row of the stored one), hit 32 banks. The
//    products keep matvec's order (bias or 0, then fmaf over r ascending),
//    so both instantiations give the same values. The ceiling's affine
//    flow (d = 64, 1 -> 128 -> 128 -> 126, compact 32 -> 128 -> 128 ->
//    128) takes 148,608 bytes beside 26,624 bytes of rows at R = 8; the
//    generic flow's six couplings never fit.
//  * Every warp of the block must call the tile gradient the same number
//    of times with the same module list: the control flow here is uniform
//    over the block, and K1's tree loops run in tile lockstep
//    (nuts_tree_body.inc's hooks).
//  * Conditioners of any form (latent_grad.cuh): in a flow that is not of
//    the main paths' form (a Whiten, or a coupling that is not a 3-layer
//    float32 silu MLP), every coupling runs the general path, a loop over
//    its layers (`tile_layer`, `tile_mlp_forward_any` /
//    `tile_mlp_backward_any`, the products summed in double, their
//    activation and bf16 rounding chosen by the form's uniform ints in
//    `tile_matvec_any`), and a Whiten module a d x d product through the
//    ring (`tile_whiten`). A flow of the main paths' form keeps the 3-layer
//    float32 functions (`tile_mlp_forward` / `tile_mlp_backward`,
//    `TileMlp`, `main_form`), and the funnel's own units
//    (-DTARGETS_FUNNEL_ONLY), which the host sends no other flow
//    (`ChainList::general`), compile only those. The per-warp kernels sum
//    each product in the same order, in float32 or double alike, and stay
//    the tile kernels' oracle.
#pragma once

#include <type_traits>

#include "latent_grad.cuh"

namespace {

// four floats of shared memory at p (16-byte aligned) as one load; the
// generic pointer is converted so that the load is a shared one even in a
// function that is not inlined into the kernel
__device__ __forceinline__ float4 lds4(const float* p) {
  float4 v;
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "r"(s));
  return v;
}

// The weight ring: kRingStages stages after the tile's R rows of scratch
// in the block's dynamic shared memory. A stage holds a chunk of rc rows
// of a layer's weight panel (the columns one pass computes, at most 64 R),
// copied from L2 with cp.async while the block computes on the stage
// before it. Each chunk costs a __syncthreads(), so big stages pay: at the
// generic flow K3 ran ~15% faster with 3 x 32 KB than with 4 x 8 KB
// (PERF.md).
constexpr int kRingStages = 3;
constexpr int kRingStageFloats = 8192;
// the most rows of a tile: 8 warps of up to 255 registers a thread fill
// the SM's 65,536
constexpr int kMaxTileRows = 8;
// the dynamic shared memory a block may use (kernels/nuts_cuda.py
// SMEM_LIMIT)
constexpr size_t kSmemLimit = 232448;

// Floats of one ring stage for a tile of R rows of `row_floats` floats
// each: kRingStageFloats, or, where that does not fit in kSmemLimit beside
// the rows, the most that does in a multiple of 256 R floats (a chunk of
// at least 4 rows of the widest panel); 0 where not even that fits.
// The host sizes the launch with it and the device finds its ring with it
// (kernels/nuts_cuda.py `ring_stage_floats` is its copy).
__host__ __device__ __forceinline__ int tile_ring_stage(int R,
                                                        size_t row_floats) {
  const size_t total = kSmemLimit / sizeof(float);
  const size_t used = (size_t)R * row_floats;
  if (used >= total) return 0;
  size_t stage = (total - used) / kRingStages;
  if (stage > (size_t)kRingStageFloats) stage = kRingStageFloats;
  return (int)(stage - stage % (256 * (size_t)R));
}

// dynamic shared memory of a tile of R rows of `row_floats` floats each,
// its weight ring included
__host__ __device__ __forceinline__ size_t tile_smem_bytes(
    int R, size_t row_floats) {
  const size_t ring = (size_t)kRingStages * tile_ring_stage(R, row_floats);
  return sizeof(float) * (R * row_floats + ring);
}

// Floats of the resident copy of a coupling's compact forward layers:
// W1 (n_in x h1), W2 (h1 x h2) and W3 (h2 x n_head), each row padded by
// one float. The host decides the resident mode with it (kernels/
// nuts_cuda.py `resident_floats` is its copy) and the device lays the
// copy out with it.
__host__ __device__ __forceinline__ size_t tile_resident_floats(
    int n_in, int h1, int h2, int n_head) {
  return (size_t)n_in * (h1 + 1) + (size_t)h1 * (h2 + 1) +
         (size_t)h2 * (n_head + 1);
}

// dynamic shared memory of a tile of R rows of `row_floats` floats each
// and the resident layers (`resident` floats) behind them
__host__ __device__ __forceinline__ size_t tile_resident_smem_bytes(
    int R, size_t row_floats, size_t resident) {
  return sizeof(float) * (R * row_floats + resident);
}

// whether the resident layers fit beside the tile's rows in kSmemLimit
__host__ __device__ __forceinline__ bool tile_resident_fits(
    int R, size_t row_floats, size_t resident) {
  return resident > 0 &&
         tile_resident_smem_bytes(R, row_floats, resident) <= kSmemLimit;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// waits until at most kRingStages - 2 of the thread's copy groups are
// still in flight
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;" :: "n"(kRingStages - 2)
               : "memory");
}

// acc[k][i] += sum_q in[b0 + i][r + q] w[q][k] for q = 0 .. 3, in order:
// the tile's inputs four at a time (one broadcast shared load a row)
template <int RPT, int KC>
__device__ __forceinline__ void fma_quad(float (&acc)[KC][RPT],
                                         const float (&w)[4][KC],
                                         const float* x0, int ld, int r) {
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const float4 x = lds4(x0 + (size_t)i * ld + r);
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      acc[k][i] = fmaf(x.x, w[0][k], acc[k][i]);
      acc[k][i] = fmaf(x.y, w[1][k], acc[k][i]);
      acc[k][i] = fmaf(x.z, w[2][k], acc[k][i]);
      acc[k][i] = fmaf(x.w, w[3][k], acc[k][i]);
    }
  }
}

// The same with double accumulators (`tile_matvec_any`: the products are
// exact, the sums rounded in double)
template <int RPT, int KC>
__device__ __forceinline__ void fma_quad(double (&acc)[KC][RPT],
                                         const float (&w)[4][KC],
                                         const float* x0, int ld, int r) {
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const float4 x = lds4(x0 + (size_t)i * ld + r);
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      acc[k][i] = fma((double)x.x, (double)w[0][k], acc[k][i]);
      acc[k][i] = fma((double)x.y, (double)w[1][k], acc[k][i]);
      acc[k][i] = fma((double)x.z, (double)w[2][k], acc[k][i]);
      acc[k][i] = fma((double)x.w, (double)w[3][k], acc[k][i]);
    }
  }
}

// The activations of a pass of `tile_matvec_part<..., kAny>` (`mode`'s,
// latent_grad.cuh `epilogue_act`), from the outputs the thread has just
// stored: a loop that is not unrolled, so that each product's code holds
// one copy of every activation, not one a (column, row) it owns.
template <int RPT, int KC>
__device__ __forceinline__ void tile_epilogue_act(const float* out,
                                                  float* act, int ld,
                                                  int n_out, int c0, int b0,
                                                  int ct, int nct,
                                                  int mode) {
#pragma unroll 1
  for (int e = 0; e < KC * RPT; ++e) {
    const int k = e / RPT, i = e - k * RPT;
    const int c = c0 + ct + nct * k;
    if (c < n_out) {
      const size_t o = (size_t)(b0 + i) * ld + c;
      act[o] = epilogue_act(out[o], mode);
    }
  }
}

// Columns c0 + ct + nct k (k < KC) of rows b0 .. b0 + RPT - 1 of one
// layer, for c0 = 0, KC nct, ... < n_out: out = bias + sum_r in W, act =
// silu(out) when given. Rows lie ld floats apart in `in`, `out` and `act`;
// `ring` is the weight ring behind the tile's rows, of stages of `stage`
// floats.
template <int RPT, int KC, bool kAny = false>
__device__ __forceinline__ void tile_matvec_part(
    const float* __restrict__ W, const float* __restrict__ bias,
    const float* in, int n_in, int n_out, float* out, float* act, int ld,
    int b0, int ct, int nct, float* ring, int stage, int mode = 0) {
  using Acc = std::conditional_t<kAny, double, float>;  // the general path
  const float* x0 = in + (size_t)b0 * ld;
  const int pw = KC * nct;  // a pass's panel of columns
  const int rc = stage / pw;  // rows a chunk, a multiple of 4
  const int n_chunks = (n_in + rc - 1) / rc;  // the last one may be short
  for (int c0 = 0; c0 < n_out; c0 += pw) {
    bool on[KC];
    Acc acc[KC][RPT];
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const int c = c0 + ct + nct * k;
      on[k] = c < n_out;  // uniform over a warp: nct and n_out are x 32
      const float b = (on[k] && bias != nullptr) ? __ldg(bias + c) : 0.0f;
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[k][i] = b;
    }
    // chunk ch (rows ch rc ..) of the panel into stage ch % kRingStages:
    // 16-byte copies of the valid columns, spread over the block
    const int quads = min(pw, n_out - c0) / 4;
    auto fetch = [&](int ch) {
      if (ch < n_chunks) {
        float* dst = ring + (ch % kRingStages) * stage;
        const float* src = W + (size_t)ch * rc * n_out + c0;
        const int n = min(rc, n_in - ch * rc) * quads;
        for (int e = threadIdx.x; e < n; e += blockDim.x) {
          const int rr = e / quads, cq = e - rr * quads;
          cp_async16(dst + rr * pw + 4 * cq,
                     src + (size_t)rr * n_out + 4 * cq);
        }
      }
      cp_async_commit();  // empty past the last chunk: counts stay even
    };
    for (int ch = 0; ch < kRingStages - 1; ++ch) fetch(ch);
    for (int ch = 0; ch < n_chunks; ++ch) {
      cp_async_wait_ring();  // this thread's copies of chunk ch landed
      __syncthreads();  // everyone's; and stage ch - 1 is read
      fetch(ch + kRingStages - 1);
      const float* wst = ring + (ch % kRingStages) * stage + ct;
      const int rows = min(rc, n_in - ch * rc);
      // not unrolled: at the generic flow unroll 2 ran K3 25% slower than
      // unroll 1 or 4, an artefact of code generation (PERF.md)
#pragma unroll 1
      for (int q4 = 0; q4 < rows; q4 += 4) {
        float w[4][KC];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int k = 0; k < KC; ++k)
            w[q][k] = wst[(q4 + q) * pw + nct * k];  // stale where !on[k]
        fma_quad<RPT, KC>(acc, w, x0, ld, ch * rc + q4);
      }
    }
    __syncthreads();  // the next pass refills the ring
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      if (on[k]) {
        const int c = c0 + ct + nct * k;
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const size_t o = (size_t)(b0 + i) * ld + c;
          if constexpr (kAny) {
            out[o] = epilogue_out((float)acc[k][i], mode);
          } else {
            out[o] = acc[k][i];
            if (act != nullptr) act[o] = acc[k][i] * sigmoid(acc[k][i]);
          }
        }
      }
    }
    if constexpr (kAny) {
      if (act != nullptr) tile_epilogue_act<RPT, KC>(out, act, ld, n_out, c0,
                                                     b0, ct, nct, mode);
    }
  }
}

// Rows per thread of a layer n_out wide in a tile of R rows: the most, up
// to R, that still gives each of the block's 32 R threads a column.
__device__ __forceinline__ int tile_rpt(int n_out, int R) {
  int rpt = 1;
  while (rpt * 2 <= R && rpt * 64 <= n_out) rpt *= 2;
  return rpt;
}

// One layer for the tile's R rows (rows ld floats apart): out[b][c] =
// bias[c] + sum_r in[b][r] W[r n_out + c], in matvec's order, and act[b][c]
// = silu(out[b][c]) when act is given. R is a power of two up to
// kMaxTileRows, n_in and n_out multiples of 32. The block's 32 R threads
// form R / RPT groups of 32 RPT; group p takes rows p RPT .. and every
// column, one column per thread per pass (two when the layer is at least
// twice as wide). Every thread of the block calls it; the weights come
// through the ring behind the R rows of scratch.
__device__ __noinline__ void tile_matvec(const float* __restrict__ W,
                                         const float* __restrict__ bias,
                                         const float* in, int n_in,
                                         int n_out, float* out, float* act,
                                         int ld, int R) {
  extern __shared__ float4 tile_dynamic_smem[];
  float* ring = reinterpret_cast<float*>(tile_dynamic_smem) + (size_t)R * ld;
  const int stage = tile_ring_stage(R, ld);
  const int rpt = tile_rpt(n_out, R);
  const int nct = 32 * rpt;
  const int t = threadIdx.x;
  const int b0 = (t / nct) * rpt, ct = t % nct;
  const bool two = n_out >= 2 * nct;
#define TILE_PART(RPT_)                                                    \
  case RPT_:                                                               \
    if (two)                                                               \
      tile_matvec_part<RPT_, 2>(W, bias, in, n_in, n_out, out, act, ld,    \
                                b0, ct, nct, ring, stage);                 \
    else                                                                   \
      tile_matvec_part<RPT_, 1>(W, bias, in, n_in, n_out, out, act, ld,    \
                                b0, ct, nct, ring, stage);                 \
    break;
  switch (rpt) {
    TILE_PART(1)
    TILE_PART(2)
    TILE_PART(4)
    TILE_PART(8)
  }
#undef TILE_PART
}

// `tile_matvec` on the general path: the sums in double (latent_grad.cuh
// kWide), `mode`'s epilogue (`epilogue_out`, `epilogue_act`): any
// activation, bf16 rounding where the form asks
__device__ __noinline__ void tile_matvec_any(const float* __restrict__ W,
                                             const float* __restrict__ bias,
                                             const float* in, int n_in,
                                             int n_out, float* out,
                                             float* act, int ld, int R,
                                             int mode) {
  extern __shared__ float4 tile_dynamic_smem[];
  float* ring = reinterpret_cast<float*>(tile_dynamic_smem) + (size_t)R * ld;
  const int stage = tile_ring_stage(R, ld);
  const int rpt = tile_rpt(n_out, R);
  const int nct = 32 * rpt;
  const int t = threadIdx.x;
  const int b0 = (t / nct) * rpt, ct = t % nct;
  const bool two = n_out >= 2 * nct;
#define TILE_PART(RPT_)                                                    \
  case RPT_:                                                               \
    if (two)                                                               \
      tile_matvec_part<RPT_, 2, true>(                             \
          W, bias, in, n_in, n_out, out, act, ld, b0, ct, nct, ring, stage, \
          mode);                                                           \
    else                                                                   \
      tile_matvec_part<RPT_, 1, true>(                             \
          W, bias, in, n_in, n_out, out, act, ld, b0, ct, nct, ring, stage, \
          mode);                                                           \
    break;
  switch (rpt) {
    TILE_PART(1)
    TILE_PART(2)
    TILE_PART(4)
    TILE_PART(8)
  }
#undef TILE_PART
}

// `tile_matvec_part` on a layer resident in shared memory: its element
// (r, c) at Ws[r sr + c sc] (sr = n_out + 1, sc = 1 for a stored layer;
// sr = 1, sc = its row stride for the transpose of one). No ring and no
// barrier: the same threads, columns, rows and order of every sum.
template <int RPT, int KC, bool kAny = false>
__device__ __forceinline__ void tile_matvec_resident_part(
    const float* Ws, int sr, int sc, const float* __restrict__ bias,
    const float* in, int n_in, int n_out, float* out, float* act, int ld,
    int b0, int ct, int nct, int mode = 0) {
  using Acc = std::conditional_t<kAny, double, float>;  // the general path
  const float* x0 = in + (size_t)b0 * ld;
  const int pw = KC * nct;
  for (int c0 = 0; c0 < n_out; c0 += pw) {
    bool on[KC];
    Acc acc[KC][RPT];
    const float* wc[KC];
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const int c = c0 + ct + nct * k;
      on[k] = c < n_out;  // uniform over a warp: nct and n_out are x 32
      const float b = (on[k] && bias != nullptr) ? __ldg(bias + c) : 0.0f;
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[k][i] = b;
      wc[k] = Ws + (size_t)min(c, n_out - 1) * sc;  // read, unused, off
    }
    // unrolled twice: at the ceiling post-warmup state K1 took 0.164 ms
    // against 0.206 not unrolled and 0.161 unrolled 4 times, K2 5.49 ms a
    // window against 5.72 and 5.73 (PERF.md)
#pragma unroll 2
    for (int r = 0; r < n_in; r += 4) {
      float w[4][KC];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int k = 0; k < KC; ++k) w[q][k] = wc[k][(r + q) * sr];
      fma_quad<RPT, KC>(acc, w, x0, ld, r);
    }
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      if (on[k]) {
        const int c = c0 + ct + nct * k;
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const size_t o = (size_t)(b0 + i) * ld + c;
          if constexpr (kAny) {
            out[o] = epilogue_out((float)acc[k][i], mode);
          } else {
            out[o] = acc[k][i];
            if (act != nullptr) act[o] = acc[k][i] * sigmoid(acc[k][i]);
          }
        }
      }
    }
    if constexpr (kAny) {
      if (act != nullptr) tile_epilogue_act<RPT, KC>(out, act, ld, n_out, c0,
                                                     b0, ct, nct, mode);
    }
  }
}

// `tile_matvec` on a resident layer (`tile_matvec_resident_part`'s Ws,
// sr, sc), with its thread layout.
__device__ __noinline__ void tile_matvec_resident(
    const float* Ws, int sr, int sc, const float* __restrict__ bias,
    const float* in, int n_in, int n_out, float* out, float* act, int ld,
    int R) {
  const int rpt = tile_rpt(n_out, R);
  const int nct = 32 * rpt;
  const int t = threadIdx.x;
  const int b0 = (t / nct) * rpt, ct = t % nct;
  const bool two = n_out >= 2 * nct;
#define TILE_PART(RPT_)                                                    \
  case RPT_:                                                               \
    if (two)                                                               \
      tile_matvec_resident_part<RPT_, 2>(Ws, sr, sc, bias, in, n_in,       \
                                         n_out, out, act, ld, b0, ct, nct); \
    else                                                                   \
      tile_matvec_resident_part<RPT_, 1>(Ws, sr, sc, bias, in, n_in,       \
                                         n_out, out, act, ld, b0, ct, nct); \
    break;
  switch (rpt) {
    TILE_PART(1)
    TILE_PART(2)
    TILE_PART(4)
    TILE_PART(8)
  }
#undef TILE_PART
}

// `tile_matvec_resident` on the general path, as `tile_matvec_any`
__device__ __noinline__ void tile_matvec_resident_any(
    const float* Ws, int sr, int sc, const float* __restrict__ bias,
    const float* in, int n_in, int n_out, float* out, float* act, int ld,
    int R, int mode) {
  const int rpt = tile_rpt(n_out, R);
  const int nct = 32 * rpt;
  const int t = threadIdx.x;
  const int b0 = (t / nct) * rpt, ct = t % nct;
  const bool two = n_out >= 2 * nct;
#define TILE_PART(RPT_)                                                    \
  case RPT_:                                                               \
    if (two)                                                               \
      tile_matvec_resident_part<RPT_, 2, true>(                    \
          Ws, sr, sc, bias, in, n_in, n_out, out, act, ld, b0, ct, nct,    \
          mode);                                                           \
    else                                                                   \
      tile_matvec_resident_part<RPT_, 1, true>(                    \
          Ws, sr, sc, bias, in, n_in, n_out, out, act, ld, b0, ct, nct,    \
          mode);                                                           \
    break;
  switch (rpt) {
    TILE_PART(1)
    TILE_PART(2)
    TILE_PART(4)
    TILE_PART(8)
  }
#undef TILE_PART
}

// floats of one row's scratch (latent_grad.cuh `Scratch`)
__device__ __forceinline__ int tile_ld(const Args& a, const ChainList& c) {
  return (int)tpuflows_nuts::row_floats(a, c);
}

// A coupling's conditioner as the tile kernels run it: W2 as packed, and
// the compact copies of its first and last layers that `pack_flow` writes
// after the module's leaves (md[6]: their offset, md[7]: np, the
// pass-through dims below the target's width a.dim): W1 (n_in x h1) and
// W1^T (h1 x n_in) over those dims, W3 (h2 x n_head), b3 and W3^T (n_head
// x h2) over the transformed dims' head parameters, p-major (column p nt + t); n_in and
// n_head are np and P nt padded with zeros to multiples of 32.
struct TileMlp {
  const float *w1, *b1, *w2, *b2, *w3, *b3, *w1t, *w2t, *w3t;
  int h1, h2, np, nt, n_in, n_head;
};

__device__ __forceinline__ TileMlp tile_mlp_at(const Args& a,
                                               const int* md) {
  const Mlp m = mlp_at(a, md);
  TileMlp t;
  t.b1 = m.b1;
  t.w2 = m.w2;
  t.b2 = m.b2;
  t.w2t = m.w2t;
  t.h1 = m.h1;
  t.h2 = m.h2;
  t.np = md[7];
  t.nt = a.dim - t.np;
  t.n_in = (t.np + 31) & ~31;
  t.n_head = ((m.n_out / a.d) * t.nt + 31) & ~31;
  const float* p = a.params + md[6];
  t.w1 = p;   p += t.n_in * t.h1;
  t.w1t = p;  p += t.h1 * t.n_in;
  t.w3 = p;   p += t.h2 * t.n_head;
  t.b3 = p;   p += t.n_head;
  t.w3t = p;
  return t;
}

// Layer k of a coupling's conditioner of any depth as the tile kernels run
// it: the compact first layer (its n_in rows over the pass-through dims)
// and last layer (its n_head columns over the transformed dims' head
// parameters) from the compact block at md[6], the layers between as
// packed. Of L >= 2 layers the compact block holds W_1 (n_in x h_1),
// W_1^T, W_L (h_{L-1} x n_head), b_L and W_L^T; of one layer W (n_in x
// n_head), b and W^T (kernels/nuts_cuda.py `_compact_leaves`).
__device__ __forceinline__ Layer tile_layer(const Args& a, const int* md,
                                            const int* fm, const TileMlp& m,
                                            int k) {
  const int L = fm[0];
  const float* p = a.params + md[6];
  Layer y;
  if (k > 0 && k < L - 1) return mlp_layer(a, md, fm, k);
  if (L == 1) {
    y.n_in = m.n_in;
    y.n_out = m.n_head;
    y.w = p;
    y.b = p + (size_t)m.n_in * m.n_head;
    y.wt = y.b + m.n_head;
    return y;
  }
  const int h1 = fm[3], hl = fm[1 + L];
  if (k == 0) {
    y.n_in = m.n_in;
    y.n_out = h1;
    y.w = p;
    y.wt = p + (size_t)m.n_in * h1;
    y.b = mlp_layer(a, md, fm, 0).b;
    return y;
  }
  y.n_in = hl;
  y.n_out = m.n_head;
  y.w = p + 2 * (size_t)m.n_in * h1;
  y.b = y.w + (size_t)hl * m.n_head;
  y.wt = y.b + m.n_head;
  return y;
}

// floats of the resident copy of layers 0 .. k - 1 (rows of n_out + 1)
__device__ __forceinline__ size_t tile_resident_before(const Args& a,
                                                       const int* md,
                                                       const int* fm,
                                                       const TileMlp& m,
                                                       int k) {
  size_t n = 0;
  for (int j = 0; j < k; ++j) {
    const Layer y = tile_layer(a, md, fm, m, j);
    n += (size_t)y.n_in * (y.n_out + 1);
  }
  return n;
}

// Whether a coupling belongs to a flow of the main paths' form (every
// coupling a 3-layer float32 silu MLP, no Whiten), which the 3-layer
// functions (`TileMlp`, `tile_mlp_forward`, `tile_mlp_backward`,
// `tile_resident_floats`) compute with float32 sums: always in the
// funnel's own units, which the host sends no other flow; else the form's
// flag (kFormGeneral, set on every coupling of any other flow) decides, so
// that a flow runs the same code in every unit.
__device__ __forceinline__ bool main_form(const int* fm) {
#ifdef TARGETS_FUNNEL_ONLY
  return true;
#else
  return (fm[2] & tpuflows_nuts::kFormGeneral) == 0;
#endif
}

// The resident copy of the one coupling's compact forward layers, behind
// the tile's R rows of ld floats: W1, W2, W3 with rows of n_out + 1 (any
// depth: each layer in turn, `tile_resident_before`).
struct TileResident {
  const float *w1, *w2, *w3;
};

__device__ __forceinline__ TileResident tile_resident_at(const TileMlp& m,
                                                         int ld, int R) {
  extern __shared__ float4 tile_dynamic_smem[];
  const float* p =
      reinterpret_cast<const float*>(tile_dynamic_smem) + (size_t)R * ld;
  TileResident w;
  w.w1 = p;  p += (size_t)m.n_in * (m.h1 + 1);
  w.w2 = p;  p += (size_t)m.h1 * (m.h2 + 1);
  w.w3 = p;
  return w;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(s), "l"(src) : "memory");
}

// rows x cols floats from L2 (row-major) to shared memory at rows of
// cols + 1: warp w copies rows w, w + R, ..., its lanes neighbouring
// floats (cols is a multiple of 32)
__device__ __forceinline__ void copy_padded(float* dst, const float* src,
                                            int rows, int cols, int R) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += R)
    for (int c = lane; c < cols; c += 32)
      cp_async4(dst + (size_t)r * (cols + 1) + c, src + (size_t)r * cols + c);
}

// The resident mode's start, by every thread of the block: the compact
// forward layers of the module list's one coupling into shared memory
// behind the R rows (`tile_resident_at`), once per launch. Traps where the
// list has another number of couplings or the launch gave too little
// shared memory: the host's `resident_floats` disagrees with the device.
// (A Whiten counts as a module that needs the ring: the host keeps a flow
// with one on the ring.)
__device__ void tile_load_resident(const Args& a, const ChainList& c,
                                   int R) {
  int k1 = -1;
  int couplings = 0;
  for (int k = 0; k < c.n_mods; ++k) {
    if (c.mods[kModInts * k] != tpuflows_nuts::kStandardize) {
      k1 = k;
      ++couplings;
    }
  }
  if (couplings != 1 || c.mods[kModInts * k1] == tpuflows_nuts::kWhiten)
    __trap();
  const int* md = c.mods + kModInts * k1;
  const int* fm = c.forms + kFormInts * k1;
  const TileMlp m = tile_mlp_at(a, md);
  const int ld = tile_ld(a, c);
  unsigned bytes;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(bytes));
  if (main_form(fm)) {
    if (tile_resident_smem_bytes(
            R, ld, tile_resident_floats(m.n_in, m.h1, m.h2, m.n_head)) >
        bytes)
      __trap();
    const TileResident w = tile_resident_at(m, ld, R);
    copy_padded(const_cast<float*>(w.w1), m.w1, m.n_in, m.h1, R);
    copy_padded(const_cast<float*>(w.w2), m.w2, m.h1, m.h2, R);
    copy_padded(const_cast<float*>(w.w3), m.w3, m.h2, m.n_head, R);
  } else {
    const int L = fm[0];
    if (tile_resident_smem_bytes(R, ld, tile_resident_before(a, md, fm, m,
                                                             L)) > bytes)
      __trap();
    float* dst = const_cast<float*>(tile_resident_at(m, ld, R).w1);
    for (int k = 0; k < L; ++k) {
      const Layer y = tile_layer(a, md, fm, m, k);
      copy_padded(dst, y.w, y.n_in, y.n_out, R);
      dst += (size_t)y.n_in * (y.n_out + 1);
    }
  }
  cp_async_commit();
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
}

// pos[j]: the place of dim lane + 32 j among the pass-through dims (mask
// 1) or among the transformed dims (mask 0), in dim order
template <int DPL>
__device__ __forceinline__ void compact_positions(const float (&mk)[DPL],
                                                  int (&pos)[DPL],
                                                  int lane) {
  const unsigned below = (1u << lane) - 1u;
  int before = 0;  // pass-through dims among the earlier chunks of 32
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    const unsigned bits = __ballot_sync(kFull, mk[j] != 0.0f);
    const int p = before + __popc(bits & below);
    pos[j] = mk[j] != 0.0f ? p : lane + 32 * j - p;
    before += __popc(bits);
  }
}

// head = MLP(xin) for every row of the tile, keeping a1 and a2; s0 is row
// 0's scratch; xin and head hold the compact layers' inputs and outputs.
// The weights come through the ring, or from the resident copy.
template <bool kResident = false>
__device__ void tile_mlp_forward(const TileMlp& m, const Scratch& s0,
                                 int ld, int R) {
  if constexpr (kResident) {
    const TileResident w = tile_resident_at(m, ld, R);
    __syncthreads();
    tile_matvec_resident(w.w1, m.h1 + 1, 1, m.b1, s0.xin, m.n_in, m.h1,
                         s0.a1, s0.v1, ld, R);
    __syncthreads();
    tile_matvec_resident(w.w2, m.h2 + 1, 1, m.b2, s0.v1, m.h1, m.h2, s0.a2,
                         s0.v2, ld, R);
    __syncthreads();
    tile_matvec_resident(w.w3, m.n_head + 1, 1, m.b3, s0.v2, m.h2,
                         m.n_head, s0.head, nullptr, ld, R);
    __syncthreads();
    return;
  }
  __syncthreads();
  tile_matvec(m.w1, m.b1, s0.xin, m.n_in, m.h1, s0.a1, s0.v1, ld, R);
  __syncthreads();
  tile_matvec(m.w2, m.b2, s0.v1, m.h1, m.h2, s0.a2, s0.v2, ld, R);
  __syncthreads();
  tile_matvec(m.w3, m.b3, s0.v2, m.h2, m.n_head, s0.head, nullptr, ld, R);
  __syncthreads();
}

// xin = d (head . MLP) / d input for every row of the tile; silu_backward
// per warp on its own row s. The resident copy is read transposed.
template <bool kResident = false>
__device__ void tile_mlp_backward(const TileMlp& m, const Scratch& s0,
                                  const Scratch& s, int ld, int R,
                                  int lane) {
  if constexpr (kResident) {
    const TileResident w = tile_resident_at(m, ld, R);
    __syncthreads();
    tile_matvec_resident(w.w3, 1, m.n_head + 1, nullptr, s0.head, m.n_head,
                         m.h2, s0.v2, nullptr, ld, R);
    __syncthreads();
    silu_backward(s.v2, s.a2, m.h2, lane);
    __syncthreads();
    tile_matvec_resident(w.w2, 1, m.h2 + 1, nullptr, s0.v2, m.h2, m.h1,
                         s0.v1, nullptr, ld, R);
    __syncthreads();
    silu_backward(s.v1, s.a1, m.h1, lane);
    __syncthreads();
    tile_matvec_resident(w.w1, 1, m.h1 + 1, nullptr, s0.v1, m.h1, m.n_in,
                         s0.xin, nullptr, ld, R);
    __syncthreads();
    return;
  }
  __syncthreads();
  tile_matvec(m.w3t, nullptr, s0.head, m.n_head, m.h2, s0.v2, nullptr, ld,
              R);
  __syncthreads();
  silu_backward(s.v2, s.a2, m.h2, lane);
  __syncthreads();
  tile_matvec(m.w2t, nullptr, s0.v2, m.h2, m.h1, s0.v1, nullptr, ld, R);
  __syncthreads();
  silu_backward(s.v1, s.a1, m.h1, lane);
  __syncthreads();
  tile_matvec(m.w1t, nullptr, s0.v1, m.h1, m.n_in, s0.xin, nullptr, ld, R);
  __syncthreads();
}

// `tile_mlp_forward` for a conditioner of any form (`fm`): its L layers in
// turn, each hidden layer's pre-activation kept; a bf16 one rounds each
// row's input first (every warp its own row)
template <bool kResident = false>
__device__ void tile_mlp_forward_any(const Args& a, const int* md,
                                     const int* fm, const TileMlp& m,
                                     const Scratch& s0, const Scratch& s,
                                     int ld, int R, int lane) {
  const int L = fm[0];
  const int mode = forward_mode(fm);
  __syncthreads();
  if (fm[2] & tpuflows_nuts::kFormBf16) {
    for (int r = lane; r < m.n_in; r += 32) s.xin[r] = bf16_round(s.xin[r]);
    __syncthreads();
  }
  const float* wres = kResident ? tile_resident_at(m, ld, R).w1 : nullptr;
  const float* in = s0.xin;
  for (int k = 0; k < L; ++k) {
    const Layer y = tile_layer(a, md, fm, m, k);
    const bool last = k == L - 1;
    float* pre = last ? s0.head : hidden_pre(s0, k + 1);
    float* act = last ? nullptr : hidden_act(s0, k + 1);
    if constexpr (kResident) {
      tile_matvec_resident_any(wres, y.n_out + 1, 1, y.b, in, y.n_in,
                               y.n_out, pre, act, ld, R, mode);
      wres += (size_t)y.n_in * (y.n_out + 1);
    } else {
      tile_matvec_any(y.w, y.b, in, y.n_in, y.n_out, pre, act, ld, R, mode);
    }
    __syncthreads();
    in = act;
  }
}

// `tile_mlp_backward` for a conditioner of any form: act' per warp on its
// own row s; a bf16 one rounds each input cotangent once
template <bool kResident = false>
__device__ void tile_mlp_backward_any(const Args& a, const int* md,
                                      const int* fm, const TileMlp& m,
                                      const Scratch& s0, const Scratch& s,
                                      int ld, int R, int lane) {
  const int L = fm[0], act = fm[1];
  const int mode = backward_mode(fm);
  __syncthreads();
  const float* g = s0.head;
  for (int k = L - 1; k >= 0; --k) {
    const Layer y = tile_layer(a, md, fm, m, k);
    float* out = k > 0 ? hidden_act(s0, k) : s0.xin;
    if constexpr (kResident) {
      const float* w = tile_resident_at(m, ld, R).w1 +
                       tile_resident_before(a, md, fm, m, k);
      tile_matvec_resident_any(w, 1, y.n_out + 1, nullptr, g, y.n_out,
                               y.n_in, out, nullptr, ld, R, mode);
    } else {
      tile_matvec_any(y.wt, nullptr, g, y.n_out, y.n_in, out, nullptr, ld,
                      R, mode);
    }
    __syncthreads();
    if (k > 0) {
      act_backward(hidden_act(s, k), hidden_pre(s, k), y.n_in, act, lane);
      __syncthreads();
    }
    g = out;
  }
}

// Whiten for the warp's row of the tile: y = y W + bias over the ring (W
// = chol^T and bias = loc for the inverse, W = chol and no bias for the
// pullback), through each row's xin and head, summed in double as the
// general path's products (`tile_matvec_any`)
template <int DPL>
__device__ __forceinline__ void tile_whiten(const float* W,
                                            const float* bias, int d,
                                            const Scratch& s0,
                                            const Scratch& s, int ld, int R,
                                            float (&y)[DPL], int lane) {
#pragma unroll
  for (int j = 0; j < DPL; ++j) s.xin[lane + 32 * j] = y[j];
  __syncthreads();
  tile_matvec_any(W, bias, s0.xin, d, d, s0.head, nullptr, ld, R, kWide);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < DPL; ++j) y[j] = s.head[lane + 32 * j];
}

// the conditioner's input for the warp's row: the pass-through dims of y
// in order (y * mask with the zeros left out), then zeros to n_in. The
// padded dims past the target's width pass through too but come last and
// have no place (pos >= np): their y is 0 and their W1 rows are zeros.
template <int DPL>
__device__ __forceinline__ void write_compact_input(
    const TileMlp& m, const Scratch& s, const float (&y)[DPL],
    const float (&mk)[DPL], const int (&pos)[DPL], int lane) {
#pragma unroll
  for (int j = 0; j < DPL; ++j)
    if (mk[j] != 0.0f && pos[j] < m.np) s.xin[pos[j]] = y[j];
  for (int r = m.np + lane; r < m.n_in; r += 32) s.xin[r] = 0.0f;
}

// `module_inverse` for the warp's row of the tile (s: its scratch, s0:
// row 0's), the conditioner through the tile's compact MLP. Leaving out
// the masked inputs and the pass-through dims' head parameters skips only
// products with a zero factor and terms multiplied by zero (y' = y and
// ladj unchanged on a pass-through dim), so it can change only the sign
// of a zero against `module_inverse`.
template <int DPL, bool kResident = false>
__device__ __noinline__ float tile_module_inverse(
    const Args& a, const int* md, const int* fm, const Scratch& s0,
    const Scratch& s, int ld, int R, float (&y)[DPL], int lane) {
  const int d = a.d;
  const float* p = a.params + md[1];
  float ladj = 0.0f;
#ifndef TARGETS_FUNNEL_ONLY
  if (md[0] == tpuflows_nuts::kWhiten) {
    tile_whiten<DPL>(p + d, p, d, s0, s, ld, R, y, lane);
    return lane == 0 ? __int_as_float(md[5]) : 0.0f;  // once a row
  }
#endif
  if (md[0] == tpuflows_nuts::kStandardize) {
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int i = lane + 32 * j;
      const float ls = __ldg(p + d + i);
      y[j] = y[j] * expf(ls) + __ldg(p + i);
      ladj += ls;
    }
    return ladj;
  }
  const Mlp mm = mlp_at(a, md);
  const TileMlp m = tile_mlp_at(a, md);
  float mk[DPL];
  int pos[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) mk[j] = __ldg(mm.mask + lane + 32 * j);
  compact_positions<DPL>(mk, pos, lane);
  write_compact_input<DPL>(m, s, y, mk, pos, lane);
  if (main_form(fm))
    tile_mlp_forward<kResident>(m, s0, ld, R);
  else
    tile_mlp_forward_any<kResident>(a, md, fm, m, s0, s, ld, R, lane);
  const float c = __int_as_float(md[5]);
  if (md[0] == tpuflows_nuts::kAffine) {
    // y' = (y - shift) exp(-s), s = clamp tanh(raw / clamp), on the
    // transformed dims
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      if (mk[j] == 0.0f) {
        const float sc = c * tanhf(s.head[m.nt + pos[j]] / c);
        y[j] = (y[j] - s.head[pos[j]]) * expf(-sc);
        ladj -= sc;
      }
    }
  } else {
    // the spline on the transformed dims; pass-through dims keep y
    const int K = md[4];
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      if (mk[j] == 0.0f) {
        float x, l;
        tpuflows_rqs::rqs_inverse(y[j], s.head + pos[j], m.nt, K, c, x, l);
        y[j] = x;
        ladj += l;
      }
    }
  }
  return ladj;
}

// `module_vjp` for the warp's row of the tile, on the compact layers (the
// pass-through dims' head cotangents are zeros and left out; the
// transformed dims' input cotangents are multiplied by zero and not
// computed): it can change only the sign of a zero against `module_vjp`.
template <int DPL, bool kResident = false>
__device__ __noinline__ void tile_module_vjp(
    const Args& a, const int* md, const int* fm, const Scratch& s0,
    const Scratch& s, int ld, int R, const float* y_in, bool& live,
    float (&g)[DPL], int lane) {
  const int d = a.d;
#ifndef TARGETS_FUNNEL_ONLY
  if (md[0] == tpuflows_nuts::kWhiten) {  // g_z = g_x chol
    const float* p = a.params + md[1];
    tile_whiten<DPL>(p + d + d * d, nullptr, d, s0, s, ld, R, g, lane);
    live = false;  // xin and head no longer hold a conditioner
    return;
  }
#endif
  if (md[0] == tpuflows_nuts::kStandardize) {
    const float* p = a.params + md[1];
#pragma unroll
    for (int j = 0; j < DPL; ++j)
      g[j] *= expf(__ldg(p + d + lane + 32 * j));
    return;
  }
  const Mlp mm = mlp_at(a, md);
  const TileMlp m = tile_mlp_at(a, md);
  float y[DPL], mk[DPL], gd[DPL];
  int pos[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    const int i = lane + 32 * j;
    y[j] = y_in[i];
    mk[j] = __ldg(mm.mask + i);
  }
  compact_positions<DPL>(mk, pos, lane);
  if (!live) {
    write_compact_input<DPL>(m, s, y, mk, pos, lane);
    if (main_form(fm))
      tile_mlp_forward<kResident>(m, s0, ld, R);
    else
      tile_mlp_forward_any<kResident>(a, md, fm, m, s0, s, ld, R, lane);
  }
  live = false;
  const float c = __int_as_float(md[5]);
  const int used = (mm.n_out / d) * m.nt;  // head parameters in use
  if (md[0] == tpuflows_nuts::kAffine) {
    // the head's cotangent is written over the head, lane by lane
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      if (mk[j] == 0.0f) {
        float* sh = s.head + pos[j];
        const float th = tanhf(sh[m.nt] / c);
        const float e = expf(-(c * th));
        const float yt = (y[j] - sh[0]) * e;
        const float gy = g[j];
        sh[0] = -gy * e;
        sh[m.nt] = -(gy * yt + 1.0f) * (1.0f - th * th);
        gd[j] = gy * e;
      } else {
        gd[j] = g[j];
      }
    }
  } else {
    const int K = md[4];
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      if (mk[j] == 0.0f) {
        float* col = s.head + pos[j];
        tpuflows_rqs::rqs_inverse_vjp(y[j], col, m.nt, K, c, g[j], 1.0f,
                                      gd[j], col, m.nt);
      } else {
        gd[j] = g[j];
      }
    }
  }
  for (int r = used + lane; r < m.n_head; r += 32) s.head[r] = 0.0f;
  if (main_form(fm))
    tile_mlp_backward<kResident>(m, s0, s, ld, R, lane);
  else
    tile_mlp_backward_any<kResident>(a, md, fm, m, s0, s, ld, R, lane);
#pragma unroll
  for (int j = 0; j < DPL; ++j)
    g[j] = mk[j] != 0.0f && pos[j] < m.np ? gd[j] + s.xin[pos[j]] : gd[j];
}

// lp = log p(f^-1(z)) + ladj and g = d lp / dz through the module list for
// the warp's row `warp` of a tile of R rows (`chain_logp_grad`, with its
// MLPs shared over the tile). Every warp of the block calls it together;
// `smem` holds R rows of tile_ld floats.
template <int DPL, bool kResident = false>
__device__ float tile_chain_logp_grad(const Args& a, const ChainList& c,
                                      float* smem, int R,
                                      const float (&z)[DPL],
                                      float (&g)[DPL], int lane, int warp) {
  const int d = a.d;
  const int ld = tile_ld(a, c);
  const Scratch s0 = scratch_at(a, c, smem);
  const Scratch s = scratch_at(a, c, smem + (size_t)warp * ld);
  float x[DPL];
  float ladj = 0.0f;
#pragma unroll
  for (int j = 0; j < DPL; ++j) x[j] = z[j];
  // sweep 1: the inverse chain, last module first; keep each input
  for (int k = c.n_mods - 1; k >= 0; --k) {
#pragma unroll
    for (int j = 0; j < DPL; ++j) s.bounds[k * d + lane + 32 * j] = x[j];
    ladj += tile_module_inverse<DPL, kResident>(
        a, c.mods + kModInts * k, c.forms + kFormInts * k, s0, s, ld, R, x,
        lane);
  }
  const float lp = target_logp_grad<DPL>(a, x, g, lane) + warp_sum(ladj);
  // sweep 2: first module first; its conditioner ran last in sweep 1
  bool live = true;
  for (int k = 0; k < c.n_mods; ++k)
    tile_module_vjp<DPL, kResident>(a, c.mods + kModInts * k,
                                    c.forms + kFormInts * k, s0, s, ld, R,
                                    s.bounds + k * d, live, g, lane);
  return lp;
}

// The same at `on ? z : alt`: a warp whose chain has stopped takes part in
// its tile's gradient at a finite point of its own (K1's lockstep).
template <int DPL, bool kResident = false>
__device__ __forceinline__ float tile_chain_logp_grad_at(
    const Args& a, const ChainList& c, float* smem, int R, bool on,
    const float (&z)[DPL], const float (&alt)[DPL], float (&g)[DPL],
    int lane, int warp) {
  float zz[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) zz[j] = on ? z[j] : alt[j];
  return tile_chain_logp_grad<DPL, kResident>(a, c, smem, R, zz, g, lane,
                                              warp);
}

}  // namespace
