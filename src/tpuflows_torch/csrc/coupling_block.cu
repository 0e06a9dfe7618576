// The earlier K6 and K7 of tpuflows_torch: one whole
// rational-quadratic-spline coupling block per tile of 8 rows, and its
// pullback. The kernels on the path are csrc/coupling_tile.cu's (tiles of
// rows whose cluster shares every weight read); these stay built, behind
// the entry points coupling_rows8_*, as their yardstick: chip_smoke.py
// times both in one call and prints how far their results part. No path
// calls them (coupling_cuda.earlier_block_eval / earlier_block_grad).
//
// K6 replaces the Pallas kernel of `_make_block_op`'s forward `_call_fwd`
// (src/tpuflows/kernels/coupling_pallas.py:163, pallas_call at :185): the
// conditioner MLP on x * b, its last layer in p-major column order, the
// spline forward or inverse, z = b x + (1 - b) y and the masked ladj summed
// per row. K7 replaces its backward `bwd` (pallas_call at :215): dx and the
// cotangent of every weight and bias, recomputing the conditioner. The
// plain PyTorch version is `block_math` in kernels/coupling_cuda.py with
// torch.autograd; the spline math is rqs_math.cuh's, shared with K4/K5 and
// K1.
//
// Design.
//  * A block of 256 threads owns kRows = 8 rows. Activations live in shared
//    memory transposed, (width, kRows), so one float4 gives a thread four
//    rows of one input. The products are the kernel's own SIMT float32
//    loops: a forward layer gives each thread one output column for four
//    rows and reads the weights from device memory (L2) once per block,
//    coalesced along the columns; a pullback through a layer gives each
//    warp one input unit and reduces over the columns in a fixed xor tree.
//  * Only the spline dims (mask 0) are evaluated: the last layer's columns
//    of a pass-through dim reach nothing (z = x there, its ladj and its
//    cotangents are multiplied by 0 in the reference), so they are neither
//    computed nor, in K7, given a cotangent other than 0. The spline dims
//    are walked in chunks of dc: the chunk's P dc raw values per row
//    (P = 3K-1) are computed into shared memory and read by the spline at
//    stride dc kRows, so `raw` never reaches device memory, which is what
//    the TPU kernel is for. The last layer is streamed from device memory
//    chunk by chunk (at d = 256 it is 3 MB).
//  * The masked ladj of a row is summed in shared memory, each (row, chunk
//    slot) in chunk order, then over the slots in order: no atomics.
//  * K7's weight cotangents sum over all rows. The TPU kernel carries them
//    across its sequential grid; CUDA blocks run in no order. So K7 is two
//    launches: pass 1 (coupling_bwd_kernel), per row tile, writes dx and,
//    when a weight needs its cotangent, each layer's input H_l (N, in_l) and
//    the cotangent G_l (N, out_l) of its pre-activation (the last layer's
//    over the spline dims only) to scratch that the wrapper allocates;
//    pass 2 (weight_grad_kernel) gives each block one 32 x 32 tile of one
//    dW_l = H_l^T G_l (with a row of ones for db_l) and walks the rows in
//    order, 32 at a time, adding each chunk's partial sum to the total.
//    The results repeat to the bit from run to run.
// Bound on this card: operations. At the fit's shape (1024 x 64, hidden
// 128 x 128, K = 8, half the dims splines) K6's products are 2 x (64 128 +
// 128 128 + 128 736) = 0.24 MFLOP per row, 0.25 GFLOP a call, 3.7 us at
// 67 TFLOP/s; K7 does about three times that.

#include <cuda_runtime.h>

#include "rqs_math.cuh"

namespace {

using namespace tpuflows_rqs;

constexpr int kMaxLayers = 8;
constexpr int kThreads = 256;
constexpr int kRows = 8;           // rows of a tile
constexpr int kColThreads = 128;   // threads over the columns of a layer
constexpr int kGroupRows = kRows / (kThreads / kColThreads);  // 4
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;          // weight-cotangent tile of pass 2
constexpr int kMaxSmem = 232448;   // bytes a block may opt in to

enum Activation { kSilu = 0, kTanh = 1, kRelu = 2, kLinear = -1 };

// The conditioner: w[l] is (width[l], width[l+1]) row-major, b[l] has
// width[l+1] values; the last layer's columns are p-major (p d + j).
struct Layers {
  const float* w[kMaxLayers];
  const float* b[kMaxLayers];
  int width[kMaxLayers + 1];
  int n;
};

struct Block {
  const float* x;     // (N, d)
  const float* mask;  // (d,), 0 or 1
  const int* idx;     // (nt,) the spline dims (mask 0), increasing
  int N, d, nt, K, dc, act;
  float B;
};

// Per-layer scratch of K7 for pass 2; null when no weight needs a
// cotangent. H[l] is (N, width[l]); G[l] is (N, width[l+1]), the last
// layer's (N, P nt) with column p nt + t for spline dim idx[t].
struct Scratch {
  float* H[kMaxLayers];
  float* G[kMaxLayers];
};

__host__ __device__ inline int up4(int n) { return (n + 3) & ~3; }

// Shared-memory layout of a tile, in 4-byte words. K6 keeps two
// activation buffers; K7 keeps every layer's input and pre-activation and
// two cotangent buffers.
struct Plan {
  int idx, cols, xs, h[kMaxLayers], a[kMaxLayers], g0, g1, raw, lacc, total;
};

__host__ __device__ inline Plan make_plan(const int* width, int n, int d,
                                          int P, int dc, bool grad) {
  Plan p;
  int o = 0;
  p.idx = o;
  o += up4(d);
  p.cols = o;
  o += up4(P * dc);
  p.xs = o;
  o += kRows * d;
  int wmax = d;
  for (int l = 1; l < n; ++l) wmax = width[l] > wmax ? width[l] : wmax;
  if (grad) {
    for (int l = 0; l < n; ++l) {
      p.h[l] = o;
      o += kRows * width[l];
    }
    for (int l = 0; l + 1 < n; ++l) {
      p.a[l] = o;
      o += kRows * width[l + 1];
    }
    p.g0 = o;
    o += kRows * wmax;
    p.g1 = o;
    o += kRows * wmax;
  } else {
    p.h[0] = o;
    o += kRows * wmax;
    p.h[1] = o;
    o += kRows * wmax;
  }
  p.raw = o;
  o += kRows * P * dc;
  p.lacc = o;
  o += kRows * dc;
  p.total = o;
  return p;
}

__device__ __forceinline__ float activate(float a, int act) {
  if (act == kSilu) return a / (1.0f + expf(-a));
  if (act == kTanh) return tanhf(a);
  if (act == kRelu) return a > 0.0f ? a : 0.0f;
  return a;
}

// d act / da, as torch's (and jax.grad's) silu, tanh and relu give it
__device__ __forceinline__ float activate_grad(float a, int act) {
  if (act == kSilu) {
    const float s = 1.0f / (1.0f + expf(-a));
    return s * (1.0f + a * (1.0f - s));
  }
  if (act == kTanh) {
    const float t = tanhf(a);
    return 1.0f - t * t;
  }
  return a > 0.0f ? 1.0f : 0.0f;
}

// One layer forward on the tile: for local column c < n (global column
// cols[c], or c when cols is null; -1 gives 0),
//   pre[c][r] = sum_k inT[k][r] W[k][col] + bias[col],
// written to preT (if not null) and act(pre) to outT (if not null); both
// (n, kRows). Thread t takes column t % 128 + 128 m and rows 4 (t / 128)
// to 4 (t / 128) + 3. The sum over k is taken in blocks of kSumBlock
// terms, each block's partial sum added to the total: this halves the
// rounding error of one running sum at these widths, and a block's loads
// are issued together.
constexpr int kSumBlock = 16;

__device__ __forceinline__ void fma_rows(const float* inT, int k, int r0,
                                         float w, float* acc) {
  const float4 h = *reinterpret_cast<const float4*>(inT + k * kRows + r0);
  acc[0] = fmaf(h.x, w, acc[0]);
  acc[1] = fmaf(h.y, w, acc[1]);
  acc[2] = fmaf(h.z, w, acc[2]);
  acc[3] = fmaf(h.w, w, acc[3]);
}

__device__ __forceinline__ void dense_fwd(const float* inT, int n_in,
                                          const float* __restrict__ W,
                                          int ldw,
                                          const float* __restrict__ bias,
                                          int n, const int* cols,
                                          float* preT, float* outT,
                                          int act) {
  const int r0 = (threadIdx.x / kColThreads) * kGroupRows;
  for (int c = threadIdx.x % kColThreads; c < n; c += kColThreads) {
    const int col = cols ? cols[c] : c;
    float acc[kGroupRows] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (col >= 0) {
      const float* wp = W + col;
      int k0 = 0;
      for (; k0 + kSumBlock <= n_in; k0 += kSumBlock) {
        float part[kGroupRows] = {0.0f, 0.0f, 0.0f, 0.0f};
        float w[kSumBlock];
#pragma unroll
        for (int i = 0; i < kSumBlock; ++i)
          w[i] = __ldg(wp + (size_t)(k0 + i) * ldw);
#pragma unroll
        for (int i = 0; i < kSumBlock; ++i)
          fma_rows(inT, k0 + i, r0, w[i], part);
#pragma unroll
        for (int i = 0; i < kGroupRows; ++i) acc[i] += part[i];
      }
      if (k0 < n_in) {
        float part[kGroupRows] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int k = k0; k < n_in; ++k)
          fma_rows(inT, k, r0, __ldg(wp + (size_t)k * ldw), part);
#pragma unroll
        for (int i = 0; i < kGroupRows; ++i) acc[i] += part[i];
      }
      const float bv = __ldg(bias + col);
#pragma unroll
      for (int i = 0; i < kGroupRows; ++i) acc[i] += bv;
    }
#pragma unroll
    for (int i = 0; i < kGroupRows; ++i) {
      if (preT) preT[c * kRows + r0 + i] = acc[i];
      if (outT) outT[c * kRows + r0 + i] = activate(acc[i], act);
    }
  }
}

// One layer's pullback to its input on the tile:
//   gin[k][r] (+)= sum_{c < n} gT[c][r] W[k][col(c)]   for k < n_in,
// one warp per k; the lanes stride over c, then the 8 row sums are
// reduced across the warp by a fixed xor tree.
__device__ __forceinline__ void dense_bwd(const float* gT, int n,
                                          const float* __restrict__ W,
                                          int ldw, const int* cols,
                                          float* ginT, int n_in,
                                          bool accumulate) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int k = warp; k < n_in; k += kWarps) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
    const float* wk = W + (size_t)k * ldw;
    for (int c = lane; c < n; c += 32) {
      const int col = cols ? cols[c] : c;
      if (col < 0) continue;
      const float w = __ldg(wk + col);
      const float4 g0 = *reinterpret_cast<const float4*>(gT + c * kRows);
      const float4 g1 =
          *reinterpret_cast<const float4*>(gT + c * kRows + 4);
      acc[0] = fmaf(g0.x, w, acc[0]);
      acc[1] = fmaf(g0.y, w, acc[1]);
      acc[2] = fmaf(g0.z, w, acc[2]);
      acc[3] = fmaf(g0.w, w, acc[3]);
      acc[4] = fmaf(g1.x, w, acc[4]);
      acc[5] = fmaf(g1.y, w, acc[5]);
      acc[6] = fmaf(g1.z, w, acc[6]);
      acc[7] = fmaf(g1.w, w, acc[7]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
    }
    float v = acc[0];
#pragma unroll
    for (int r = 1; r < kRows; ++r)
      if (lane == r) v = acc[r];
    if (lane < kRows) {
      float* o = ginT + k * kRows + lane;
      *o = accumulate ? *o + v : v;
    }
  }
}

// The global columns of the last layer for the chunk of spline dims
// starting at j0: local column c = p dc + jj is p d + idx[j0 + jj], or -1
// past the last spline dim.
__device__ __forceinline__ void chunk_cols(int* cols, const int* idx, int P,
                                           int d, int dc, int j0, int nt) {
  for (int c = threadIdx.x; c < P * dc; c += kThreads) {
    const int p = c / dc, jj = c - p * dc;
    cols[c] = j0 + jj < nt ? p * d + idx[j0 + jj] : -1;
  }
}

// Loads the tile's x (row-major, 0 past N), the spline dims, and the
// conditioner's input h0 = x b (transposed).
__device__ __forceinline__ void load_tile(const Block& bk, const Plan& pl,
                                          float* smem, int row0) {
  int* idx = reinterpret_cast<int*>(smem + pl.idx);
  for (int j = threadIdx.x; j < bk.nt; j += kThreads) idx[j] = bk.idx[j];
  for (int e = threadIdx.x; e < kRows * bk.d; e += kThreads) {
    const int r = e / bk.d, j = e - r * bk.d, row = row0 + r;
    const float v = row < bk.N ? bk.x[(size_t)row * bk.d + j] : 0.0f;
    smem[pl.xs + e] = v;
    smem[pl.h[0] + j * kRows + r] = v * bk.mask[j];
  }
}

template <bool kInverse>
__global__ void __launch_bounds__(kThreads)
    coupling_fwd_kernel(Layers L, Block bk, float* __restrict__ z,
                        float* __restrict__ ladj) {
  extern __shared__ __align__(16) float smem[];
  const int P = 3 * bk.K - 1, d = bk.d, dc = bk.dc;
  const Plan pl = make_plan(L.width, L.n, d, P, dc, false);
  const int* idx = reinterpret_cast<const int*>(smem + pl.idx);
  int* cols = reinterpret_cast<int*>(smem + pl.cols);
  const int row0 = blockIdx.x * kRows, tid = threadIdx.x;

  load_tile(bk, pl, smem, row0);
  for (int e = tid; e < kRows * dc; e += kThreads) smem[pl.lacc + e] = 0.0f;
  // pass-through dims: z = x
  for (int e = tid; e < kRows * d; e += kThreads) {
    const int r = e / d, j = e - r * d, row = row0 + r;
    if (row < bk.N && bk.mask[j] != 0.0f)
      z[(size_t)row * d + j] = smem[pl.xs + e];
  }
  __syncthreads();
  int cur = 0;
  for (int l = 0; l + 1 < L.n; ++l) {
    dense_fwd(smem + pl.h[cur], L.width[l], L.w[l], L.width[l + 1], L.b[l],
              L.width[l + 1], nullptr, nullptr, smem + pl.h[cur ^ 1],
              bk.act);
    __syncthreads();
    cur ^= 1;
  }
  const int last = L.n - 1, st = dc * kRows;
  float* rawT = smem + pl.raw;
  for (int j0 = 0; j0 < bk.nt; j0 += dc) {
    chunk_cols(cols, idx, P, d, dc, j0, bk.nt);
    __syncthreads();
    dense_fwd(smem + pl.h[cur], L.width[last], L.w[last], P * d, L.b[last],
              P * dc, cols, rawT, nullptr, kLinear);
    __syncthreads();
    for (int e = tid; e < kRows * dc; e += kThreads) {
      const int r = e % kRows, jj = e / kRows;
      const int jt = j0 + jj, row = row0 + r;
      if (jt >= bk.nt || row >= bk.N) continue;
      const int j = idx[jt];
      float yv, lv;
      if (kInverse)
        rqs_inverse(smem[pl.xs + r * d + j], rawT + e, st, bk.K, bk.B, yv,
                    lv);
      else
        rqs_forward(smem[pl.xs + r * d + j], rawT + e, st, bk.K, bk.B, yv,
                    lv);
      z[(size_t)row * d + j] = yv;
      smem[pl.lacc + e] += lv;
    }
    __syncthreads();
  }
  if (tid < kRows && row0 + tid < bk.N) {
    float s = 0.0f;
    for (int jj = 0; jj < dc; ++jj) s += smem[pl.lacc + jj * kRows + tid];
    ladj[row0 + tid] = s;
  }
}

// Copies a transposed (w, kRows) tile to rows row0.. of a row-major (N, w)
// array.
__device__ __forceinline__ void store_rows(float* out, const float* tT,
                                           int w, int row0, int N) {
  for (int e = threadIdx.x; e < kRows * w; e += kThreads) {
    const int r = e / w, k = e - r * w;
    if (row0 + r < N) out[(size_t)(row0 + r) * w + k] = tT[k * kRows + r];
  }
}

template <bool kInverse>
__global__ void __launch_bounds__(kThreads)
    coupling_bwd_kernel(Layers L, Block bk, Scratch S,
                        const float* __restrict__ gz,
                        const float* __restrict__ gladj,
                        float* __restrict__ dx) {
  extern __shared__ __align__(16) float smem[];
  const int P = 3 * bk.K - 1, d = bk.d, dc = bk.dc;
  const Plan pl = make_plan(L.width, L.n, d, P, dc, true);
  const int* idx = reinterpret_cast<const int*>(smem + pl.idx);
  int* cols = reinterpret_cast<int*>(smem + pl.cols);
  const int row0 = blockIdx.x * kRows, tid = threadIdx.x;
  const int last = L.n - 1, h_last = L.width[last];
  const bool wgrad = S.G[0] != nullptr;

  load_tile(bk, pl, smem, row0);
  __syncthreads();
  // the conditioner again, keeping every pre-activation and input
  for (int l = 0; l < last; ++l) {
    dense_fwd(smem + pl.h[l], L.width[l], L.w[l], L.width[l + 1], L.b[l],
              L.width[l + 1], nullptr, smem + pl.a[l], smem + pl.h[l + 1],
              bk.act);
    __syncthreads();
  }
  if (wgrad)
    for (int l = 0; l < L.n; ++l)
      store_rows(S.H[l], smem + pl.h[l], L.width[l], row0, bk.N);
  float* gh = smem + pl.g0;  // cotangent of the last layer's input
  for (int e = tid; e < kRows * h_last; e += kThreads) gh[e] = 0.0f;

  const int st = dc * kRows, n_raw = P * bk.nt;
  float* rawT = smem + pl.raw;
  for (int j0 = 0; j0 < bk.nt; j0 += dc) {
    chunk_cols(cols, idx, P, d, dc, j0, bk.nt);
    __syncthreads();
    dense_fwd(smem + pl.h[last], h_last, L.w[last], P * d, L.b[last],
              P * dc, cols, rawT, nullptr, kLinear);
    __syncthreads();
    // the spline's pullback; the raw values' cotangents overwrite them
    for (int e = tid; e < kRows * dc; e += kThreads) {
      const int r = e % kRows, jj = e / kRows;
      const int jt = j0 + jj, row = row0 + r;
      if (jt >= bk.nt || row >= bk.N) {
        for (int p = 0; p < P; ++p) rawT[e + p * st] = 0.0f;
        continue;
      }
      const int j = idx[jt];
      const float gy = gz[(size_t)row * d + j], gl = gladj[row];
      float dxv;
      if (kInverse)
        rqs_inverse_vjp(smem[pl.xs + r * d + j], rawT + e, st, bk.K, bk.B,
                        gy, gl, dxv, rawT + e, st);
      else
        rqs_forward_vjp(smem[pl.xs + r * d + j], rawT + e, st, bk.K, bk.B,
                        gy, gl, dxv, rawT + e, st);
      dx[(size_t)row * d + j] = dxv;
    }
    __syncthreads();
    if (wgrad) {
      for (int e = tid; e < kRows * P * dc; e += kThreads) {
        const int r = e / (P * dc), c = e - r * (P * dc);
        const int p = c / dc, jt = j0 + c - p * dc;
        if (row0 + r < bk.N && jt < bk.nt)
          S.G[last][(size_t)(row0 + r) * n_raw + p * bk.nt + jt] =
              rawT[c * kRows + r];
      }
    }
    dense_bwd(rawT, P * dc, L.w[last], P * d, cols, gh, h_last, true);
    __syncthreads();
  }
  // down the hidden layers: g_a = g_h act'(a), then g_h of the input
  float* other = smem + pl.g1;
  for (int l = last - 1; l >= 0; --l) {
    const int w = L.width[l + 1];
    for (int e = tid; e < kRows * w; e += kThreads)
      gh[e] *= activate_grad(smem[pl.a[l] + e], bk.act);
    __syncthreads();
    if (wgrad) store_rows(S.G[l], gh, w, row0, bk.N);
    dense_bwd(gh, w, L.w[l], w, nullptr, other, L.width[l], false);
    __syncthreads();
    float* t = gh;
    gh = other;
    other = t;
  }
  // pass-through dims: dz/dx = 1 and the conditioner's input x b
  for (int e = tid; e < kRows * d; e += kThreads) {
    const int r = e / d, j = e - r * d, row = row0 + r;
    if (row < bk.N && bk.mask[j] != 0.0f)
      dx[(size_t)row * d + j] = gz[(size_t)row * d + j] + gh[j * kRows + r];
  }
}

// Pass 2 of K7: tile (i0.., c0..) of dW_l = H_l^T G_l, with row in_l the
// bias (a column of ones appended to H_l), summed over the rows in order.
struct WeightGrad {
  const float* H[kMaxLayers];
  const float* G[kMaxLayers];
  float* dW[kMaxLayers];
  float* db[kMaxLayers];
  int n_in[kMaxLayers], n_out[kMaxLayers], tiles_c[kMaxLayers];
  int first[kMaxLayers + 1];
  int n, N, d, nt;
  const int* idx;
};

__global__ void __launch_bounds__(kThreads)
    weight_grad_kernel(WeightGrad a) {
  __shared__ float Hs[kTile][kTile];
  __shared__ float Gs[kTile][kTile];
  int l = 0;
  while ((int)blockIdx.x >= a.first[l + 1]) ++l;
  const int t = blockIdx.x - a.first[l];
  const int i0 = (t / a.tiles_c[l]) * kTile;
  const int c0 = (t % a.tiles_c[l]) * kTile;
  const int n_in = a.n_in[l], n_out = a.n_out[l];
  const float* H = a.H[l];
  const float* G = a.G[l];
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  float acc[kTile / kWarps] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int n0 = 0; n0 < a.N; n0 += kTile) {
    for (int q = 0; q < kTile / kWarps; ++q) {
      const int nn = ty + kWarps * q, row = n0 + nn;
      const int i = i0 + tx, c = c0 + tx;
      float hv = 0.0f, gv = 0.0f;
      if (row < a.N) {
        hv = i < n_in ? H[(size_t)row * n_in + i] : (i == n_in ? 1.0f : 0.0f);
        gv = c < n_out ? G[(size_t)row * n_out + c] : 0.0f;
      }
      Hs[nn][tx] = hv;
      Gs[nn][tx] = gv;
    }
    __syncthreads();
    float part[kTile / kWarps] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 8
    for (int nn = 0; nn < kTile; ++nn) {
      const float g = Gs[nn][tx];
#pragma unroll
      for (int m = 0; m < kTile / kWarps; ++m)
        part[m] = fmaf(Hs[nn][ty + kWarps * m], g, part[m]);
    }
#pragma unroll
    for (int m = 0; m < kTile / kWarps; ++m) acc[m] += part[m];
    __syncthreads();
  }
  const int c = c0 + tx;
  if (c >= n_out) return;
  int col = c, ldw = n_out;
  if (l == a.n - 1) {  // compact spline columns -> p-major p d + j
    const int p = c / a.nt;
    col = p * a.d + a.idx[c - p * a.nt];
    ldw = (n_out / a.nt) * a.d;
  }
#pragma unroll
  for (int m = 0; m < kTile / kWarps; ++m) {
    const int i = i0 + ty + kWarps * m;
    if (i < n_in)
      a.dW[l][(size_t)i * ldw + col] = acc[m];
    else if (i == n_in)
      a.db[l][col] = acc[m];
  }
}

bool layers_of(const void* const* ws, const void* const* bs,
               const int* widths, int n_layers, int d, int knots,
               Layers& L) {
  if (n_layers < 1 || n_layers > kMaxLayers) return false;
  if (widths[0] != d || widths[n_layers] != (3 * knots - 1) * d) return false;
  L.n = n_layers;
  for (int l = 0; l <= n_layers; ++l) {
    if (widths[l] <= 0) return false;
    L.width[l] = widths[l];
  }
  for (int l = 0; l < n_layers; ++l) {
    L.w[l] = static_cast<const float*>(ws[l]);
    L.b[l] = static_cast<const float*>(bs[l]);
  }
  return true;
}

bool block_of(const void* x, const void* mask, const void* idx,
              long long N, int d, int nt, int knots, float B, int act,
              int dc, Block& bk) {
  if (N < 0 || N > (1LL << 30) || d <= 0 || nt < 0 || nt > d) return false;
  if (knots < 2 || knots > kMaxKnots || !(B > 0.0f) || dc <= 0) return false;
  if (act < kSilu || act > kRelu) return false;
  bk.x = static_cast<const float*>(x);
  bk.mask = static_cast<const float*>(mask);
  bk.idx = static_cast<const int*>(idx);
  bk.N = (int)N;
  bk.d = d;
  bk.nt = nt;
  bk.K = knots;
  bk.dc = dc;
  bk.act = act;
  bk.B = B;
  return true;
}

template <class Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

// The entry points. Each returns a cudaError_t (0 = launched). ws, bs and
// widths are host arrays of n_layers (n_layers + 1) entries; the weight
// and bias pointers, x, mask (d floats), idx (nt ints), z, ladj, gz,
// gladj and dx are device pointers. The Python wrapper checks device,
// dtype, shapes and contiguity before calling.

// Shared memory of a launch, in bytes (0 if the arguments are invalid).
extern "C" long long coupling_rows8_smem(const int* widths, int n_layers,
                                         int d, int knots, int dc,
                                         int grad) {
  if (n_layers < 1 || n_layers > kMaxLayers) return 0;
  return 4LL * make_plan(widths, n_layers, d, 3 * knots - 1, dc, grad != 0)
                   .total;
}

// K6: (z, ladj) of the block, forward or inverse.
extern "C" int coupling_rows8_fwd_f32(
    const void* x, const void* mask, const void* idx, const void* const* ws,
    const void* const* bs, const int* widths, int n_layers, long long N,
    int d, int nt, int knots, float range_limit, int act, int inverse,
    int dc, void* z, void* ladj, void* stream) {
  Layers L;
  Block bk;
  if (!layers_of(ws, bs, widths, n_layers, d, knots, L) ||
      !block_of(x, mask, idx, N, d, nt, knots, range_limit, act, dc, bk))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const size_t smem =
      4 * (size_t)make_plan(L.width, L.n, d, 3 * knots - 1, dc, false).total;
  const unsigned grid = (unsigned)((N + kRows - 1) / kRows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* zp = static_cast<float*>(z);
  float* lp = static_cast<float*>(ladj);
  cudaError_t err;
  if (inverse) {
    if ((err = prepare(coupling_fwd_kernel<true>, smem)) != cudaSuccess)
      return (int)err;
    coupling_fwd_kernel<true><<<grid, kThreads, smem, s>>>(L, bk, zp, lp);
  } else {
    if ((err = prepare(coupling_fwd_kernel<false>, smem)) != cudaSuccess)
      return (int)err;
    coupling_fwd_kernel<false><<<grid, kThreads, smem, s>>>(L, bk, zp, lp);
  }
  return (int)cudaGetLastError();
}

// K7, pass 1: dx, and with Hs / Gs (host arrays of n_layers device
// pointers, or null) each layer's input and pre-activation cotangent.
extern "C" int coupling_rows8_bwd_f32(
    const void* x, const void* mask, const void* idx, const void* const* ws,
    const void* const* bs, const int* widths, int n_layers, long long N,
    int d, int nt, int knots, float range_limit, int act, int inverse,
    int dc, const void* gz, const void* gladj, void* dx,
    void* const* Hs, void* const* Gs, void* stream) {
  Layers L;
  Block bk;
  if (!layers_of(ws, bs, widths, n_layers, d, knots, L) ||
      !block_of(x, mask, idx, N, d, nt, knots, range_limit, act, dc, bk) ||
      (Hs == nullptr) != (Gs == nullptr))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  Scratch S;
  for (int l = 0; l < kMaxLayers; ++l) {
    S.H[l] = Hs && l < n_layers ? static_cast<float*>(Hs[l]) : nullptr;
    S.G[l] = Gs && l < n_layers ? static_cast<float*>(Gs[l]) : nullptr;
  }
  const size_t smem =
      4 * (size_t)make_plan(L.width, L.n, d, 3 * knots - 1, dc, true).total;
  const unsigned grid = (unsigned)((N + kRows - 1) / kRows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gzp = static_cast<const float*>(gz);
  const float* glp = static_cast<const float*>(gladj);
  float* dxp = static_cast<float*>(dx);
  cudaError_t err;
  if (inverse) {
    if ((err = prepare(coupling_bwd_kernel<true>, smem)) != cudaSuccess)
      return (int)err;
    coupling_bwd_kernel<true><<<grid, kThreads, smem, s>>>(L, bk, S, gzp,
                                                           glp, dxp);
  } else {
    if ((err = prepare(coupling_bwd_kernel<false>, smem)) != cudaSuccess)
      return (int)err;
    coupling_bwd_kernel<false><<<grid, kThreads, smem, s>>>(L, bk, S, gzp,
                                                            glp, dxp);
  }
  return (int)cudaGetLastError();
}

// K7, pass 2: dW_l = H_l^T G_l and db_l = sum_rows G_l for every layer, the
// last layer's written to the columns p d + idx[t] of its p-major dW and
// db (the wrapper zeroes the others: pass-through dims get no cotangent).
extern "C" int coupling_rows8_wgrad_f32(
    void* const* Hs, void* const* Gs, void* const* dWs, void* const* dbs,
    const int* widths, int n_layers, long long N, int d, int nt, int knots,
    const void* idx, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || N < 0 || N > (1LL << 30) ||
      nt < 0 || nt > d || knots < 2 ||
      widths[n_layers] != (3 * knots - 1) * d)
    return (int)cudaErrorInvalidValue;
  WeightGrad a;
  a.n = n_layers;
  a.N = (int)N;
  a.d = d;
  a.nt = nt;
  a.idx = static_cast<const int*>(idx);
  a.first[0] = 0;
  for (int l = 0; l < kMaxLayers; ++l) {
    const bool on = l < n_layers;
    a.H[l] = on ? static_cast<const float*>(Hs[l]) : nullptr;
    a.G[l] = on ? static_cast<const float*>(Gs[l]) : nullptr;
    a.dW[l] = on ? static_cast<float*>(dWs[l]) : nullptr;
    a.db[l] = on ? static_cast<float*>(dbs[l]) : nullptr;
    a.n_in[l] = on ? widths[l] : 0;
    a.n_out[l] =
        on ? (l == n_layers - 1 ? (3 * knots - 1) * nt : widths[l + 1]) : 0;
    a.tiles_c[l] = (a.n_out[l] + kTile - 1) / kTile;
    const int tiles_i = on ? (a.n_in[l] + 1 + kTile - 1) / kTile : 0;
    a.first[l + 1] = a.first[l] + tiles_i * a.tiles_c[l];
  }
  const int blocks = a.first[n_layers];
  if (N == 0 || blocks == 0) return 0;
  weight_grad_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
