// K6 and K7 of tpuflows_torch past the tile kernels' reach: the wide unit,
// one whole rational-quadratic-spline coupling block per tile of rows, and
// the first pass of its pullback, for any block the plain version takes.
//
// It replaces what the tile kernels (coupling_tile.cu) replace: the Pallas
// kernels of `_make_block_op` (src/tpuflows/kernels/coupling_pallas.py:163,
// pallas_call at :185 and, for the pullback, :215), which hold every
// parameter and activation of a grid step in VMEM and so take any number
// of layers, any widths and any K. The tile kernels hold a tile's
// activations in shared memory and take at most 8 layers; kernels/
// coupling_cuda.py `tile_plan` sends a block here where it has more, or
// where no tile of 16 or 8 rows fits the 227 KB of shared memory a CTA may
// have (at d = 64 and K = 8: a hidden layer of 3,648 units in K6, of 2,496
// in K7, fewer the more layers; d = 4096). K7's second pass is the tile
// kernels' own (`coupling_tile_wgrad_f32`), which reads its scratch from
// device memory at any width. The plain PyTorch version is `block_math` in
// kernels/coupling_cuda.py with torch.autograd.
//
// Design. The tile kernels' structure with their shared memory moved to a
// per-launch work buffer in device memory (the wrapper allocates it,
// `wide_floats` floats a cluster): a cluster of 2 CTAs owns a tile of
// kRows rows and keeps there the layer activations, [unit][row] in two
// buffers of the widest layer input, K7's act'(a) of every hidden layer,
// and each CTA's chunk of raw values with its column map, its ladj slots
// (K6) or its partial cotangent of the last hidden layer (K7). The CTAs
// split every layer's units, and the spline dims, as the tile kernels do,
// write their halves into the cluster's buffers and read the other's after
// a cluster barrier from L2 (ld.global.cg). At most kMaxClusters clusters
// walk the tiles, so the buffer is at most that many tiles' (K7 at
// layers of 4,096 units: 1.4 MB a cluster, 90 MB in all; L2 holds 50).
//
// Order of sums. A product gives each thread one output column and 4
// rows, its weights read where they are used (`__ldg`), and sums each
// output in blocks of kSumBlock terms from the first, each block an fma
// chain from 0 added to the total: the tile kernels' order. Their
// per-row sums (the ladj slots, the cluster's partials) are taken in their
// order too, over the same chunks when the wrapper passes the tile plan's
// chunk of spline dims. So at a shape both take, z, ladj, dx and pass 2's
// scratch, hence every weight's cotangent, equal the tile kernels' to the
// bit (chip_smoke.py `spline_reach_vs_plain` holds this at the fit's
// shape). A bf16 conditioner rounds each weight where it is loaded
// (equal to the wrapper's rounded copies the tile kernels read), so the
// caller's tensors are used as they are.
//
// Bound on this card: operations, as the tile kernels'; their products
// are register-tiled from shared memory, these read a weight and a float4
// of activations for 4 FMAs, and L1/L2 bandwidth sets their pace.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "coupling_ops.cuh"
#include "rqs_math.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace tpuflows_coupling;
using namespace tpuflows_rqs;

constexpr int kThreads = 256;
constexpr int kRows = 16;                     // rows of a tile
constexpr int kCols = kThreads * 4 / kRows;   // columns of a panel
constexpr int kMaxClusters = 66;              // 132 SMs

// The block. `table` (device, int64), for the n layers: the weight
// pointers, the bias pointers, the n + 1 widths, and per layer the units
// of the layers' outputs before its output (where its act'(a) and pass
// 2's G scratch start) and of their inputs before its input (pass 2's H
// scratch) (kernels/coupling_cuda.py `_wide_table`).
struct Wide {
  const float* x;     // (N, d)
  const float* mask;  // (d,), 0 or 1
  const int* idx;     // (nt,) the spline dims (mask 0), increasing
  const long long* table;
  int n, N, d, nt, K, act, dc;
  float B;
  float* work;             // clusters x per_cluster floats
  long long per_cluster;   // floats of a cluster's buffer
  long long xbuf;          // floats of an activation buffer
  long long base;          // floats before the CTAs' regions
  long long region;        // floats of a CTA's region
};

__device__ __forceinline__ const float* weight(const Wide& k, int l) {
  return reinterpret_cast<const float*>(__ldg(k.table + l));
}
__device__ __forceinline__ const float* bias(const Wide& k, int l) {
  return reinterpret_cast<const float*>(__ldg(k.table + k.n + l));
}
__device__ __forceinline__ int width(const Wide& k, int l) {
  return (int)__ldg(k.table + 2 * k.n + l);
}
// units of the layers' outputs before layer l's (in the act'(a) buffer
// and in G), and of their inputs before its input (in H)
__device__ __forceinline__ long long out_units(const Wide& k, int l) {
  return __ldg(k.table + 3 * k.n + 1 + l);
}
__device__ __forceinline__ long long in_units(const Wide& k, int l) {
  return __ldg(k.table + 4 * k.n + 1 + l);
}

// A cluster's buffer: two activation buffers, K7's act'(a) of each hidden
// layer, then one region a CTA: the chunk's raw values, its column map,
// and K6's ladj slots and per-row sums or K7's partial cotangent of the
// last hidden layer. Every region a multiple of 4 floats.
struct Sizes {
  long long xbuf, base, region, total;
};

__host__ __device__ inline long long up4(long long n) {
  return (n + 3) & ~3LL;
}

__host__ inline Sizes sizes_of(const int* width, int n, int P, int dc,
                               bool grad) {
  long long wmax = 0, hidden = 0;
  for (int l = 0; l < n; ++l) wmax = width[l] > wmax ? width[l] : wmax;
  for (int l = 0; l + 1 < n; ++l) hidden += width[l + 1];
  Sizes s;
  s.xbuf = kRows * wmax;
  s.base = 2 * s.xbuf + (grad ? kRows * hidden : 0);
  s.region = (long long)kRows * P * dc + up4((long long)P * dc) +
             (grad ? (long long)kRows * width[n - 1]
                   : (long long)kRows * dc + kRows);
  s.total = s.base + kCluster * s.region;
  return s;
}

// out[r][o] = sum_q A[q][r] b(q, o) for r < kRows, o < n_out, q < n_red,
// A [q][r] at pitch kRows in the work buffer: each output's sum in blocks
// of kSumBlock terms from q = 0, each an fma chain from 0 added to the
// total (the tile kernels' `product`); put(r, o, value, colv(o)) once for
// each (r, o), by the thread that summed it.
template <class BAt, class ColV, class Put>
__device__ __forceinline__ void product(const float* A, int n_red,
                                        int n_out, BAt b_at, ColV colv,
                                        Put put) {
  const int c = threadIdx.x % kCols, r0 = 4 * (threadIdx.x / kCols);
  for (int o = c; o < n_out; o += kCols) {
    const float cv = colv(o);
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    auto step = [&](int q, float(&part)[4]) {
      const float w = b_at(q, o);
      const float4 a = __ldcg(
          reinterpret_cast<const float4*>(A + (size_t)q * kRows + r0));
      part[0] = fmaf(a.x, w, part[0]);
      part[1] = fmaf(a.y, w, part[1]);
      part[2] = fmaf(a.z, w, part[2]);
      part[3] = fmaf(a.w, w, part[3]);
    };
    for (int qb = 0; qb < n_red; qb += kSumBlock) {
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (qb + kSumBlock <= n_red) {  // unrolled: the loads run ahead
#pragma unroll
        for (int q = 0; q < kSumBlock; ++q) step(qb + q, part);
      } else {
        for (int q = qb; q < n_red; ++q) step(q, part);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] += part[i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) put(r0 + i, o, acc[i], cv);
  }
}

struct NoColV {
  __device__ __forceinline__ float operator()(int) const { return 0.0f; }
};

// The tile's conditioner input h0 = x b, transposed (0 past N): each CTA
// writes half of it.
template <bool kBf16>
__device__ __forceinline__ void load_input(const Wide& k, float* X0, int row0,
                                           int rank) {
  for (int e = rank * kThreads + threadIdx.x; e < kRows * k.d;
       e += kCluster * kThreads) {
    const int r = e / k.d, j = e - r * k.d, row = row0 + r;
    const float v = row < k.N ? k.x[(size_t)row * k.d + j] : 0.0f;
    X0[(size_t)j * kRows + r] = operand<kBf16>(v * k.mask[j]);
  }
}

// The hidden layers forward on the tile, each CTA over its slice of a
// layer's units; with D, act'(a) of each unit; with H (pass 2's scratch),
// each layer's output. Returns the buffer holding the last layer's input.
template <bool kBf16>
__device__ __forceinline__ int hidden_forward(cg::cluster_group& cl,
                                              const Wide& k, float** X,
                                              float* D, float* H, int row0,
                                              int rank) {
  const int act = k.act, N = k.N;
  int cur = 0;
  for (int l = 0; l + 1 < k.n; ++l) {
    const int w = width(k, l + 1), sw = slice_width(w);
    const int lo = min(w, rank * sw), hi = min(w, lo + sw);
    float* out = X[cur ^ 1];
    const float* W = weight(k, l);
    const float* b = bias(k, l);
    float* Dl = D ? D + kRows * out_units(k, l) : nullptr;
    float* Hl = H ? H + N * in_units(k, l + 1) : nullptr;
    product(X[cur], width(k, l), hi - lo,
            [&](int q, int o) {
              return operand<kBf16>(__ldg(W + (size_t)q * w + lo + o));
            },
            [&](int o) { return __ldg(b + lo + o); },
            [&](int r, int o, float v, float bv) {
              const float a = v + bv;
              const float h = operand<kBf16>(activate(a, act));
              const size_t u = (size_t)(lo + o) * kRows + r;
              out[u] = h;
              if (Dl) Dl[u] = activate_grad(a, act);
              if (Hl && row0 + r < N)
                Hl[(size_t)(lo + o) * N + row0 + r] = h;
            });
    cl.sync();
    cur ^= 1;
  }
  return cur;
}

// The chunk of spline dims j0 .. j0 + nj - 1: its column map (local
// column c = p dc + jj is p d + idx[j0 + jj], or -1 for jj >= nj), then
// its raw values raw[c][r] = (H W)[r][col(c)] + b[col(c)] (0 where -1).
template <bool kBf16>
__device__ __forceinline__ void chunk_raw(const Wide& k, const float* H,
                                          int h, int P, int j0, int nj,
                                          int* cols, float* raw) {
  const int dc = k.dc, ldw = P * k.d;
  for (int c = threadIdx.x; c < P * dc; c += kThreads) {
    const int p = c / dc, jj = c - p * dc;
    cols[c] = jj < nj ? p * k.d + __ldg(k.idx + j0 + jj) : -1;
  }
  __syncthreads();
  const float* W = weight(k, k.n - 1);
  const float* b = bias(k, k.n - 1);
  product(H, h, P * dc,
          [&](int q, int o) {
            const int col = cols[o];
            return col >= 0 ? operand<kBf16>(__ldg(W + (size_t)q * ldw + col))
                            : 0.0f;
          },
          [&](int o) {
            const int col = cols[o];
            return col >= 0 ? __ldg(b + col) : 0.0f;
          },
          [&](int r, int o, float v, float bv) {
            raw[(size_t)o * kRows + r] = cols[o] >= 0 ? v + bv : 0.0f;
          });
  __syncthreads();
}

template <bool kInverse, bool kBf16>
__global__ void __launch_bounds__(kThreads)
    coupling_wide_fwd_kernel(Wide k, float* __restrict__ z,
                             float* __restrict__ ladj) {
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank(), tid = threadIdx.x;
  const int cluster = blockIdx.x / kCluster, clusters = gridDim.x / kCluster;
  const int d = k.d, dc = k.dc, N = k.N, P = 3 * k.K - 1, last = k.n - 1;
  float* buf = k.work + (size_t)cluster * k.per_cluster;
  float* X[2] = {buf, buf + k.xbuf};
  float* raw = buf + k.base + rank * k.region;
  int* cols = reinterpret_cast<int*>(raw + (size_t)kRows * P * dc);
  float* lacc = raw + (size_t)kRows * P * dc + up4((long long)P * dc);
  float* lrow = lacc + kRows * dc;
  const int ntc = slice_width(k.nt);
  const int jlo = min(k.nt, rank * ntc), jhi = min(k.nt, jlo + ntc);
  const int st = dc * kRows, tiles = (N + kRows - 1) / kRows;
  for (int tile = cluster; tile < tiles; tile += clusters) {
    const int row0 = tile * kRows;
    load_input<kBf16>(k, X[0], row0, rank);
    for (int e = tid; e < kRows * dc; e += kThreads) lacc[e] = 0.0f;
    cl.sync();
    const int cur =
        hidden_forward<kBf16>(cl, k, X, nullptr, nullptr, row0, rank);
    for (int j0 = jlo; j0 < jhi; j0 += dc) {
      const int nj = min(dc, jhi - j0);
      chunk_raw<kBf16>(k, X[cur], width(k, last), P, j0, nj, cols, raw);
      for (int e = tid; e < kRows * dc; e += kThreads) {
        const int r = e % kRows, jj = e / kRows, row = row0 + r;
        if (jj >= nj || row >= N) continue;
        const int j = __ldg(k.idx + j0 + jj);
        float yv, lv;
        if (kInverse)
          rqs_inverse(k.x[(size_t)row * d + j], raw + e, st, k.K, k.B, yv,
                      lv);
        else
          rqs_forward(k.x[(size_t)row * d + j], raw + e, st, k.K, k.B, yv,
                      lv);
        z[(size_t)row * d + j] = yv;
        lacc[e] += lv;
      }
      __syncthreads();
    }
    if (tid < kRows) {
      float s = 0.0f;
      for (int jj = 0; jj < dc; ++jj) s += lacc[jj * kRows + tid];
      lrow[tid] = s;
    }
    if (rank == 0) {  // pass-through dims: z = x
      for (int e = tid; e < kRows * d; e += kThreads) {
        const int r = e / d, j = e - r * d, row = row0 + r;
        if (row < N && k.mask[j] != 0.0f)
          z[(size_t)row * d + j] = k.x[(size_t)row * d + j];
      }
    }
    cl.sync();
    if (rank == 0 && tid < kRows && row0 + tid < N) {
      float s = 0.0f;
      for (int q = 0; q < kCluster; ++q)
        s += __ldcg(lrow + (q - rank) * k.region + tid);
      ladj[row0 + tid] = s;
    }
    cl.sync();  // the tile's buffers are read before the next tile's
  }
}

template <bool kInverse, bool kBf16>
__global__ void __launch_bounds__(kThreads)
    coupling_wide_bwd_kernel(Wide k, const float* __restrict__ gz,
                             const float* __restrict__ gladj,
                             float* __restrict__ dx, float* Hs, float* Gs) {
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank(), tid = threadIdx.x;
  const int cluster = blockIdx.x / kCluster, clusters = gridDim.x / kCluster;
  const int d = k.d, dc = k.dc, N = k.N, P = 3 * k.K - 1, last = k.n - 1;
  float* buf = k.work + (size_t)cluster * k.per_cluster;
  float* X[2] = {buf, buf + k.xbuf};
  float* D = buf + 2 * k.xbuf;
  float* raw = buf + k.base + rank * k.region;
  int* cols = reinterpret_cast<int*>(raw + (size_t)kRows * P * dc);
  float* GH = raw + (size_t)kRows * P * dc + up4((long long)P * dc);
  const bool wgrad = Hs != nullptr;
  const int h = width(k, last);
  const int ntc = slice_width(k.nt);
  const int jlo = min(k.nt, rank * ntc), jhi = min(k.nt, jlo + ntc);
  const int st = dc * kRows, ldw = P * d, tiles = (N + kRows - 1) / kRows;
  const float* W_last = weight(k, last);
  float* G_last = wgrad ? Gs + N * out_units(k, last) : nullptr;
  for (int tile = cluster; tile < tiles; tile += clusters) {
    const int row0 = tile * kRows;
    load_input<kBf16>(k, X[0], row0, rank);
    if (wgrad) {  // H_0 = x b over this CTA's slice of dims
      const int sw = slice_width(d);
      const int lo = min(d, rank * sw), hi = min(d, lo + sw);
      for (int e = tid; e < kRows * (hi - lo); e += kThreads) {
        const int j = lo + e / kRows, r = e % kRows, row = row0 + r;
        if (row < N)
          Hs[(size_t)j * N + row] =
              operand<kBf16>(k.x[(size_t)row * d + j] * k.mask[j]);
      }
    }
    for (int e = tid; e < kRows * h; e += kThreads) GH[e] = 0.0f;
    cl.sync();
    const int cur = hidden_forward<kBf16>(cl, k, X, D, wgrad ? Hs : nullptr,
                                          row0, rank);
    float* H = X[cur];
    for (int j0 = jlo; j0 < jhi; j0 += dc) {
      const int nj = min(dc, jhi - j0);
      chunk_raw<kBf16>(k, H, h, P, j0, nj, cols, raw);
      // the spline's pullback; the raw values' cotangents overwrite them
      for (int e = tid; e < kRows * dc; e += kThreads) {
        const int r = e % kRows, jj = e / kRows, row = row0 + r;
        if (jj >= nj || row >= N) {
          for (int p = 0; p < P; ++p) raw[e + (size_t)p * st] = 0.0f;
          continue;
        }
        const int j = __ldg(k.idx + j0 + jj);
        const float gy = gz[(size_t)row * d + j], gl = gladj[row];
        float dxv;
        if (kInverse)
          rqs_inverse_vjp(k.x[(size_t)row * d + j], raw + e, st, k.K, k.B,
                          gy, gl, dxv, raw + e, st);
        else
          rqs_forward_vjp(k.x[(size_t)row * d + j], raw + e, st, k.K, k.B,
                          gy, gl, dxv, raw + e, st);
        dx[(size_t)row * d + j] = dxv;
      }
      __syncthreads();
      if (wgrad) {  // column p nt + t of the compact last layer
        for (int e = tid; e < kRows * P * dc; e += kThreads) {
          const int r = e % kRows, c = e / kRows, row = row0 + r;
          const int p = c / dc, jj = c - p * dc;
          if (row < N && jj < nj)
            G_last[(size_t)(p * k.nt + j0 + jj) * N + row] = raw[e];
        }
      }
      product(raw, P * dc, h,
              [&](int q, int o) {
                const int col = cols[q];
                return col >= 0 ? operand<kBf16>(
                                      __ldg(W_last + (size_t)o * ldw + col))
                                : 0.0f;
              },
              NoColV{},
              [&](int r, int o, float v, float) { GH[o * kRows + r] += v; });
      __syncthreads();
    }
    cl.sync();
    // the cluster's partials summed in rank order over this CTA's slice of
    // units: G of the last hidden layer (into H's buffer), or, without
    // one, the input's cotangent
    {
      const int sw = slice_width(h);
      const int lo = min(h, rank * sw), hi = min(h, lo + sw);
      const float* Dl =
          last > 0 ? D + kRows * out_units(k, last - 1) : nullptr;
      float* Gl =
          last > 0 && wgrad ? Gs + N * out_units(k, last - 1) : nullptr;
      for (int e = lo * kRows + tid; e < hi * kRows; e += kThreads) {
        float part[kCluster];  // the partials' loads in flight together
#pragma unroll
        for (int q = 0; q < kCluster; ++q)
          part[q] = __ldcg(GH + (q - rank) * k.region + e);
        float v = 0.0f;
#pragma unroll
        for (int q = 0; q < kCluster; ++q) v += part[q];
        v = operand<kBf16>(v);  // the input cotangent, rounded once
        const int u = e / kRows, r = e % kRows, row = row0 + r;
        if (last > 0) {
          const float g = v * __ldcg(Dl + e);
          H[e] = g;
          if (Gl && row < N) Gl[(size_t)u * N + row] = g;
        } else if (row < N && k.mask[u] != 0.0f) {
          dx[(size_t)row * d + u] = gz[(size_t)row * d + u] + v;
        }
      }
    }
    cl.sync();
    // down the hidden layers: the input's cotangent of layer l over this
    // CTA's slice of its units, times act' of the layer below (or, at the
    // bottom, dx of the pass-through dims: dz/dx = 1 plus the conditioner)
    int a = cur;
    for (int l = last - 1; l >= 0; --l) {
      const int w = width(k, l), wo = width(k, l + 1), sw = slice_width(w);
      const int lo = min(w, rank * sw), hi = min(w, lo + sw);
      float* out = X[a ^ 1];
      const float* W = weight(k, l);
      const float* Dm = l > 0 ? D + kRows * out_units(k, l - 1) : nullptr;
      float* Gm = l > 0 && wgrad ? Gs + N * out_units(k, l - 1) : nullptr;
      product(X[a], wo, hi - lo,
              [&](int q, int o) {
                return operand<kBf16>(__ldg(W + (size_t)(lo + o) * wo + q));
              },
              NoColV{},
              [&](int r, int o, float v, float) {
                const int u = lo + o, row = row0 + r;
                v = operand<kBf16>(v);  // rounded once
                if (l > 0) {
                  const float g = v * __ldcg(Dm + (size_t)u * kRows + r);
                  out[(size_t)u * kRows + r] = g;
                  if (Gm && row < N) Gm[(size_t)u * N + row] = g;
                } else if (row < N && k.mask[u] != 0.0f) {
                  dx[(size_t)row * d + u] = gz[(size_t)row * d + u] + v;
                }
              });
      cl.sync();
      a ^= 1;
    }
  }
}

// Launches `kernel` on 2 `clusters` CTAs in clusters of kCluster.
template <class Kernel, class... Args>
cudaError_t launch(Kernel kernel, int clusters, cudaStream_t s,
                   Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * kCluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

int clusters_for(long long N) {
  const long long tiles = (N + kRows - 1) / kRows;
  return (int)(tiles < kMaxClusters ? tiles : kMaxClusters);
}

// The block's arguments, checked; false where the kernels do not take them
// or the work buffer is too small.
bool wide_of(const void* x, const void* mask, const void* idx,
             const void* table, const int* widths, int n_layers, long long N,
             int d, int nt, int knots, float B, int act, int bf16, int dc,
             void* work, long long work_floats, bool grad, Wide& k) {
  if (n_layers < 1 || N < 0 || N > (1LL << 30) || d <= 0 || nt < 0 ||
      nt > d || knots < 2 || !(B > 0.0f) || act < kSilu || act > kGelu ||
      (bf16 != 0 && bf16 != 1) || dc < 1)
    return false;
  if (widths[0] != d || widths[n_layers] != (3 * knots - 1) * d) return false;
  for (int l = 0; l <= n_layers; ++l)
    if (widths[l] <= 0) return false;
  const Sizes s = sizes_of(widths, n_layers, 3 * knots - 1, dc, grad);
  if (work_floats < clusters_for(N) * s.total) return false;
  k.x = static_cast<const float*>(x);
  k.mask = static_cast<const float*>(mask);
  k.idx = static_cast<const int*>(idx);
  k.table = static_cast<const long long*>(table);
  k.n = n_layers;
  k.N = (int)N;
  k.d = d;
  k.nt = nt;
  k.K = knots;
  k.act = act;
  k.dc = dc;
  k.B = B;
  k.work = static_cast<float*>(work);
  k.per_cluster = s.total;
  k.xbuf = s.xbuf;
  k.base = s.base;
  k.region = s.region;
  return true;
}

template <bool kBf16>
cudaError_t launch_fwd(bool inverse, cudaStream_t s, const Wide& k, float* z,
                       float* ladj) {
  const int c = clusters_for(k.N);
  if (inverse)
    return launch(coupling_wide_fwd_kernel<true, kBf16>, c, s, k, z, ladj);
  return launch(coupling_wide_fwd_kernel<false, kBf16>, c, s, k, z, ladj);
}

template <bool kBf16>
cudaError_t launch_bwd(bool inverse, cudaStream_t s, const Wide& k,
                       const float* gz, const float* gl, float* dx, float* Hs,
                       float* Gs) {
  const int c = clusters_for(k.N);
  if (inverse)
    return launch(coupling_wide_bwd_kernel<true, kBf16>, c, s, k, gz, gl, dx,
                  Hs, Gs);
  return launch(coupling_wide_bwd_kernel<false, kBf16>, c, s, k, gz, gl, dx,
                Hs, Gs);
}

}  // namespace

// The entry points. Each returns a cudaError_t (0 = launched). widths is a
// host array of n_layers + 1 ints; table (the layers, `_wide_table`), x,
// mask (d floats), idx (nt ints), work, z, ladj, gz, gladj, dx, Hs and Gs
// are device pointers; bf16 1 for a bf16 conditioner (its weights as the
// module holds them); dc is the plan's chunk of spline dims. The Python
// wrapper checks device, dtype, shapes and contiguity before calling.

// Floats of the work buffer a launch on N rows needs: what `wide_floats`
// in kernels/coupling_cuda.py computes (0 if the arguments are invalid).
extern "C" long long coupling_wide_floats(const int* widths, int n_layers,
                                          int knots, int dc, int grad,
                                          long long N) {
  if (n_layers < 1 || knots < 2 || dc < 1 || N < 0) return 0;
  return clusters_for(N) *
         sizes_of(widths, n_layers, 3 * knots - 1, dc, grad != 0).total;
}

// K6: (z, ladj) of the block, forward or inverse.
extern "C" int coupling_wide_fwd_f32(
    const void* x, const void* mask, const void* idx, const void* table,
    const int* widths, int n_layers, long long N, int d, int nt, int knots,
    float range_limit, int act, int bf16, int inverse, int dc, void* work,
    long long work_floats, void* z, void* ladj, void* stream) {
  Wide k;
  if (!wide_of(x, mask, idx, table, widths, n_layers, N, d, nt, knots,
               range_limit, act, bf16, dc, work, work_floats, false, k))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* zp = static_cast<float*>(z);
  float* lp = static_cast<float*>(ladj);
  if (bf16) return (int)launch_fwd<true>(inverse, s, k, zp, lp);
  return (int)launch_fwd<false>(inverse, s, k, zp, lp);
}

// K7, pass 1: dx, and with Hs / Gs (device buffers, or null) every
// layer's input and pre-activation cotangent, transposed ((units, N)),
// layer l's at N times its units before it (`_wide_table`); pass 2 is
// the tile kernels' `coupling_tile_wgrad_f32`.
extern "C" int coupling_wide_bwd_f32(
    const void* x, const void* mask, const void* idx, const void* table,
    const int* widths, int n_layers, long long N, int d, int nt, int knots,
    float range_limit, int act, int bf16, int inverse, int dc, void* work,
    long long work_floats, const void* gz, const void* gladj, void* dx,
    void* Hs, void* Gs, void* stream) {
  Wide k;
  if (!wide_of(x, mask, idx, table, widths, n_layers, N, d, nt, knots,
               range_limit, act, bf16, dc, work, work_floats, true, k) ||
      (Hs == nullptr) != (Gs == nullptr))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gzp = static_cast<const float*>(gz);
  const float* glp = static_cast<const float*>(gladj);
  float* dxp = static_cast<float*>(dx);
  float* hp = static_cast<float*>(Hs);
  float* gp = static_cast<float*>(Gs);
  if (bf16) return (int)launch_bwd<true>(inverse, s, k, gzp, glp, dxp, hp, gp);
  return (int)launch_bwd<false>(inverse, s, k, gzp, glp, dxp, hp, gp);
}
