// K6 and K7 of tpuflows_torch on tiles of rows that share every weight
// read: one whole rational-quadratic-spline coupling block per tile, and
// its pullback.
//
// K6 replaces the Pallas kernel of `_make_block_op`'s forward `_call_fwd`
// (src/tpuflows/kernels/coupling_pallas.py:163, pallas_call at :185): the
// conditioner MLP on x * b, its last layer in p-major column order, the
// spline forward or inverse, z = b x + (1 - b) y and the masked ladj summed
// per row. K7 replaces its backward `bwd` (pallas_call at :215): dx and the
// cotangent of every weight and bias, recomputing the conditioner. The
// plain PyTorch version is `block_math` in kernels/coupling_cuda.py with
// torch.autograd; the spline math is rqs_math.cuh's, shared with K4/K5 and
// K1. The design these kernels replaced (8 rows a block, every weight from
// L2 once per block) stays built in coupling_block.cu as their yardstick.
//
// Bound on this card: operations. At the fit's shape (1024 x 64, hidden
// 128 x 128, K = 8, half the dims splines) K6's products are 2 x (64 128 +
// 128 128 + 128 736) = 0.24 MFLOP per row, 3.7 us at 67 TFLOP/s float32;
// K7 does about three times that. Float32 on the FMA pipes: TF32 on the
// tensor cores keeps too few digits for the spline's bars.
//
// Design.
//  * A cluster of 2 CTAs owns a tile of R rows (16, halved to 8 where
//    the shared memory requires it; a template parameter that
//    `tile_plan` in coupling_cuda.py picks). Of 8, 16 and 32 rows in
//    clusters of 1, 2 and 4, 16 rows in clusters of 2 was the fastest on
//    the card at the fit's shape and at d = 256 (PERF.md §6).
//    Activations and cotangents live in each CTA's shared memory
//    transposed, [unit][row] at a pitch of R floats. Every layer's output
//    units are split over the cluster: CTA `rank` computes units [rank sw,
//    (rank + 1) sw), sw = ceil(width / 2), then gathers the other's slice
//    from its shared memory (distributed shared memory) after a cluster
//    barrier. So each weight is read from L2 once per tile of R rows, and
//    N = 1024 rows still make 128 CTAs.
//  * The products are register-tiled float32 GEMMs (`product`): each
//    thread computes 4 rows x CT columns (CT = 1, 2 or 4 by the panel's
//    width, `ct_of`), reading per reduction step one float4 of its 4 rows
//    of the transposed activation (a broadcast within its warp) and CT
//    weights with ld.shared, so a load feeds 4-16 FMAs. The weights stream
//    through a 4-stage ring in shared memory (stages of up to 8448 floats,
//    the plan's), as [reduction][output] panels: a forward layer's
//    columns, or, for a pullback, the transposed rows of W; 16-byte
//    cp.async where the columns are contiguous and aligned (the hidden
//    layers), else 4-byte copies (the spline dims' columns p d + idx[j]).
//    Each output's sum runs in blocks of 16 terms added to the total, the
//    order of the earlier kernels' forward layers. Where two activation
//    buffers of 8 rows leave the ring no room (a layer input of about
//    3,000 units or more), K6 runs without it (stage 0,
//    `product_direct`: each weight read from L2 where it is used, the
//    same order of sums), so that it takes every shape the earlier
//    layout took; K7's plans keep the ring (where K7 has no room for it,
//    the earlier K7 had none for its own layout either).
//  * Only the spline dims (mask 0) are evaluated. They are split over the
//    cluster and walked in chunks of dc: the chunk's P dc raw values per row
//    (P = 3K-1) are computed into shared memory and read by the spline at
//    stride dc R, so `raw` never reaches device memory, which is what the
//    TPU kernel is for. The masked ladj of a row is summed per (chunk slot,
//    row) in chunk order, then over the slots, then over the cluster's CTAs
//    in rank order: no atomics.
//  * K7's last layer: each CTA pulls its spline columns' cotangents back
//    through W (with the same chunk's columns streamed again) into a
//    partial cotangent of the last hidden layer; the cluster sums the
//    partials in rank order, each CTA over its slice of units, then walks
//    down the hidden layers with the same split and gather.
//  * K7's weight cotangents sum over all rows. Pass 1 (coupling_tile_bwd)
//    writes dx and, when a weight needs its cotangent, every layer's input
//    H_l and pre-activation cotangent G_l (the last layer's over the spline
//    dims only) to scratch, transposed: (units, N), so that each CTA's
//    writes and pass 2's reads run along the rows. Pass 2
//    (coupling_tile_wgrad) is a GEMM over the row axis: dW_l = H_l^T G_l,
//    with a row of ones for db_l, in 64 x 64 output tiles of 4 x 4 per
//    thread; the rows are split over a cluster of S CTAs (S fixed by the
//    shapes), each summing its slice in blocks of 32 rows, and the S
//    partial tiles are added in rank order through distributed shared
//    memory. The results repeat to the bit from run to run, and dx does
//    not depend on whether pass 2 runs.
//  * What bounds them now (phase marks of a -DCOUPLING_TILE_PROFILE build,
//    scripts/coupling_tile_phases.py): one CTA of 8 warps per SM at N =
//    1024, and in the last layer's products the 4-byte copies of the
//    spline columns, about half of those products' time.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "rqs_math.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace tpuflows_rqs;

constexpr int kMaxLayers = 8;
constexpr int kThreads = 256;
constexpr int kCluster = 2;         // CTAs of a cluster, over a tile
constexpr int kStages = 4;          // weight ring
constexpr int kSumBlock = 16;       // terms of a partial sum
constexpr int kMaxSmem = 232448;    // bytes a block may opt in to
constexpr int kWTile = 64;          // pass 2's output tile edge
constexpr int kWRows = 32;          // pass 2's rows per step
constexpr int kWPitch = kWTile + 4;

enum Activation { kSilu = 0, kTanh = 1, kRelu = 2 };

// -DCOUPLING_TILE_PROFILE: thread 0 of each CTA stamps clock64() at the
// phase marks below (coupling_tile_profile reads them back); a
// development build, not the one the wrappers load
#ifdef COUPLING_TILE_PROFILE
constexpr int kProfMarks = 32;
constexpr int kProfCtas = 4096;
__device__ long long g_tile_prof[kProfCtas * kProfMarks];
#define TILE_MARK(k)                                              \
  do {                                                            \
    if (threadIdx.x == 0 && blockIdx.x < kProfCtas)               \
      g_tile_prof[blockIdx.x * kProfMarks + (k)] = clock64();     \
  } while (0)
#else
#define TILE_MARK(k) \
  do {               \
  } while (0)
#endif

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
  int N, d, nt, K, act;
  float B;
  int R, dc;          // rows of a tile, spline dims of a chunk
  int stage;          // floats of a ring stage, 0 without a ring (K6)
};

// Per-layer scratch of K7 for pass 2, transposed; null when no weight
// needs a cotangent. H[l] is (width[l], N); G[l] is (width[l+1], N), the
// last layer's (P nt, N) with row p nt + t for spline dim idx[t].
struct Scratch {
  float* H[kMaxLayers];
  float* G[kMaxLayers];
};

__host__ __device__ inline int up4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int slice_width(int w) {
  return (w + kCluster - 1) / kCluster;
}

// Column groups of a block: 256 threads over R / 4 groups of rows.
__host__ __device__ constexpr int col_groups(int R) {
  return kThreads * 4 / R;
}

// Reduction rows of a ring stage of `stage` floats for panels of ow
// outputs (at a pitch of ow + 4): a multiple of 16, at most 128.
__host__ __device__ inline int stage_rows(int stage, int ow) {
  const int q = (stage / (ow + 4)) & ~15;
  return q < 128 ? q : 128;
}

// Columns per thread of a product of n_out outputs: of 1, 2 and 4 (a panel
// of CT col_groups(R) outputs), the one with the fewest instructions,
// counted as the padded columns times 4 + 2 / CT per reduction step (4 CT
// FMAs and 2 loads per CT columns), among those whose panel is at most
// one column per thread (the copies' layout) and leaves a stage 16 rows;
// the wider on a tie. (Counting shared-memory wavefronts instead picks CT
// = 4 for the fit's last layer, 4% slower on the card.)
__host__ __device__ inline int ct_of(int R, int n_out, int stage) {
  const int tc = col_groups(R);
  int best = 1, cost = -1;
  for (int ct = 1; ct <= 4; ct *= 2) {
    const int ow = ct * tc;
    if (ow > kThreads || stage_rows(stage, ow) < 16) break;
    const int c = (n_out + ow - 1) / ow * ow * (8 + 4 / ct);  // twice
    if (cost < 0 || c <= cost) {
      best = ct;
      cost = c;
    }
  }
  return best;
}

// Shared-memory layout of a CTA, in 4-byte words (every region a multiple
// of 4 words). K6 keeps two activation buffers, the chunk's raw values and
// the ladj slots; K7 the same buffers and each hidden layer's act'(a) over
// its own slice of units.
struct Layout {
  int cols, x0, x1, raw, lacc, lrow, dl[kMaxLayers], ring, total;
};

__host__ __device__ inline Layout make_layout(const int* width, int n, int P,
                                              int R, int dc, int stage,
                                              bool grad) {
  Layout s;
  int o = 0;
  s.cols = o;
  o += up4(P * dc);
  int wmax = 0;
  for (int l = 0; l < n; ++l) wmax = width[l] > wmax ? width[l] : wmax;
  s.x0 = o;
  o += R * wmax;
  s.x1 = o;
  o += R * wmax;
  s.raw = o;
  o += R * P * dc;
  s.lacc = s.lrow = o;
  if (!grad) {
    o += R * dc;
    s.lrow = o;
    o += R;
  }
  for (int l = 0; l < kMaxLayers; ++l) {
    s.dl[l] = o;
    if (grad && l + 1 < n) o += R * slice_width(width[l + 1]);
  }
  s.ring = o;
  o += kStages * stage;
  s.total = o;
  return s;
}

__device__ __forceinline__ float activate(float a, int act) {
  if (act == kSilu) return a / (1.0f + expf(-a));
  if (act == kTanh) return tanhf(a);
  return a > 0.0f ? a : 0.0f;
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

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// waits until at most kStages - 2 of the thread's copy groups are in flight
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;" :: "n"(kStages - 2) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// A thread's place in a product: rows r0 .. r0 + 3 and column group cg.
// A warp holds WR = min(4, R / 4) groups of rows and 32 / WR column
// groups; the warps tile the rest, rows first.
struct ThreadTile {
  int r0, cg;
};

template <int R>
__device__ __forceinline__ ThreadTile thread_tile() {
  constexpr int tr = R / 4;
  constexpr int wr = tr < 4 ? tr : 4;
  constexpr int lc = 32 / wr;
  constexpr int wrw = tr / wr;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  ThreadTile t;
  t.r0 = 4 * ((warp % wrw) * wr + lane / lc);
  t.cg = (warp / wrw) * lc + lane % lc;
  return t;
}

// Where a product's weights come from. kFwd: B[q][o] = W[q ldw + col(o)]
// (a layer's columns; reduction over its inputs); kBwd: B[q][o] = W[(off +
// o) ldw + col(q)] (the transposed rows, for a pullback). col(i) is
// cols[i] when cols is given (-1: a zero), else off + i (kFwd) or i (kBwd).
enum Stream { kFwd = 0, kBwd = 1 };

struct BSrc {
  const float* W;
  int ldw, off;
  const int* cols;
};

// Loads from shared memory as such: the operands reach the products
// through pointers whose state space the compiler cannot infer, and a
// generic load of shared memory is much slower than ld.shared.
__device__ __forceinline__ float4 lds4(const float* p) {
  float4 v;
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(s));
  return v;
}

__device__ __forceinline__ float2 lds2(const float* p) {
  float2 v;
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y)
               : "r"(s));
  return v;
}

__device__ __forceinline__ float lds1(const float* p) {
  float v;
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(s));
  return v;
}

template <int CT>
__device__ __forceinline__ void fma_step(float (&part)[4][CT],
                                         const float* a, const float* b) {
  const float4 av = lds4(a);
  const float ar[4] = {av.x, av.y, av.z, av.w};
  float bv[CT];
  if constexpr (CT == 4) {
    const float4 t = lds4(b);
    bv[0] = t.x;
    bv[1] = t.y;
    bv[2] = t.z;
    bv[3] = t.w;
  } else if constexpr (CT == 2) {
    const float2 t = lds2(b);
    bv[0] = t.x;
    bv[1] = t.y;
  } else {
    bv[0] = lds1(b);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) part[i][j] = fmaf(ar[i], bv[j], part[i][j]);
}

// out[r][o] = sum_q AT[q][r] B[q][o] for r < R, o < n_out, q < n_red,
// handed to put(r, o, value, cv) (every valid (r, o) once, by one thread,
// at the end of its panel) with cv = colv(o), which each thread asks for
// its columns when their panel starts, so that a load there (a bias)
// overlaps the panel's products. AT is [q][r] at pitch R in shared
// memory. Panels of ow = CT col_groups(R) outputs; the reduction streams
// through the ring in stages of stage_rows(stage, ow) rows, one stage
// after another across the panels, so that the ring stays full from the
// first panel to the last. Ends with the ring drained and the block
// synchronised; the caller synchronises after the last epilogue.
template <int CT, int kKind, int R, class ColV, class Put>
__device__ __forceinline__ void product_ct(const float* AT, int n_red,
                                           int n_out, const BSrc& bs,
                                           float* ring, int stage,
                                           ColV& colv, Put& put) {
  const ThreadTile t = thread_tile<R>();
  constexpr int ow = CT * col_groups(R), pitch = ow + 4;
  const int qc = stage_rows(stage, ow);
  const int n_chunks = (n_red + qc - 1) / qc;
  const int total = n_chunks * ((n_out + ow - 1) / ow);
  // kFwd on contiguous columns (no map, 16-byte aligned rows): 16-byte
  // copies of 4 columns; else 4-byte copies
  const bool vec = kKind == kFwd && bs.cols == nullptr && bs.ldw % 4 == 0 &&
                   bs.off % 4 == 0 &&
                   (reinterpret_cast<size_t>(bs.W) & 15) == 0;
  // a thread's place in the copies: kFwd, column fo of the panel and rows
  // fq, fq + fstep, ... (4 columns fo4 .. fo4 + 3 and rows fq4, fq4 +
  // fstep4, ... when vec); kBwd, row bq + 8 k of the stage and columns bo,
  // bo + 32, ...
  constexpr int fstep = kThreads / ow, fstep4 = kThreads * 4 / ow;
  const int fo = threadIdx.x % ow, fq = threadIdx.x / ow;
  const int fo4 = 4 * (threadIdx.x % (ow / 4)), fq4 = threadIdx.x / (ow / 4);
  const int bq = threadIdx.x & 7, bo = threadIdx.x >> 3;
  auto fetch = [&](int g) {
    if (g < total) {
      const int p = g / n_chunks, ch = g - p * n_chunks;
      const int o0 = p * ow, pw = min(ow, n_out - o0);
      float* dst = ring + (g % kStages) * stage;
      const int q0 = ch * qc, nq = min(qc, n_red - q0);
      if constexpr (kKind == kFwd) {
        // neighbouring threads on neighbouring columns
        if (vec) {
          const float* src = bs.W + (size_t)q0 * bs.ldw + bs.off + o0 + fo4;
          for (int q = fq4; q < nq; q += fstep4) {
            float* sp = dst + q * pitch + fo4;
            const float* gp = src + (size_t)q * bs.ldw;
            if (fo4 + 3 < pw) {
              cp_async16(sp, gp);
            } else {
              for (int u = 0; u < 3 && fo4 + u < pw; ++u)
                cp_async4(sp + u, gp + u);
            }
          }
        } else if (fo < pw) {
          const int col = bs.cols ? bs.cols[o0 + fo] : bs.off + o0 + fo;
          const float* src = bs.W + (size_t)q0 * bs.ldw + col;
          for (int q = fq; q < nq; q += fstep) {
            float* sp = dst + q * pitch + fo;
            if (col >= 0)
              cp_async4(sp, src + (size_t)q * bs.ldw);
            else
              *sp = 0.0f;
          }
        }
      } else {
        // 8 neighbouring threads on 8 neighbouring floats of a row of W
        // (one 32-byte sector); pitch = 4 mod 32 spreads a warp's 8 x 4
        // stores over the 32 banks
        for (int q = bq; q < nq; q += 8) {
          const int col = bs.cols ? bs.cols[q0 + q] : q0 + q;
          const float* src = bs.W + (size_t)(bs.off + o0) * bs.ldw + col;
          for (int o = bo; o < pw; o += kThreads / 8) {
            float* sp = dst + q * pitch + o;
            if (col >= 0)
              cp_async4(sp, src + (size_t)o * bs.ldw);
            else
              *sp = 0.0f;
          }
        }
      }
    }
  };
  float acc[4][CT], cv[CT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[i][j] = 0.0f;
  for (int g = 0; g < kStages - 1; ++g) {
    fetch(g);
    cp_async_commit();
  }
  for (int g = 0; g < total; ++g) {
    cp_async_wait_ring();  // this thread's copies of stage g landed
    __syncthreads();       // everyone's; and stage g - 1 is read
    fetch(g + kStages - 1);
    cp_async_commit();  // empty past the last stage: counts stay even
    const int p = g / n_chunks, ch = g - p * n_chunks;
    if (ch == 0) {  // the panel's column values, in flight with its sums
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int o = p * ow + t.cg * CT + j;
        cv[j] = o < n_out ? colv(o) : 0.0f;
      }
    }
    const float* bp = ring + (g % kStages) * stage + t.cg * CT;
    const float* ap = AT + (size_t)ch * qc * R + t.r0;
    const int nq = min(qc, n_red - ch * qc);
    for (int qb = 0; qb < nq; qb += kSumBlock) {
      float part[4][CT];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) part[i][j] = 0.0f;
      if (qb + kSumBlock <= nq) {
#pragma unroll
        for (int q = 0; q < kSumBlock; ++q)
          fma_step<CT>(part, ap + (qb + q) * R, bp + (qb + q) * pitch);
      } else {
        for (int q = qb; q < nq; ++q)
          fma_step<CT>(part, ap + q * R, bp + q * pitch);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) acc[i][j] += part[i][j];
    }
    if (ch == n_chunks - 1) {  // the panel's sums are whole
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int o = p * ow + t.cg * CT + j;
        if (o < n_out) {
#pragma unroll
          for (int i = 0; i < 4; ++i) put(t.r0 + i, o, acc[i][j], cv[j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) acc[i][j] = 0.0f;
    }
  }
  cp_async_wait_all();
  __syncthreads();  // the ring is free for the next product
}

// A forward product without the ring (stage 0), for a K6 plan whose
// activations leave the ring no room: one column a thread, each weight
// read from L2 with __ldg where it is used, and the sums in the ring's
// order (blocks of kSumBlock terms from q = 0; a stage holds a multiple of
// kSumBlock rows), so that its results equal the ring's to the bit.
template <int R, class ColV, class Put>
__device__ __forceinline__ void product_direct(const float* AT, int n_red,
                                               int n_out, const BSrc& bs,
                                               ColV& colv, Put& put) {
  const ThreadTile t = thread_tile<R>();
  constexpr int ow = col_groups(R);
  for (int o0 = 0; o0 < n_out; o0 += ow) {
    const int o = o0 + t.cg;
    const int col =
        o < n_out ? (bs.cols ? bs.cols[o] : bs.off + o) : -1;  // -1: zero
    const float cv = o < n_out ? colv(o) : 0.0f;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int qb = 0; qb < n_red; qb += kSumBlock) {
      const int qe = min(n_red, qb + kSumBlock);
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int q = qb; q < qe; ++q) {
        const float w =
            col >= 0 ? __ldg(bs.W + (size_t)q * bs.ldw + col) : 0.0f;
        const float4 av = lds4(AT + q * R + t.r0);
        part[0] = fmaf(av.x, w, part[0]);
        part[1] = fmaf(av.y, w, part[1]);
        part[2] = fmaf(av.z, w, part[2]);
        part[3] = fmaf(av.w, w, part[3]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] += part[i];
    }
    if (o < n_out) {
#pragma unroll
      for (int i = 0; i < 4; ++i) put(t.r0 + i, o, acc[i], cv);
    }
  }
  __syncthreads();
}

template <int kKind, int R, class ColV, class Put>
__device__ __forceinline__ void product(const float* AT, int n_red,
                                        int n_out, const BSrc& bs,
                                        float* ring, int stage, ColV colv,
                                        Put put) {
  if constexpr (kKind == kFwd) {
    if (stage == 0) {  // K6 without a ring
      product_direct<R>(AT, n_red, n_out, bs, colv, put);
      return;
    }
  }
  const int ct = ct_of(R, n_out, stage);
  if (ct == 4)
    product_ct<4, kKind, R>(AT, n_red, n_out, bs, ring, stage, colv, put);
  else if (ct == 2)
    product_ct<2, kKind, R>(AT, n_red, n_out, bs, ring, stage, colv, put);
  else
    product_ct<1, kKind, R>(AT, n_red, n_out, bs, ring, stage, colv, put);
}

// no column values
struct NoColV {
  __device__ __forceinline__ float operator()(int) const { return 0.0f; }
};

// Copies the other CTAs' slices of a [unit][row] buffer of w units into
// this CTA's (after a cluster barrier that follows their writes).
__device__ __forceinline__ void gather(cg::cluster_group& cl, float* buf,
                                       int R, int w, int rank) {
  const int sw = slice_width(w);
  for (int s = 0; s < kCluster; ++s) {
    const int lo = min(w, s * sw), hi = min(w, lo + sw);
    if (s == rank || hi <= lo) continue;
    const float4* __restrict__ src =
        reinterpret_cast<const float4*>(cl.map_shared_rank(buf, s) + lo * R);
    float4* __restrict__ dst = reinterpret_cast<float4*>(buf + lo * R);
    const int n = (hi - lo) * R / 4;
    // four loads in flight before the stores
    for (int e = threadIdx.x; e < n; e += 4 * kThreads) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (e + u * kThreads < n) v[u] = src[e + u * kThreads];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (e + u * kThreads < n) dst[e + u * kThreads] = v[u];
    }
  }
}

// The tile's conditioner input h0 = x b, transposed (0 past N).
__device__ __forceinline__ void load_input(const Block& bk, float* X0,
                                           int row0) {
  for (int e = threadIdx.x; e < bk.R * bk.d; e += kThreads) {
    const int r = e / bk.d, j = e - r * bk.d, row = row0 + r;
    const float v = row < bk.N ? bk.x[(size_t)row * bk.d + j] : 0.0f;
    X0[j * bk.R + r] = v * bk.mask[j];
  }
}

// The last layer's columns of the chunk of spline dims j0 .. j0 + nj - 1:
// local column c = p dc + jj is p d + idx[j0 + jj], or -1 for jj >= nj.
__device__ __forceinline__ void chunk_cols(int* cols, const Block& bk,
                                           int P, int j0, int nj) {
  for (int c = threadIdx.x; c < P * bk.dc; c += kThreads) {
    const int p = c / bk.dc, jj = c - p * bk.dc;
    cols[c] = jj < nj ? p * bk.d + __ldg(bk.idx + j0 + jj) : -1;
  }
}

// The hidden layers forward on the tile, each split over the cluster and
// gathered; with `grad`, act'(a) of each layer over this CTA's slice to
// lay.dl[l], and with Hs (scratch), each layer's output to Hs[l + 1].
// Returns the buffer holding the last layer's input.
template <int R>
__device__ __forceinline__ int hidden_forward(cg::cluster_group& cl,
                                              const Layers& L,
                                              const Block& bk, float** X,
                                              float* smem, const Layout& lay,
                                              bool grad, float* const* Hs,
                                              int row0, int rank) {
  const int act = bk.act, N = bk.N;
  int cur = 0;
  for (int l = 0; l + 1 < L.n; ++l) {
    const int w = L.width[l + 1], sw = slice_width(w);
    const int lo = min(w, rank * sw), hi = min(w, lo + sw);
    float* out = X[cur ^ 1];
    const float* bias = L.b[l];
    float* D = grad ? smem + lay.dl[l] : nullptr;
    float* H = Hs ? Hs[l + 1] : nullptr;
    product<kFwd, R>(X[cur], L.width[l], hi - lo,
                  BSrc{L.w[l], w, lo, nullptr}, smem + lay.ring, bk.stage,
                  [&](int o) { return __ldg(bias + lo + o); },
                  [&](int r, int o, float v, float b) {
                    const float a = v + b;
                    const float h = activate(a, act);
                    out[(lo + o) * R + r] = h;
                    if (D) D[o * R + r] = activate_grad(a, act);
                    if (H && row0 + r < N) H[(size_t)(lo + o) * N + row0 + r] = h;
                  });
    TILE_MARK(4 + 2 * l);
    cl.sync();
    gather(cl, out, R, w, rank);
    __syncthreads();
    TILE_MARK(5 + 2 * l);
    cur ^= 1;
  }
  return cur;
}

template <bool kInverse, int R>
__global__ void __launch_bounds__(kThreads, 1)
    coupling_tile_fwd_kernel(Layers L, Block bk, float* __restrict__ z,
                             float* __restrict__ ladj) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int d = bk.d, dc = bk.dc, N = bk.N;
  const int rank = (int)cl.block_rank(), P = 3 * bk.K - 1, last = L.n - 1;
  const Layout lay = make_layout(L.width, L.n, P, R, dc, bk.stage, false);
  int* cols = reinterpret_cast<int*>(smem + lay.cols);
  float* X[2] = {smem + lay.x0, smem + lay.x1};
  float* raw = smem + lay.raw;
  float* lacc = smem + lay.lacc;
  float* lrow = smem + lay.lrow;
  const int row0 = (blockIdx.x / kCluster) * R, tid = threadIdx.x;

  TILE_MARK(0);
  load_input(bk, X[0], row0);
  for (int e = tid; e < R * dc; e += kThreads) lacc[e] = 0.0f;
  __syncthreads();
  TILE_MARK(1);
  const int cur =
      hidden_forward<R>(cl, L, bk, X, smem, lay, false, nullptr, row0, rank);
  TILE_MARK(20);

  // this CTA's spline dims, in chunks of dc
  const int ntc = slice_width(bk.nt);
  const int jlo = min(bk.nt, rank * ntc), jhi = min(bk.nt, jlo + ntc);
  const int st = dc * R;
  const float* bias = L.b[last];
  for (int j0 = jlo; j0 < jhi; j0 += dc) {
    const int nj = min(dc, jhi - j0);
    chunk_cols(cols, bk, P, j0, nj);
    __syncthreads();
    product<kFwd, R>(X[cur], L.width[last], P * dc,
                  BSrc{L.w[last], P * d, 0, cols}, smem + lay.ring, bk.stage,
                  [&](int o) {
                    const int c = cols[o];
                    return c >= 0 ? __ldg(bias + c) : 0.0f;
                  },
                  [&](int r, int o, float v, float b) {
                    raw[o * R + r] = cols[o] >= 0 ? v + b : 0.0f;
                  });
    __syncthreads();
    if (j0 == jlo) TILE_MARK(21);
    for (int e = tid; e < R * dc; e += kThreads) {
      const int r = e % R, jj = e / R, row = row0 + r;
      if (jj >= nj || row >= N) continue;
      const int j = __ldg(bk.idx + j0 + jj);
      float yv, lv;
      if (kInverse)
        rqs_inverse(bk.x[(size_t)row * d + j], raw + e, st, bk.K, bk.B, yv,
                    lv);
      else
        rqs_forward(bk.x[(size_t)row * d + j], raw + e, st, bk.K, bk.B, yv,
                    lv);
      z[(size_t)row * d + j] = yv;
      lacc[e] += lv;
    }
    __syncthreads();
    if (j0 == jlo) TILE_MARK(22);
  }
  TILE_MARK(24);
  if (tid < R) {
    float s = 0.0f;
    for (int jj = 0; jj < dc; ++jj) s += lacc[jj * R + tid];
    lrow[tid] = s;
  }
  if (rank == 0) {  // pass-through dims: z = x
    for (int e = tid; e < R * d; e += kThreads) {
      const int r = e / d, j = e - r * d, row = row0 + r;
      if (row < N && bk.mask[j] != 0.0f)
        z[(size_t)row * d + j] = bk.x[(size_t)row * d + j];
    }
  }
  cl.sync();
  if (rank == 0 && tid < R && row0 + tid < N) {
    float s = 0.0f;
    for (int q = 0; q < kCluster; ++q) s += cl.map_shared_rank(lrow, q)[tid];
    ladj[row0 + tid] = s;
  }
  TILE_MARK(25);
  cl.sync();  // no CTA leaves while another reads its shared memory
  TILE_MARK(26);
}

template <bool kInverse, int R>
__global__ void __launch_bounds__(kThreads, 1)
    coupling_tile_bwd_kernel(Layers L, Block bk, Scratch S,
                             const float* __restrict__ gz,
                             const float* __restrict__ gladj,
                             float* __restrict__ dx) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int d = bk.d, dc = bk.dc, N = bk.N;
  const int rank = (int)cl.block_rank(), P = 3 * bk.K - 1, last = L.n - 1;
  const Layout lay = make_layout(L.width, L.n, P, R, dc, bk.stage, true);
  int* cols = reinterpret_cast<int*>(smem + lay.cols);
  float* X[2] = {smem + lay.x0, smem + lay.x1};
  float* raw = smem + lay.raw;
  const int row0 = (blockIdx.x / kCluster) * R, tid = threadIdx.x;
  const bool wgrad = S.G[0] != nullptr;

  TILE_MARK(0);
  load_input(bk, X[0], row0);
  if (wgrad) {  // H_0 = x b over this CTA's slice of dims
    const int sw = slice_width(d);
    const int lo = min(d, rank * sw), hi = min(d, lo + sw);
    for (int e = tid; e < R * (hi - lo); e += kThreads) {
      const int j = lo + e / R, r = e % R, row = row0 + r;
      if (row < N)
        S.H[0][(size_t)j * N + row] = bk.x[(size_t)row * d + j] * bk.mask[j];
    }
  }
  __syncthreads();
  TILE_MARK(1);
  const int cur = hidden_forward<R>(cl, L, bk, X, smem, lay, true,
                                 wgrad ? S.H : nullptr, row0, rank);
  TILE_MARK(20);
  float* H = X[cur];
  float* GH = X[cur ^ 1];  // this CTA's partial cotangent of H
  const int h = L.width[last];
  for (int e = tid; e < R * h; e += kThreads) GH[e] = 0.0f;

  const int ntc = slice_width(bk.nt);
  const int jlo = min(bk.nt, rank * ntc), jhi = min(bk.nt, jlo + ntc);
  const int st = dc * R, ldw = P * d;
  const float* bias = L.b[last];
  float* G_last = S.G[last];
  for (int j0 = jlo; j0 < jhi; j0 += dc) {
    const int nj = min(dc, jhi - j0);
    chunk_cols(cols, bk, P, j0, nj);
    __syncthreads();
    product<kFwd, R>(H, h, P * dc, BSrc{L.w[last], ldw, 0, cols},
                  smem + lay.ring, bk.stage,
                  [&](int o) {
                    const int c = cols[o];
                    return c >= 0 ? __ldg(bias + c) : 0.0f;
                  },
                  [&](int r, int o, float v, float b) {
                    raw[o * R + r] = cols[o] >= 0 ? v + b : 0.0f;
                  });
    __syncthreads();
    if (j0 == jlo) TILE_MARK(21);
    // the spline's pullback; the raw values' cotangents overwrite them
    for (int e = tid; e < R * dc; e += kThreads) {
      const int r = e % R, jj = e / R, row = row0 + r;
      if (jj >= nj || row >= N) {
        for (int p = 0; p < P; ++p) raw[e + p * st] = 0.0f;
        continue;
      }
      const int j = __ldg(bk.idx + j0 + jj);
      const float gy = gz[(size_t)row * d + j], gl = gladj[row];
      float dxv;
      if (kInverse)
        rqs_inverse_vjp(bk.x[(size_t)row * d + j], raw + e, st, bk.K, bk.B,
                        gy, gl, dxv, raw + e, st);
      else
        rqs_forward_vjp(bk.x[(size_t)row * d + j], raw + e, st, bk.K, bk.B,
                        gy, gl, dxv, raw + e, st);
      dx[(size_t)row * d + j] = dxv;
    }
    __syncthreads();
    if (j0 == jlo) TILE_MARK(22);
    if (wgrad) {  // column p nt + t of the compact last layer
      for (int e = tid; e < R * P * dc; e += kThreads) {
        const int r = e % R, c = e / R, row = row0 + r;
        const int p = c / dc, jj = c - p * dc;
        if (row < N && jj < nj)
          G_last[(size_t)(p * bk.nt + j0 + jj) * N + row] = raw[e];
      }
    }
    product<kBwd, R>(raw, P * dc, h, BSrc{L.w[last], ldw, 0, cols},
                  smem + lay.ring, bk.stage, NoColV{},
                  [&](int r, int o, float v, float) { GH[o * R + r] += v; });
    __syncthreads();
    if (j0 == jlo) TILE_MARK(23);
  }
  TILE_MARK(24);
  cl.sync();
  // the cluster's partials summed in rank order over this CTA's slice of
  // units: G of the last hidden layer (into H's buffer), or, without one,
  // the input's cotangent
  {
    const int sw = slice_width(h);
    const int lo = min(h, rank * sw), hi = min(h, lo + sw);
    const float* D = smem + lay.dl[last > 0 ? last - 1 : 0];
    float* Gs = last > 0 ? S.G[last - 1] : nullptr;
    for (int e = lo * R + tid; e < hi * R; e += kThreads) {
      float part[kCluster];  // the partials' loads in flight together
#pragma unroll
      for (int q = 0; q < kCluster; ++q)
        part[q] = cl.map_shared_rank(GH, q)[e];
      float v = 0.0f;
#pragma unroll
      for (int q = 0; q < kCluster; ++q) v += part[q];
      const int k = e / R, r = e % R, row = row0 + r;
      if (last > 0) {
        const float g = v * D[e - lo * R];
        H[e] = g;
        if (Gs && row < N) Gs[(size_t)k * N + row] = g;
      } else if (row < N && bk.mask[k] != 0.0f) {
        dx[(size_t)row * d + k] = gz[(size_t)row * d + k] + v;
      }
    }
  }
  TILE_MARK(25);
  cl.sync();
  TILE_MARK(26);
  // down the hidden layers: the input's cotangent of layer l over this
  // CTA's slice of its units, times act' of the layer below (or, at the
  // bottom, dx of the pass-through dims: dz/dx = 1 plus the conditioner)
  int a = cur;
  for (int l = last - 1; l >= 0; --l) {
    gather(cl, X[a], R, L.width[l + 1], rank);
    __syncthreads();
    const int w = L.width[l], sw = slice_width(w);
    const int lo = min(w, rank * sw), hi = min(w, lo + sw);
    float* out = X[a ^ 1];
    const float* D = smem + lay.dl[l > 0 ? l - 1 : 0];
    float* Gs = l > 0 ? S.G[l - 1] : nullptr;
    product<kBwd, R>(X[a], L.width[l + 1], hi - lo,
                  BSrc{L.w[l], L.width[l + 1], lo, nullptr}, smem + lay.ring, bk.stage,
                  NoColV{}, [&](int r, int o, float v, float) {
                    const int k = lo + o, row = row0 + r;
                    if (l > 0) {
                      const float g = v * D[o * R + r];
                      out[k * R + r] = g;
                      if (Gs && row < N) Gs[(size_t)k * N + row] = g;
                    } else if (row < N && bk.mask[k] != 0.0f) {
                      dx[(size_t)row * d + k] = gz[(size_t)row * d + k] + v;
                    }
                  });
    if (l > 0) cl.sync();
    TILE_MARK(27 + (l < 3 ? l : 3));
    a ^= 1;
  }
  cl.sync();  // no CTA leaves while another reads its shared memory
  TILE_MARK(31);
}

// Pass 2 of K7: tile (i0.., c0..) of dW_l = H_l^T G_l, with row in_l the
// bias (a row of ones appended to H_l^T), over this CTA's slice of the
// rows; the cluster's S slices are added in rank order.
struct WeightGrad {
  const float* H[kMaxLayers];
  const float* G[kMaxLayers];
  float* dW[kMaxLayers];
  float* db[kMaxLayers];
  int n_in[kMaxLayers], n_out[kMaxLayers], tiles_c[kMaxLayers];
  int first[kMaxLayers + 1];
  int n, N, d, nt, S;
  const int* idx;
};

__global__ void __launch_bounds__(kThreads, 1)
    coupling_tile_wgrad_kernel(WeightGrad a) {
  __shared__ __align__(16) float Hs[kWRows * kWPitch];
  __shared__ __align__(16) float Gs[kWRows * kWPitch];
  __shared__ __align__(16) float Ps[kWTile * kWTile];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank(), unit = blockIdx.x / a.S;
  int l = 0;
  while (unit >= a.first[l + 1]) ++l;
  const int t = unit - a.first[l];
  const int i0 = (t / a.tiles_c[l]) * kWTile;
  const int c0 = (t % a.tiles_c[l]) * kWTile;
  const int n_in = a.n_in[l], n_out = a.n_out[l], N = a.N;
  const float* H = a.H[l];
  const float* G = a.G[l];
  const int per = ((N + a.S - 1) / a.S + kWRows - 1) / kWRows * kWRows;
  const int n_lo = min(N, rank * per), n_hi = min(N, n_lo + per);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ti = 4 * ((warp & 3) * 4 + lane / 8);
  const int tc = 4 * ((warp >> 2) * 8 + lane % 8);
  // loader: element e of a step, 8 neighbouring rows of 4 units per 32
  // threads (one sector each); e < 2048 covers 32 rows x 64 units
  float hr[8], gr[8];
  auto load = [&](int n0) {
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int e = threadIdx.x + kThreads * m;
      const int nn = (e & 7) + 8 * ((e >> 5) & 3);
      const int u = ((e >> 3) & 3) + 4 * (e >> 7);
      const int row = n0 + nn, i = i0 + u, c = c0 + u;
      float hv = 0.0f, gv = 0.0f;
      if (row < n_hi) {
        hv = i < n_in ? H[(size_t)i * N + row] : (i == n_in ? 1.0f : 0.0f);
        gv = c < n_out ? G[(size_t)c * N + row] : 0.0f;
      }
      hr[m] = hv;
      gr[m] = gv;
    }
  };
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  if (n_lo < n_hi) load(n_lo);
  for (int n0 = n_lo; n0 < n_hi; n0 += kWRows) {
    __syncthreads();  // the previous step's reads are done
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int e = threadIdx.x + kThreads * m;
      const int nn = (e & 7) + 8 * ((e >> 5) & 3);
      const int u = ((e >> 3) & 3) + 4 * (e >> 7);
      Hs[nn * kWPitch + u] = hr[m];
      Gs[nn * kWPitch + u] = gr[m];
    }
    __syncthreads();
    if (n0 + kWRows < n_hi) load(n0 + kWRows);
    float part[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = 0.0f;
#pragma unroll 8
    for (int nn = 0; nn < kWRows; ++nn) {
      const float4 hv = *reinterpret_cast<const float4*>(Hs + nn * kWPitch + ti);
      const float4 gv = *reinterpret_cast<const float4*>(Gs + nn * kWPitch + tc);
      const float hh[4] = {hv.x, hv.y, hv.z, hv.w};
      const float gg[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = fmaf(hh[i], gg[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(Ps + (ti + i) * kWTile + tc) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  cl.sync();
  const int share = kWTile * kWTile / a.S;
  const bool is_last = l == a.n - 1;
  const int ldw = is_last ? (n_out / a.nt) * a.d : n_out;
  for (int e = rank * share + threadIdx.x; e < (rank + 1) * share;
       e += kThreads) {
    const int i = i0 + e / kWTile, c = c0 + e % kWTile;
    if (i > n_in || c >= n_out) continue;
    float part[8];  // the partials' loads in flight together
#pragma unroll
    for (int q = 0; q < 8; ++q)
      part[q] = q < a.S ? cl.map_shared_rank(Ps, q)[e] : 0.0f;
    float v = 0.0f;
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (q < a.S) v += part[q];
    int col = c;
    if (is_last) {  // compact spline columns -> p-major p d + j
      const int p = c / a.nt;
      col = p * a.d + a.idx[c - p * a.nt];
    }
    if (i < n_in)
      a.dW[l][(size_t)i * ldw + col] = v;
    else
      a.db[l][col] = v;
  }
  cl.sync();  // no CTA leaves while another reads its shared memory
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

// The plans the kernels take: R in {8, 16} rows (one instantiation
// each), dc >= 1 and a ring stage of 2112-8448 floats (a multiple of 4
// that leaves a stage 16 rows of the narrowest panel), or, for K6 (not
// `grad`), no ring (stage 0).
bool plan_ok(int R, int dc, int stage, bool grad) {
  if (!(R == 8 || R == 16) || dc < 1) return false;
  if (stage == 0) return !grad;
  return stage % 4 == 0 && stage <= 8448 &&
         stage_rows(stage, col_groups(R)) >= 16;
}

bool block_of(const void* x, const void* mask, const void* idx,
              long long N, int d, int nt, int knots, float B, int act,
              int R, int dc, int stage, bool grad, Block& bk) {
  if (N < 0 || N > (1LL << 30) || d <= 0 || nt < 0 || nt > d) return false;
  if (knots < 2 || knots > kMaxKnots || !(B > 0.0f)) return false;
  if (act < kSilu || act > kRelu || !plan_ok(R, dc, stage, grad)) return false;
  bk.x = static_cast<const float*>(x);
  bk.mask = static_cast<const float*>(mask);
  bk.idx = static_cast<const int*>(idx);
  bk.N = (int)N;
  bk.d = d;
  bk.nt = nt;
  bk.K = knots;
  bk.act = act;
  bk.B = B;
  bk.R = R;
  bk.dc = dc;
  bk.stage = stage;
  return true;
}

// Launches `kernel` on `grid` CTAs in clusters of `cluster`, with `smem`
// bytes of dynamic shared memory.
template <class Kernel, class... Args>
cudaError_t launch(Kernel kernel, unsigned grid, int cluster, size_t smem,
                   cudaStream_t s, Args... args) {
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// The entry points. Each returns a cudaError_t (0 = launched). ws, bs and
// widths are host arrays of n_layers (n_layers + 1) entries; the weight
// and bias pointers, x, mask (d floats), idx (nt ints), z, ladj, gz,
// gladj and dx are device pointers. rows, dc and stage are the launch
// plan (`tile_plan` in kernels/coupling_cuda.py). The Python wrapper checks
// device, dtype, shapes and contiguity before calling.

#ifdef COUPLING_TILE_PROFILE
// the phase marks of the last launch: n <= kProfCtas kProfMarks values
extern "C" int coupling_tile_profile(long long* host, int n) {
  if (n > kProfCtas * kProfMarks) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(host, g_tile_prof, sizeof(long long) * n);
}
#endif

// Shared memory of a launch, in bytes (0 if the arguments are invalid):
// what `tile_plan` computes in Python.
extern "C" long long coupling_tile_smem(const int* widths, int n_layers,
                                        int knots, int rows, int dc,
                                        int stage, int grad) {
  if (n_layers < 1 || n_layers > kMaxLayers ||
      !plan_ok(rows, dc, stage, grad != 0))
    return 0;
  return 4LL * make_layout(widths, n_layers, 3 * knots - 1, rows, dc, stage,
                           grad != 0)
                   .total;
}

// K6's instantiation for R rows, forward or inverse.
template <int R>
cudaError_t launch_fwd(bool inverse, unsigned grid, size_t smem,
                       cudaStream_t s, const Layers& L, const Block& bk,
                       float* z, float* ladj) {
  if (inverse)
    return launch(coupling_tile_fwd_kernel<true, R>, grid, kCluster, smem, s,
                  L, bk, z, ladj);
  return launch(coupling_tile_fwd_kernel<false, R>, grid, kCluster, smem, s,
                L, bk, z, ladj);
}

// K7 pass 1's instantiation for R rows, forward or inverse.
template <int R>
cudaError_t launch_bwd(bool inverse, unsigned grid, size_t smem,
                       cudaStream_t s, const Layers& L, const Block& bk,
                       const Scratch& S, const float* gz, const float* gl,
                       float* dx) {
  if (inverse)
    return launch(coupling_tile_bwd_kernel<true, R>, grid, kCluster, smem, s,
                  L, bk, S, gz, gl, dx);
  return launch(coupling_tile_bwd_kernel<false, R>, grid, kCluster, smem, s,
                L, bk, S, gz, gl, dx);
}

// K6: (z, ladj) of the block, forward or inverse.
extern "C" int coupling_tile_fwd_f32(
    const void* x, const void* mask, const void* idx, const void* const* ws,
    const void* const* bs, const int* widths, int n_layers, long long N,
    int d, int nt, int knots, float range_limit, int act, int inverse,
    int rows, int dc, int stage, void* z, void* ladj, void* stream) {
  Layers L;
  Block bk;
  if (!layers_of(ws, bs, widths, n_layers, d, knots, L) ||
      !block_of(x, mask, idx, N, d, nt, knots, range_limit, act, rows, dc,
                stage, false, bk))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const size_t smem =
      4 * (size_t)make_layout(L.width, L.n, 3 * knots - 1, rows, dc, stage,
                              false)
              .total;
  const unsigned grid = (unsigned)((N + rows - 1) / rows * kCluster);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* zp = static_cast<float*>(z);
  float* lp = static_cast<float*>(ladj);
  if (rows == 8)
    return (int)launch_fwd<8>(inverse, grid, smem, s, L, bk, zp, lp);
  return (int)launch_fwd<16>(inverse, grid, smem, s, L, bk, zp, lp);
}

// K7, pass 1: dx, and with Hs / Gs (host arrays of n_layers device
// pointers, or null) each layer's input and pre-activation cotangent,
// transposed ((units, N)).
extern "C" int coupling_tile_bwd_f32(
    const void* x, const void* mask, const void* idx, const void* const* ws,
    const void* const* bs, const int* widths, int n_layers, long long N,
    int d, int nt, int knots, float range_limit, int act, int inverse,
    int rows, int dc, int stage, const void* gz, const void* gladj, void* dx,
    void* const* Hs, void* const* Gs, void* stream) {
  Layers L;
  Block bk;
  if (!layers_of(ws, bs, widths, n_layers, d, knots, L) ||
      !block_of(x, mask, idx, N, d, nt, knots, range_limit, act, rows, dc,
                stage, true, bk) ||
      (Hs == nullptr) != (Gs == nullptr))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  Scratch S;
  for (int l = 0; l < kMaxLayers; ++l) {
    S.H[l] = Hs && l < n_layers ? static_cast<float*>(Hs[l]) : nullptr;
    S.G[l] = Gs && l < n_layers ? static_cast<float*>(Gs[l]) : nullptr;
  }
  const size_t smem =
      4 * (size_t)make_layout(L.width, L.n, 3 * knots - 1, rows, dc, stage,
                              true)
              .total;
  const unsigned grid = (unsigned)((N + rows - 1) / rows * kCluster);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gzp = static_cast<const float*>(gz);
  const float* glp = static_cast<const float*>(gladj);
  float* dxp = static_cast<float*>(dx);
  if (rows == 8)
    return (int)launch_bwd<8>(inverse, grid, smem, s, L, bk, S, gzp, glp,
                              dxp);
  return (int)launch_bwd<16>(inverse, grid, smem, s, L, bk, S, gzp, glp,
                             dxp);
}

// K7, pass 2: dW_l = H_l^T G_l and db_l = sum_rows G_l for every layer,
// the rows split over clusters of `slices` CTAs; the last layer's written
// to the columns p d + idx[t] of its p-major dW and db (the wrapper zeroes
// the others: pass-through dims get no cotangent).
extern "C" int coupling_tile_wgrad_f32(
    void* const* Hs, void* const* Gs, void* const* dWs, void* const* dbs,
    const int* widths, int n_layers, long long N, int d, int nt, int knots,
    const void* idx, int slices, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || N < 0 || N > (1LL << 30) ||
      nt < 0 || nt > d || knots < 2 ||
      widths[n_layers] != (3 * knots - 1) * d ||
      !(slices == 1 || slices == 2 || slices == 4 || slices == 8))
    return (int)cudaErrorInvalidValue;
  WeightGrad a;
  a.n = n_layers;
  a.N = (int)N;
  a.d = d;
  a.nt = nt;
  a.S = slices;
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
    a.tiles_c[l] = (a.n_out[l] + kWTile - 1) / kWTile;
    const int tiles_i = on ? (a.n_in[l] + 1 + kWTile - 1) / kWTile : 0;
    a.first[l + 1] = a.first[l] + tiles_i * a.tiles_c[l];
  }
  const int tiles = a.first[n_layers];
  if (N == 0 || tiles == 0) return 0;
  return (int)launch(coupling_tile_wgrad_kernel, (unsigned)(tiles * slices),
                     slices, 0, static_cast<cudaStream_t>(stream), a);
}
