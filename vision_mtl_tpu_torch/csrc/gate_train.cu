// MTAN's train-mode attention gate, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `fused_attention_gate_train`
// (`_stats_kernel_1`, `_stats_kernel_2`, `_gate_kernel_3`) of
// vision_mtl_tpu/ops/pallas/fused_gate.py. Both BatchNorms of the gate
// chain normalise with the batch's own statistics, so three passes run:
//
//   pass 1: h = x @ w1 + b1; per channel mean1 and biased var1 of h;
//   pass 2: h again, BN1 with those statistics, relu, a = h @ w2 + b2;
//           mean2 and var2 of a;
//   pass 3: out = shared * sigmoid(BN2(a)), both BNs with batch statistics.
//
// Pass 1 writes x @ w1 (N, hidden) f32 to scratch memory, and passes 2 and
// 3 read it back instead of recomputing the first product (on the TPU each
// pass recomputed it in VMEM): 3 x 4 N hidden bytes moved (at MTAN's
// largest level, 128 x 256 at batch 8, 134 MB written and read twice, about
// 0.12 ms of HBM time) against two more first products (two thirds of the
// three passes' operations). Where Cin <= 16 (MTAN's first level, Cin = 3)
// the product is cheaper than its bytes, and every pass recomputes it. a
// (N, C2) is recomputed; it never reaches device memory. x and shared are
// (N, Cin) and (N, C2) rows in f32 or bf16; the weights are f32; out takes
// shared's type. The variances are biased and clamped at 0.
//
// Products in f32 accuracy on the tensor cores (3xTF32), with the tile
// body of csrc/gate_tile.cuh: two TF32 products for x @ w1 when x is bf16,
// three otherwise. One TF32 pass alone would not do: it keeps 11 bits of
// each operand, and the batch statistics must agree with f32 products to
// 1e-5.
//
// Design. 256 threads (8 warps, 4 along the rows x 2 along the columns) for
// each tile of rows. The first product streams x and w1 over Cin in chunks,
// double-buffered with cp.async (16-byte copies, zero-filled past N, Cin and
// the column count); the weights are read from L2 once per tile. Large N
// takes 128-row tiles and 32-deep chunks, and two blocks share an SM; a
// warp owns 32 rows x up to 64 columns, 2 x 8 m16n8 tiles, so each A
// fragment feeds 8 products and each B fragment 2. Small N (fewer 128-row
// tiles than half the SMs) takes 64-row tiles, for twice the blocks, and
// 64-deep chunks: there a block's pipeline steps run one after another
// with little else on its SM, so fewer, larger steps. Passes 2 and 3 load
// their tile of x @ w1 and apply BN1 as h' = relu((x @ w1)_j * s_j + c_j)
// (the BN scale in the epilogue, not on the weights); h' goes to shared
// memory (f32), and the second product streams w2 as the first streams w1.
// When N is small the columns are split across blockIdx.y to fill the
// card: pass 1 takes half of the hidden channels per block when there are
// fewer tiles than SMs; passes 2 and 3 take at most 128 of C2's channels
// per block (a wider C2 is split).
//
// What bounds it on an H100: the function needs its two products once,
// 2N(Cin hidden + hidden C2) operations, against N(Cin + 2 C2) activations
// moved: above the f32 ridge of the card, so the products bound it. Taken
// as 3xTF32 (two TF32 products for x @ w1 when x is bf16) with x @ w1
// stored, the three passes do 2N(k Cin hidden + 6 hidden C2) operations,
// k = 3 for f32 x and 2 for bf16, at the 495 TFLOP/s TF32 rate, and move
// 12 N hidden bytes of x @ w1 besides the activations.
//
// Statistics. A statistics pass launches at most a fixed number of blocks
// in x (so the order of the sums depends on N alone), each walking its tiles
// in a fixed order. A warp reduces each of its columns over its rows to
// (count, mean, M2) by Chan's pairwise update across its lanes in a fixed
// butterfly; a thread per column folds the four warps' results, in order,
// into the block's running (mean, M2), in f32. The last block to finish
// combines the blocks' partials in f64, in block order, and writes the
// statistics and the next pass's folded BN: scale inv = gamma / sqrt(var +
// eps) and constant (bias_conv - mean) * inv + beta. No floating-point
// atomic decides an order, so two launches on the same inputs give the
// same bits; no E[h^2] - E[h]^2 is ever formed.
//
// Tasks. MTAN's task-folded levels (fold_tasks) take the T tasks' gates in
// one call: x, the weights, out and the statistics carry a leading task
// axis, shared is the tasks' one map, and each pass puts the task index on
// blockIdx.z. Each task has its own scratch (x @ w1, the partials, the
// folded BNs) and its own counter of finished blocks, so its last block
// combines its partials alone; a task's blocks walk the tiles that a call
// for that task alone walks, and each task's results are bit for bit
// those of its own call.

#include "gate_tile.cuh"

namespace {

using namespace gate_tile;

constexpr int kMaxHidden = 128;
constexpr int kMaxC2 = 512;
constexpr int kSliceC2 = 128;          // C2 columns a block of passes 2 and 3 takes, at most

enum Mode { kStatsH, kStatsA, kGate };

// floats of shared memory a pass takes with tile Tl: x stages (two) or, in
// passes 2 and 3, h' in their place; weight stages (two); the warps'
// statistics
template <class Tl>
__host__ __device__ constexpr int region(int mode) {
  return mode == kStatsH || 2 * Tl::kRows * Tl::kXs > Tl::kRows * kHs ? 2 * Tl::kRows * Tl::kXs
                                                                      : Tl::kRows * kHs;
}
template <class Tl>
__host__ __device__ constexpr int smem_floats(int mode) {
  return region<Tl>(mode) + 2 * Tl::kChunk * kWs + 2 * 4 * 128;
}

struct Pass {
  const void* x;
  const void* shared;
  void* out;
  const float* w1;
  const float* w2;
  // h' = relu((x @ w1) * s1 + c1) and a = (h' @ w2) * s2 + c2, per column;
  // the statistics passes take c1 = b1 (pass 1) and c2 = b2 (pass 2) as the
  // conv bias their statistics include
  const float* s1;
  const float* c1;
  const float* s2;
  const float* c2;
  long long n;
  int cin, hidden, c2ch;
  int cols1;       // columns of the first product a block takes (pass 1 may split hidden)
  int cols2;       // columns of the second product a block takes (a slice of C2)
  int vec_x;       // x rows are 16-byte aligned: staged by cp.async
  float* h;        // (n, hidden) x @ w1: written by pass 1, read by passes 2 and 3
  // statistics passes only
  float* partial;           // (gridDim.x, 2, C): each block's mean and M2
  unsigned int* done;       // the task's blocks finished, zero before the launch
  const float* conv_bias;   // (C,) the bias inside the statistics (b1 or b2)
  const float* bn_scale;    // (C,) BN gamma
  const float* bn_bias;     // (C,) BN beta
  float eps;
  float* mean;              // (C,) batch mean
  float* var;               // (C,) biased batch variance, clamped at 0
  float* fold_s;            // (C,) folded BN for the next passes: scale
  float* fold_c;            // (C,) and constant
  // task t's pointers are the fields above plus t times these (elements)
  struct Strides {
    long long x, out, w1, w2, s1, c1, s2, c2, h, partial, done, conv_bias, bn_scale, bn_bias,
        stats, fold;
  } ts;
};

// The pass of task t: each pointer moved to the task's own tensors.
template <typename T>
__device__ __forceinline__ Pass task_pass(Pass p, long long t) {
  p.x = static_cast<const T*>(p.x) + t * p.ts.x;
  if (p.out != nullptr) p.out = static_cast<T*>(p.out) + t * p.ts.out;
  p.w1 += t * p.ts.w1;
  p.w2 += t * p.ts.w2;
  if (p.s1 != nullptr) p.s1 += t * p.ts.s1;
  if (p.c1 != nullptr) p.c1 += t * p.ts.c1;
  if (p.s2 != nullptr) p.s2 += t * p.ts.s2;
  if (p.c2 != nullptr) p.c2 += t * p.ts.c2;
  if (p.h != nullptr) p.h += t * p.ts.h;
  if (p.partial != nullptr) {
    p.partial += t * p.ts.partial;
    p.done += t * p.ts.done;
    p.conv_bias += t * p.ts.conv_bias;
    p.bn_scale += t * p.ts.bn_scale;
    p.bn_bias += t * p.ts.bn_bias;
    p.mean += t * p.ts.stats;
    p.var += t * p.ts.stats;
    p.fold_s += t * p.ts.fold;
    p.fold_c += t * p.ts.fold;
  }
  return p;
}

// Chan's update: (n, mean, m2) += (nb, mean_b, m2_b)
__device__ __forceinline__ void chan(float& n, float& mean, float& m2, float nb, float mb,
                                     float m2b) {
  const float nab = n + nb;
  const float d = mb - mean;
  const float f = nab > 0.f ? nb / nab : 0.f;
  mean += d * f;
  m2 += m2b + d * d * n * f;
  n = nab;
}

// Valid rows of warp row `q` (`rows` rows each) of the tile starting at row0.
__device__ __forceinline__ int quarter_rows(long long n, long long row0, int q, int rows) {
  const long long left = n - row0 - (long long)rows * q;
  return left <= 0 ? 0 : (left >= rows ? rows : (int)left);
}

// A warp's statistics of each of its columns v = acc + bias[col] over its
// 16 kMt rows, into red_mean / red_m2 [warp row][column].
template <int kMt>
__device__ __forceinline__ void warp_stats(const float (&acc)[kMt][kNt][4], int nt,
                                           const float* bias, int bias0, int col0, int cols,
                                           long long n, long long row0, int wm, float* red_mean,
                                           float* red_m2) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int j = 0; j < kNt; ++j) {
    if (j >= nt) break;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = col0 + j * 8 + 2 * tg + e;
      const float b = col < cols ? bias[bias0 + col] : 0.f;
      float v[2 * kMt];
      bool ok[2 * kMt];
#pragma unroll
      for (int m = 0; m < kMt; ++m)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = m * 2 + half;
          v[i] = acc[m][j][half * 2 + e] + b;
          ok[i] = row0 + wm * 16 * kMt + m * 16 + half * 8 + g < n;
        }
      float cnt = 0.f, s = 0.f;
#pragma unroll
      for (int i = 0; i < 2 * kMt; ++i) {
        cnt += ok[i] ? 1.f : 0.f;
        s += ok[i] ? v[i] : 0.f;
      }
      float mean = cnt > 0.f ? s / cnt : 0.f, m2 = 0.f;
#pragma unroll
      for (int i = 0; i < 2 * kMt; ++i) {
        const float d = v[i] - mean;
        m2 += ok[i] ? d * d : 0.f;
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {  // lanes of the other rows, same column
        const float nb = __shfl_xor_sync(0xffffffffu, cnt, off);
        const float mb = __shfl_xor_sync(0xffffffffu, mean, off);
        const float m2b = __shfl_xor_sync(0xffffffffu, m2, off);
        chan(cnt, mean, m2, nb, mb, m2b);
      }
      if (g == 0 && col < cols) {
        red_mean[wm * 128 + col] = mean;
        red_m2[wm * 128 + col] = m2;
      }
    }
  }
}

// Rows a statistics block walks: tiles b, b + g, b + 2g, ... of `tiles`
// tiles of `rows` rows.
__device__ __forceinline__ long long block_rows(long long n, int rows, long long tiles, int g,
                                                int b) {
  const long long count = (tiles - 1 - b) / g + 1;
  const long long short_by = ((tiles - 1) % g == b) ? tiles * rows - n : 0;
  return count * rows - short_by;
}

// The last block of a statistics pass: the blocks' partials combined in f64
// in block order, the statistics and the next passes' folded BN written out.
// Each column's blocks are cut into `parts` contiguous ranges, one thread
// each, whose sums are then added in range order: a fixed order, spread
// over the block's threads. `scratch` is shared memory for 2 * kThreads +
// gridDim.x doubles. `rows_per_tile`: the pass's tile.
__device__ void finalize_stats(const Pass& p, int ch, int rows_per_tile, double* scratch) {
  const long long tiles = (p.n + rows_per_tile - 1) / rows_per_tile;
  const int g = gridDim.x, tid = threadIdx.x;
  double* part = scratch;                     // [kThreads]: one range's sum
  double* mean_of = scratch + kThreads;       // [kThreads]: a column's mean, by its first thread
  double* rows = scratch + 2 * kThreads;      // [g]: rows of each block
  for (int b = tid; b < g; b += kThreads)
    rows[b] = (double)block_rows(p.n, rows_per_tile, tiles, g, b);
  int parts = 1;
  while (parts < 8 && 2 * parts * ch <= kThreads) parts *= 2;
  const int cols = kThreads / parts;          // columns per round
  const double n = (double)p.n;
  for (int c0 = 0; c0 < ch; c0 += cols) {
    const int c = c0 + tid / parts, q = tid % parts;
    const int b0 = q * g / parts, b1 = (q + 1) * g / parts;
    const bool live = tid < cols * parts && c < ch;
    __syncthreads();  // rows[] is written; the previous round's scratch is read
    double sum = 0.0;
    if (live) {
#pragma unroll 4
      for (int b = b0; b < b1; ++b) sum += rows[b] * (double)__ldcg(&p.partial[(2 * b) * ch + c]);
    }
    part[tid] = sum;
    __syncthreads();
    if (live && q == 0) {
      double total = 0.0;
      for (int i = 0; i < parts; ++i) total += part[tid + i];
      mean_of[tid] = total / n;
    }
    __syncthreads();
    const double mean = mean_of[tid - q];
    double m2 = 0.0;
    if (live) {
#pragma unroll 4
      for (int b = b0; b < b1; ++b) {
        const double d = (double)__ldcg(&p.partial[(2 * b) * ch + c]) - mean;
        m2 += (double)__ldcg(&p.partial[(2 * b + 1) * ch + c]) + rows[b] * d * d;
      }
    }
    __syncthreads();  // part[] of the first phase is read
    part[tid] = m2;
    __syncthreads();
    if (live && q == 0) {
      double total = 0.0;
      for (int i = 0; i < parts; ++i) total += part[tid + i];
      const float mean_f = (float)mean;
      const float var_f = fmaxf((float)(total / n), 0.f);
      p.mean[c] = mean_f;
      p.var[c] = var_f;
      const float inv = p.bn_scale[c] / sqrtf(var_f + p.eps);
      p.fold_s[c] = inv;
      p.fold_c[c] = (p.conv_bias[c] - mean_f) * inv + p.bn_bias[c];
    }
  }
}

template <typename T, int kMode, class Tl>
__global__ void __launch_bounds__(kThreads, 2) gate_train_kernel(const Pass task0) {
  extern __shared__ __align__(16) float smem[];
  const Pass p = task_pass<T>(task0, blockIdx.z);
  constexpr int kRows = Tl::kRows, kK = Tl::kChunk, kMt = Tl::kWarpRows / 16;
  constexpr int kColAlign = 16;                         // 2 column warps x n8
  constexpr int kXBuf = kRows * Tl::kXs;                // floats per x buffer (f32 or bf16)
  float* wbuf = smem;                                   // [2][kK][kWs]
  float* xbuf = wbuf + 2 * kK * kWs;                    // [2][kRows][kXs] (bf16: kXsB)
  float* hs = xbuf;                                     // passes 2, 3: [kRows][kHs] h'
  float* red_mean = xbuf + region<Tl>(kMode);           // [4][128]
  float* red_m2 = red_mean + 4 * 128;

  const T* __restrict__ x = static_cast<const T*>(p.x);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const long long n = p.n;
  const long long tiles = (n + kRows - 1) / kRows;
  // columns of this block: the first product's [c1lo, c1lo + cols1) of
  // hidden, the second's [c2lo, c2lo + cols2) of C2
  const int c1lo = kMode == kStatsH ? blockIdx.y * p.cols1 : 0;
  const int c1n = min(p.cols1, p.hidden - c1lo);
  const int c2lo = blockIdx.y * p.cols2;
  const int c2n = kMode == kStatsH ? 0 : min(p.cols2, p.c2ch - c2lo);
  const int w1cols = (c1n + kColAlign - 1) / kColAlign * kColAlign;  // staged, zero past c1n
  const int nt1 = w1cols / kColAlign;                   // n8 tiles of a warp
  const int w2cols = (c2n + kColAlign - 1) / kColAlign * kColAlign;
  const int nt2 = w2cols / kColAlign;
  const int stat_ch = kMode == kStatsH ? p.hidden : p.c2ch;
  const int stat_lo = kMode == kStatsH ? c1lo : c2lo;
  const int stat_n = kMode == kStatsH ? c1n : c2n;
  const int nk1 = (p.cin + kK - 1) / kK;
  const int nk2 = (p.hidden + kK - 1) / kK;
  const int wrow0 = wm * Tl::kWarpRows;                 // the warp's first row in the tile

  float run_n = 0.f, run_mean = 0.f, run_m2 = 0.f;  // this block's statistics of column tid

  const long long first = blockIdx.x, step = kMode == kGate ? tiles : gridDim.x;
  for (long long tile = first; tile < tiles; tile += step) {
    const long long row0 = tile * kRows;
    float acc[kMt][kNt][4];
#pragma unroll
    for (int m = 0; m < kMt; ++m)
#pragma unroll
      for (int j = 0; j < kNt; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

    if (kMode == kStatsH || p.h == nullptr) {
      // ---- first product: x @ w1[:, c1lo : c1lo + c1n] ----
      T* xs = reinterpret_cast<T*>(xbuf);
      constexpr int kPitch = sizeof(T) == 4 ? Tl::kXs : Tl::kXsB;
      stage_x<Tl>(xs, x, n, p.cin, row0, 0, p.vec_x);
      stage_w<kK>(wbuf, p.w1, p.cin, p.hidden, 0, c1lo, c1lo + c1n, w1cols);
      cp_async_commit();
      for (int kc = 0; kc < nk1; ++kc) {
        const int buf = kc & 1;
        if (kc + 1 < nk1) {
          stage_x<Tl>(reinterpret_cast<T*>(xbuf + (buf ^ 1) * kXBuf), x, n, p.cin, row0,
                      (kc + 1) * kK, p.vec_x);
          stage_w<kK>(wbuf + (buf ^ 1) * kK * kWs, p.w1, p.cin, p.hidden, (kc + 1) * kK, c1lo,
                      c1lo + c1n, w1cols);
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        const int k8 = (min(kK, p.cin - kc * kK) + 7) / 8;
        mma_chunk<kMt>(acc, reinterpret_cast<const T*>(xbuf + buf * kXBuf), kPitch, 0,
                       wbuf + buf * kK * kWs, k8, nt1, wrow0, wn * nt1 * 8);
        __syncthreads();  // the buffers are free for the next stage
      }
      // x @ w1 for passes 2 and 3
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
        if (kMode != kStatsH || p.h == nullptr || j >= nt1) break;
        const int col = wn * nt1 * 8 + j * 8 + 2 * tg;
        if (col >= c1n) continue;
#pragma unroll
        for (int m = 0; m < kMt; ++m)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const long long gr = row0 + wrow0 + m * 16 + half * 8 + g;
            if (gr < n)
              *reinterpret_cast<float2*>(p.h + gr * p.hidden + c1lo + col) =
                  make_float2(acc[m][j][half * 2], acc[m][j][half * 2 + 1]);
          }
      }
    } else {
      // ---- x @ w1, as pass 1 wrote it ----
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
        if (j >= nt1) break;
        const int col = wn * nt1 * 8 + j * 8 + 2 * tg;
        if (col >= p.hidden) continue;
#pragma unroll
        for (int m = 0; m < kMt; ++m)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const long long gr = row0 + wrow0 + m * 16 + half * 8 + g;
            if (gr < n) {
              const float2 v = __ldcg(reinterpret_cast<const float2*>(p.h + gr * p.hidden + col));
              acc[m][j][half * 2] = v.x;
              acc[m][j][half * 2 + 1] = v.y;
            }
          }
      }
    }

    if constexpr (kMode == kStatsH) {
      warp_stats<kMt>(acc, nt1, p.c1, c1lo, wn * nt1 * 8, c1n, n, row0, wm, red_mean, red_m2);
    } else {
      // w2's first chunk loads while h' is written
      stage_w<kK>(wbuf, p.w2, p.hidden, p.c2ch, 0, c2lo, c2lo + c2n, w2cols);
      cp_async_commit();
      // ---- h' = relu((x @ w1) * s1 + c1) into shared memory; 0 past hidden ----
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
        if (j >= nt1) break;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = wn * nt1 * 8 + j * 8 + 2 * tg + e;
          const bool real = col < p.hidden;
          const float s = real ? p.s1[col] : 0.f, c = real ? p.c1[col] : 0.f;
#pragma unroll
          for (int m = 0; m < kMt; ++m)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int r = wrow0 + m * 16 + half * 8 + g;
              hs[r * kHs + col] = real ? fmaxf(fmaf(acc[m][j][half * 2 + e], s, c), 0.f) : 0.f;
            }
        }
      }
      // ---- second product: h' @ w2[:, c2lo : c2lo + c2n] ----
#pragma unroll
      for (int m = 0; m < kMt; ++m)
#pragma unroll
        for (int j = 0; j < kNt; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
      for (int kc = 0; kc < nk2; ++kc) {
        const int buf = kc & 1;
        if (kc + 1 < nk2) {
          stage_w<kK>(wbuf + (buf ^ 1) * kK * kWs, p.w2, p.hidden, p.c2ch, (kc + 1) * kK, c2lo,
                      c2lo + c2n, w2cols);
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();  // h' is complete; the chunk has landed
        const int k8 = (min(kK, p.hidden - kc * kK) + 7) / 8;
        mma_chunk<kMt>(acc, hs, kHs, kc * kK, wbuf + buf * kK * kWs, k8, nt2, wrow0,
                       wn * nt2 * 8);
        __syncthreads();
      }

      if constexpr (kMode == kStatsA) {
        warp_stats<kMt>(acc, nt2, p.c2, c2lo, wn * nt2 * 8, c2n, n, row0, wm, red_mean, red_m2);
      } else {
        // ---- out = shared * sigmoid((h' @ w2) * s2 + c2) ----
        const T* __restrict__ shared = static_cast<const T*>(p.shared);
        T* __restrict__ out = static_cast<T*>(p.out);
#pragma unroll
        for (int j = 0; j < kNt; ++j) {
          if (j >= nt2) break;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = wn * nt2 * 8 + j * 8 + 2 * tg + e;
            if (col >= c2n) continue;
            const int oc = c2lo + col;
            const float s = p.s2[oc], c = p.c2[oc];
#pragma unroll
            for (int m = 0; m < kMt; ++m)
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const long long gr = row0 + wrow0 + m * 16 + half * 8 + g;
                if (gr >= n) continue;
                const float a = fmaf(acc[m][j][half * 2 + e], s, c);
                const float gate = 1.f / (1.f + expf(-a));
                const long long o = gr * p.c2ch + oc;
                out[o] = from_f32<T>(to_f32(shared[o]) * gate);
              }
          }
        }
      }
    }

    if constexpr (kMode != kGate) {
      __syncthreads();  // the warps' statistics are in red_mean / red_m2
      if (tid < stat_n) {
        for (int q = 0; q < 4; ++q) {
          const int nq = quarter_rows(n, row0, q, Tl::kWarpRows);
          if (nq == 0) break;
          chan(run_n, run_mean, run_m2, (float)nq, red_mean[q * 128 + tid], red_m2[q * 128 + tid]);
        }
      }
      // red_* are rewritten only after the next tile's product, past its barriers
    }
  }

  if constexpr (kMode != kGate) {
    __shared__ bool last_block;
    if (tid < stat_n) {
      p.partial[(2 * blockIdx.x) * stat_ch + stat_lo + tid] = run_mean;
      p.partial[(2 * blockIdx.x + 1) * stat_ch + stat_lo + tid] = run_m2;
    }
    __threadfence();  // this block's partials are visible before it reports done
    __syncthreads();
    // the task's counter: its own blocks only
    if (tid == 0) last_block = atomicAdd(p.done, 1u) == gridDim.x * gridDim.y - 1;
    __syncthreads();
    if (last_block) {
      __threadfence();
      finalize_stats(p, stat_ch, kRows, reinterpret_cast<double*>(smem));  // tiles done with it
    }
  }
}

bool shapes_ok(long long n, int cin, int hidden, int c2ch) {
  return n > 0 && cin > 0 && hidden > 0 && hidden <= kMaxHidden && hidden % 4 == 0 && c2ch > 0 &&
         c2ch <= kMaxC2 && c2ch % 4 == 0;
}

int tile_rows(long long n) { return small_n(n) ? SmallTile::kRows : BigTile::kRows; }

// blocks in x of a statistics pass, two per SM at most: they depend on N
// alone, and so does the order of the sums
int stats_blocks(long long n) {
  const long long t = num_tiles(n, tile_rows(n));
  return (int)(t < 2 * kSMs ? t : 2 * kSMs);
}

// pass 1 splits the hidden channels in two when there are fewer tiles than SMs
int hidden_split(long long n, int hidden) {
  return hidden > 64 && num_tiles(n, tile_rows(n)) < kSMs ? 2 : 1;
}

int c2_slices(int c2ch) { return (c2ch + kSliceC2 - 1) / kSliceC2; }

// pass 1 stores x @ w1 for passes 2 and 3, unless Cin is so small that
// recomputing it costs less than reading it
bool stores_h(int cin) { return cin > 16; }

template <typename T, int kMode, class Tl>
cudaError_t launch_mode(const Pass& p, dim3 grid, cudaStream_t s) {
  static bool opted_in = false;
  const size_t smem = sizeof(float) * smem_floats<Tl>(kMode);
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(gate_train_kernel<T, kMode, Tl>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  gate_train_kernel<T, kMode, Tl><<<grid, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

template <int kMode>
cudaError_t launch(const Pass& p, dim3 grid, bool bf16, bool small, cudaStream_t s) {
  if (small)
    return bf16 ? launch_mode<__nv_bfloat16, kMode, SmallTile>(p, grid, s)
                : launch_mode<float, kMode, SmallTile>(p, grid, s);
  return bf16 ? launch_mode<__nv_bfloat16, kMode, BigTile>(p, grid, s)
              : launch_mode<float, kMode, BigTile>(p, grid, s);
}

// floats of one task's scratch for n rows: x @ w1 (n, hidden) f32 where it
// is stored, the statistics passes' partials, the folded BNs
long long task_scratch_floats(long long n, int cin, int hidden, int c2ch) {
  const long long g = stats_blocks(n);
  return (stores_h(cin) ? n * hidden : 0) + g * 2 * (hidden + c2ch) + 2 * (hidden + c2ch);
}

}  // namespace

// Bytes of scratch device memory that vmtl_fused_attention_gate_train_tasks
// needs for `tasks` tasks of n rows: each task's scratch (x @ w1 where it
// is stored, the partials, the folded BNs) and two counters per task.
extern "C" long long vmtl_fused_attention_gate_train_tasks_scratch_bytes(long long n, int cin,
                                                                         int hidden, int c2ch,
                                                                         int tasks) {
  return 4 * (tasks * task_scratch_floats(n, cin, hidden, c2ch) + 2LL * tasks);
}

// Train-mode gate of T tasks: one memset and three kernels on `stream`,
// nothing allocated, no synchronisation. x (tasks, n, cin) rows, shared (n,
// c2ch) rows (every task's), out (tasks, n, c2ch) rows, all float (is_bf16
// = 0) or bf16 (is_bf16 = 1); w1 (tasks, cin, hidden), b1, scale1, bias1
// (tasks, hidden); w2 (tasks, hidden, c2ch), b2, scale2, bias2 (tasks,
// c2ch), all float, the weights 16-byte aligned. hidden and c2ch must be
// multiples of 4, hidden <= 128, c2ch <= 512, 1 <= tasks <= 65535. Writes
// out and stats = (tasks, [mean1, var1 (hidden each), mean2, var2 (c2ch
// each)]) float, biased variances clamped at 0. scratch holds
// vmtl_fused_attention_gate_train_tasks_scratch_bytes(n, cin, hidden, c2ch,
// tasks) bytes, 16-byte aligned, with any contents. Task t's results are
// bit for bit those of a call with tasks = 1 on its own x and weights.
// Returns the first CUDA error of the launches, 0 when all were queued.
extern "C" int vmtl_fused_attention_gate_train_tasks(
    const void* x, const void* shared, const void* w1, const void* b1, const void* scale1,
    const void* bias1, const void* w2, const void* b2, const void* scale2, const void* bias2,
    void* out, void* stats, void* scratch, int tasks, long long n, int cin, int hidden, int c2ch,
    float eps, int is_bf16, void* stream) {
  if (!shapes_ok(n, cin, hidden, c2ch) || tasks < 1 || tasks > 65535)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(w1) | reinterpret_cast<uintptr_t>(w2)) & 15)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int g = stats_blocks(n);
  const bool small = small_n(n);
  float* st = static_cast<float*>(stats);
  if (reinterpret_cast<uintptr_t>(scratch) & 15) return (int)cudaErrorMisalignedAddress;
  // task 0's scratch; task t's lies t * per_task floats further on
  const long long per_task = task_scratch_floats(n, cin, hidden, c2ch);
  float* f = static_cast<float*>(scratch);
  float* h = stores_h(cin) ? f : nullptr;
  if (h != nullptr) f += n * hidden;
  float* part1 = f;
  f += (long long)g * 2 * hidden;
  float* part2 = f;
  f += (long long)g * 2 * c2ch;
  float* inv1 = f;
  float* cst1 = f + hidden;
  float* inv2 = f + 2 * hidden;
  float* cst2 = f + 2 * hidden + c2ch;
  // the counters: two per task, after every task's scratch
  unsigned int* done =
      reinterpret_cast<unsigned int*>(static_cast<float*>(scratch) + tasks * per_task);
  cudaError_t err = cudaMemsetAsync(done, 0, 2 * sizeof(unsigned int) * tasks, s);
  if (err != cudaSuccess) return (int)err;

  Pass p = {};
  p.x = x;
  p.n = n;
  p.cin = cin;
  p.hidden = hidden;
  p.c2ch = c2ch;
  p.eps = eps;
  p.w1 = static_cast<const float*>(w1);
  p.w2 = static_cast<const float*>(w2);
  p.h = h;
  // a task's x rows start on a multiple of cin elements: 16-byte aligned
  // whenever the first task's are and cin fills 16 bytes
  const int per16 = is_bf16 ? 8 : 4;
  p.vec_x = cin % per16 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int slices = c2_slices(c2ch);
  p.cols2 = (c2ch / slices + 3) / 4 * 4;
  if (p.cols2 * slices < c2ch) p.cols2 += 4;
  p.cols1 = hidden;
  p.ts.x = n * cin;
  p.ts.out = n * c2ch;
  p.ts.w1 = (long long)cin * hidden;
  p.ts.w2 = (long long)hidden * c2ch;
  p.ts.h = per_task;
  p.ts.partial = per_task;
  p.ts.fold = per_task;
  p.ts.done = 2;
  p.ts.stats = 2 * (hidden + c2ch);

  // pass 1: statistics of h = x @ w1 + b1
  Pass p1 = p;
  const int split1 = hidden_split(n, hidden);
  p1.cols1 = (hidden / split1 + 3) / 4 * 4;
  p1.c1 = static_cast<const float*>(b1);
  p1.ts.c1 = hidden;
  p1.partial = part1;
  p1.done = done;
  p1.conv_bias = static_cast<const float*>(b1);
  p1.bn_scale = static_cast<const float*>(scale1);
  p1.bn_bias = static_cast<const float*>(bias1);
  p1.ts.conv_bias = p1.ts.bn_scale = p1.ts.bn_bias = hidden;
  p1.mean = st;
  p1.var = st + hidden;
  p1.fold_s = inv1;
  p1.fold_c = cst1;
  if ((err = launch<kStatsH>(p1, dim3(g, split1, tasks), is_bf16, small, s)) != cudaSuccess)
    return (int)err;

  // pass 2: statistics of a = relu(BN1(h)) @ w2 + b2
  Pass p2 = p;
  p2.s1 = inv1;
  p2.c1 = cst1;
  p2.ts.s1 = p2.ts.c1 = per_task;
  p2.c2 = static_cast<const float*>(b2);
  p2.ts.c2 = c2ch;
  p2.partial = part2;
  p2.done = done + 1;
  p2.conv_bias = static_cast<const float*>(b2);
  p2.bn_scale = static_cast<const float*>(scale2);
  p2.bn_bias = static_cast<const float*>(bias2);
  p2.ts.conv_bias = p2.ts.bn_scale = p2.ts.bn_bias = c2ch;
  p2.mean = st + 2 * hidden;
  p2.var = st + 2 * hidden + c2ch;
  p2.fold_s = inv2;
  p2.fold_c = cst2;
  if ((err = launch<kStatsA>(p2, dim3(g, slices, tasks), is_bf16, small, s)) != cudaSuccess)
    return (int)err;

  // pass 3: out = shared * sigmoid(BN2(a))
  Pass p3 = p;
  p3.shared = shared;
  p3.out = out;
  p3.s1 = inv1;
  p3.c1 = cst1;
  p3.s2 = inv2;
  p3.c2 = cst2;
  p3.ts.s1 = p3.ts.c1 = p3.ts.s2 = p3.ts.c2 = per_task;
  const long long tiles = num_tiles(n, tile_rows(n));
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return (int)launch<kGate>(p3, dim3((unsigned)tiles, slices, tasks), is_bf16, small, s);
}
