// MTAN's attention gate, written by hand for Hopper (sm_90a): the eval-mode
// gate and the three passes of the train-mode gate, from one tile body.
//
// Replaces the Pallas TPU kernels of vision_mtl_tpu/ops/pallas/fused_gate.py:
//
//   * `fused_attention_gate` (`_kernel`), eval mode. Per pixel row
//
//         out = shared * sigmoid(relu(x @ w1 + c1) @ w2 + c2)
//
//     with both BatchNorms already folded into (w1, c1) and (w2, c2) by the
//     caller.
//   * `fused_attention_gate_train` (`_stats_kernel_1`, `_stats_kernel_2`,
//     `_gate_kernel_3`), train mode, where both BNs normalise with the
//     batch's own statistics:
//       pass 1: h = x @ w1 + b1; per channel mean1 and biased var1 of h;
//       pass 2: h again, BN1 with those statistics, relu, a = h @ w2 + b2;
//               mean2 and var2 of a;
//       pass 3: the eval-mode gate with both batch-statistic BNs folded in.
//     The (N, hidden) and (N, C2) intermediates are recomputed in every
//     pass and never reach device memory, as on the TPU.
//
// x and shared are (N, Cin) and (N, C2) rows in f32 or bf16; the weights are
// f32; all arithmetic is f32, as in the Pallas kernels; out takes shared's
// type.
//
// What bounds it on an H100: the products run in f32, 2*N*(Cin*hidden +
// hidden*C2) operations per pass that runs both (pass 1 runs only the first)
// against N*(Cin + 2*C2) activation elements moved. At MTAN's shapes that is
// 33 to 56 operations per byte with f32 activations and 67 to 112 with bf16,
// above the f32 ridge of the card (67 TFLOP/s over 3.35 TB/s = 20 per byte),
// so the f32 FMA rate bounds it, not device memory.
//
// Design: 256 threads for each tile of 32 rows. The (32, hidden)
// intermediate h lives in shared memory only (on the TPU it stayed in VMEM).
// w1 is streamed over Cin in chunks of 32 rows: at Cin = 640 it is 320 KB and
// does not fit. w2 is streamed in chunks that fill a 16 KB buffer. Every
// thread owns 4x4 register micro-tiles, so each shared-memory load feeds
// four FMAs. A per-channel scale (the folded BN's 1/std) multiplies each
// weight chunk as it is staged, so the train passes fold nothing in device
// memory. Plain SIMT f32 code: tensor cores (wgmma) and TMA are later work.
//
// Statistics. On the TPU the grid ran in order and carried a (2, C) sum from
// tile to tile. Blocks here run in parallel, so a statistics pass launches at
// most kStatsBlocks blocks, each walking its tiles in a fixed order. Each
// thread reduces its 4-row groups to a mean and a sum of squared deviations
// (M2); the block folds its groups, in order, into a running (mean, M2) per
// channel by Chan's pairwise update, in f32. The last block to finish
// combines the blocks' partials in f64, in block order. No floating-point
// atomic decides an order, so two launches on the same inputs give the same
// bits; and no E[h^2] - E[h]^2 is ever formed, which in f32 over 262,144 rows
// loses the variance of a channel whose mean is large against its spread.
// The last block also writes the next pass's folded BN: scale
// inv = gamma / sqrt(var + eps) and constant (bias_conv - mean) * inv + beta,
// fold_bn of the JAX package.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;                // pixel rows per tile
constexpr int kRowsPad = kRows + 4;      // transposed tiles: rows stay 16 B aligned
constexpr int kChunkK = 32;              // rows of w1 (input channels) per chunk
constexpr int kWBuf = 4096;              // floats in the weight-chunk buffer (16 KB)
constexpr int kMaxHidden = 128;
constexpr int kMaxC2 = 512;
constexpr int kGroups = kRows / 4;       // 4-row groups of a tile
// 4x4 micro-tiles of the (32, C2) output a thread owns, at most
constexpr int kMaxTiles = kGroups * (kMaxC2 / 4) / kThreads;
// blocks of a statistics pass, at most: two per SM of an H100. Fixed, so the
// order of the sums depends on N alone.
constexpr int kStatsBlocks = 2 * 132;

// kGate: out = shared * sigmoid(...). kStatsH: statistics of h = x @ w1 + c1
// (no relu, no second product). kStatsA: statistics of
// a = relu(x @ w1 + c1) @ w2 + c2.
enum Mode { kGate, kStatsH, kStatsA };

struct Pass {
  const void* x;
  const void* shared;
  void* out;
  // h = x @ (w1 * s1) + c1 and a = h' @ (w2 * s2) + c2, per column; a null
  // scale is 1
  const float* w1;
  const float* s1;
  const float* c1;
  const float* w2;
  const float* s2;
  const float* c2;
  long long n;
  int cin, hidden, c2ch;
  // statistics passes only
  float* partial;           // (gridDim.x, 2, C): each block's mean and M2
  unsigned int* done;       // blocks finished, zero before the launch
  const float* conv_bias;   // (C,) the bias inside the statistics (b1 or b2)
  const float* bn_scale;    // (C,) BN gamma
  const float* bn_bias;     // (C,) BN beta
  float eps;
  float* mean;              // (C,) batch mean
  float* var;               // (C,) biased batch variance, clamped at 0
  float* fold_s;            // (C,) folded BN for the next passes: scale
  float* fold_c;            // (C,) and constant
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ void fma4x4(float (&acc)[4][4], const float4 a, const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
}

// Copies `count` weights (rows of `cols` columns) into shared memory,
// each multiplied by its column's scale when `scale` is not null. The
// column is carried from one element to the next, not recomputed by a
// modulo.
__device__ __forceinline__ void stage_chunk(float* __restrict__ dst, const float* __restrict__ src,
                                            const float* __restrict__ scale, int count, int cols) {
  if (scale == nullptr) {
    for (int i = threadIdx.x; i < count; i += kThreads) dst[i] = src[i];
    return;
  }
  const int step = kThreads % cols;
  int col = threadIdx.x % cols;
  for (int i = threadIdx.x; i < count; i += kThreads) {
    dst[i] = src[i] * scale[col];
    col += step;
    if (col >= cols) col -= cols;
  }
}

// Valid rows (0..4) of the 4-row group that starts `first` rows into the data.
__device__ __forceinline__ int group_rows(long long n, long long first) {
  const long long left = n - first;
  return left <= 0 ? 0 : (left >= 4 ? 4 : (int)left);
}

// Rows a statistics block walks: tiles b, b + g, b + 2g, ... of `tiles`.
__device__ __forceinline__ long long block_rows(long long n, long long tiles, int g, int b) {
  const long long count = (tiles - 1 - b) / g + 1;
  const long long short_by = ((tiles - 1) % g == b) ? tiles * kRows - n : 0;
  return count * kRows - short_by;
}

// One micro-tile's columns: mean and M2 of the valid rows of its 4-row
// group, into gmean / gm2 at [group][column].
__device__ __forceinline__ void group_stats(const float (&v)[4][4], int nv, int tr, int col0,
                                            int ch, float* gmean, float* gm2) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r) s += r < nv ? v[r][c] : 0.f;
    const float mean = nv ? s / nv : 0.f;
    float m2 = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float d = v[r][c] - mean;
      m2 += r < nv ? d * d : 0.f;
    }
    gmean[tr * ch + col0 + c] = mean;
    gm2[tr * ch + col0 + c] = m2;
  }
}

// Folds a tile's groups, in order, into the block's running (mean, M2) per
// channel; `seen` rows were folded before, `left` = n - the tile's first row.
// Each channel stays with one thread for the whole launch.
__device__ __forceinline__ void fold_groups(const float* gmean, const float* gm2, float* run_mean,
                                            float* run_m2, long long seen, long long left, int ch) {
  for (int c = threadIdx.x; c < ch; c += kThreads) {
    float mean = run_mean[c], m2 = run_m2[c];
    float na = (float)seen;
    for (int g = 0; g < kGroups; ++g) {
      const int nv = group_rows(left, 4LL * g);
      if (nv == 0) break;
      const float nb = (float)nv, nab = na + nb;
      const float d = gmean[g * ch + c] - mean;
      mean += d * (nb / nab);
      m2 += gm2[g * ch + c] + d * d * (na * nb / nab);
      na = nab;
    }
    run_mean[c] = mean;
    run_m2[c] = m2;
  }
}

// The last block of a statistics pass: the blocks' partials combined in f64
// in block order, the statistics and the next passes' folded BN written out.
__device__ void finalize_stats(const Pass& p, int ch) {
  const long long tiles = (p.n + kRows - 1) / kRows;
  const int g = gridDim.x;
  const double n = (double)p.n;
  for (int c = threadIdx.x; c < ch; c += kThreads) {
    double sum = 0.0;
    for (int b = 0; b < g; ++b)
      sum += (double)block_rows(p.n, tiles, g, b) * (double)__ldcg(&p.partial[(2 * b) * ch + c]);
    const double mean = sum / n;
    double m2 = 0.0;
    for (int b = 0; b < g; ++b) {
      const double d = (double)__ldcg(&p.partial[(2 * b) * ch + c]) - mean;
      m2 += (double)__ldcg(&p.partial[(2 * b + 1) * ch + c]) +
            (double)block_rows(p.n, tiles, g, b) * d * d;
    }
    const float mean_f = (float)mean;
    const float var_f = fmaxf((float)(m2 / n), 0.f);
    p.mean[c] = mean_f;
    p.var[c] = var_f;
    const float inv = p.bn_scale[c] / sqrtf(var_f + p.eps);
    p.fold_s[c] = inv;
    p.fold_c[c] = (p.conv_bias[c] - mean_f) * inv + p.bn_bias[c];
  }
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads) gate_kernel(const Pass p) {
  __shared__ __align__(16) float xs[kChunkK * kRowsPad];     // x chunk, [k][row]
  __shared__ __align__(16) float ws[kWBuf];                  // w1 or w2 chunk, [k][col]
  __shared__ __align__(16) float hs[kMaxHidden * kRowsPad];  // h, [j][row]
  __shared__ float run_mean[kMode == kGate ? 1 : kMaxC2];    // block's running statistics
  __shared__ float run_m2[kMode == kGate ? 1 : kMaxC2];
  __shared__ bool last_block;

  const T* __restrict__ x = static_cast<const T*>(p.x);
  const int tid = threadIdx.x;
  const long long n = p.n;
  const int cin = p.cin, hidden = p.hidden, c2ch = p.c2ch;
  const int stat_ch = kMode == kStatsH ? hidden : c2ch;
  const long long tiles = (n + kRows - 1) / kRows;
  if (kMode != kGate) {
    for (int c = tid; c < stat_ch; c += kThreads) run_mean[c] = run_m2[c] = 0.f;
  }
  long long seen = 0;  // rows folded into the running statistics

  const int h4 = hidden / 4;
  const bool own1 = tid < kGroups * h4;  // hidden <= 128: one micro-tile a thread
  const int tr1 = own1 ? tid / h4 : 0;
  const int tc1 = own1 ? tid % h4 : 0;
  const int c4 = c2ch / 4;
  const int tiles2 = kGroups * c4;
  const int jc = min(hidden, kWBuf / c2ch);

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * kRows;

    // ---- h = x @ (w1 * s1) + c1 ----
    float acc1[4][4] = {};
    for (int k0 = 0; k0 < cin; k0 += kChunkK) {
      const int kc = min(kChunkK, cin - k0);
      __syncthreads();  // the previous chunk (or tile) has been consumed
      for (int i = tid; i < kRows * kChunkK; i += kThreads) {
        const int r = i / kChunkK, k = i % kChunkK;
        const long long gr = row0 + r;
        xs[k * kRowsPad + r] = (gr < n && k < kc) ? to_f32(x[gr * cin + k0 + k]) : 0.f;
      }
      stage_chunk(ws, p.w1 + (long long)k0 * hidden, p.s1, kc * hidden, hidden);
      __syncthreads();
      if (own1) {
        for (int k = 0; k < kc; ++k) {
          const float4 xv = *reinterpret_cast<const float4*>(&xs[k * kRowsPad + tr1 * 4]);
          const float4 wv = *reinterpret_cast<const float4*>(&ws[k * hidden + tc1 * 4]);
          fma4x4(acc1, xv, wv);
        }
      }
    }
    if (own1) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float b = p.c1[tc1 * 4 + c];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc1[r][c] += b;
      }
    }

    if constexpr (kMode == kStatsH) {
      __syncthreads();  // the last w1 chunk has been consumed: ws, hs take the groups
      if (own1) group_stats(acc1, group_rows(n, row0 + tr1 * 4), tr1, tc1 * 4, hidden, ws, hs);
      __syncthreads();
      fold_groups(ws, hs, run_mean, run_m2, seen, n - row0, hidden);
      seen += min((long long)kRows, n - row0);
      continue;
    }

    // ---- h' = relu(h), kept in shared memory; a = h' @ (w2 * s2) + c2 ----
    if (own1) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float4 v = make_float4(fmaxf(acc1[0][c], 0.f), fmaxf(acc1[1][c], 0.f),
                                     fmaxf(acc1[2][c], 0.f), fmaxf(acc1[3][c], 0.f));
        *reinterpret_cast<float4*>(&hs[(tc1 * 4 + c) * kRowsPad + tr1 * 4]) = v;
      }
    }
    float acc2[kMaxTiles][4][4] = {};
    for (int j0 = 0; j0 < hidden; j0 += jc) {
      const int jn = min(jc, hidden - j0);
      __syncthreads();  // hs is complete; the previous w2 chunk has been consumed
      stage_chunk(ws, p.w2 + (long long)j0 * c2ch, p.s2, jn * c2ch, c2ch);
      __syncthreads();
#pragma unroll
      for (int m = 0; m < kMaxTiles; ++m) {
        const int t = tid + m * kThreads;
        if (t < tiles2) {
          const int tr = t / c4, tc = t % c4;
          for (int j = 0; j < jn; ++j) {
            const float4 hv = *reinterpret_cast<const float4*>(&hs[(j0 + j) * kRowsPad + tr * 4]);
            const float4 wv = *reinterpret_cast<const float4*>(&ws[j * c2ch + tc * 4]);
            fma4x4(acc2[m], hv, wv);
          }
        }
      }
    }

    if constexpr (kMode == kStatsA) {
      __syncthreads();  // the second product is done with ws and hs
#pragma unroll
      for (int m = 0; m < kMaxTiles; ++m) {
        const int t = tid + m * kThreads;
        if (t >= tiles2) continue;
        const int tr = t / c4, tc = t % c4;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float b = p.c2[tc * 4 + c];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc2[m][r][c] += b;
        }
        group_stats(acc2[m], group_rows(n, row0 + tr * 4), tr, tc * 4, c2ch, ws, hs);
      }
      __syncthreads();
      fold_groups(ws, hs, run_mean, run_m2, seen, n - row0, c2ch);
      seen += min((long long)kRows, n - row0);
      continue;
    }

    // ---- out = shared * sigmoid(a) ----
    const T* __restrict__ shared = static_cast<const T*>(p.shared);
    T* __restrict__ out = static_cast<T*>(p.out);
#pragma unroll
    for (int m = 0; m < kMaxTiles; ++m) {
      const int t = tid + m * kThreads;
      if (t >= tiles2) continue;
      const int tr = t / c4, tc = t % c4;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const long long gr = row0 + tr * 4 + r;
        if (gr >= n) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = tc * 4 + c;
          const float a = acc2[m][r][c] + p.c2[col];
          const float gate = 1.f / (1.f + expf(-a));
          const long long o = gr * c2ch + col;
          out[o] = from_f32<T>(to_f32(shared[o]) * gate);
        }
      }
    }
  }

  if constexpr (kMode != kGate) {
    for (int c = tid; c < stat_ch; c += kThreads) {
      p.partial[(2 * blockIdx.x) * stat_ch + c] = run_mean[c];
      p.partial[(2 * blockIdx.x + 1) * stat_ch + c] = run_m2[c];
    }
    __threadfence();  // this block's partials are visible before it reports done
    __syncthreads();
    if (tid == 0) last_block = atomicAdd(p.done, 1u) == gridDim.x - 1;
    __syncthreads();
    if (last_block) {
      __threadfence();
      finalize_stats(p, stat_ch);
    }
  }
}

bool shapes_ok(long long n, int cin, int hidden, int c2ch) {
  return n > 0 && cin > 0 && hidden > 0 && hidden <= kMaxHidden && hidden % 4 == 0 && c2ch > 0 &&
         c2ch <= kMaxC2 && c2ch % 4 == 0;
}

long long num_tiles(long long n) { return (n + kRows - 1) / kRows; }

int stats_blocks(long long n) {
  return (int)(num_tiles(n) < kStatsBlocks ? num_tiles(n) : kStatsBlocks);
}

template <int kMode>
void launch(const Pass& p, unsigned grid, bool bf16, cudaStream_t s) {
  if (bf16)
    gate_kernel<__nv_bfloat16, kMode><<<grid, kThreads, 0, s>>>(p);
  else
    gate_kernel<float, kMode><<<grid, kThreads, 0, s>>>(p);
}

}  // namespace

// Eval-mode gate. Returns cudaGetLastError() after the launch: 0 when the
// kernel was queued. x, shared, out: (n, cin), (n, c2ch), (n, c2ch) rows of
// float (is_bf16 = 0) or bf16 (is_bf16 = 1); w1 (cin, hidden), c1 (hidden),
// w2 (hidden, c2ch), c2 (c2ch) float. hidden and c2ch must be multiples of
// 4, hidden <= 128, c2ch <= 512. Runs on `stream`, allocates nothing and does
// not synchronise.
extern "C" int vmtl_fused_attention_gate(const void* x, const void* shared, const void* w1,
                                         const void* c1, const void* w2, const void* c2,
                                         void* out, long long n, int cin, int hidden, int c2ch,
                                         int is_bf16, void* stream) {
  if (!shapes_ok(n, cin, hidden, c2ch)) return (int)cudaErrorInvalidValue;
  Pass p = {};
  p.x = x;
  p.shared = shared;
  p.out = out;
  p.w1 = static_cast<const float*>(w1);
  p.c1 = static_cast<const float*>(c1);
  p.w2 = static_cast<const float*>(w2);
  p.c2 = static_cast<const float*>(c2);
  p.n = n;
  p.cin = cin;
  p.hidden = hidden;
  p.c2ch = c2ch;
  launch<kGate>(p, (unsigned)num_tiles(n), is_bf16, reinterpret_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// Bytes of scratch device memory that vmtl_fused_attention_gate_train needs
// for n rows: the statistics passes' partials, the folded BNs and two
// counters.
extern "C" long long vmtl_fused_attention_gate_train_scratch_bytes(long long n, int hidden,
                                                                   int c2ch) {
  const long long g = stats_blocks(n);
  return 4 * (g * 2 * (hidden + c2ch) + 2 * (hidden + c2ch) + 2);
}

// Train-mode gate: three passes on `stream`, nothing allocated, no
// synchronisation. Inputs as for the eval gate, but unfolded: w1 (cin,
// hidden), b1, scale1, bias1 (hidden); w2 (hidden, c2ch), b2, scale2, bias2
// (c2ch), all float. Writes out (n, c2ch) and stats = [mean1, var1 (hidden
// each), mean2, var2 (c2ch each)] float, biased variances clamped at 0.
// scratch holds vmtl_fused_attention_gate_train_scratch_bytes(n, hidden,
// c2ch) bytes, 4-byte aligned, with any contents. Returns the first CUDA
// error of the launches, 0 when all were queued.
extern "C" int vmtl_fused_attention_gate_train(
    const void* x, const void* shared, const void* w1, const void* b1, const void* scale1,
    const void* bias1, const void* w2, const void* b2, const void* scale2, const void* bias2,
    void* out, void* stats, void* scratch, long long n, int cin, int hidden, int c2ch, float eps,
    int is_bf16, void* stream) {
  if (!shapes_ok(n, cin, hidden, c2ch)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int g = stats_blocks(n);
  float* st = static_cast<float*>(stats);
  float* f = static_cast<float*>(scratch);
  float* part1 = f;
  f += (long long)g * 2 * hidden;
  float* part2 = f;
  f += (long long)g * 2 * c2ch;
  float* inv1 = f;
  float* cst1 = f + hidden;
  float* inv2 = f + 2 * hidden;
  float* cst2 = f + 2 * hidden + c2ch;
  unsigned int* done = reinterpret_cast<unsigned int*>(f + 2 * (hidden + c2ch));
  cudaError_t err = cudaMemsetAsync(done, 0, 2 * sizeof(unsigned int), s);
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

  // pass 1: statistics of h = x @ w1 + b1
  Pass p1 = p;
  p1.c1 = static_cast<const float*>(b1);
  p1.partial = part1;
  p1.done = done;
  p1.conv_bias = static_cast<const float*>(b1);
  p1.bn_scale = static_cast<const float*>(scale1);
  p1.bn_bias = static_cast<const float*>(bias1);
  p1.mean = st;
  p1.var = st + hidden;
  p1.fold_s = inv1;
  p1.fold_c = cst1;
  launch<kStatsH>(p1, (unsigned)g, is_bf16, s);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  // pass 2: statistics of a = relu(BN1(h)) @ w2 + b2
  Pass p2 = p;
  p2.s1 = inv1;
  p2.c1 = cst1;
  p2.c2 = static_cast<const float*>(b2);
  p2.partial = part2;
  p2.done = done + 1;
  p2.conv_bias = static_cast<const float*>(b2);
  p2.bn_scale = static_cast<const float*>(scale2);
  p2.bn_bias = static_cast<const float*>(bias2);
  p2.mean = st + 2 * hidden;
  p2.var = st + 2 * hidden + c2ch;
  p2.fold_s = inv2;
  p2.fold_c = cst2;
  launch<kStatsA>(p2, (unsigned)g, is_bf16, s);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  // pass 3: out = shared * sigmoid(BN2(a))
  Pass p3 = p;
  p3.shared = shared;
  p3.out = out;
  p3.s1 = inv1;
  p3.c1 = cst1;
  p3.s2 = inv2;
  p3.c2 = cst2;
  launch<kGate>(p3, (unsigned)num_tiles(n), is_bf16, s);
  return (int)cudaGetLastError();
}
