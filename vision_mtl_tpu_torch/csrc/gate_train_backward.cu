// The gradient of MTAN's train-mode attention gate, written by hand for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package differentiates the gate chain
// with XLA. It replaces the PyTorch ops of the port's autograd backward
// (kernels/fused_gate_train._gate_backward, which stays as the plain
// version), about 40 a gate, many of them full passes over f32 (N, hidden)
// and (N, C2) tensors. The chain, BN1 and BN2 with batch statistics:
//
//   h = x w1 + b1; h^ = (h - m1) r1; r = relu(h^ g1 + be1)
//   a = r w2 + b2; a^ = (a - m2) r2; attn = sigmoid(a^ g2 + be2); out = shared attn
//
// (r1, r2 = 1 / sqrt(var + eps)) gives ten gradients. A BatchNorm's
// gradient needs two sums over every row of its output's gradient, so the
// work runs as three passes over row tiles with those sums between them:
//
//   pass A: h, r, a, attn from the saved inputs and statistics; dshared =
//           dout attn; dz2 = dout shared attn (1 - attn); per C2 channel
//           the sums of dz2 and dz2 a^ (dbias2, dscale2). Keeps x w1, dz2
//           and a^ in scratch memory.
//   pass B: da = r2 g2 (dz2 - sum(dz2) / N - a^ sum(dz2 a^) / N), written
//           over dz2; db2 = sum(da); dr = (da w2^T) [h^ g1 + be1 > 0]; per
//           hidden channel the sums of dr and dr h^ (dbias1, dscale1).
//   weights 2: dw2 = r^T da, r from the kept x w1.
//   pass C: dr again from da; dh = r1 g1 (dr - sum(dr) / N - h^ sum(dr h^)
//           / N), written over x w1; db1 = sum(dh); dx = dh w1^T.
//   weights 1: dw1 = x^T dh.
//
// Products in f32 accuracy on the tensor cores, 3xTF32 as the forward's
// (csrc/gate_tile.cuh: its tile body, cp.async staging and TF32 split):
// two TF32 products where one operand is bf16 (x w1 and x^T dh at bf16
// activations), three otherwise. One TF32 product, or a bf16 one, would
// not hold the gradients to f32's limits.
//
// What bounds it on an H100. The least work reads x, shared and dout once
// and writes dx and dshared once (at MTAN's batch 32, bf16, both tasks:
// 4.2 GB a step, 1.25 ms at 3.35 TB/s), and takes the products x w1, r w2,
// da w2^T, dh w1^T, r^T da and x^T dh once each; at 3xTF32 these are
// 2 N (7 Cin hidden + 9 hidden C2) operations at bf16 x (9 Cin hidden at
// f32), 1.79 TFLOP a step there, 3.6 ms at the 495 TFLOP/s TF32 rate: the
// products bound it. The three passes move more than the least: x w1 (N, hidden) f32 and dz2, a^ (N, C2) f32 are written once and
// read back instead of recomputed (cheaper than their products at the rate
// mma.sync reaches, about a tenth of the TF32 peak in the forward), and
// the weight gradients are row reductions over all N, run as split-K
// products on the kept tiles (weights 1 and 2), whose partial sums are
// folded in a fixed order. Design against that bound:
//   * row passes: 256 threads a block, 128-row tiles (64 at small N) as
//     the forward's, at most 2 blocks an SM (264 at most), each walking
//     tiles b, b + g, b + 2g, ... in a fixed order; the weight chunk is
//     double-buffered with cp.async, the A operand of each product (x, r,
//     da, dh) sits in shared memory;
//   * C2 and Cin wider than 128 are taken 128 columns at a time inside the
//     block, so a row tile is read once per pass;
//   * weight gradients: blocks of 128 x 128 outputs over row ranges (split
//     K), 32 rows a stage and three in flight, A read transposed from a
//     row-major tile and staged only as wide as the block's outputs.
//
// Deterministic sums. Each block sums its tiles' columns in a fixed order
// (a warp's rows by a butterfly, then the four row warps in order, or a
// thread per column down the tile) into per-block partials; the last block
// of the pass to finish adds the partials in block order in f64. The
// weight gradients' split partials are added in split order in f64. No
// floating-point atomic decides an order: two launches on the same inputs
// give the same bits, and each task's bits under the task axis (T on
// blockIdx.z, its own scratch and counters) equal its own T = 1 call.
// dshared is every task's gate's: above T = 1 each task writes its part in
// f32 and a last launch adds them in task order.
//
// Ranks. Under data parallelism the BN sums are over every rank's rows.
// The staged entry (vmtl_gate_train_backward_stage) stops after pass A and
// after pass B: the pass's last block writes its f64 sums, which the caller
// all-reduces and hands to a fold stage; the fused call's last block runs
// the same fold. With one rank the staged call is bit for bit the fused one.

#include "gate_tile.cuh"

namespace {

using namespace gate_tile;

constexpr int kMaxHidden = 128;
constexpr int kMaxC2 = 512;
constexpr int kCols = 128;      // columns of C2 (or Cin) a row pass takes at a time
constexpr int kCs = kCols + 4;  // row pitch of a tile of those columns in shared memory
constexpr int kCounters = 3;    // per task: passes A, B and C's finished blocks

enum Pass { kPassA, kPassB, kPassC };
enum Sums { kFoldA, kFoldB, kWeights1, kWeights2 };

// The weight gradients' stage: 32 rows of up to 128 columns of the A operand
// (x, or x w1), read transposed.
struct RowStage {
  static constexpr int kRows = 32;
  static constexpr int kXs = 136;   // f32 pitch: (8 k + m) spans the banks when read transposed
  static constexpr int kXsB = 136;  // bf16 pitch (elements): 16-byte rows, (4 k + m / 2) the same
};

struct Bwd {
  // inputs of task 0; task t's lie t times a task's size further on
  const void* dout;    // (n, c2) T
  const void* x;       // (n, cin) T
  const void* shared;  // (n, c2) T, every task's
  const float *w1, *b1, *scale1, *bias1, *w2, *b2, *scale2, *bias2;
  const float *m1, *v1, *m2, *v2;  // the forward's batch statistics
  // outputs
  void* dx;            // (n, cin) T
  void* dshared;       // (n, c2) T, when tasks == 1
  float *dw1, *db1, *dscale1, *dbias1, *dw2, *db2, *dscale2, *dbias2;
  float* dshared_f32;  // (tasks, n, c2) each task's part, when tasks > 1
  // a task's scratch (per_task floats, task t at t * per_task)
  float* h;            // (n, hidden) x w1, then dh
  float* dz;           // (n, c2) dz2, then da
  float* ahat;         // (n, c2) a^
  float* w1t;          // (hidden, cin_ld) w1^T, zero past cin
  float* w2t;          // (c2, hidden) w2^T
  float* col1;         // 6 x (hidden): BN1's folds, below
  float* col2;         // 6 x (c2): BN2's
  float* part_a;       // (blocks, 2, c2)
  float* part_b;       // (blocks, 2 hidden + c2)
  float* part_c;       // (blocks, hidden)
  float* wpart1;       // (splits1, cin, hidden)
  float* wpart2;       // (splits2, hidden, c2)
  unsigned int* done;  // kCounters per task, after every task's scratch
  double* local;       // staged calls: (tasks, 2, C) f64 sums; null in the fused call
  double n_total;      // rows of every rank
  long long n, per_task;
  float eps;
  int tasks, cin, hidden, c2ch, cin_ld, vec_x;
  int pairs;           // dout and shared hold two elements in one aligned load
};

// The columns' folds, 6 arrays of C each: s = g r and c = (b - m) s + be
// (z = raw s + c, raw the product without its bias; the forward's fold to
// the bit), u = r and v = (b - m) r (z^ = raw u + v), and, once the pass's
// sums are in, q = -s sum(dy z^) / N and o = -s sum(dy) / N (the BN's
// gradient dz = s dy + q z^ + o).
enum Fold { kS, kC, kU, kV, kQ, kO };

template <typename T>
__device__ __forceinline__ Bwd at_task(Bwd p, int t) {
  const long long n = p.n, nh = (long long)p.hidden, nc = (long long)p.c2ch;
  p.dout = static_cast<const T*>(p.dout) + t * n * nc;
  p.x = static_cast<const T*>(p.x) + t * n * p.cin;
  p.w1 += t * p.cin * nh;
  p.w2 += t * nh * nc;
  p.b1 += t * nh;
  p.scale1 += t * nh;
  p.bias1 += t * nh;
  p.m1 += t * nh;
  p.v1 += t * nh;
  p.b2 += t * nc;
  p.scale2 += t * nc;
  p.bias2 += t * nc;
  p.m2 += t * nc;
  p.v2 += t * nc;
  p.dx = static_cast<T*>(p.dx) + t * n * p.cin;
  p.dw1 += t * p.cin * nh;
  p.db1 += t * nh;
  p.dscale1 += t * nh;
  p.dbias1 += t * nh;
  p.dw2 += t * nh * nc;
  p.db2 += t * nc;
  p.dscale2 += t * nc;
  p.dbias2 += t * nc;
  if (p.dshared_f32 != nullptr) p.dshared_f32 += t * n * nc;
  const long long s = t * p.per_task;
  p.h += s;
  p.dz += s;
  p.ahat += s;
  p.w1t += s;
  p.w2t += s;
  p.col1 += s;
  p.col2 += s;
  p.part_a += s;
  p.part_b += s;
  p.part_c += s;
  p.wpart1 += s;
  p.wpart2 += s;
  p.done += t * kCounters;
  return p;
}

__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Sums of a warp's two values a lane (rows of the lane's column) over the
// lanes of the same column, in a fixed butterfly; lane g == 0 holds them.
__device__ __forceinline__ float column_sum(float v) {
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Rows a row-pass block walks: tiles b, b + g, ... of `tiles`.
int row_blocks(long long n) {
  const long long t = num_tiles(n, small_n(n) ? SmallTile::kRows : BigTile::kRows);
  return (int)(t < 2 * kSMs ? t : 2 * kSMs);
}

template <class Tl>
__host__ __device__ constexpr int tile_floats() {
  return 2 * Tl::kRows * Tl::kXs > Tl::kRows * kCs ? 2 * Tl::kRows * Tl::kXs : Tl::kRows * kCs;
}
// weight stages (two), the row tile (x stages, or r, da, dh), the warps'
// column sums (two sums x 4 row warps x 128), the block's running sums (at
// most two of C2's)
template <class Tl>
__host__ __device__ constexpr int pass_smem_floats() {
  return 2 * Tl::kChunk * kWs + tile_floats<Tl>() + 2 * 4 * 128 + 2 * kMaxC2;
}

// The BN fold of column c once its two sums are known: q and o.
__device__ __forceinline__ void bn_grad_fold(float* col, int ch, int c, double sum_dy,
                                             double sum_dy_z, double n_total) {
  const double s = (double)col[kS * ch + c];
  col[kQ * ch + c] = (float)(-s * sum_dy_z / n_total);
  col[kO * ch + c] = (float)(-s * sum_dy / n_total);
}

// Column c's sum over the row-pass blocks' partials (block b's at
// part[b * stride + c]), in block order, in f64.
__device__ __forceinline__ double blocks_sum(const float* part, int blocks, int stride, int c) {
  double s = 0.0;
#pragma unroll 8
  for (int b = 0; b < blocks; ++b) s += (double)__ldcg(&part[(long long)b * stride + c]);
  return s;
}

// The last block of a row pass: the blocks' partials added and the pass's
// outputs written; in a staged call the two BN sums go to `local` for the
// caller, otherwise the next pass's fold is made here.
template <int kPass>
__device__ void finish_pass(const Bwd& p, int blocks, double* local) {
  const int H = p.hidden, C = p.c2ch;
  if constexpr (kPass == kPassA) {
    for (int c = threadIdx.x; c < C; c += kThreads) {
      const double s0 = blocks_sum(p.part_a, blocks, 2 * C, c);
      const double s1 = blocks_sum(p.part_a, blocks, 2 * C, C + c);
      p.dbias2[c] = (float)s0;
      p.dscale2[c] = (float)s1;
      if (local != nullptr) {
        local[c] = s0;
        local[C + c] = s1;
      } else {
        bn_grad_fold(p.col2, C, c, s0, s1, p.n_total);
      }
    }
  } else if constexpr (kPass == kPassB) {
    const int stride = 2 * H + C;
    for (int c = threadIdx.x; c < H; c += kThreads) {
      const double s0 = blocks_sum(p.part_b, blocks, stride, c);
      const double s1 = blocks_sum(p.part_b, blocks, stride, H + c);
      p.dbias1[c] = (float)s0;
      p.dscale1[c] = (float)s1;
      if (local != nullptr) {
        local[c] = s0;
        local[H + c] = s1;
      } else {
        bn_grad_fold(p.col1, H, c, s0, s1, p.n_total);
      }
    }
    for (int c = threadIdx.x; c < C; c += kThreads)
      p.db2[c] = (float)blocks_sum(p.part_b, blocks, stride, 2 * H + c);
  } else {
    for (int c = threadIdx.x; c < H; c += kThreads)
      p.db1[c] = (float)blocks_sum(p.part_c, blocks, H, c);
  }
}

// Fills the row tile [kRows][kCs] with da for C2 columns [c0, c0 + cn) of
// rows row0...: from dz2 and a^ (pass B, which writes da over dz2) or from
// da (pass C); zero past n and from cn to the next multiple of 8.
template <int kPass, int kRows>
__device__ __forceinline__ void fill_da(const Bwd& p, float* tile, long long row0, int c0, int cn) {
  constexpr int kBatch = 4;        // a thread's loads in flight together
  const int q = (cn + 7) / 8 * 2;  // float4 groups a row, cn rounded up to 8
  const int C = p.c2ch;
  for (int i0 = threadIdx.x; i0 < kRows * q; i0 += kBatch * kThreads) {
    float4 v[kBatch], ah[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * kThreads, r = i / q, c4 = (i - r * q) * 4;
      v[b] = ah[b] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < kRows * q && row0 + r < p.n && c4 < cn) {
        const long long o = (row0 + r) * C + c0 + c4;
        v[b] = __ldcg(reinterpret_cast<const float4*>(p.dz + o));
        if constexpr (kPass == kPassB) ah[b] = __ldcg(reinterpret_cast<const float4*>(p.ahat + o));
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * kThreads, r = i / q, c4 = (i - r * q) * 4;
      if (i >= kRows * q) break;
      if constexpr (kPass == kPassB) {
        if (row0 + r < p.n && c4 < cn) {
          const int c = c0 + c4;
          const float4 s = *reinterpret_cast<const float4*>(p.col2 + kS * C + c);
          const float4 qq = *reinterpret_cast<const float4*>(p.col2 + kQ * C + c);
          const float4 o = *reinterpret_cast<const float4*>(p.col2 + kO * C + c);
          v[b].x = fmaf(s.x, v[b].x, fmaf(qq.x, ah[b].x, o.x));
          v[b].y = fmaf(s.y, v[b].y, fmaf(qq.y, ah[b].y, o.y));
          v[b].z = fmaf(s.z, v[b].z, fmaf(qq.z, ah[b].z, o.z));
          v[b].w = fmaf(s.w, v[b].w, fmaf(qq.w, ah[b].w, o.w));
          __stcg(reinterpret_cast<float4*>(p.dz + (row0 + r) * C + c), v[b]);
        }
      }
      *reinterpret_cast<float4*>(tile + r * kCs + c4) = v[b];
    }
  }
}

// acc += tile[:, 0:cn] @ wt[c0 : c0 + cn, 0 : cols]: the row tile (kCs
// pitch) against a transposed weight (rows of ld floats), its chunks
// double-buffered. The tile is complete before the first product.
template <class Tl, int kMt>
__device__ __forceinline__ void tile_product(float (&acc)[kMt][kNt][4], const float* tile,
                                             float* wbuf, const float* wt, int k_rows, int ld,
                                             int c0, int cn, int col0, int cols, int nt) {
  constexpr int kK = Tl::kChunk;
  const int wrow0 = ((threadIdx.x >> 5) & 3) * Tl::kWarpRows;
  const int wn = threadIdx.x >> 7;
  const int staged = (cols + 15) / 16 * 16;
  const int nk = (cn + kK - 1) / kK;
  stage_w<kK>(wbuf, wt, k_rows, ld, c0, col0, col0 + cols, staged);
  cp_async_commit();
  for (int kc = 0; kc < nk; ++kc) {
    const int buf = kc & 1;
    if (kc + 1 < nk) {
      stage_w<kK>(wbuf + (buf ^ 1) * kK * kWs, wt, k_rows, ld, c0 + (kc + 1) * kK, col0,
                  col0 + cols, staged);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k8 = (min(kK, cn - kc * kK) + 7) / 8;
    mma_chunk<kMt>(acc, tile, kCs, kc * kK, wbuf + buf * kK * kWs, k8, nt, wrow0, wn * nt * 8);
    __syncthreads();
  }
}

template <int kMt>
__device__ __forceinline__ void zero(float (&acc)[kMt][kNt][4]) {
#pragma unroll
  for (int m = 0; m < kMt; ++m)
#pragma unroll
    for (int j = 0; j < kNt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
}

// Adds the warps' column sums red[k][4][128] (k < nsum) into run[k * stride
// + c0 + c] for c < cols, the four row warps in order.
__device__ __forceinline__ void add_warp_sums(const float* red, float* run, int nsum, int stride,
                                              int c0, int cols) {
  __syncthreads();
  for (int i = threadIdx.x; i < nsum * cols; i += kThreads) {
    const int k = i / cols, c = i - k * cols;
    const float* r = red + k * 512 + c;
    run[k * stride + c0 + c] += ((r[0] + r[128]) + r[256]) + r[384];
  }
  __syncthreads();
}

// Pass A, B or C of the gradient (see the head of the file) for task
// blockIdx.z, walking tiles blockIdx.x, + gridDim.x, ...
template <typename T, int kPass, class Tl>
__global__ void __launch_bounds__(kThreads, 2) backward_gate_kernel(const Bwd task0) {
  extern __shared__ __align__(16) float smem[];
  const Bwd p = at_task<T>(task0, blockIdx.z);
  constexpr int kRows = Tl::kRows, kK = Tl::kChunk, kMt = Tl::kWarpRows / 16;
  constexpr int kXBuf = kRows * Tl::kXs;
  float* wbuf = smem;                          // [2][kK][kWs]
  float* tile = wbuf + 2 * kK * kWs;           // x stages, then r (pass A); da, then dh (B, C)
  float* red = tile + tile_floats<Tl>();       // [2][4][128]
  float* run = red + 2 * 4 * 128;              // the block's running column sums

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const long long n = p.n;
  const int H = p.hidden, C = p.c2ch;
  const long long tiles = (n + kRows - 1) / kRows;
  const int hcols = (H + 15) / 16 * 16;
  const int nth = hcols / 16;                  // n8 tiles a warp takes over the hidden columns
  const int wrow0 = wm * Tl::kWarpRows;
  const int nrun = kPass == kPassA ? 2 * C : kPass == kPassB ? 2 * H + C : H;
  for (int i = tid; i < nrun; i += kThreads) run[i] = 0.f;
  __syncthreads();

  for (long long tile_i = blockIdx.x; tile_i < tiles; tile_i += gridDim.x) {
    const long long row0 = tile_i * kRows;
    float acc[kMt][kNt][4];
    zero(acc);

    if constexpr (kPass == kPassA) {
      // ---- x w1, kept for passes B and C ----
      const T* x = static_cast<const T*>(p.x);
      constexpr int kPitch = sizeof(T) == 4 ? Tl::kXs : Tl::kXsB;
      const int nk1 = (p.cin + kK - 1) / kK;
      stage_x<Tl>(reinterpret_cast<T*>(tile), x, n, p.cin, row0, 0, p.vec_x);
      stage_w<kK>(wbuf, p.w1, p.cin, H, 0, 0, H, hcols);
      cp_async_commit();
      for (int kc = 0; kc < nk1; ++kc) {
        const int buf = kc & 1;
        if (kc + 1 < nk1) {
          stage_x<Tl>(reinterpret_cast<T*>(tile + (buf ^ 1) * kXBuf), x, n, p.cin, row0,
                      (kc + 1) * kK, p.vec_x);
          stage_w<kK>(wbuf + (buf ^ 1) * kK * kWs, p.w1, p.cin, H, (kc + 1) * kK, 0, H, hcols);
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        const int k8 = (min(kK, p.cin - kc * kK) + 7) / 8;
        mma_chunk<kMt>(acc, reinterpret_cast<const T*>(tile + buf * kXBuf), kPitch, 0,
                       wbuf + buf * kK * kWs, k8, nth, wrow0, wn * nth * 8);
        __syncthreads();
      }
      // x w1 to scratch; r = relu(BN1) into the tile, zero past hidden
      const float* s1 = p.col1 + kS * H;
      const float* c1 = p.col1 + kC * H;
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
        if (j >= nth) break;
        const int col = wn * nth * 8 + j * 8 + 2 * tg;
        const bool real = col < H;
        const float sa = real ? s1[col] : 0.f, sb = real ? s1[col + 1] : 0.f;
        const float ca = real ? c1[col] : 0.f, cb = real ? c1[col + 1] : 0.f;
#pragma unroll
        for (int m = 0; m < kMt; ++m)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = wrow0 + m * 16 + half * 8 + g;
            const float a0 = acc[m][j][half * 2], a1 = acc[m][j][half * 2 + 1];
            if (real && row0 + r < n) store2(p.h + (row0 + r) * H + col, a0, a1);
            tile[r * kCs + col] = real ? fmaxf(fmaf(a0, sa, ca), 0.f) : 0.f;
            tile[r * kCs + col + 1] = real ? fmaxf(fmaf(a1, sb, cb), 0.f) : 0.f;
          }
      }
      // ---- a = r w2, 128 columns of C2 at a time; dshared, dz2, a^ ----
      const T* shared = static_cast<const T*>(p.shared);
      const T* dout = static_cast<const T*>(p.dout);
      for (int c0 = 0; c0 < C; c0 += kCols) {
        const int cn = min(kCols, C - c0);
        const int nt2 = (cn + 15) / 16;
        zero(acc);
        __syncthreads();  // r is in the tile
        tile_product<Tl, kMt>(acc, tile, wbuf, p.w2, H, C, 0, H, c0, cn, nt2);
        // (tile_product reads w2 rows [0, H) as the contraction, columns c0...)
#pragma unroll
        for (int j = 0; j < kNt; ++j) {
          if (j >= nt2) break;
          const int col = wn * nt2 * 8 + j * 8 + 2 * tg;
          const bool real = col < cn;  // cn is a multiple of 4: both columns
          const int oc = c0 + col;
          float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // [dz2, dz2 a^][column]
          if (real) {
            const float2 s2 = load2(p.col2 + kS * C + oc), c2 = load2(p.col2 + kC * C + oc);
            const float2 u2 = load2(p.col2 + kU * C + oc), v2 = load2(p.col2 + kV * C + oc);
#pragma unroll
            for (int m = 0; m < kMt; ++m)
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const long long gr = row0 + wrow0 + m * 16 + half * 8 + g;
                if (gr >= n) continue;
                const long long o = gr * C + oc;
                const float2 d = p.pairs ? load2(dout + o)
                                         : make_float2(to_f32(dout[o]), to_f32(dout[o + 1]));
                const float2 s = p.pairs ? load2(shared + o)
                                         : make_float2(to_f32(shared[o]), to_f32(shared[o + 1]));
                float ds[2], dz2[2], ah[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const float v = acc[m][j][half * 2 + e];
                  const float attn =
                      1.f / (1.f + expf(-fmaf(v, e ? s2.y : s2.x, e ? c2.y : c2.x)));
                  const float de = e ? d.y : d.x, se = e ? s.y : s.x;
                  ah[e] = fmaf(v, e ? u2.y : u2.x, e ? v2.y : v2.x);
                  ds[e] = de * attn;
                  dz2[e] = de * se * attn * (1.f - attn);
                  sum[0][e] += dz2[e];
                  sum[1][e] += dz2[e] * ah[e];
                }
                if (p.dshared_f32 != nullptr)
                  store2(p.dshared_f32 + o, ds[0], ds[1]);
                else
                  store2(static_cast<T*>(p.dshared) + o, ds[0], ds[1]);
                __stcg(reinterpret_cast<float2*>(p.dz + o), make_float2(dz2[0], dz2[1]));
                __stcg(reinterpret_cast<float2*>(p.ahat + o), make_float2(ah[0], ah[1]));
              }
          }
#pragma unroll
          for (int k = 0; k < 2; ++k)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float v = column_sum(sum[k][e]);
              if (g == 0 && real) red[k * 512 + wm * 128 + col + e] = v;
            }
        }
        add_warp_sums(red, run, 2, C, c0, cn);
      }
    } else {
      // ---- dr = (da w2^T) [z1 > 0], 128 columns of C2 at a time ----
      for (int c0 = 0; c0 < C; c0 += kCols) {
        const int cn = min(kCols, C - c0);
        __syncthreads();  // the tile's last readers are done
        fill_da<kPass, kRows>(p, tile, row0, c0, cn);
        __syncthreads();
        if constexpr (kPass == kPassB) {  // db2: a thread per column down the tile
          if (tid < cn) {
            float s = 0.f;
#pragma unroll 8
            for (int r = 0; r < kRows; ++r) s += tile[r * kCs + tid];
            run[2 * H + c0 + tid] += s;
          }
        }
        tile_product<Tl, kMt>(acc, tile, wbuf, p.w2t, C, H, c0, cn, 0, H, nth);
      }
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
        if (j >= nth) break;
        const int col = wn * nth * 8 + j * 8 + 2 * tg;
        const bool real = col < H;
        float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // [dr, dr h^][column]
        const int cc = real ? col : 0;
        const float2 s1 = load2(p.col1 + kS * H + cc), c1 = load2(p.col1 + kC * H + cc);
        const float2 u1 = load2(p.col1 + kU * H + cc), v1 = load2(p.col1 + kV * H + cc);
        const float2 q1 = load2(p.col1 + kQ * H + cc), o1 = load2(p.col1 + kO * H + cc);
#pragma unroll
        for (int m = 0; m < kMt; ++m)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = wrow0 + m * 16 + half * 8 + g;
            const long long gr = row0 + r;
            float dh[2] = {0.f, 0.f};
            if (real && gr < n) {
              const float2 hv = __ldcg(reinterpret_cast<const float2*>(p.h + gr * H + col));
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float hx = e ? hv.y : hv.x;
                const float hhat = fmaf(hx, e ? u1.y : u1.x, e ? v1.y : v1.x);
                const float sc = e ? s1.y : s1.x;
                const float dr = fmaf(hx, sc, e ? c1.y : c1.x) > 0.f ? acc[m][j][half * 2 + e]
                                                                    : 0.f;
                if constexpr (kPass == kPassB) {
                  sum[0][e] += dr;
                  sum[1][e] += dr * hhat;
                } else {
                  dh[e] = fmaf(sc, dr, fmaf(e ? q1.y : q1.x, hhat, e ? o1.y : o1.x));
                }
              }
              if constexpr (kPass == kPassC)
                __stcg(reinterpret_cast<float2*>(p.h + gr * H + col), make_float2(dh[0], dh[1]));
            }
            if constexpr (kPass == kPassC) {  // dh into the tile; zero past hidden and n
              tile[r * kCs + col] = dh[0];
              tile[r * kCs + col + 1] = dh[1];
            }
          }
        if constexpr (kPass == kPassB) {
#pragma unroll
          for (int k = 0; k < 2; ++k)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float v = column_sum(sum[k][e]);
              if (g == 0 && real) red[k * 512 + wm * 128 + col + e] = v;
            }
        }
      }
      if constexpr (kPass == kPassB) {
        add_warp_sums(red, run, 2, H, 0, H);
      } else {
        __syncthreads();  // dh is in the tile
        if (tid < H) {  // db1: a thread per column down the tile
          float s = 0.f;
#pragma unroll 8
          for (int r = 0; r < kRows; ++r) s += tile[r * kCs + tid];
          run[tid] += s;
        }
        // ---- dx = dh w1^T, 128 columns of Cin at a time ----
        T* dx = static_cast<T*>(p.dx);
        const bool pairs = (p.cin & 1) == 0;
        for (int c0 = 0; c0 < p.cin; c0 += kCols) {
          const int cn = min(kCols, p.cin - c0);
          const int nt = (cn + 15) / 16;
          zero(acc);
          tile_product<Tl, kMt>(acc, tile, wbuf, p.w1t, H, p.cin_ld, 0, H, c0, cn, nt);
#pragma unroll
          for (int j = 0; j < kNt; ++j) {
            if (j >= nt) break;
            const int col = wn * nt * 8 + j * 8 + 2 * tg;
            if (col >= cn) continue;
#pragma unroll
            for (int m = 0; m < kMt; ++m)
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const long long gr = row0 + wrow0 + m * 16 + half * 8 + g;
                if (gr >= n) continue;
                T* o = dx + gr * p.cin + c0 + col;
                const float a0 = acc[m][j][half * 2], a1 = acc[m][j][half * 2 + 1];
                if (pairs) {
                  store2(o, a0, a1);
                } else {
                  o[0] = from_f32<T>(a0);
                  if (col + 1 < cn) o[1] = from_f32<T>(a1);
                }
              }
          }
        }
      }
    }
  }

  // the block's partial sums; the last block adds every block's
  __syncthreads();
  float* part = kPass == kPassA ? p.part_a : kPass == kPassB ? p.part_b : p.part_c;
  for (int i = tid; i < nrun; i += kThreads) part[(long long)blockIdx.x * nrun + i] = run[i];
  __shared__ bool last_block;
  __threadfence();
  __syncthreads();
  if (tid == 0) last_block = atomicAdd(p.done + kPass, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last_block) {
    __threadfence();
    const int ch = kPass == kPassA ? C : H;
    finish_pass<kPass>(p, gridDim.x,
                       p.local == nullptr ? nullptr : p.local + (long long)blockIdx.z * 2 * ch);
  }
}

// Per task (blockIdx.z): w1^T and w2^T into scratch, the BNs' folds from
// the saved statistics, the counters zeroed.
template <typename T>
__global__ void backward_prep_gate_kernel(const Bwd task0) {
  const Bwd p = at_task<T>(task0, blockIdx.z);
  const int H = p.hidden, C = p.c2ch;
  const long long n1 = (long long)H * p.cin_ld, n2 = n1 + (long long)C * H;
  const long long total = n2 + H + C + kCounters;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    if (i < n1) {
      const int k = (int)(i / p.cin_ld), c = (int)(i - (long long)k * p.cin_ld);
      p.w1t[i] = c < p.cin ? p.w1[(long long)c * H + k] : 0.f;
    } else if (i < n2) {
      const long long j = i - n1;
      const int c = (int)(j / H), k = (int)(j - (long long)c * H);
      p.w2t[j] = p.w2[(long long)k * C + c];
    } else if (i < n2 + H + C) {
      const bool first = i < n2 + H;
      const int c = (int)(first ? i - n2 : i - n2 - H), ch = first ? H : C;
      float* col = first ? p.col1 : p.col2;
      const float var = (first ? p.v1 : p.v2)[c], mean = (first ? p.m1 : p.m2)[c];
      const float conv_bias = (first ? p.b1 : p.b2)[c];
      // s and c as the forward's fold_bn makes them, so that the relu and
      // attn recomputed here are the forward's to the bit
      const float inv = (first ? p.scale1 : p.scale2)[c] / sqrtf(var + p.eps);
      col[kS * ch + c] = inv;
      col[kC * ch + c] = (conv_bias - mean) * inv + (first ? p.bias1 : p.bias2)[c];
      const float r = 1.f / sqrtf(var + p.eps);
      col[kU * ch + c] = r;
      col[kV * ch + c] = (conv_bias - mean) * r;
    } else {
      p.done[i - n2 - H - C] = 0u;
    }
  }
}

// Rows [row0, row0 + RowStage::kRows) x columns [col0, col0 + 2^lg_cols)
// of the row-major (n_end, ld) src into dst (pitch kXs or kXsB elements):
// 16-byte copies where rows are aligned (vec), else element by element;
// zeros past n_end and ld. 8 <= 2^lg_cols <= 128.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, long long n_end, int ld,
                                           long long row0, int col0, int lg_cols, bool vec) {
  constexpr int kPer16 = 16 / sizeof(T);
  constexpr int kLgPer16 = sizeof(T) == 4 ? 2 : 3;
  constexpr int kPitch = sizeof(T) == 4 ? RowStage::kXs : RowStage::kXsB;
  const int lg = vec ? lg_cols - kLgPer16 : lg_cols;  // log2 of the copies a row
  const int mask = (1 << lg) - 1;
  for (int i = threadIdx.x; i < RowStage::kRows << lg; i += kThreads) {
    const int r = i >> lg, c = (i & mask) * (vec ? kPer16 : 1);
    const long long gr = row0 + r;
    const bool valid = gr < n_end && col0 + c < ld;
    if (vec)
      cp_async16(dst + r * kPitch + c, valid ? src + gr * ld + col0 + c : src, valid);
    else
      dst[r * kPitch + c] = valid ? src[gr * ld + col0 + c] : from_f32<T>(0.f);
  }
}

// The weight gradients as split-K products over the rows: dw1 = x^T dh
// (kWhich kWeights1, A = x) or dw2 = r^T da (kWeights2, A = x w1 through
// BN1 and relu), 128 x 128 outputs a block (blockIdx.y), the rows of split
// blockIdx.x in stages of 32, kWStages in flight; the partials go to
// wpart1 / wpart2. A is staged only as far as the block's outputs reach.
constexpr int kWStages = 3;
constexpr int kWStageFloats = RowStage::kRows * RowStage::kXs + RowStage::kRows * kWs;

template <typename TA, int kWhich>
__global__ void __launch_bounds__(kThreads, 2) weight_grad_gate_kernel(const Bwd task0, int ntiles,
                                                                       long long rows_per) {
  extern __shared__ __align__(16) float smem[];
  using St = RowStage;
  constexpr int kAFloats = St::kRows * St::kXs;  // one A stage (f32; bf16 takes half)
  constexpr int kMt = 2;
  const Bwd p = at_task<TA>(task0, blockIdx.z);
  float* abuf = smem;                            // [kWStages][32][136]
  float* bbuf = smem + kWStages * kAFloats;      // [kWStages][32][kWs]
  const bool first = kWhich == kWeights1;
  const int M = first ? p.cin : p.hidden, NC = first ? p.hidden : p.c2ch;
  const TA* a_src = first ? static_cast<const TA*>(p.x) : reinterpret_cast<const TA*>(p.h);
  const float* b_src = first ? p.h : p.dz;
  const bool vec_a = first ? p.vec_x != 0 : true;
  const int m0 = (blockIdx.y / ntiles) * 128, n0 = (blockIdx.y % ntiles) * 128;
  const int mvalid = min(128, M - m0), nvalid = min(128, NC - n0);
  int lg_a = 3;                                  // log2 of the A columns staged, at least
  while ((1 << lg_a) < mvalid) ++lg_a;           // mvalid; rows past them give outputs that
                                                 // are not stored
  const int staged = (nvalid + 15) / 16 * 16, nt = staged / 16;
  const long long r_begin = blockIdx.x * rows_per;
  const long long r_end = min(p.n, r_begin + rows_per);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2, wrow0 = wm * 32;
  const int nk = (int)((r_end - r_begin + St::kRows - 1) / St::kRows);
  const float* s1 = p.col1 + kS * p.hidden;
  const float* c1 = p.col1 + kC * p.hidden;

  auto load_stage = [&](int kc) {
    const long long r0 = r_begin + (long long)kc * St::kRows;
    const int buf = kc % kWStages;
    stage_rows<TA>(reinterpret_cast<TA*>(abuf + buf * kAFloats), a_src, r_end, M, r0, m0, lg_a,
                   vec_a);
    stage_w<St::kRows>(bbuf + buf * St::kRows * kWs, b_src, (int)r_end, NC, (int)r0, n0,
                       n0 + nvalid, staged);
  };
  float acc[kMt][kNt][4];
  zero(acc);
  for (int k = 0; k < kWStages - 1; ++k) {
    if (k < nk) load_stage(k);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<kWStages - 2>();
    __syncthreads();  // stage kc has landed; the stage before it is free
    if (kc + kWStages - 1 < nk) load_stage(kc + kWStages - 1);
    cp_async_commit();
    float* a = abuf + (kc % kWStages) * kAFloats;
    if constexpr (kWhich == kWeights2) {
      // r = relu(BN1(x w1)); rows past r_end meet zero rows of da
      for (int i = tid; i < St::kRows * 128; i += kThreads) {
        const int r = i >> 7, m = i & 127;
        if (m < mvalid) {
          float* v = a + r * St::kXs + m;
          *v = fmaxf(fmaf(*v, s1[m0 + m], c1[m0 + m]), 0.f);
        }
      }
      __syncthreads();
    }
    if (wrow0 < mvalid)
      mma_chunk_strided<kMt>(acc, reinterpret_cast<const TA*>(a), 1,
                             sizeof(TA) == 4 ? St::kXs : St::kXsB,
                             bbuf + (kc % kWStages) * St::kRows * kWs, St::kRows / 8, nt, wrow0,
                             wn * nt * 8);
  }

  float* out = (first ? p.wpart1 : p.wpart2) + (long long)blockIdx.x * M * NC;
  const int lane = tid & 31, g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int j = 0; j < kNt; ++j) {
    if (j >= nt) break;
    const int col = wn * nt * 8 + j * 8 + 2 * tg;
    if (col >= nvalid) continue;
#pragma unroll
    for (int m = 0; m < kMt; ++m)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = wrow0 + m * 16 + half * 8 + g;
        if (row < mvalid)
          store2(out + (long long)(m0 + row) * NC + n0 + col, acc[m][j][half * 2],
                 acc[m][j][half * 2 + 1]);
      }
  }
}

// Folds and sums, one thread an output, task on blockIdx.z: a staged call's
// BN folds from the caller's all-reduced sums (kFoldA: BN2's, kFoldB:
// BN1's), or the weight gradients from their split partials in split order
// (kWeights1, kWeights2).
template <int kWhat>
__global__ void backward_sums_gate_kernel(const Bwd task0, int parts) {
  const Bwd p = at_task<float>(task0, blockIdx.z);
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if constexpr (kWhat == kFoldA || kWhat == kFoldB) {
    const int ch = kWhat == kFoldA ? p.c2ch : p.hidden;
    const double* local = p.local + (long long)blockIdx.z * 2 * ch;
    if (i < ch) bn_grad_fold(kWhat == kFoldA ? p.col2 : p.col1, ch, (int)i, local[i], local[ch + i],
                             p.n_total);
  } else {
    const long long count = (long long)p.hidden * (kWhat == kWeights1 ? p.cin : p.c2ch);
    if (i >= count) return;
    const float* part = kWhat == kWeights1 ? p.wpart1 : p.wpart2;
    double s = 0.0;
    for (int k = 0; k < parts; ++k) s += (double)__ldcg(&part[k * count + i]);
    (kWhat == kWeights1 ? p.dw1 : p.dw2)[i] = (float)s;
  }
}

// dshared of T tasks: their f32 parts added in task order.
template <typename T>
__global__ void backward_tasks_gate_kernel(const float* parts, T* out, int tasks, long long count) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int t = 0; t < tasks; ++t) s += parts[t * count + i];
  out[i] = from_f32<T>(s);
}

bool shapes_ok(long long n, int cin, int hidden, int c2ch) {
  return n > 0 && n < (1LL << 31) - 64 && cin > 0 && hidden > 0 && hidden <= kMaxHidden &&
         hidden % 4 == 0 && c2ch > 0 && c2ch <= kMaxC2 && c2ch % 4 == 0;
}

// split-K of a weight gradient with `tiles` 128 x 128 output blocks: about
// two blocks an SM, each a whole number of 32-row stages; depends on the
// shapes alone, and so does the order of the sums
long long rows_per_split(long long n, int tiles) {
  const long long stages = (n + 31) / 32;
  long long splits = 2 * kSMs / tiles;
  splits = splits < 1 ? 1 : (splits > stages ? stages : splits);
  return (stages + splits - 1) / splits * 32;
}
int n_splits(long long n, int tiles) {
  const long long rows = rows_per_split(n, tiles);
  return (int)((n + rows - 1) / rows);
}
int tiles_of(int m, int nc) { return ((m + 127) / 128) * ((nc + 127) / 128); }

long long round4(long long v) { return (v + 3) / 4 * 4; }

// a task's scratch, in floats, each part a multiple of 4
long long task_floats(long long n, int cin, int hidden, int c2ch) {
  const long long g = row_blocks(n);
  return round4(n * hidden) + 2 * round4(n * c2ch) + round4(hidden * round4(cin)) +
         round4((long long)c2ch * hidden) + round4(6LL * hidden) + round4(6LL * c2ch) +
         round4(g * 2 * c2ch) + round4(g * (2 * hidden + c2ch)) + round4(g * hidden) +
         round4((long long)n_splits(n, tiles_of(cin, hidden)) * cin * hidden) +
         round4((long long)n_splits(n, tiles_of(hidden, c2ch)) * hidden * c2ch);
}

long long scratch_floats(long long n, int cin, int hidden, int c2ch, int tasks) {
  return tasks * task_floats(n, cin, hidden, c2ch) + (tasks > 1 ? tasks * round4(n * c2ch) : 0) +
         round4((long long)kCounters * tasks);
}

template <typename T, int kPass, class Tl>
cudaError_t launch_pass(const Bwd& p, cudaStream_t s) {
  static bool opted_in = false;
  const size_t smem = sizeof(float) * pass_smem_floats<Tl>();
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(backward_gate_kernel<T, kPass, Tl>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  backward_gate_kernel<T, kPass, Tl><<<dim3(row_blocks(p.n), 1, p.tasks), kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

template <int kPass>
cudaError_t pass(const Bwd& p, bool bf16, cudaStream_t s) {
  if (small_n(p.n))
    return bf16 ? launch_pass<__nv_bfloat16, kPass, SmallTile>(p, s)
                : launch_pass<float, kPass, SmallTile>(p, s);
  return bf16 ? launch_pass<__nv_bfloat16, kPass, BigTile>(p, s)
              : launch_pass<float, kPass, BigTile>(p, s);
}

template <typename TA, int kWhich>
cudaError_t launch_weights(const Bwd& p, cudaStream_t s) {
  static bool opted_in = false;
  const size_t smem = sizeof(float) * kWStages * kWStageFloats;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(weight_grad_gate_kernel<TA, kWhich>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const int m = kWhich == kWeights1 ? p.cin : p.hidden;
  const int nc = kWhich == kWeights1 ? p.hidden : p.c2ch;
  const int tiles = tiles_of(m, nc);
  const long long rows = rows_per_split(p.n, tiles);
  weight_grad_gate_kernel<TA, kWhich>
      <<<dim3(n_splits(p.n, tiles), tiles, p.tasks), kThreads, smem, s>>>(p, (nc + 127) / 128,
                                                                          rows);
  return cudaGetLastError();
}

template <int kWhat>
cudaError_t sums(const Bwd& p, long long count, int parts, cudaStream_t s) {
  backward_sums_gate_kernel<kWhat>
      <<<dim3((unsigned)((count + 255) / 256), 1, p.tasks), 256, 0, s>>>(p, parts);
  return cudaGetLastError();
}

// The fused call (stage < 0) or one stage of a staged call (0-4, see
// vmtl_gate_train_backward_stage).
int gate_backward(void* const* in, void* const* out, void* scratch, int tasks, long long n, int cin,
                  int hidden, int c2ch, float eps, int is_bf16, void* stream, int stage,
                  double* local, double n_total) {
  if (!shapes_ok(n, cin, hidden, c2ch) || tasks < 1 || tasks > 65535)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(scratch) & 15) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool bf16 = is_bf16 != 0;
  Bwd p = {};
  p.dout = in[0];
  p.x = in[1];
  p.shared = in[2];
  const float* const* w = reinterpret_cast<const float* const*>(in + 3);
  p.w1 = w[0];
  p.b1 = w[1];
  p.scale1 = w[2];
  p.bias1 = w[3];
  p.w2 = w[4];
  p.b2 = w[5];
  p.scale2 = w[6];
  p.bias2 = w[7];
  p.m1 = w[8];
  p.v1 = w[9];
  p.m2 = w[10];
  p.v2 = w[11];
  p.dx = out[0];
  p.dshared = out[1];
  float* const* o = reinterpret_cast<float* const*>(out + 2);
  p.dw1 = o[0];
  p.db1 = o[1];
  p.dscale1 = o[2];
  p.dbias1 = o[3];
  p.dw2 = o[4];
  p.db2 = o[5];
  p.dscale2 = o[6];
  p.dbias2 = o[7];
  p.n = n;
  p.cin = cin;
  p.hidden = hidden;
  p.c2ch = c2ch;
  p.cin_ld = (int)round4(cin);
  p.eps = eps;
  p.tasks = tasks;
  p.local = local;
  p.n_total = stage < 0 ? (double)n : n_total;
  const int per16 = bf16 ? 8 : 4;
  p.vec_x = cin % per16 == 0 && (reinterpret_cast<uintptr_t>(in[1]) & 15) == 0;
  p.pairs = ((reinterpret_cast<uintptr_t>(in[0]) | reinterpret_cast<uintptr_t>(in[2])) &
             (2 * (bf16 ? 2 : 4) - 1)) == 0;
  // task 0's scratch; task t's lies t * per_task floats further on
  p.per_task = task_floats(n, cin, hidden, c2ch);
  float* f = static_cast<float*>(scratch);
  const long long g = row_blocks(n);
  const int splits1 = n_splits(n, tiles_of(cin, hidden));
  const int splits2 = n_splits(n, tiles_of(hidden, c2ch));
  p.h = f;
  f += round4(n * hidden);
  p.dz = f;
  f += round4(n * c2ch);
  p.ahat = f;
  f += round4(n * c2ch);
  p.w1t = f;
  f += round4(hidden * round4(cin));
  p.w2t = f;
  f += round4((long long)c2ch * hidden);
  p.col1 = f;
  f += round4(6LL * hidden);
  p.col2 = f;
  f += round4(6LL * c2ch);
  p.part_a = f;
  f += round4(g * 2 * c2ch);
  p.part_b = f;
  f += round4(g * (2 * hidden + c2ch));
  p.part_c = f;
  f += round4(g * hidden);
  p.wpart1 = f;
  f += round4((long long)splits1 * cin * hidden);
  p.wpart2 = f;
  float* rest = static_cast<float*>(scratch) + tasks * p.per_task;
  p.dshared_f32 = tasks > 1 ? rest : nullptr;
  if (tasks > 1) rest += tasks * round4(n * c2ch);
  p.done = reinterpret_cast<unsigned int*>(rest);

  cudaError_t err = cudaSuccess;
  const bool staged = stage >= 0;
  if (stage <= 0) {
    const long long prep = (long long)hidden * round4(cin) + (long long)c2ch * hidden;
    backward_prep_gate_kernel<float>
        <<<dim3((unsigned)((prep + 255) / 256), 1, tasks), 256, 0, s>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if ((err = pass<kPassA>(p, bf16, s)) != cudaSuccess) return (int)err;
    if (staged) return 0;
  }
  if (stage == 1) return (int)sums<kFoldA>(p, c2ch, 0, s);
  if (stage < 0 || stage == 2) {
    if ((err = pass<kPassB>(p, bf16, s)) != cudaSuccess) return (int)err;
    if (staged) return 0;
  }
  if (stage == 3) return (int)sums<kFoldB>(p, hidden, 0, s);
  // stage 4 or the fused call's rest: dw2 reads x w1 before pass C
  // overwrites it with dh
  p.local = nullptr;
  if ((err = launch_weights<float, kWeights2>(p, s)) != cudaSuccess) return (int)err;
  if ((err = pass<kPassC>(p, bf16, s)) != cudaSuccess) return (int)err;
  if ((err = bf16 ? launch_weights<__nv_bfloat16, kWeights1>(p, s)
                  : launch_weights<float, kWeights1>(p, s)) != cudaSuccess)
    return (int)err;
  if ((err = sums<kWeights1>(p, (long long)cin * hidden, splits1, s)) != cudaSuccess)
    return (int)err;
  if ((err = sums<kWeights2>(p, (long long)hidden * c2ch, splits2, s)) != cudaSuccess)
    return (int)err;
  if (tasks > 1) {
    const long long count = n * c2ch;
    if (bf16)
      backward_tasks_gate_kernel<__nv_bfloat16><<<(unsigned)((count + 255) / 256), 256, 0, s>>>(
          p.dshared_f32, static_cast<__nv_bfloat16*>(p.dshared), tasks, count);
    else
      backward_tasks_gate_kernel<float><<<(unsigned)((count + 255) / 256), 256, 0, s>>>(
          p.dshared_f32, static_cast<float*>(p.dshared), tasks, count);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// Bytes of scratch device memory that vmtl_gate_train_backward needs for
// `tasks` tasks of n rows.
extern "C" long long vmtl_gate_train_backward_scratch_bytes(long long n, int cin, int hidden,
                                                            int c2ch, int tasks) {
  return 4 * scratch_floats(n, cin, hidden, c2ch, tasks);
}

// The ten gradients of the train-mode gate of T tasks, on `stream`, nothing
// allocated, no synchronisation. `in`: dout (tasks, n, c2ch), x (tasks, n,
// cin), shared (n, c2ch), all float (is_bf16 = 0) or bf16 (is_bf16 = 1);
// then float: w1 (tasks, cin, hidden), b1, scale1, bias1 (tasks, hidden),
// w2 (tasks, hidden, c2ch), b2, scale2, bias2 (tasks, c2ch), and the
// forward's mean1, var1 (tasks, hidden), mean2, var2 (tasks, c2ch); every
// tensor contiguous. `out`: dx (x's type and
// shape), dshared (shared's; every task's gate's gradient summed in task
// order), then float dw1, db1, dscale1, dbias1, dw2, db2, dscale2, dbias2,
// the weights' shapes. hidden and c2ch multiples of 4, hidden <= 128, c2ch
// <= 512. scratch holds vmtl_gate_train_backward_scratch_bytes(n, cin,
// hidden, c2ch, tasks) bytes, 16-byte aligned, with any contents. Task t's
// results other than dshared are bit for bit those of a call with tasks = 1
// on its own inputs. Returns the first CUDA error of the launches, 0 when
// all were queued.
extern "C" int vmtl_gate_train_backward(void* const* in, void* const* out, void* scratch, int tasks,
                                        long long n, int cin, int hidden, int c2ch, float eps,
                                        int is_bf16, void* stream) {
  return gate_backward(in, out, scratch, tasks, n, cin, hidden, c2ch, eps, is_bf16, stream, -1,
                       nullptr, 0.0);
}

// One stage of the gradient, for a caller whose BN statistics are over the
// rows of several ranks (n_total rows in all, n on each). The arguments are
// those of vmtl_gate_train_backward, the same on every stage (scratch
// carries the kept tiles and folds from stage to stage), and `local`, f64
// (tasks, 2, C), C = c2ch for stages 0 and 1, hidden for 2 and 3:
//   0: pass A; writes local = this rank's sums of dz2 and dz2 a^ per C2
//      channel (and dbias2, dscale2, this rank's);
//   1: folds BN2's gradient from local, the ranks' all-reduced sums;
//   2: pass B; writes local = this rank's sums of dr and dr h^ (and dbias1,
//      dscale1, db2);
//   3: folds BN1's gradient from local, all-reduced;
//   4: the weight gradients and pass C (local unused).
// Stages run in this order on one stream. With local passed from each pass
// to its fold unchanged and n_total = n, the results are bit for bit those
// of the fused call.
extern "C" int vmtl_gate_train_backward_stage(void* const* in, void* const* out, void* scratch,
                                              int tasks, long long n, int cin, int hidden,
                                              int c2ch, float eps, int is_bf16, void* stream,
                                              int stage, void* local, double n_total) {
  if (stage < 0 || stage > 4 || (stage < 4 && local == nullptr) || !(n_total >= (double)n))
    return (int)cudaErrorInvalidValue;
  return gate_backward(in, out, scratch, tasks, n, cin, hidden, c2ch, eps, is_bf16, stream, stage,
                       static_cast<double*>(local), n_total);
}
