// MTAN's eval-mode attention gate, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `fused_attention_gate` (`_kernel`) of
// vision_mtl_tpu/ops/pallas/fused_gate.py. Per pixel row
//
//     out = shared * sigmoid(relu(x @ w1 + c1) @ w2 + c2)
//
// with both BatchNorms already folded into (w1, c1) and (w2, c2) by the
// caller. (The train-mode gate, whose BNs take the batch's statistics, is
// csrc/gate_train.cu; both take their tile body from csrc/gate_tile.cuh.)
//
// x and shared are (N, Cin) and (N, C2) rows in f32 or bf16; the weights are
// f32; the products are taken in f32 accuracy and the rest in f32, as in the
// Pallas kernel; out takes shared's type.
//
// What bounds it on an H100: its two products, 2N(Cin hidden + hidden C2)
// operations, against N(Cin + 2 C2) activation elements moved. On the f32
// units that is above the card's ridge at every MTAN level. Taken as 3xTF32
// on the tensor cores (three TF32 products at 495 TFLOP/s for each f32 one,
// two for x @ w1 when x is bf16) the operations still bound it at the
// large levels; at the narrowest ones the bytes come close.
//
// Design. One tile of rows per block, 256 threads (gate_tile.cuh): 128-row
// tiles and 32-deep stages, two blocks to an SM; below 8,321 rows (fewer
// 128-row tiles than half the SMs) 64-row tiles and 64-deep stages, for
// twice the blocks. The first product streams x and w1 over Cin in
// double-buffered cp.async stages, so the weights are read from L2 once per
// tile. h' = relu(x @ w1 + c1) goes to shared memory as f32 (in place of
// the x stages) and never reaches device memory; the second product streams
// w2 the same way. The gates sigmoid(h' @ w2 + c2) go to shared memory in
// turn, and the block then reads shared and writes out along whole rows, as
// 16-byte vectors where the rows allow. Each k-step's partial product is
// added to the f32 sum with rounding to nearest (mma_chunk), so the sums
// over Cin = 640 keep f32 accuracy.
//
// Pairs. A block's second product takes at most 128 columns of C2, and at
// small N there are few tiles (MTAN's enc3 and dec0: N = 4,096, 64 tiles,
// C2 = 256). There the two blocks of a tile form a thread-block cluster
// along blockIdx.y: each takes half of Cin's stages of the first product,
// the two add their partial sums through distributed shared memory, and
// each then takes its own slice of C2. x @ w1 is taken once per tile (per
// pair: a C2 above 256 takes two pairs, and each pair takes it), and the
// card gets 128 blocks at N = 4,096 instead of 64. The other ways cost
// more there: one block walking both slices over one h' has half the
// blocks; two blocks each taking the whole x @ w1 for its slice do it twice
// (on an H100, dec0 in f32 then took 69 us a call, the plain version 51). At
// large N with C2 <= 128 (every other MTAN level) a block takes the tile
// alone.
//
// Tasks. MTAN's task-folded levels (fold_tasks) take the T tasks' gates in
// one launch: x, the weights and out carry a leading task axis, shared is
// the tasks' one map, and the task index is blockIdx.z. A task's blocks
// take the tiles, slices and pairs that a launch of that task alone takes
// (a cluster never spans two tasks), so each task's result is bit for bit
// that of its own launch.

#include <cooperative_groups.h>

#include "gate_tile.cuh"

namespace {

using namespace gate_tile;

constexpr int kMaxHidden = 128;
constexpr int kMaxC2 = 512;
constexpr int kSliceC2 = 128;  // C2 columns a block takes, at most

struct Pass {
  const void* x;
  const void* shared;
  void* out;
  // h' = relu(x @ w1 + c1) and a = h' @ w2 + c2
  const float* w1;
  const float* c1;
  const float* w2;
  const float* c2;
  long long n;
  int cin, hidden, c2ch;
  int cols2;    // C2 columns a block takes (a slice; a pair takes two)
  // x, w1, c1, w2, c2 and out hold T tasks back to back, shared one map
  int vec_x;    // x rows are 16-byte aligned: staged by cp.async
  int vec_out;  // shared and out rows are 16-byte aligned: read and written as 16-byte vectors
};

// floats of shared memory with tile Tl: the x stages (two), later h' and
// then the gates in their place; the weight stages (two)
template <class Tl>
__host__ __device__ constexpr int smem_floats() {
  return (2 * Tl::kXs > kHs ? 2 * Tl::kRows * Tl::kXs : Tl::kRows * kHs) + 2 * Tl::kChunk * kWs;
}

// out = shared * gate over 16 bytes; the gates are 16 / sizeof(T) floats
__device__ __forceinline__ uint4 gate16(uint4 s, const float* gate, float) {
  const float4 g0 = *reinterpret_cast<const float4*>(gate);
  float4 v = *reinterpret_cast<float4*>(&s);
  v = make_float4(v.x * g0.x, v.y * g0.y, v.z * g0.z, v.w * g0.w);
  return *reinterpret_cast<uint4*>(&v);
}
__device__ __forceinline__ uint4 gate16(uint4 s, const float* gate, __nv_bfloat16) {
  __nv_bfloat16* v = reinterpret_cast<__nv_bfloat16*>(&s);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __float2bfloat16(__bfloat162float(v[i]) * gate[i]);
  return s;
}

// The pass of task t: its own x, weights and out; shared is every task's.
template <typename T>
__device__ __forceinline__ Pass task_pass(Pass p, long long t) {
  p.x = static_cast<const T*>(p.x) + t * p.n * p.cin;
  p.out = static_cast<T*>(p.out) + t * p.n * p.c2ch;
  p.w1 += t * p.cin * p.hidden;
  p.c1 += t * p.hidden;
  p.w2 += t * p.hidden * p.c2ch;
  p.c2 += t * p.c2ch;
  return p;
}

template <typename T, class Tl, bool kPair>
__global__ void __launch_bounds__(kThreads, 2) gate_kernel(const Pass task0) {
  extern __shared__ __align__(16) float smem[];
  const Pass p = task_pass<T>(task0, blockIdx.z);
  constexpr int kRows = Tl::kRows, kK = Tl::kChunk, kMt = Tl::kWarpRows / 16;
  constexpr int kColAlign = 16;                   // 2 column warps x n8
  constexpr int kXBuf = kRows * Tl::kXs;          // floats per x stage (f32 or bf16)
  constexpr int kPitch = sizeof(T) == 4 ? Tl::kXs : Tl::kXsB;
  float* wbuf = smem;                             // [2][kK][kWs]
  float* xbuf = wbuf + 2 * kK * kWs;              // [2][kRows][kPitch] x stages
  float* hs = xbuf;                               // then [kRows][kHs]: h', then the gates

  const T* __restrict__ x = static_cast<const T*>(p.x);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const long long n = p.n;
  const long long row0 = (long long)blockIdx.x * kRows;
  const int c2lo = blockIdx.y * p.cols2;          // this block's columns of C2
  // 0 for a pair's empty second slice
  const int c2n = kPair ? max(0, min(p.cols2, p.c2ch - c2lo)) : min(p.cols2, p.c2ch - c2lo);
  const int w1cols = (p.hidden + kColAlign - 1) / kColAlign * kColAlign;  // staged, zero past hidden
  const int nt1 = w1cols / kColAlign;             // n8 tiles of a warp
  const int w2cols = (c2n + kColAlign - 1) / kColAlign * kColAlign;
  const int nt2 = w2cols / kColAlign;
  const int nk1 = (p.cin + kK - 1) / kK;
  // the first product's stages this block takes: a pair splits them in two
  const int rank = kPair ? (int)(blockIdx.y & 1) : 0;
  const int kbeg = kPair ? rank * ((nk1 + 1) / 2) : 0;
  const int kend = kPair && rank == 0 ? (nk1 + 1) / 2 : nk1;
  const int nk2 = (p.hidden + kK - 1) / kK;
  const int wrow0 = wm * Tl::kWarpRows;           // the warp's first row in the tile

  float acc[kMt][kNt][4];
#pragma unroll
  for (int m = 0; m < kMt; ++m)
#pragma unroll
    for (int j = 0; j < kNt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

  // ---- first product: x @ w1 over stages [kbeg, kend) ----
  if (!kPair || kbeg < kend) {
    stage_x<Tl>(reinterpret_cast<T*>(xbuf), x, n, p.cin, row0, kbeg * kK, p.vec_x);
    stage_w<kK>(wbuf, p.w1, p.cin, p.hidden, kbeg * kK, 0, p.hidden, w1cols);
    cp_async_commit();
  }
  for (int kc = kbeg; kc < kend; ++kc) {
    const int buf = (kc - kbeg) & 1;
    if (kc + 1 < kend) {
      stage_x<Tl>(reinterpret_cast<T*>(xbuf + (buf ^ 1) * kXBuf), x, n, p.cin, row0,
                  (kc + 1) * kK, p.vec_x);
      stage_w<kK>(wbuf + (buf ^ 1) * kK * kWs, p.w1, p.cin, p.hidden, (kc + 1) * kK, 0, p.hidden,
                  w1cols);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k8 = (min(kK, p.cin - kc * kK) + 7) / 8;
    mma_chunk<kMt>(acc, reinterpret_cast<const T*>(xbuf + buf * kXBuf), kPitch, 0,
                   wbuf + buf * kK * kWs, k8, nt1, wrow0, wn * nt1 * 8);
    __syncthreads();  // the stages are free
  }

  if constexpr (kPair) {
    // x @ w1 = this block's partial + the other's: each puts its partial in
    // its own shared memory, reads the other's at the same places (both
    // blocks lay the tile out alike) and adds it (a + b == b + a in f32,
    // so both hold the same sums)
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
      if (j >= nt1) break;
      const int col = wn * nt1 * 8 + j * 8 + 2 * tg;
#pragma unroll
      for (int m = 0; m < kMt; ++m)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = wrow0 + m * 16 + half * 8 + g;
          *reinterpret_cast<float2*>(&hs[r * kHs + col]) =
              make_float2(acc[m][j][half * 2], acc[m][j][half * 2 + 1]);
        }
    }
    cluster.sync();  // both partials are in place
    const float* other = cluster.map_shared_rank(hs, rank ^ 1);
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
      if (j >= nt1) break;
      const int col = wn * nt1 * 8 + j * 8 + 2 * tg;
#pragma unroll
      for (int m = 0; m < kMt; ++m)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = wrow0 + m * 16 + half * 8 + g;
          const float2 v = *reinterpret_cast<const float2*>(&other[r * kHs + col]);
          acc[m][j][half * 2] += v.x;
          acc[m][j][half * 2 + 1] += v.y;
        }
    }
    cluster.sync();  // the other block has read this one's partial: hs is free
    if (c2n == 0) return;
  }

  // w2's first chunk loads while h' is written
  stage_w<kK>(wbuf, p.w2, p.hidden, p.c2ch, 0, c2lo, c2lo + c2n, w2cols);
  cp_async_commit();
  // ---- h' = relu(x @ w1 + c1) into shared memory; 0 past hidden ----
#pragma unroll
  for (int j = 0; j < kNt; ++j) {
    if (j >= nt1) break;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = wn * nt1 * 8 + j * 8 + 2 * tg + e;
      const bool real = col < p.hidden;
      const float c = real ? p.c1[col] : 0.f;
#pragma unroll
      for (int m = 0; m < kMt; ++m)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = wrow0 + m * 16 + half * 8 + g;
          hs[r * kHs + col] = real ? fmaxf(acc[m][j][half * 2 + e] + c, 0.f) : 0.f;
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
    mma_chunk<kMt>(acc, hs, kHs, kc * kK, wbuf + buf * kK * kWs, k8, nt2, wrow0, wn * nt2 * 8);
    __syncthreads();  // h' is read
  }

  // ---- the gates sigmoid(h' @ w2 + c2) into shared memory ----
  float* gs = hs;
#pragma unroll
  for (int j = 0; j < kNt; ++j) {
    if (j >= nt2) break;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = wn * nt2 * 8 + j * 8 + 2 * tg + e;
      if (col >= c2n) continue;
      const float c = p.c2[c2lo + col];
#pragma unroll
      for (int m = 0; m < kMt; ++m)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = wrow0 + m * 16 + half * 8 + g;
          gs[r * kHs + col] = 1.f / (1.f + expf(-(acc[m][j][half * 2 + e] + c)));
        }
    }
  }
  __syncthreads();

  // ---- out = shared * gate, along the tile's rows ----
  const T* __restrict__ shared = static_cast<const T*>(p.shared);
  T* __restrict__ out = static_cast<T*>(p.out);
  const int rows = (int)min((long long)kRows, n - row0);
  if (p.vec_out) {
    constexpr int kPer16 = 16 / sizeof(T);
    const int segs = c2n / kPer16;
    for (int i = tid; i < rows * segs; i += kThreads) {
      const int r = i / segs, s = i - r * segs;
      const long long o = (row0 + r) * p.c2ch + c2lo + s * kPer16;
      const uint4 v = *reinterpret_cast<const uint4*>(shared + o);
      *reinterpret_cast<uint4*>(out + o) = gate16(v, gs + r * kHs + s * kPer16, T());
    }
  } else {
    for (int i = tid; i < rows * c2n; i += kThreads) {
      const int r = i / c2n, col = i - r * c2n;
      const long long o = (row0 + r) * p.c2ch + c2lo + col;
      out[o] = from_f32<T>(to_f32(shared[o]) * gs[r * kHs + col]);
    }
  }
}

bool shapes_ok(long long n, int cin, int hidden, int c2ch) {
  return n > 0 && cin > 0 && hidden > 0 && hidden <= kMaxHidden && hidden % 4 == 0 && c2ch > 0 &&
         c2ch <= kMaxC2 && c2ch % 4 == 0;
}

template <typename T, class Tl, bool kPair>
cudaError_t launch_tile(const Pass& p, dim3 grid, cudaStream_t s) {
  static bool opted_in = false;
  constexpr size_t smem = sizeof(float) * smem_floats<Tl>();
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(gate_kernel<T, Tl, kPair>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute cluster[1];  // a pair: the two blocks of a tile along y
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 2;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = kPair ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, gate_kernel<T, Tl, kPair>, p);
}

// Grid and slices: tiles along x; along y, a pair of blocks for every 256
// columns of C2 where blocks pair up (small N, or C2 above 128), else one;
// the tasks along z.
template <typename T>
cudaError_t launch(Pass p, int tasks, cudaStream_t s) {
  const bool small = small_n(p.n);
  const bool pair = small || p.c2ch > kSliceC2;
  const long long tiles = num_tiles(p.n, small ? SmallTile::kRows : BigTile::kRows);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int slices = pair ? 2 * ((p.c2ch + 2 * kSliceC2 - 1) / (2 * kSliceC2)) : 1;
  p.cols2 = ((p.c2ch + slices - 1) / slices + 7) / 8 * 8;  // whole 16-byte vectors
  const dim3 grid((unsigned)tiles, slices, tasks);
  if (small)
    return pair ? launch_tile<T, SmallTile, true>(p, grid, s)
                : launch_tile<T, SmallTile, false>(p, grid, s);
  return pair ? launch_tile<T, BigTile, true>(p, grid, s)
              : launch_tile<T, BigTile, false>(p, grid, s);
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

}  // namespace

// Eval-mode gate of T tasks. Returns the first CUDA error of the launch, 0
// when the kernel was queued. x: (tasks, n, cin) rows; shared: (n, c2ch)
// rows, the same for every task; out: (tasks, n, c2ch) rows; all float
// (is_bf16 = 0) or bf16 (is_bf16 = 1). w1 (tasks, cin, hidden), c1 (tasks,
// hidden), w2 (tasks, hidden, c2ch), c2 (tasks, c2ch) float, w1 and w2
// 16-byte aligned. hidden and c2ch must be multiples of 4, hidden <= 128,
// c2ch <= 512, 1 <= tasks <= 65535. Task t's out is bit for bit that of a
// launch with tasks = 1 on task t's x and weights. Runs on `stream`,
// allocates nothing and does not synchronise.
extern "C" int vmtl_fused_attention_gate_tasks(const void* x, const void* shared, const void* w1,
                                               const void* c1, const void* w2, const void* c2,
                                               void* out, int tasks, long long n, int cin,
                                               int hidden, int c2ch, int is_bf16, void* stream) {
  if (!shapes_ok(n, cin, hidden, c2ch) || tasks < 1 || tasks > 65535)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(w1) || !aligned16(w2)) return (int)cudaErrorMisalignedAddress;
  const int per16 = is_bf16 ? 8 : 4;  // elements in 16 bytes
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
  // a task's rows start on a multiple of cin (c2ch) elements: 16-byte
  // aligned whenever the first task's are and cin (c2ch) fills 16 bytes
  p.vec_x = cin % per16 == 0 && aligned16(x);
  p.vec_out = c2ch % per16 == 0 && aligned16(shared) && aligned16(out);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch<__nv_bfloat16>(p, tasks, s) : launch<float>(p, tasks, s));
}
