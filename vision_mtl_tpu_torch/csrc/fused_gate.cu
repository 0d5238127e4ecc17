// MTAN's eval-mode attention gate, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `fused_attention_gate` (`_kernel`) of
// vision_mtl_tpu/ops/pallas/fused_gate.py. Per pixel row
//
//     out = shared * sigmoid(relu(x @ w1 + c1) @ w2 + c2)
//
// with both BatchNorms already folded into (w1, c1) and (w2, c2) by the
// caller. (The train-mode gate, whose BNs take the batch's statistics, is
// csrc/gate_train.cu.)
//
// x and shared are (N, Cin) and (N, C2) rows in f32 or bf16; the weights are
// f32; all arithmetic is f32, as in the Pallas kernel; out takes shared's
// type.
//
// What bounds it on an H100: the products run in f32, 2*N*(Cin*hidden +
// hidden*C2) operations against N*(Cin + 2*C2) activation elements moved.
// At MTAN's shapes that is 33 to 56 operations per byte with f32
// activations and 67 to 112 with bf16, above the f32 ridge of the card
// (67 TFLOP/s over 3.35 TB/s = 20 per byte), so the f32 FMA rate bounds it,
// not device memory.
//
// Design: 256 threads for each tile of 32 rows. The (32, hidden)
// intermediate h lives in shared memory only (on the TPU it stayed in VMEM).
// w1 is streamed over Cin in chunks of 32 rows: at Cin = 640 it is 320 KB and
// does not fit. w2 is streamed in chunks that fill a 16 KB buffer. Every
// thread owns 4x4 register micro-tiles, so each shared-memory load feeds
// four FMAs. Plain SIMT f32 code: tensor cores and TMA are later work.

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

struct Pass {
  const void* x;
  const void* shared;
  void* out;
  // h = x @ w1 + c1 and a = h' @ w2 + c2
  const float* w1;
  const float* c1;
  const float* w2;
  const float* c2;
  long long n;
  int cin, hidden, c2ch;
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

// Copies `count` weights into shared memory.
__device__ __forceinline__ void stage_chunk(float* __restrict__ dst, const float* __restrict__ src,
                                            int count) {
  for (int i = threadIdx.x; i < count; i += kThreads) dst[i] = src[i];
}

template <typename T>
__global__ void __launch_bounds__(kThreads) gate_kernel(const Pass p) {
  __shared__ __align__(16) float xs[kChunkK * kRowsPad];     // x chunk, [k][row]
  __shared__ __align__(16) float ws[kWBuf];                  // w1 or w2 chunk, [k][col]
  __shared__ __align__(16) float hs[kMaxHidden * kRowsPad];  // h, [j][row]

  const T* __restrict__ x = static_cast<const T*>(p.x);
  const int tid = threadIdx.x;
  const long long n = p.n;
  const int cin = p.cin, hidden = p.hidden, c2ch = p.c2ch;
  const long long tiles = (n + kRows - 1) / kRows;

  const int h4 = hidden / 4;
  const bool own1 = tid < kGroups * h4;  // hidden <= 128: one micro-tile a thread
  const int tr1 = own1 ? tid / h4 : 0;
  const int tc1 = own1 ? tid % h4 : 0;
  const int c4 = c2ch / 4;
  const int tiles2 = kGroups * c4;
  const int jc = min(hidden, kWBuf / c2ch);

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * kRows;

    // ---- h = x @ w1 + c1 ----
    float acc1[4][4] = {};
    for (int k0 = 0; k0 < cin; k0 += kChunkK) {
      const int kc = min(kChunkK, cin - k0);
      __syncthreads();  // the previous chunk (or tile) has been consumed
      for (int i = tid; i < kRows * kChunkK; i += kThreads) {
        const int r = i / kChunkK, k = i % kChunkK;
        const long long gr = row0 + r;
        xs[k * kRowsPad + r] = (gr < n && k < kc) ? to_f32(x[gr * cin + k0 + k]) : 0.f;
      }
      stage_chunk(ws, p.w1 + (long long)k0 * hidden, kc * hidden);
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

    // ---- h' = relu(h), kept in shared memory; a = h' @ w2 + c2 ----
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
      stage_chunk(ws, p.w2 + (long long)j0 * c2ch, jn * c2ch);
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
}

bool shapes_ok(long long n, int cin, int hidden, int c2ch) {
  return n > 0 && cin > 0 && hidden > 0 && hidden <= kMaxHidden && hidden % 4 == 0 && c2ch > 0 &&
         c2ch <= kMaxC2 && c2ch % 4 == 0;
}

long long num_tiles(long long n) { return (n + kRows - 1) / kRows; }

void launch(const Pass& p, unsigned grid, bool bf16, cudaStream_t s) {
  if (bf16)
    gate_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(p);
  else
    gate_kernel<float><<<grid, kThreads, 0, s>>>(p);
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
  launch(p, (unsigned)num_tiles(n), is_bf16, reinterpret_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}
