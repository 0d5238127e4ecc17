// MTAN's inference-mode attention gate, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `fused_attention_gate` (`_kernel`) of
// vision_mtl_tpu/ops/pallas/fused_gate.py. Per pixel row:
//
//     out = shared * sigmoid(relu(x @ w1 + c1) @ w2 + c2)
//
// with both BatchNorms already folded into (w1, c1) and (w2, c2) by the
// caller. x and shared are (N, Cin) and (N, C2) rows in f32 or bf16; the
// weights are f32; all arithmetic is f32, as in the Pallas kernel; out takes
// shared's type.
//
// What bounds it on an H100: the products run in f32, 2*N*(Cin*hidden +
// hidden*C2) operations against N*(Cin + 2*C2) activation elements moved.
// At MTAN's shapes that is 33 to 56 operations per byte with f32
// activations and 67 to 112 with bf16, above the f32 ridge of the card
// (67 TFLOP/s over 3.35 TB/s = 20 per byte), so the f32 FMA rate bounds it,
// not device memory.
//
// Design: one block of 256 threads for each tile of 32 rows. The (32, hidden)
// intermediate h lives in shared memory only and never reaches device memory
// (on the TPU it stayed in VMEM). w1 is streamed over Cin in chunks of 32
// rows: at Cin = 640 it is 320 KB and does not fit. w2 is streamed in chunks
// that fill a 16 KB buffer. Every thread owns 4x4 register micro-tiles, so
// each shared-memory load feeds four FMAs. Plain SIMT f32 code: tensor cores
// (wgmma) and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;                // pixel rows per block
constexpr int kRowsPad = kRows + 4;      // transposed tiles: rows stay 16 B aligned
constexpr int kChunkK = 32;              // rows of w1 (input channels) per chunk
constexpr int kWBuf = 4096;              // floats in the weight-chunk buffer (16 KB)
constexpr int kMaxHidden = 128;
constexpr int kMaxC2 = 512;
// 4x4 micro-tiles of the (32, C2) output a thread owns, at most
constexpr int kMaxTiles = (kRows / 4) * (kMaxC2 / 4) / kThreads;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
gate_kernel(const T* __restrict__ x, const T* __restrict__ shared,
            const float* __restrict__ w1, const float* __restrict__ c1,
            const float* __restrict__ w2, const float* __restrict__ c2,
            T* __restrict__ out, long long n, int cin, int hidden, int c2ch) {
  __shared__ __align__(16) float xs[kChunkK * kRowsPad];     // x chunk, [k][row]
  __shared__ __align__(16) float ws[kWBuf];                  // w1 or w2 chunk, [k][col]
  __shared__ __align__(16) float hs[kMaxHidden * kRowsPad];  // h, [j][row]

  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * kRows;

  // ---- h = relu(x @ w1 + c1), kept in shared memory ----
  const int h4 = hidden / 4;
  const bool own1 = tid < (kRows / 4) * h4;  // hidden <= 128: one micro-tile a thread
  const int tr1 = own1 ? tid / h4 : 0;
  const int tc1 = own1 ? tid % h4 : 0;
  float acc1[4][4] = {};
  for (int k0 = 0; k0 < cin; k0 += kChunkK) {
    const int kc = min(kChunkK, cin - k0);
    __syncthreads();  // the previous chunk has been consumed
    for (int i = tid; i < kRows * kChunkK; i += kThreads) {
      const int r = i / kChunkK, k = i % kChunkK;
      const long long gr = row0 + r;
      xs[k * kRowsPad + r] = (gr < n && k < kc) ? to_f32(x[gr * cin + k0 + k]) : 0.f;
    }
    for (int i = tid; i < kc * hidden; i += kThreads) ws[i] = w1[(long long)k0 * hidden + i];
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
      const int j = tc1 * 4 + c;
      const float b = c1[j];
      const float4 v = make_float4(fmaxf(acc1[0][c] + b, 0.f), fmaxf(acc1[1][c] + b, 0.f),
                                   fmaxf(acc1[2][c] + b, 0.f), fmaxf(acc1[3][c] + b, 0.f));
      *reinterpret_cast<float4*>(&hs[j * kRowsPad + tr1 * 4]) = v;
    }
  }

  // ---- a = h @ w2 + c2; out = shared * sigmoid(a) ----
  const int c4 = c2ch / 4;
  const int tiles2 = (kRows / 4) * c4;
  const int jc = min(hidden, kWBuf / c2ch);
  float acc2[kMaxTiles][4][4] = {};
  for (int j0 = 0; j0 < hidden; j0 += jc) {
    const int jn = min(jc, hidden - j0);
    __syncthreads();  // hs is complete; the previous w2 chunk has been consumed
    for (int i = tid; i < jn * c2ch; i += kThreads) ws[i] = w2[(long long)j0 * c2ch + i];
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
        const float a = acc2[m][r][c] + c2[col];
        const float gate = 1.f / (1.f + expf(-a));
        const long long o = gr * c2ch + col;
        out[o] = from_f32<T>(to_f32(shared[o]) * gate);
      }
    }
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch: 0 when the kernel was queued.
// x, shared, out: (n, cin), (n, c2ch), (n, c2ch) rows of float (is_bf16 = 0)
// or bf16 (is_bf16 = 1); w1 (cin, hidden), c1 (hidden), w2 (hidden, c2ch),
// c2 (c2ch) float. hidden and c2ch must be multiples of 4, hidden <= 128,
// c2ch <= 512. Runs on `stream`, allocates nothing and does not synchronise.
extern "C" int vmtl_fused_attention_gate(const void* x, const void* shared, const void* w1,
                                         const void* c1, const void* w2, const void* c2,
                                         void* out, long long n, int cin, int hidden, int c2ch,
                                         int is_bf16, void* stream) {
  if (n <= 0 || cin <= 0 || hidden <= 0 || hidden > kMaxHidden || hidden % 4 != 0 ||
      c2ch <= 0 || c2ch > kMaxC2 || c2ch % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n + kRows - 1) / kRows));
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* fw1 = static_cast<const float*>(w1);
  const float* fc1 = static_cast<const float*>(c1);
  const float* fw2 = static_cast<const float*>(w2);
  const float* fc2 = static_cast<const float*>(c2);
  if (is_bf16) {
    gate_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(shared), fw1, fc1,
        fw2, fc2, static_cast<__nv_bfloat16*>(out), n, cin, hidden, c2ch);
  } else {
    gate_kernel<float><<<grid, kThreads, 0, s>>>(static_cast<const float*>(x),
                                                 static_cast<const float*>(shared), fw1, fc1, fw2,
                                                 fc2, static_cast<float*>(out), n, cin, hidden, c2ch);
  }
  return (int)cudaGetLastError();
}
