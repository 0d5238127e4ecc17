// 3x3 stride-1 convolution for small channel counts, written by hand for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `conv3x3_small` (`_kernel`, `_pack_rhs`,
// `_halos`, `_conv3x3_pallas`) of vision_mtl_tpu/ops/pallas/small_conv.py:
//
//     out[b, h, w, o] = cast(sum_{du, dv, c} x[b, h+du-1, w+dv-1, c] * k[du, dv, c, o] + bias[o])
//
// NHWC input (B, H, W, C) and output (B, H, W, O) in T (bf16 or f32), HWIO
// weights (3, 3, C, O) already cast to T by the caller (so bf16 products see
// bf16-rounded weights, as the Pallas kernel's `_pack_rhs(kernel, x.dtype)`
// does), bias (O,) in f32 or none. Products and sums in f32; the bias is
// added in f32 and the result is cast to T once. Zero padding of one pixel
// on every side, done here: a staged pixel outside the image reads as 0.
// Any H and W; ragged tiles are masked. O <= 104 (the port calls it for
// C, O < 100).
//
// The TPU kernel packs the three row taps into the contraction and the
// three column taps into the output lanes, (T*W, 3C) @ (3C, 3O), to fill
// 128-lane MXU tiles. None of that applies here. Design: one block per
// (image, 4 x 32 output tile); warp w computes output channels [8w, 8w + 8)
// of the whole tile, each lane 4 consecutive columns of one row, so a thread
// keeps a 4 x 8 f32 accumulator in registers. Input channels are staged 8
// at a time: the (4 + 2) x (32 + 2) input tile with its halo, as f32 in a
// channel-major layout whose row pitch (37) makes a warp's 32 column reads
// fall in 32 different banks, and the matching (8, 9, O') weights, O'
// rounded up to 8 with zeros, which every lane of a warp reads at one
// address (a broadcast). Per staged channel and row tap a lane reads 6
// inputs and 6 weight vectors and does 96 FMAs. Summation order is fixed
// (channels, then row taps, then column taps), so results are bit-identical
// from launch to launch.
//
// What bounds it on an H100: at the basic model's decoder tail (batch 8,
// 128 x 256 at the largest) the four convolutions do 24 GFLOP and move
// 132 MB in bf16; the bf16 tensor cores would need 0.024 ms and the memory
// 0.040 ms, so the bytes bound it. This kernel runs on the f32 SIMT units
// (67 TFLOP/s), whose peak alone puts it at 0.36 ms or more: the products,
// not the bytes, limit it. Tensor cores (mma.sync / wgmma) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 4;              // output rows per block
constexpr int kTileW = 32;             // output columns per block
constexpr int kPix = 4;                // consecutive output columns per lane
constexpr int kOcPerWarp = 8;          // output channels per warp (and per lane)
constexpr int kChunk = 8;              // input channels staged per step
constexpr int kInRows = kTileH + 2;
constexpr int kInCols = kTileW + 2;
constexpr int kRowPitch = 37;          // >= kInCols, = 1 mod 4: conflict-free lane reads
constexpr int kChanPitch = kInRows * kRowPitch;
constexpr int kMaxWarps = 13;          // O <= 104
constexpr int kMaxThreads = 32 * kMaxWarps;

static_assert(kTileW == 8 * kPix && kTileH == 4, "a warp's 32 lanes cover the tile");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
conv3x3_small_kernel(const T* __restrict__ x, const T* __restrict__ k,
                     const float* __restrict__ bias, T* __restrict__ out,
                     int H, int W, int C, int O, int tiles_w) {
  extern __shared__ __align__(16) float smem[];
  const int oc_pad = (blockDim.x / 32) * kOcPerWarp;
  float* xs = smem;                          // [kChunk][kInRows][kRowPitch]
  float* ws = smem + kChunk * kChanPitch;    // [kChunk][9][oc_pad]

  const int b = blockIdx.y;
  const int h0 = (blockIdx.x / tiles_w) * kTileH;
  const int w0 = (blockIdx.x % tiles_w) * kTileW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane / 8;                    // output row within the tile
  const int col0 = (lane % 8) * kPix;        // first output column within the tile
  const int oc0 = warp * kOcPerWarp;
  const T* xb = x + (size_t)b * H * W * C;

  float acc[kPix][kOcPerWarp];
#pragma unroll
  for (int p = 0; p < kPix; ++p)
#pragma unroll
    for (int i = 0; i < kOcPerWarp; ++i) acc[p][i] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kChunk) {
    __syncthreads();  // the previous chunk's reads are done
    // input tile with halo; channels fastest, so neighbouring threads read
    // neighbouring addresses
    for (int i = threadIdx.x; i < kChunk * kInRows * kInCols; i += blockDim.x) {
      const int cc = i % kChunk, pix = i / kChunk;
      const int ry = pix / kInCols, cx = pix % kInCols;
      const int h = h0 - 1 + ry, w = w0 - 1 + cx, c = c0 + cc;
      float v = 0.f;
      if (h >= 0 && h < H && w >= 0 && w < W && c < C) v = to_f32(xb[((size_t)h * W + w) * C + c]);
      xs[cc * kChanPitch + ry * kRowPitch + cx] = v;
    }
    // weights of this chunk, output channels fastest, zero past C and O
    for (int i = threadIdx.x; i < kChunk * 9 * oc_pad; i += blockDim.x) {
      const int o = i % oc_pad, rest = i / oc_pad;
      const int tap = rest % 9, cc = rest / 9, c = c0 + cc;
      float v = 0.f;
      if (c < C && o < O) v = to_f32(k[((size_t)tap * C + c) * O + o]);
      ws[i] = v;
    }
    __syncthreads();

#pragma unroll 2
    for (int cc = 0; cc < kChunk; ++cc) {
      const float* xrow = xs + cc * kChanPitch + r * kRowPitch + col0;
      const float* wc = ws + cc * 9 * oc_pad + oc0;
#pragma unroll
      for (int du = 0; du < 3; ++du) {
        float xv[kPix + 2];
#pragma unroll
        for (int j = 0; j < kPix + 2; ++j) xv[j] = xrow[du * kRowPitch + j];
#pragma unroll
        for (int dv = 0; dv < 3; ++dv) {
          const float4 wa = *reinterpret_cast<const float4*>(wc + (du * 3 + dv) * oc_pad);
          const float4 wb = *reinterpret_cast<const float4*>(wc + (du * 3 + dv) * oc_pad + 4);
          const float wv[kOcPerWarp] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int p = 0; p < kPix; ++p)
#pragma unroll
            for (int i = 0; i < kOcPerWarp; ++i) acc[p][i] = fmaf(xv[p + dv], wv[i], acc[p][i]);
        }
      }
    }
  }

  const int h = h0 + r;
  if (h >= H) return;
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const int w = w0 + col0 + p;
    if (w >= W) continue;
    T* o = out + (((size_t)b * H + h) * W + w) * O;
#pragma unroll
    for (int i = 0; i < kOcPerWarp; ++i) {
      const int oc = oc0 + i;
      if (oc < O) o[oc] = from_f32<T>(acc[p][i] + (bias != nullptr ? bias[oc] : 0.f));
    }
  }
}

template <typename T>
int launch(const void* x, const void* k, const void* bias, void* out, int B, int H, int W,
           int C, int O, cudaStream_t stream) {
  const int warps = (O + kOcPerWarp - 1) / kOcPerWarp;
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const long long tiles = (long long)((H + kTileH - 1) / kTileH) * tiles_w;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (kChunk * kChanPitch + kChunk * 9 * warps * kOcPerWarp);
  conv3x3_small_kernel<T><<<dim3((unsigned)tiles, (unsigned)B), 32 * warps, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(k), static_cast<const float*>(bias),
      static_cast<T*>(out), H, W, C, O, tiles_w);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch: 0 when the kernel was queued.
// x: (B, H, W, C) and k: (3, 3, C, O) in T, out: (B, H, W, O) in T, all
// contiguous; T is bf16 when `bf16` is nonzero, else f32. bias: O floats or
// NULL. Needs B, H, W, C, O >= 1, B <= 65535 and O <= 104; the shared memory
// (at most 37 KB at O = 104) stays under the 48 KB a block may use without
// opting in.
extern "C" int vmtl_conv3x3_small(const void* x, const void* k, const void* bias, void* out,
                                  int B, int H, int W, int C, int O, int bf16, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || C < 1 || O < 1 || O > kMaxWarps * kOcPerWarp)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (bf16) return launch<__nv_bfloat16>(x, k, bias, out, B, H, W, C, O, s);
  return launch<float>(x, k, bias, out, B, H, W, C, O, s);
}
