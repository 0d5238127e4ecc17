// 3x3 stride-1 convolution for small channel counts, written by hand for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `conv3x3_small` (`_kernel`, `_pack_rhs`,
// `_halos`, `_conv3x3_pallas`) of vision_mtl_tpu/ops/pallas/small_conv.py:
//
//     out[b, h, w, o] = cast(sum_{du, dv, c} x[b, h+du-1, w+dv-1, c] * k[du, dv, c, o] + bias[o])
//
// NHWC input (B, H, W, C) and output (B, H, W, O) in T (bf16 or f32), HWIO
// weights (3, 3, C, O), bias (O,) in f32 or none. The weights are rounded to
// T before the products, as the Pallas kernel's `_pack_rhs(kernel,
// x.dtype)` does; products and sums in f32; the bias is added in f32 and the
// result is cast to T once. Zero padding of one pixel on every side, done
// here. Any H and W; C, O <= 104 (the port calls it for C, O < 100).
//
// The TPU kernel packs the three row taps into the contraction and the
// three column taps into the output lanes, (T*W, 3C) @ (3C, 3O), to fill
// 128-lane MXU tiles. None of that applies here. The C entry dispatches on
// the type:
//
// * bf16: `conv3x3_small_tc_kernel`, an implicit GEMM on the tensor cores
//   (mma.sync.m16n8k16, bf16 operands, f32 sums: the Pallas kernel's
//   dot_general with preferred_element_type=f32). M is a 4 x 64
//   tile of output pixels, N the output channels rounded up to 8, K per tap
//   the input channels rounded up to 16. A block stages the rounded
//   weights of all 9 taps once, as [tap][o][c] (read from the f32 weights
//   at any strides, so the caller neither casts nor copies them), then
//   walks its tiles: the (4 + 2) x (64 + 2) input tile with its halo is read
//   as 16-byte chunks of the image rows (a pixel of 67 or 33 bf16 channels
//   is only 2-byte aligned; a row span is contiguous; the chunks are counted
//   from the 16-byte boundary at or below x, so x itself may start
//   anywhere) and repacked into a
//   [pixel][channel] layout padded to C16 + 8 channels, whose 16-byte rows
//   ldmatrix takes without bank conflicts. Every padded channel and weight
//   is zeroed explicitly. Warp w computes output row w / 2, 32 columns (two
//   m16 tiles) by all the block's output channels. The output tile is
//   staged in shared memory and written out as whole row spans. Where the
//   weights and tiles exceed the 227 KB a block may use (C, O near 100),
//   the output channels are split across blockIdx.y.
// * f32: `conv3x3_small_kernel`, a SIMT kernel on f32 FMAs (each lane a
//   4 x 8 accumulator of a 4 x 32 tile, 8 input channels staged at a time),
//   which beats cuDNN's f32 conv at these shapes and carries the f32
//   train-step check.
//
// Summation orders are fixed (taps, then channels; every output is one
// thread's), so results are bit-identical from launch to launch.
//
// What bounds it on an H100: at the basic model's decoder tail (batch 8,
// 128 x 256 at the largest) the four convolutions do 24 GFLOP and move
// 132 MB in bf16; the bf16 tensor cores would need 0.024 ms and the memory
// 0.040 ms, so the bytes bound it. The SIMT f32 kernel is bound by the f32
// FMA rate (67 TFLOP/s).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// f32: SIMT kernel
// ---------------------------------------------------------------------------

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
constexpr int kMaxChannels = kMaxWarps * kOcPerWarp;

static_assert(kTileW == 8 * kPix && kTileH == 4, "a warp's 32 lanes cover the tile");

__global__ void __launch_bounds__(kMaxThreads)
conv3x3_small_kernel(const float* __restrict__ x, const float* __restrict__ k,
                     const float* __restrict__ bias, float* __restrict__ out,
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
  const float* xb = x + (size_t)b * H * W * C;

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
      if (h >= 0 && h < H && w >= 0 && w < W && c < C) v = xb[((size_t)h * W + w) * C + c];
      xs[cc * kChanPitch + ry * kRowPitch + cx] = v;
    }
    // weights of this chunk, output channels fastest, zero past C and O
    for (int i = threadIdx.x; i < kChunk * 9 * oc_pad; i += blockDim.x) {
      const int o = i % oc_pad, rest = i / oc_pad;
      const int tap = rest % 9, cc = rest / 9, c = c0 + cc;
      float v = 0.f;
      if (c < C && o < O) v = k[((size_t)tap * C + c) * O + o];
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
    float* o = out + (((size_t)b * H + h) * W + w) * O;
#pragma unroll
    for (int i = 0; i < kOcPerWarp; ++i) {
      const int oc = oc0 + i;
      if (oc < O) o[oc] = acc[p][i] + (bias != nullptr ? bias[oc] : 0.f);
    }
  }
}

int launch_f32(const float* x, const float* k, const float* bias, float* out, int B, int H,
               int W, int C, int O, cudaStream_t stream) {
  const int warps = (O + kOcPerWarp - 1) / kOcPerWarp;
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const long long tiles = (long long)((H + kTileH - 1) / kTileH) * tiles_w;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (kChunk * kChanPitch + kChunk * 9 * warps * kOcPerWarp);
  conv3x3_small_kernel<<<dim3((unsigned)tiles, (unsigned)B), 32 * warps, smem, stream>>>(
      x, k, bias, out, H, W, C, O, tiles_w);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor-core implicit GEMM
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;           // 8 warps
constexpr int kTileH = 4;               // output rows per tile
constexpr int kTileW = 64;              // output columns per tile
constexpr int kInH = kTileH + 2;
constexpr int kInW = kTileW + 2;
constexpr int kMaxNt = 9;               // n8 tiles of output channels a block computes, at most

// n / d by a multiply, exact for n * d < 2^32
struct FastDiv {
  unsigned m;
  int d;
};

FastDiv make_div(int d) { return {d == 1 ? 0u : 0xFFFFFFFFu / (unsigned)d + 1u, d}; }

__device__ __forceinline__ int fdiv(int n, FastDiv f) {
  return f.d == 1 ? n : (int)__umulhi((unsigned)n, f.m);
}

struct Args {
  const bf16* x;        // the 16-byte boundary at or below the input
  int xoff;             // elements from there to the input's first, 0..7
  const float* k;
  const float* bias;
  bf16* out;
  long long ks[4];      // strides of k (du, dv, c, o), in elements
  int B, H, W, C, O;
  int cpad;             // C rounded up to 16: the contraction per tap
  int cs;               // channel stride of a staged pixel or weight row: cpad + 8
  int og;               // output channels a block computes: a multiple of 8
  int tiles_h, tiles_w, tiles;  // spatial tiles per image row, column; in all
  int cmax;             // 16-byte chunks of a staged row span, at most
  FastDiv div_c, div_cs, div_cmax, div_tiles_w;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

// d = a * b on a 16 x 8 x 16 tile: bf16 operands, f32 result
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

__global__ void __launch_bounds__(kThreads) conv3x3_small_tc_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ws = reinterpret_cast<bf16*>(smem_raw);  // [9][og][cs] weights, k-contiguous
  bf16* xs = ws + 9 * a.og * a.cs;               // [kInH][kInW][cs] input tile with halo
  bf16* os = xs + kInH * kInW * a.cs;            // [kTileH * kTileW][ogv] output tile
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int C = a.C, cs = a.cs;
  const int o0 = blockIdx.y * a.og;              // first output channel of the block
  const int ogv = min(a.og, a.O - o0);           // of them real
  const int nt = (ogv + 7) / 8;
  const bf16 zero = __float2bfloat16_rn(0.f);

  // weights of all taps, rounded to bf16, zero past C and O; taps fastest,
  // then channels, so the HWIO view of an OIHW weight reads contiguously
  for (int i = tid; i < 9 * a.og * cs; i += kThreads) {
    const int rest = i / 9, tap = i - rest * 9;
    const int ol = fdiv(rest, a.div_cs), c = rest - ol * cs;
    const int o = o0 + ol;
    float v = 0.f;
    if (c < C && ol < ogv) {
      const int du = tap / 3, dv = tap - du * 3;
      v = __ldg(a.k + du * a.ks[0] + dv * a.ks[1] + c * a.ks[2] + o * a.ks[3]);
    }
    ws[(tap * a.og + ol) * cs + c] = __float2bfloat16_rn(v);
  }
  // the input tile's padded channels stay zero; staging writes channels < C
  for (int i = tid; i < kInH * kInW * (cs - C); i += kThreads) {
    const int pix = i / (cs - C);
    xs[pix * cs + C + (i - pix * (cs - C))] = zero;
  }

  const int wr = warp >> 1;                      // output row of the warp within the tile
  const int wc = (warp & 1) * 32;                // its first output column
  const int g = lane >> 2, tg = lane & 3;
  // ldmatrix row addresses: A rows are pixels (lane & 15), k half lane >> 4;
  // B rows are output channels (lane & 7), k half (lane >> 3) & 1
  const bf16* a_lane = xs + (wr * kInW + wc + (lane & 15)) * cs + (lane >> 4) * 8;
  const bf16* b_lane = ws + (lane & 7) * cs + ((lane >> 3) & 1) * 8;
  const size_t img = (size_t)a.H * a.W;

  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
    const int per_img = a.tiles_h * a.tiles_w;
    const int b = t / per_img, tr = t - b * per_img;
    const int th = fdiv(tr, a.div_tiles_w), tw = tr - th * a.tiles_w;
    const int h0 = th * kTileH, w0 = tw * kTileW;

    // ---- stage the input tile: image pixels [h0-1, h0+kTileH] x [w0-1, w0+kTileW]
    // pixels outside the image: zero
    for (int i = tid; i < kInH * kInW; i += kThreads) {
      const int y = i / kInW, px = i - y * kInW;
      const int h = h0 - 1 + y, w = w0 - 1 + px;
      if (h < 0 || h >= a.H || w < 0 || w >= a.W)
        for (int c = 0; c < C; ++c) xs[i * cs + c] = zero;
    }
    // pixels inside: each staged row's span of in-image pixels is contiguous
    // in memory; read it as aligned 16-byte chunks and scatter the elements
    for (int i0 = tid; i0 < kInH * a.cmax; i0 += 4 * kThreads) {
      uint4 v[4];
      int e0[4], n_el[4], dst0[4];  // first element's place in the span; span length; its row
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * kThreads;
        const int y = fdiv(i, a.div_cmax), q = i - y * a.cmax;
        const int h = h0 - 1 + y;
        const int pa = max(0, 1 - w0), pb = min(kInW, a.W - w0 + 1);
        const bool row_ok = i < kInH * a.cmax && h >= 0 && h < a.H && pb > pa;
        const long long s0 =
            ((long long)b * img + (long long)h * a.W + (w0 - 1 + pa)) * C + a.xoff;
        const long long c0 = (s0 & ~7LL) + 8LL * q;  // 8 bf16 per chunk; a.x is 16-byte aligned
        n_el[u] = (pb - pa) * C;
        e0[u] = (int)(c0 - s0);                      // >= -7
        dst0[u] = (y * kInW + pa) * cs;
        const bool live = row_ok && e0[u] < n_el[u];
        if (!live) n_el[u] = 0;
        v[u] = live ? __ldg(reinterpret_cast<const uint4*>(a.x + c0)) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (n_el[u] == 0) continue;
        const bf16* e8 = reinterpret_cast<const bf16*>(&v[u]);
        const int j0 = max(0, -e0[u]), j1 = min(8, n_el[u] - e0[u]);
        const int e = e0[u] + j0;
        const int px = fdiv(e, a.div_c);
        int c = e - px * C;
        int d = dst0[u] + px * cs + c;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j < j0 || j >= j1) continue;
          xs[d] = e8[j];
          ++d;
          if (++c == C) {  // the next pixel
            c = 0;
            d += cs - C;
          }
        }
      }
    }
    __syncthreads();

    // ---- products: acc[m16 tile][n8 tile] over 9 taps x cpad / 16 steps. The
    // tensor cores truncate as they accumulate, so each step's product is
    // taken from zero and added to acc in f32 with rounding to nearest.
    float acc[2][kMaxNt][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < kMaxNt; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

    for (int tap = 0; tap < 9; ++tap) {
      const int du = tap / 3, dv = tap - du * 3;
      const bf16* a_tap = a_lane + (du * kInW + dv) * cs;
      const bf16* b_tap = b_lane + tap * a.og * cs;
      for (int kk = 0; kk < a.cpad; kk += 16) {
        uint32_t af[2][4];
        ldmatrix_x4(af[0], a_tap + kk);
        ldmatrix_x4(af[1], a_tap + 16 * cs + kk);
        // kG n8 tiles at a time: their B fragments, then their 2 kG
        // independent products back to back, then the adds
        constexpr int kG = 3;
#pragma unroll
        for (int j0 = 0; j0 < kMaxNt; j0 += kG) {
          if (j0 >= nt) break;
          uint32_t bfr[kG][2];
          float t[kG][2][4];
#pragma unroll
          for (int jj = 0; jj < kG; ++jj) ldmatrix_x2(bfr[jj], b_tap + (j0 + jj) * 8 * cs + kk);
#pragma unroll
          for (int jj = 0; jj < kG; ++jj)
#pragma unroll
            for (int m = 0; m < 2; ++m) mma_bf16(t[jj][m], af[m], bfr[jj]);
#pragma unroll
          for (int jj = 0; jj < kG; ++jj) {
            if (j0 + jj >= nt) break;
#pragma unroll
            for (int m = 0; m < 2; ++m)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[m][j0 + jj][e] += t[jj][m][e];
          }
        }
      }
    }

    // ---- epilogue: + bias in f32, one cast, into the output tile
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < kMaxNt; ++j) {
        if (j >= nt) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ol = j * 8 + 2 * tg + (e & 1);
          if (ol >= ogv) continue;
          const int p = wr * kTileW + wc + m * 16 + g + (e >> 1) * 8;
          const float bv = a.bias != nullptr ? a.bias[o0 + ol] : 0.f;
          os[p * ogv + ol] = __float2bfloat16_rn(acc[m][j][e] + bv);
        }
      }
    __syncthreads();  // the tile's products are done with xs; os is complete

    // ---- write the output tile, row by row
    const int nw = min(kTileW, a.W - w0);
    for (int r = 0; r < kTileH; ++r) {
      const int h = h0 + r;
      if (h >= a.H) break;
      bf16* dst = a.out + (((size_t)b * img + (size_t)h * a.W + w0) * a.O + o0);
      const bf16* src = os + r * kTileW * ogv;
      if (ogv == a.O) {  // one contiguous span of nw * O elements
        const int n = nw * ogv;
        if (((reinterpret_cast<uintptr_t>(dst) | (uintptr_t)(2 * n)) & 15) == 0) {
          for (int i = tid; i < n / 8; i += kThreads)
            reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
        } else {
          for (int i = tid; i < n; i += kThreads) dst[i] = src[i];
        }
      } else {  // this block's channels of each pixel
        for (int i = tid; i < nw * ogv; i += kThreads) {
          const int p = i / ogv, ol = i - p * ogv;
          dst[(size_t)p * a.O + ol] = src[i];
        }
      }
    }
  }
}

int device_attr(cudaDeviceAttr attr) {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, attr, dev);
  return v;
}

int launch(const bf16* x, const float* k, const long long* ks, const float* bias, bf16* out,
           int B, int H, int W, int C, int O, cudaStream_t stream) {
  // read from the 16-byte boundary at or below x: each chunk read holds an
  // element of x, so it lies in x's pages
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x);
  if (addr & 1) return (int)cudaErrorMisalignedAddress;
  Args a = {};
  a.xoff = (int)((addr & 15) >> 1);
  a.x = x - a.xoff;
  a.k = k;
  a.bias = bias;
  a.out = out;
  for (int i = 0; i < 4; ++i) a.ks[i] = ks[i];
  a.B = B;
  a.H = H;
  a.W = W;
  a.C = C;
  a.O = O;
  a.cpad = (C + 15) / 16 * 16;
  a.cs = a.cpad + 8;
  const long long tiles_h = (H + kTileH - 1) / kTileH, tiles_w = (W + kTileW - 1) / kTileW;
  const long long tiles = B * tiles_h * tiles_w;
  if (tiles > 0x7fffffffLL || (long long)B * H * W * C > (1LL << 40)) return (int)cudaErrorInvalidValue;
  a.tiles_h = (int)tiles_h;
  a.tiles_w = (int)tiles_w;
  a.tiles = (int)tiles;
  a.cmax = (kInW * C * 2 + 15) / 16 + 1;

  // output channels per block: all of them, unless the weights and tiles
  // then exceed what a block may use
  const int max_smem = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  const int n8 = (O + 7) / 8;
  int groups = 1;
  size_t smem = 0;
  for (;; ++groups) {
    const int per = (n8 + groups - 1) / groups;
    if (per > kMaxNt) continue;
    a.og = per * 8;
    smem = sizeof(bf16) * ((size_t)9 * a.og * a.cs + (size_t)kInH * kInW * a.cs +
                           (size_t)kTileH * kTileW * a.og);
    if (smem <= (size_t)max_smem) break;
    if (per == 1) return (int)cudaErrorInvalidValue;
  }
  groups = (n8 * 8 + a.og - 1) / a.og;
  a.div_c = make_div(C);
  a.div_cs = make_div(a.cs);
  a.div_cmax = make_div(a.cmax);
  a.div_tiles_w = make_div(a.tiles_w);

  // host-side set-up, cached: the opt-in to all of a block's shared memory
  // once, and the blocks an SM holds for the last size asked (a stale value
  // from a racing caller only sizes the grid, never the result)
  static bool opted_in = false;
  static size_t occ_smem = 0;
  static int occ_blocks = 0;
  cudaError_t err;
  if (!opted_in) {
    err = cudaFuncSetAttribute(conv3x3_small_tc_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  int per_sm = smem == occ_smem ? occ_blocks : 0;
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv3x3_small_tc_kernel,
                                                         kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    occ_blocks = per_sm;
    occ_smem = smem;
  }
  const long long slots = (long long)per_sm * device_attr(cudaDevAttrMultiProcessorCount);
  const long long gx = tiles < (slots + groups - 1) / groups ? tiles : (slots + groups - 1) / groups;
  conv3x3_small_tc_kernel<<<dim3((unsigned)gx, (unsigned)groups), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// Returns the CUDA error of the launch: 0 when the kernel was queued.
// x: (B, H, W, C) and out: (B, H, W, O), contiguous, in bf16 when `bf16` is
// nonzero, else f32. k: (3, 3, C, O) float32 weights at element strides
// ks0..ks3 (any layout for bf16; f32 needs them contiguous). bias: O floats
// or NULL. Needs B, H, W, C, O >= 1, B <= 65535, C, O <= 104, and x aligned
// to its element. Runs on `stream`, allocates nothing, does not
// synchronise.
extern "C" int vmtl_conv3x3_small(const void* x, const void* k, const void* bias, void* out,
                                  int B, int H, int W, int C, int O, long long ks0, long long ks1,
                                  long long ks2, long long ks3, int bf16, void* stream) {
  const long long k_strides[4] = {ks0, ks1, ks2, ks3};
  if (B < 1 || B > 65535 || H < 1 || W < 1 || C < 1 || O < 1 || C > kMaxChannels ||
      O > kMaxChannels)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* kf = static_cast<const float*>(k);
  const float* bf = static_cast<const float*>(bias);
  if (bf16)
    return tc::launch(static_cast<const __nv_bfloat16*>(x), kf, k_strides, bf,
                      static_cast<__nv_bfloat16*>(out), B, H, W, C, O, s);
  const long long contiguous[4] = {3LL * C * O, (long long)C * O, O, 1};
  for (int i = 0; i < 4; ++i)
    if (k_strides[i] != contiguous[i]) return (int)cudaErrorInvalidValue;
  return launch_f32(static_cast<const float*>(x), kf, bf, static_cast<float*>(out), B, H, W, C,
                    O, s);
}
