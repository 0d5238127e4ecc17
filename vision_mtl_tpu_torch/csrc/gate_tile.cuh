// The tile body of MTAN's attention-gate kernels on Hopper (sm_90a):
// products in f32 accuracy on the tensor cores (3xTF32), operands staged in
// shared memory by cp.async. Included by csrc/fused_gate.cu (the eval gate),
// csrc/gate_train.cu (the train gate) and csrc/gate_train_backward.cu (its
// gradient).
//
// 3xTF32. Each f32 operand a is split as it is loaded from shared memory
// into a_hi, the TF32 rounding of a (cvt.rna), and a_lo, the TF32 rounding
// of a - a_hi; then a * b ~ a_lo * b_hi + a_hi * b_lo + a_hi * b_hi, three
// mma.sync.m16n8k8.tf32 with f32 accumulators. The dropped a_lo * b_lo is
// below f32's own rounding. A bf16 operand is exact in TF32 (a_lo = 0), so
// a product with a bf16 A takes two. One TF32 product alone keeps 11 bits
// of each operand: not enough for the gates' f32 limits
// (tests/test_torch_gate_tf32.py).
//
// A block is 256 threads: 8 warps, 4 along the rows x 2 along the columns.
// A warp owns 16 kMt rows x up to 64 columns (kNt n8 tiles), so a block
// covers up to 128 columns of a product. The A operand may be read
// transposed (mma_chunk_strided): the train gate's backward
// (csrc/gate_train_backward.cu) sums its weight gradients over the rows
// of row-major tiles.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace gate_tile {

constexpr int kThreads = 256;
constexpr int kWs = 128 + 8;  // weight chunk row pitch: = 8 mod 32, conflict-free B loads
constexpr int kHs = 128 + 4;  // h' row pitch
constexpr int kNt = 8;        // n8 tiles of a warp, at most (64 columns)

// A tile: kMt m16 tiles of rows per warp, contraction staged kK rows at a
// time. Large N takes Tile<2, 32> (128 rows; two blocks fit an SM, so one's
// loads overlap the other's products); small N Tile<1, 64> (64 rows, twice
// the blocks; half the pipeline steps, each with twice the products, since
// there a block's steps run one after another with little else on its SM).
template <int kMt, int kK>
struct Tile {
  static constexpr int kRows = 64 * kMt;      // pixel rows per tile
  static constexpr int kWarpRows = 16 * kMt;  // rows of a warp
  static constexpr int kChunk = kK;           // contraction rows per stage
  static constexpr int kXs = kK + 4;          // f32 x row pitch: 4g + tg spans the 32 banks
  static constexpr int kXsB = kK + 8;         // bf16 x row pitch (elements): 16-byte rows
};
using BigTile = Tile<2, 32>;
using SmallTile = Tile<1, 64>;

constexpr int kSMs = 132;  // SMs of an H100 SXM: sizes the grids, never the result

inline long long num_tiles(long long n, int rows) { return (n + rows - 1) / rows; }

// small N: fewer 128-row tiles than half the SMs (N at most 8,320)
inline bool small_n(long long n) { return num_tiles(n, BigTile::kRows) < kSMs / 2; }

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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; zeros when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = tf32(v - __uint_as_float(hi));
}

// d += a * b on a 16 x 8 x 8 tile: TF32 operands, f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// d = a * b, the same tile from zero
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4], const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

__device__ __forceinline__ float load_a(const float* p) { return *p; }
__device__ __forceinline__ float load_a(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// acc += A[:, k0 : k0 + 8 * k8] @ B[0 : 8 * k8, warp's columns], 3xTF32
// (2 products when A is bf16, exact in TF32). A is (rows, lda) in shared
// memory, B a staged weight chunk (rows of kWs). The tensor cores truncate
// as they accumulate, so each 8-deep step sums into a fresh partial, which
// is added to acc in f32 with rounding to nearest: over Cin = 640 the
// truncation would otherwise pile up to ~1e-6 of the result. The products
// of kG n8 tiles are issued in phases (every tile's first, then every
// second, ...), so that the tensor cores see independent products back to
// back rather than each waiting for the one before.
//
// mma_chunk_strided reads A's element (row i, contraction k) at A[i * a_rs
// + k * a_ks]: mma_chunk is a_rs = lda, a_ks = 1 from column k0.
template <int kMt, typename TA>
__device__ __forceinline__ void mma_chunk_strided(float (&acc)[kMt][kNt][4], const TA* A, int a_rs,
                                                  int a_ks, const float* B, int k8, int nt,
                                                  int row0, int col0) {
  constexpr bool kExactA = !std::is_same<TA, float>::value;
  const int lane = threadIdx.x & 31, g = lane >> 2, tg = lane & 3;
  for (int ks = 0; ks < k8; ++ks) {
    const int k = ks * 8;
    uint32_t ahi[kMt][4], alo[kMt][4];
#pragma unroll
    for (int m = 0; m < kMt; ++m) {
      const TA* a0 = A + (row0 + m * 16 + g) * a_rs + (k + tg) * a_ks;
      const float v[4] = {load_a(a0), load_a(a0 + 8 * a_rs), load_a(a0 + 4 * a_ks),
                          load_a(a0 + 8 * a_rs + 4 * a_ks)};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (kExactA) {
          ahi[m][i] = __float_as_uint(v[i]);
          alo[m][i] = 0u;
        } else {
          split(v[i], ahi[m][i], alo[m][i]);
        }
      }
    }
    constexpr int kG = 4 / kMt;  // n8 tiles per phase group
#pragma unroll
    for (int j0 = 0; j0 < kNt; j0 += kG) {
      if (j0 >= nt) break;
      uint32_t bhi[kG][2], blo[kG][2];
      float t[kMt][kG][4];
#pragma unroll
      for (int jj = 0; jj < kG; ++jj) {
        const float* b0 = B + (k + tg) * kWs + col0 + (j0 + jj) * 8 + g;
        split(b0[0], bhi[jj][0], blo[jj][0]);
        split(b0[4 * kWs], bhi[jj][1], blo[jj][1]);
      }
#pragma unroll
      for (int jj = 0; jj < kG; ++jj)
#pragma unroll
        for (int m = 0; m < kMt; ++m) {
          if (kExactA)
            mma_tf32_zero(t[m][jj], ahi[m], blo[jj]);
          else
            mma_tf32_zero(t[m][jj], alo[m], bhi[jj]);
        }
      if (!kExactA) {
#pragma unroll
        for (int jj = 0; jj < kG; ++jj)
#pragma unroll
          for (int m = 0; m < kMt; ++m) mma_tf32(t[m][jj], ahi[m], blo[jj]);
      }
#pragma unroll
      for (int jj = 0; jj < kG; ++jj)
#pragma unroll
        for (int m = 0; m < kMt; ++m) mma_tf32(t[m][jj], ahi[m], bhi[jj]);
#pragma unroll
      for (int jj = 0; jj < kG; ++jj) {
        if (j0 + jj >= nt) break;
#pragma unroll
        for (int m = 0; m < kMt; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][j0 + jj][e] += t[m][jj][e];
      }
    }
  }
}

template <int kMt, typename TA>
__device__ __forceinline__ void mma_chunk(float (&acc)[kMt][kNt][4], const TA* A, int lda, int k0,
                                          const float* B, int k8, int nt, int row0, int col0) {
  mma_chunk_strided<kMt>(acc, A + k0, lda, 1, B, k8, nt, row0, col0);
}

// Stages rows [k0, k0 + kK) x columns [col0, col0 + ncols) of the row-major
// (K, ld) weight w into a (kK, kWs) chunk; zeros past K and past the column
// limit `col_end`. ncols is a multiple of 4, at most 128.
template <int kK>
__device__ __forceinline__ void stage_w(float* dst, const float* w, int K, int ld, int k0,
                                        int col0, int col_end, int ncols) {
  const int segs = ncols / 4;
  for (int i = threadIdx.x; i < kK * segs; i += kThreads) {
    const int r = i / segs, s = i - r * segs;
    const int k = k0 + r, col = col0 + 4 * s;
    const bool valid = k < K && col < col_end;
    cp_async16(dst + r * kWs + 4 * s, valid ? w + (long long)k * ld + col : w, valid);
  }
}

// Stages rows [row0, row0 + kRows) x contraction [k0, k0 + kChunk) of x into
// a tile; zeros past N and Cin. `vec`: x's rows are 16-byte aligned and
// copied by cp.async, else element by element.
template <class Tl, typename T>
__device__ __forceinline__ void stage_x(T* dst, const T* x, long long n, int cin, long long row0,
                                        int k0, bool vec) {
  constexpr int kPer16 = 16 / sizeof(T);  // elements per 16 bytes
  constexpr int kPitch = sizeof(T) == 4 ? Tl::kXs : Tl::kXsB;
  if (vec) {
    constexpr int segs = Tl::kChunk / kPer16;
    for (int i = threadIdx.x; i < Tl::kRows * segs; i += kThreads) {
      const int r = i / segs, s = i - r * segs;
      const long long gr = row0 + r;
      const int k = k0 + s * kPer16;
      const bool valid = gr < n && k < cin;
      cp_async16(dst + r * kPitch + s * kPer16, valid ? x + gr * cin + k : x, valid);
    }
  } else {
    for (int i = threadIdx.x; i < Tl::kRows * Tl::kChunk; i += kThreads) {
      const int r = i / Tl::kChunk, k = i - r * Tl::kChunk;
      const long long gr = row0 + r;
      dst[r * kPitch + k] = (gr < n && k0 + k < cin) ? x[gr * cin + k0 + k] : from_f32<T>(0.f);
    }
  }
}

}  // namespace gate_tile
