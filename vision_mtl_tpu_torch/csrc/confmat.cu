// Confusion matrix, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `confusion_matrix` (`_kernel`) of
// vision_mtl_tpu/ops/pallas/confmat.py:
//
//     cm[t[i], p[i]] += 1   for every sample i whose mask is set
//
// rows are targets, columns predictions. A sample whose target or prediction
// lies outside [0, C) adds nothing and is never written out of bounds (the
// Pallas kernel's one-hot row is all zeros for it). The metric path's
// weights are 0/1 per sample (`valid`), so the weights come in as a byte
// mask (or none: every sample counts) and the counts are integers.
//
// Accumulation: integer. Each warp adds into one of up to eight (C, C)
// uint32 histograms in the block's shared memory, fed by a grid-stride loop;
// the block sums them and adds each nonzero cell to a uint32 (C, C) scratch
// in device memory with one atomicAdd. The last block to finish converts the
// scratch to the f32 output. Counts are exact up to 2^32 - 1 per cell in one
// call (metrics.py promises 2^31 per update); the f32 output is exact up to
// 2^24 per cell and rounds beyond it with relative error at most 2^-24, as
// the f32 result of the JAX package does.
//
// What bounds it on an H100: device memory. It reads 9 bytes per sample (two
// int32 ids and a mask byte) and does one integer add; at 8 x 128 x 256
// samples that is 2.4 MB, under a microsecond at 3.35 TB/s, so at this size
// the launch itself dominates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSub = kThreads / 32;  // one histogram per warp, at most
constexpr int kSmemBytes = 48 * 1024;   // dynamic shared memory without opt-in
constexpr int kItemsPerThread = 8;
constexpr int kMaxBlocks = 4 * 132;

__global__ void __launch_bounds__(kThreads)
confmat_kernel(const int32_t* __restrict__ t, const int32_t* __restrict__ p,
               const uint8_t* __restrict__ mask, long long n, int c, int nsub,
               unsigned int* __restrict__ scratch, unsigned int* __restrict__ done,
               float* __restrict__ out) {
  extern __shared__ unsigned int hist[];  // nsub x (c * c)
  __shared__ bool last_block;
  const int cc = c * c;
  for (int i = threadIdx.x; i < nsub * cc; i += kThreads) hist[i] = 0u;
  __syncthreads();

  unsigned int* mine = hist + ((threadIdx.x / 32) % nsub) * cc;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    const int ti = t[i], pi = p[i];
    if ((unsigned)ti < (unsigned)c && (unsigned)pi < (unsigned)c && (mask == nullptr || mask[i]))
      atomicAdd(&mine[ti * c + pi], 1u);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < cc; i += kThreads) {
    unsigned int s = 0u;
    for (int k = 0; k < nsub; ++k) s += hist[k * cc + i];
    if (s) atomicAdd(&scratch[i], s);
  }
  __threadfence();  // this block's adds are visible before it reports done
  __syncthreads();
  if (threadIdx.x == 0) last_block = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last_block) {
    __threadfence();
    for (int i = threadIdx.x; i < cc; i += kThreads)
      out[i] = (float)__ldcg(&scratch[i]);  // L2 read: other blocks' atomics land there
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch: 0 when the kernel was queued.
// t, p: n int32 ids; mask: n bytes (nonzero = counts) or NULL; scratch:
// c * c + 1 uint32, ZEROED by the caller (the last word is the blocks'
// done-counter); out: (c, c) float, written by the last block. c * c * 4
// bytes must fit the 48 KB of shared memory a block may use (c <= 110).
extern "C" int vmtl_confusion_matrix(const void* t, const void* p, const void* mask, long long n,
                                     int c, void* scratch, void* out, void* stream) {
  if (n < 0 || c <= 0 || (long long)c * c * 4 > kSmemBytes) return (int)cudaErrorInvalidValue;
  const int cc = c * c;
  int nsub = kSmemBytes / (cc * 4);
  if (nsub > kMaxSub) nsub = kMaxSub;
  long long blocks = (n + (long long)kThreads * kItemsPerThread - 1) / ((long long)kThreads * kItemsPerThread);
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  unsigned int* s = static_cast<unsigned int*>(scratch);
  confmat_kernel<<<(unsigned)blocks, kThreads, (size_t)nsub * cc * 4,
                   reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(t), static_cast<const int32_t*>(p),
      static_cast<const uint8_t*>(mask), n, c, nsub, s, s + cc, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
