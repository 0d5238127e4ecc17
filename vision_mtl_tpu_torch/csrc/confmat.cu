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
// uint32 histograms in the block's shared memory, one shared-memory atomic
// add per sample. Lanes of a warp that add to one cell at once do not slow
// it down on an H100: with one class everywhere the kernel is faster than
// with uniform ids, and adding equal cells once per warp first
// (__match_any_sync, or one add where all lanes agree) was slower on each
// of the label mixes chip_smoke.py times. A lane takes 16 samples at a time
// with 16-byte loads: four of each id array and one of mask bytes. Samples
// before the first index at which all three arrays are 16-byte aligned, and
// after the last whole group of 16, are taken one at a time. The block sums
// its histograms and adds each nonzero cell to a uint32 (C, C) accumulator
// in device memory with one integer atomicAdd. The last block to finish
// writes the accumulator out as f32 and sets it, and the blocks' done
// counter, back to zero. Counts are exact up to 2^32 - 1 per cell in one
// call (metrics.py promises 2^31 per update); the f32 output is exact up to
// 2^24 per cell and rounds beyond it with relative error at most 2^-24, as
// the f32 result of the JAX package does.
//
// One launch per call, no memset: the accumulator and the counter are zero
// when a launch starts and when it ends. The caller keeps one accumulator
// per stream, zeroed once when it is made. Launches on one stream run one
// after another, so each finds the zeros its predecessor left; launches on
// two streams use two accumulators. Integer atomics make the result the
// same whatever order the blocks finish in.
//
// What bounds it on an H100: device memory. It reads 9 bytes per sample (two
// int32 ids and a mask byte) and does one integer add; at 8 x 128 x 256
// samples that is 2.4 MB, under a microsecond at 3.35 TB/s, so at this size
// the launch itself dominates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemBytes = 48 * 1024;       // dynamic shared memory without opt-in
constexpr int kGroup = 16;                  // samples a lane loads at once
constexpr int kMaxBlocks = 2 * 132;

// cell of one sample, or -1 when it counts nowhere
__device__ __forceinline__ int cell(int t, int p, bool keep, int c) {
  return keep && (unsigned)t < (unsigned)c && (unsigned)p < (unsigned)c ? t * c + p : -1;
}

__global__ void __launch_bounds__(kThreads)
confmat_kernel(const int32_t* __restrict__ t, const int32_t* __restrict__ p,
               const uint8_t* __restrict__ mask, long long n, int c, int nsub, long long head,
               long long groups, unsigned int* __restrict__ acc, unsigned int* __restrict__ done,
               float* __restrict__ out) {
  extern __shared__ unsigned int hist[];  // nsub x (c * c)
  __shared__ bool last_block;
  const int cc = c * c;
  const int warp = threadIdx.x / 32;
  for (int i = threadIdx.x; i < cc * nsub; i += kThreads) hist[i] = 0u;
  __syncthreads();

  unsigned int* mine = hist + (warp % nsub) * cc;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  // samples [head, head + 16 groups), 16 to a thread
  for (long long gi = first; gi < groups; gi += stride) {
    const long long i0 = head + gi * kGroup;
    int4 tv[4], pv[4];
    uint4 mv = make_uint4(~0u, ~0u, ~0u, ~0u);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      tv[q] = __ldg(reinterpret_cast<const int4*>(t + i0) + q);
      pv[q] = __ldg(reinterpret_cast<const int4*>(p + i0) + q);
    }
    if (mask != nullptr) mv = __ldg(reinterpret_cast<const uint4*>(mask + i0));
    const int* ts = reinterpret_cast<const int*>(tv);
    const int* ps = reinterpret_cast<const int*>(pv);
    const unsigned int* ms = reinterpret_cast<const unsigned int*>(&mv);
#pragma unroll
    for (int s = 0; s < kGroup; ++s) {
      const int key = cell(ts[s], ps[s], ((ms[s / 4] >> (8 * (s % 4))) & 0xffu) != 0u, c);
      if (key >= 0) atomicAdd(&mine[key], 1u);
    }
  }
  // the rest, one sample a thread: [0, head) and [head + 16 groups, n)
  const long long rest = n - groups * kGroup;
  for (long long k = first; k < rest; k += stride) {
    const long long i = k < head ? k : k + groups * kGroup;
    const int key = cell(t[i], p[i], mask == nullptr || mask[i] != 0, c);
    if (key >= 0) atomicAdd(&mine[key], 1u);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < cc; i += kThreads) {
    unsigned int s = 0u;
    for (int k = 0; k < nsub; ++k) s += hist[k * cc + i];
    if (s) atomicAdd(&acc[i], s);
  }
  __threadfence();  // this block's adds are visible before it reports done
  __syncthreads();
  if (threadIdx.x == 0) last_block = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last_block) {
    __threadfence();
    for (int i = threadIdx.x; i < cc; i += kThreads) {
      out[i] = (float)__ldcg(&acc[i]);  // L2 read: other blocks' atomics land there
      acc[i] = 0u;
    }
    if (threadIdx.x == 0) *done = 0u;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch: 0 when the kernel was queued.
// t, p: n int32 ids; mask: n bytes (nonzero = counts) or NULL; scratch:
// c * c + 1 uint32, zero when the kernel starts, and left zero when it ends
// (the last word is the blocks' done counter): one scratch per stream,
// zeroed once. out: (c, c) float, written by the last block. c * c * 4
// bytes must fit the 48 KB of shared memory a block may use (c <= 110).
extern "C" int vmtl_confusion_matrix(const void* t, const void* p, const void* mask, long long n,
                                     int c, void* scratch, void* out, void* stream) {
  if (n < 0 || c <= 0 || (long long)c * c * 4 > kSmemBytes) return (int)cudaErrorInvalidValue;
  const int cc = c * c;
  int nsub = kSmemBytes / (cc * 4);
  if (nsub > kWarps) nsub = kWarps;
  // the first index at which t, p and mask are all 16-byte aligned, if any
  const uintptr_t at = reinterpret_cast<uintptr_t>(t), ap = reinterpret_cast<uintptr_t>(p);
  const uintptr_t am = reinterpret_cast<uintptr_t>(mask);
  long long head = n, groups = 0;
  if (at % 4 == 0 && ap % 4 == 0 && at % 16 == ap % 16) {
    const long long h_ids = (long long)((16 - at % 16) % 16) / 4;
    const long long h_mask = mask == nullptr ? h_ids : (long long)((16 - am % 16) % 16);
    if (h_mask % 4 == h_ids && h_mask <= n) {
      head = h_mask;
      groups = (n - head) / kGroup;
    }
  }
  long long blocks = (n + (long long)kThreads * kGroup - 1) / ((long long)kThreads * kGroup);
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  unsigned int* s = static_cast<unsigned int*>(scratch);
  confmat_kernel<<<(unsigned)blocks, kThreads, (size_t)nsub * cc * 4,
                   reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(t), static_cast<const int32_t*>(p),
      static_cast<const uint8_t*>(mask), n, c, nsub, head, groups, s, s + cc,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
