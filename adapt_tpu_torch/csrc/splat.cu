// Sorted film splat for Hopper (sm_90a): out = film + the per-pixel sums of
// a pixel-sorted stream of rgb updates.
//
// Replaces the Pallas TPU kernel adapt_tpu/ops/splat_pallas.py
// `_splat_kernel` (:52, via `splat_sorted_accumulate` :103), which adds the
// t=1 light-tracing splats of a BDPT pass into the (P, 3) film. Its only
// contract is the sum: entries whose pixel id lies outside [0, P) (the
// callers' `drop` sentinel P) are ignored.
//
// The TPU kernel walks 1024-pixel film tiles in order, DMAs each tile's
// window of at most MAX_WIN updates into VMEM and reduces a one-hot
// (pixels x updates) product; a tile over MAX_WIN falls back to a scatter.
// None of that carries over. Here one thread owns one film pixel p:
//
//   lo = lower_bound(idx, p), hi = lower_bound(idx, p + 1)   (binary search)
//   acc = sum of rgb[lo .. hi) in stream order, in three f32 registers
//   out[p] = film[p] + acc
//
// No atomics, so a pixel's sum is the same from run to run; no window, so a
// caustic hot spot needs no fallback. Every add rounds once (__fadd_rn, and
// the library is built with -fmad=false), in the order of the plain PyTorch
// version (ops/splat.py `splat_sorted_accumulate_plain`), so the two agree
// bit for bit.
//
// Bound: bytes. Each update is read once (4 B id + 12 B rgb) and each pixel
// reads 12 B of film and writes 12 B: at the BDPT cbox shape (P = 262,144,
// M = 6 x 262,144 t=1 updates) that is ~31.5 MB, ~0.0094 ms at 3.35 TB/s.
// Neighbouring threads read neighbouring segments, so the update reads
// coalesce; the two binary searches (~21 steps each) hit L2 after the first
// warps. Making it fast is later work.

#include <cuda_runtime.h>

#define BLOCK 256

// First position in idx[lo, hi) whose value is >= key (idx ascending).
__device__ __forceinline__ int lower_bound(const int* idx, int lo, int hi,
                                           int key) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (idx[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void splat_kernel(const float* __restrict__ film,
                             const int* __restrict__ idx,
                             const float* __restrict__ rgb, int P, int M,
                             float* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int lo = lower_bound(idx, 0, M, p);
  const int hi = lower_bound(idx, lo, M, p + 1);
  float r = 0.0f, g = 0.0f, b = 0.0f;
  for (int j = lo; j < hi; ++j) {
    r = __fadd_rn(r, rgb[3 * j + 0]);
    g = __fadd_rn(g, rgb[3 * j + 1]);
    b = __fadd_rn(b, rgb[3 * j + 2]);
  }
  out[3 * p + 0] = __fadd_rn(film[3 * p + 0], r);
  out[3 * p + 1] = __fadd_rn(film[3 * p + 1], g);
  out[3 * p + 2] = __fadd_rn(film[3 * p + 2], b);
}

extern "C" int splat_sorted_accumulate(const float* film, const int* idx,
                                       const float* rgb, int P, int M,
                                       float* out, void* stream) {
  splat_kernel<<<(P + BLOCK - 1) / BLOCK, BLOCK, 0, (cudaStream_t)stream>>>(
      film, idx, rgb, P, M, out);
  return (int)cudaGetLastError();
}
