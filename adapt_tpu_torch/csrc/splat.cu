// Sorted film splat for Hopper (sm_90a): out = film + the per-pixel sums of
// a pixel-sorted stream of rgb updates.
//
// Replaces the Pallas TPU kernel adapt_tpu/ops/splat_pallas.py
// `_splat_kernel` (:52, via `splat_sorted_accumulate` :103), which adds the
// t=1 light-tracing splats of a BDPT pass into the (P, 3) film. Its only
// contract is the sum: entries whose pixel id lies outside [0, P) (negative
// ids sort to the front, the callers' `drop` sentinel P to the back) are
// ignored.
//
// The TPU kernel walks 1024-pixel film tiles in order, DMAs each tile's
// window of at most MAX_WIN updates into VMEM and reduces a one-hot
// (pixels x updates) product; a tile over MAX_WIN falls back to a scatter.
// None of that carries over. Here a block of TILE threads owns TILE
// consecutive pixels [p0, p0 + TILE):
//
//   1. window: warp 0 finds lo = lower_bound(idx, p0), warp 1
//      hi = lower_bound(idx, min(p0 + TILE, P)), each by a 32-way search
//      (32 probes a step, ~5 steps over 1.5M updates) after a look at the
//      stream's two ends;
//   2. segment: pixel thread p finds its [start, end) inside the window,
//      lower_bound(p) by halving [lo, hi) and the end by galloping from
//      start. The window's ids are few and shared by the block's threads,
//      so these loads hit L1 after the first warps; a thread no longer
//      searches the whole stream (~21 dependent loads from L2, twice);
//   3. sums: each thread adds rgb[start .. end) in stream order in three
//      f32 registers, eight rows of loads in flight at a time. A block
//      holding a segment longer than LONG rows (a caustic hot spot) instead
//      stages its window's rows in shared memory, CHUNK at a time, read
//      coalesced, and each thread adds its part of each chunk: a window of
//      any length, no cap and no fallback;
//   4. out[p] = film[p] + acc, the film's loads issued before the search.
//
// An empty window (the BDPT pass's own t=1 stream drops every update: its
// first id is P) makes the block two loads and a copy of its film tile. A
// coalesced scan of the window that marks segment heads and tails in shared
// memory was built first and lost to the per-pixel search on a stream
// whose tile holds 70,000 updates. No atomics, so a
// pixel's sum is the same from run to run. Every add rounds once
// (__fadd_rn, and the library is built with -fmad=false), in the order of
// the plain PyTorch version (ops/splat.py `splat_sorted_accumulate_plain`):
// a pixel's updates one by one in stream order, then the film, so the two
// agree bit for bit. A pixel holding a long segment is summed by one thread
// from shared memory (a tree reduction would reassociate the sum).
//
// Bound: bytes. Each kept update is read once (4 B id + 12 B rgb) and each
// pixel reads 12 B of film and writes 12 B: at the BDPT cbox shape
// (P = 262,144, M = 6 x 262,144 updates, 10% dropped) ~31.5 MB, ~0.0094 ms
// at 3.35 TB/s.

#include <cuda_runtime.h>

#define TILE 256
#define LONG 1024   // a segment longer than this is summed from shared memory
#define CHUNK 1024  // rgb rows a block stages in shared memory at a time
#define FULL 0xffffffffu

// First position in idx[lo, hi) whose value is >= key (idx ascending;
// hi when there is none), by halving.
__device__ __forceinline__ int lower_bound(const int* __restrict__ idx, int lo,
                                           int hi, int key) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(idx + mid) < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// First position in idx[0, M) whose value is >= key (idx ascending), found
// by one warp: each step the 32 lanes probe 32 evenly spaced positions of
// the range [lo, hi] that holds the answer and keep the gap where the
// ballot turns; a range of at most 32 entries is read whole.
__device__ int warp_lower_bound(const int* __restrict__ idx, int M, int key) {
  const int lane = threadIdx.x & 31;
  // the ends first: a key at or below the first id (every key, on a stream
  // that drops every update) or above the last one needs no search
  if (M == 0 || __ldg(idx) >= key) return 0;
  if (__ldg(idx + M - 1) < key) return M;
  long long lo = 0, hi = M;
  while (hi - lo > 32) {
    const long long q = lo + (hi - lo) * (lane + 1) / 33;
    const unsigned below = __ballot_sync(FULL, __ldg(idx + q) < key);
    const int c = __popc(below);  // probes below key: a prefix of the lanes
    const long long q_lo = lo + (hi - lo) * c / 33;        // probe c - 1
    const long long q_hi = lo + (hi - lo) * (c + 1) / 33;  // probe c
    if (c > 0) lo = q_lo + 1;
    if (c < 32) hi = q_hi;
  }
  const long long j = lo + lane;
  const bool below = j < hi && __ldg(idx + j) < key;
  return (int)(lo + __popc(__ballot_sync(FULL, below)));
}

// Adds rgb[j0 .. j1) to (r, g, b) in stream order, reading from global
// memory eight rows at a time, so that their loads are in flight together.
__device__ __forceinline__ void add_rows(const float* __restrict__ rgb, int j0,
                                         int j1, float& r, float& g,
                                         float& b) {
  int j = j0;
  for (; j + 8 <= j1; j += 8) {
    float x[24];
#pragma unroll
    for (int q = 0; q < 24; ++q) x[q] = __ldg(rgb + 3 * (size_t)j + q);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      r = __fadd_rn(r, x[3 * q]);
      g = __fadd_rn(g, x[3 * q + 1]);
      b = __fadd_rn(b, x[3 * q + 2]);
    }
  }
  for (; j < j1; ++j) {
    r = __fadd_rn(r, __ldg(rgb + 3 * (size_t)j + 0));
    g = __fadd_rn(g, __ldg(rgb + 3 * (size_t)j + 1));
    b = __fadd_rn(b, __ldg(rgb + 3 * (size_t)j + 2));
  }
}

__global__ void __launch_bounds__(TILE)
    splat_kernel(const float* __restrict__ film, const int* __restrict__ idx,
                 const float* __restrict__ rgb, int P, int M,
                 float* __restrict__ out) {
  __shared__ int window[2];
  __shared__ float stage[3][CHUNK];  // r, g, b of a chunk's rows
  const int t = threadIdx.x;
  const int p0 = blockIdx.x * TILE;
  const int p = p0 + t;
  // the film tile's loads go out first, beside the search
  float f[3] = {0.0f, 0.0f, 0.0f};
  if (p < P) {
#pragma unroll
    for (int c = 0; c < 3; ++c) f[c] = __ldg(film + 3 * (size_t)p + c);
  }
  if (t < 64) {
    const int key = t < 32 ? p0 : min(p0 + TILE, P);
    const int at = warp_lower_bound(idx, M, key);
    if ((t & 31) == 0) window[t >> 5] = at;
  }
  __syncthreads();
  const int lo = window[0], hi = window[1];
  // 2. this pixel's segment, inside the window
  int start = hi, end = hi;
  if (p < P && lo < hi) {
    start = lower_bound(idx, lo, hi, p);
    int step = 1, at = start;  // gallop: idx[start .. at) all equal p
    while (at + step <= hi && __ldg(idx + at + step - 1) == p) {
      at += step;
      step <<= 1;
    }
    end = lower_bound(idx, at, min(at + step, hi), p + 1);
  }
  // 3. sums in stream order
  float r = 0.0f, g = 0.0f, b = 0.0f;
  if (!__syncthreads_or(end - start > LONG)) {
    add_rows(rgb, start, end, r, g, b);  // every segment short: directly
  } else {
    // a long segment: the block stages the window's rows in shared memory,
    // CHUNK at a time, read coalesced, and each thread adds its part of
    // the chunk
    for (int c0 = lo; c0 < hi; c0 += CHUNK) {
      const int n = 3 * (min(c0 + CHUNK, hi) - c0);
      const float* src = rgb + 3 * (size_t)c0;
#pragma unroll
      for (int k = 0; k < 3 * CHUNK / TILE; ++k) {
        const int q = t + k * TILE;
        if (q < n) stage[q % 3][q / 3] = __ldg(src + q);
      }
      __syncthreads();
      const int j1 = min(end, c0 + CHUNK) - c0;
      int j = max(start, c0) - c0;
      for (; j + 8 <= j1; j += 8) {
        float x[24];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          x[3 * q] = stage[0][j + q];
          x[3 * q + 1] = stage[1][j + q];
          x[3 * q + 2] = stage[2][j + q];
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          r = __fadd_rn(r, x[3 * q]);
          g = __fadd_rn(g, x[3 * q + 1]);
          b = __fadd_rn(b, x[3 * q + 2]);
        }
      }
      for (; j < j1; ++j) {
        r = __fadd_rn(r, stage[0][j]);
        g = __fadd_rn(g, stage[1][j]);
        b = __fadd_rn(b, stage[2][j]);
      }
      __syncthreads();
    }
  }
  if (p >= P) return;
  out[3 * (size_t)p + 0] = __fadd_rn(f[0], r);
  out[3 * (size_t)p + 1] = __fadd_rn(f[1], g);
  out[3 * (size_t)p + 2] = __fadd_rn(f[2], b);
}

extern "C" int splat_sorted_accumulate(const float* film, const int* idx,
                                       const float* rgb, int P, int M,
                                       float* out, void* stream) {
  splat_kernel<<<(P + TILE - 1) / TILE, TILE, 0, (cudaStream_t)stream>>>(
      film, idx, rgb, P, M, out);
  return (int)cudaGetLastError();
}
