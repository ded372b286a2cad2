// The threefry2x32 draws of adapt_tpu_torch/rng.py for Hopper (sm_90a):
// `lane_uniform` (a per-lane fold_in, then D uniforms under the lane's key)
// and `uniform` (jax.random.uniform over a flat counter), each in one launch.
//
// Replaces no Pallas kernel: the JAX package draws through `jax.random`,
// which XLA lowers to fused integer ops. The port's plain version
// (rng.py's int64 tensor code, the twin the tests hold to jax.random) runs
// each of the 20 rounds' add, shifts, or, xor and mask as its own eager op
// over int64 words: ~350 launches a lane_uniform, ~180 a uniform. Here a
// thread hashes in 32-bit registers, so a draw is one launch and its only
// traffic is the float32 output it writes.
//
// Bound: integer issue. A hash is 20 rounds of add, rotate (one funnel
// shift) and xor, and five key injections. Its 20 rotates and 20 xors run
// only on the integer ALU pipe (64 lanes a clock an SM; the adds may issue
// on the FMA pipe as IMAD), and a float takes 3 more. PT's cbox draw
// (262,144 lanes, D = 11) hashes 262,144 x 12 blocks: ~135M such
// operations, ~8 us at 132 SMs and 1.98 GHz, against ~3.8 us for its
// 11.5 MB of output and 1 MB of lane ids at 3.35 TB/s. Measured on an
// H100: ~15 us (chip_smoke phase 2f).
//
// lane_uniform: one thread a lane. A thread hashes (0, pos) under the
// iteration key into its lane key, keeps it in registers, and hashes
// (0, j) under it for each column j. A thread's row of D words is 4D bytes
// wide (44-60 at PT's D = 11-15), so stores straight from the row would
// touch a sector per lane a column; instead the block stages its rows in
// shared memory, up to COLS columns at a time, and stores them coalesced
// (for D <= COLS the block's output is one contiguous run). The staging
// rows are padded to an odd stride, so that the lanes' column writes fall
// on distinct banks.
//
// uniform: one thread a counter i of the flattened shape: the hash of
// (i >> 32, i & 0xFFFFFFFF), jax's partitionable stream (bits1 ^ bits2
// over a 64-bit iota).
//
// Both map the 32 random bits to [0, 1) as jax.random.uniform does: the
// top 23 as the mantissa under exponent 0, minus one (exact).

#include <cuda_runtime.h>
#include <stdint.h>

#define LANES 128   // lanes (threads) a block of the lane kernel
#define COLS 16     // columns a lane stages at a time
#define THREADS 256 // threads a block of the flat kernel

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// The threefry2x32 block hash of (x1, x2) under the key (k1, k2): 5 x 4
// rounds with key injection, as rng.py `threefry2x32` and
// jax/_src/prng.py `_threefry2x32_lowering`.
__device__ __forceinline__ void threefry2x32(uint32_t k1, uint32_t k2,
                                             uint32_t x1, uint32_t x2,
                                             uint32_t& y1, uint32_t& y2) {
  const uint32_t k3 = k1 ^ k2 ^ 0x1BD11BDAu;
  uint32_t a = x1 + k1, b = x2 + k2;
#define MIX(r)      \
  a += b;           \
  b = rotl(b, r) ^ a;
#define ROUNDS_0 MIX(13) MIX(15) MIX(26) MIX(6)
#define ROUNDS_1 MIX(17) MIX(29) MIX(16) MIX(24)
  ROUNDS_0 a += k2; b += k3 + 1u;
  ROUNDS_1 a += k3; b += k1 + 2u;
  ROUNDS_0 a += k1; b += k2 + 3u;
  ROUNDS_1 a += k2; b += k3 + 4u;
  ROUNDS_0 a += k3; b += k1 + 5u;
#undef ROUNDS_1
#undef ROUNDS_0
#undef MIX
  y1 = a;
  y2 = b;
}

// 23 random bits under exponent 0, minus one: a float in [0, 1).
__device__ __forceinline__ float unit_float(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

template <typename Pos>
__global__ void __launch_bounds__(LANES)
    threefry_lane_uniform_kernel(uint32_t k1, uint32_t k2,
                                 const Pos* __restrict__ pos, int n, int D,
                                 float* __restrict__ out) {
  __shared__ float tile[LANES * (COLS + 1)];
  const int t = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * LANES;
  const int rows = (int)min((long long)LANES, n - r0);
  // the lane key: the hash of (0, pos) under the iteration key
  uint32_t a1 = 0u, a2 = 0u;
  if (t < rows) threefry2x32(k1, k2, 0u, (uint32_t)pos[r0 + t], a1, a2);
  for (int j0 = 0; j0 < D; j0 += COLS) {
    const int w = min(COLS, D - j0);
    const int stride = w | 1;
    if (t < rows) {
      for (int c = 0; c < w; ++c) {
        uint32_t b1, b2;
        threefry2x32(a1, a2, 0u, (uint32_t)(j0 + c), b1, b2);
        tile[t * stride + c] = unit_float(b1 ^ b2);
      }
    }
    __syncthreads();
    // element e of the block's rows x w words, in row-major order: row r,
    // column c, stepped by LANES without a division in the loop
    const int m = rows * w, dr = LANES / w, dc = LANES % w;
    int r = t / w, c = t % w;
    for (int e = t; e < m; e += LANES) {
      out[(size_t)(r0 + r) * D + j0 + c] = tile[r * stride + c];
      r += dr;
      c += dc;
      if (c >= w) {
        c -= w;
        ++r;
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS)
    threefry_uniform_kernel(uint32_t k1, uint32_t k2, long long n,
                            float* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * THREADS) {
    uint32_t b1, b2;
    threefry2x32(k1, k2, (uint32_t)((unsigned long long)i >> 32),
                 (uint32_t)i, b1, b2);
    out[i] = unit_float(b1 ^ b2);
  }
}

// (n, D) float32 row-major uniforms: row i keyed by pos[i] (int32, or
// int64 when pos_is_64; its low 32 bits are the count) under (k1, k2).
// n >= 1, D >= 1.
extern "C" int threefry_lane_uniform(uint32_t k1, uint32_t k2,
                                     const void* pos, int pos_is_64, int n,
                                     int D, float* out, void* stream) {
  const unsigned blocks = (unsigned)(((long long)n + LANES - 1) / LANES);
  if (pos_is_64) {
    threefry_lane_uniform_kernel<long long>
        <<<blocks, LANES, 0, (cudaStream_t)stream>>>(
            k1, k2, (const long long*)pos, n, D, out);
  } else {
    threefry_lane_uniform_kernel<int>
        <<<blocks, LANES, 0, (cudaStream_t)stream>>>(
            k1, k2, (const int*)pos, n, D, out);
  }
  return (int)cudaGetLastError();
}

// n float32 uniforms: word i the hash of the 64-bit counter i under
// (k1, k2). n >= 1.
extern "C" int threefry_uniform(uint32_t k1, uint32_t k2, long long n,
                                float* out, void* stream) {
  const long long want = (n + THREADS - 1) / THREADS;
  const unsigned blocks = (unsigned)(want < (1 << 20) ? want : (1 << 20));
  threefry_uniform_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      k1, k2, n, out);
  return (int)cudaGetLastError();
}
