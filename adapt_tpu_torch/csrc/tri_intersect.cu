// Brute-force ray/triangle kernels for Hopper (sm_90a): closest hit, any hit
// and the media walk's hits.
//
// Replace the Pallas TPU kernels adapt_tpu/ops/intersect_pallas.py
// `_tri_kernel` (closest hit, :58), `_occ_kernel` (any hit, :109) and
// `_track_kernel` (media walk, :131): the same plane + dual-basis test, over
// every triangle of a small scene.
//
//   t = (d - o.n) / (dir.n)     (|dir.n| < 1e-12 -> denominator 1e-12, and
//   u = (o.U + t*(dir.U)) - cu   the row is rejected)
//   v = (o.V + t*(dir.V)) - cv
//   valid = u >= 0 && v >= 0 && u + v <= 1 && t > RAY_EPS && |dir.n| >= 1e-12
//
// Exactness: each dot is (a0*b0 + a1*b1) + a2*b2 and every operation rounds
// once, as in the JAX package and in the plain PyTorch twins. The library is
// built with -fmad=false (no FMA contraction) and IEEE division; float
// constants carry the f suffix so comparisons happen in f32. A flipped edge
// hit (u ~ 0, u + v ~ 1) would change a whole path, so results must agree
// bit for bit with the twins.
//
// Design: one thread per ray; the block stages the triangle table through
// shared memory in tiles of TILE rows (12 floats a row), so any T is correct.
// The closest-hit kernel keeps a running minimum with strict <, so the first
// row wins a tie (argmin semantics of the Pallas kernel); the winner's
// normal and object id are read from device memory once, after the sweep.
// The any-hit kernel exits once every ray of the block is occluded.
//
// Bound: at the slice's T = 34 the sweep is ~40 flops per (ray, triangle)
// pair from shared memory plus 40 bytes per ray of device memory traffic,
// so it is issue-bound, not memory-bound. Making it fast (wider tiles of
// rays per thread, a BVH for larger T) is later work.
//
// The media-walk kernel (tri_track_kernel) is documented where it starts.

#include <cuda_runtime.h>

#define TILE 256
#define ROW 12  // n(3) d U(3) cu V(3) cv

__device__ __forceinline__ float dot3(float a0, float a1, float a2,
                                      const float* b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b[0]), __fmul_rn(a1, b[1])),
                   __fmul_rn(a2, b[2]));
}

// The test of one (ray, triangle) pair; returns valid, writes t/u/v.
__device__ __forceinline__ bool tri_test(const float* ro, const float* rd,
                                         const float* g, float* t_out,
                                         float* u_out, float* v_out) {
  const float o_n = dot3(ro[0], ro[1], ro[2], g + 0);
  const float d_n = dot3(rd[0], rd[1], rd[2], g + 0);
  const float o_u = dot3(ro[0], ro[1], ro[2], g + 4);
  const float d_u = dot3(rd[0], rd[1], rd[2], g + 4);
  const float o_v = dot3(ro[0], ro[1], ro[2], g + 8);
  const float d_v = dot3(rd[0], rd[1], rd[2], g + 8);
  const bool flat = fabsf(d_n) < 1e-12f;
  const float denom = flat ? 1e-12f : d_n;
  const float t = __fdiv_rn(__fsub_rn(g[3], o_n), denom);
  const float u = __fsub_rn(__fadd_rn(o_u, __fmul_rn(t, d_u)), g[7]);
  const float v = __fsub_rn(__fadd_rn(o_v, __fmul_rn(t, d_v)), g[11]);
  *t_out = t;
  *u_out = u;
  *v_out = v;
  return (u >= 0.0f) && (v >= 0.0f) && (__fadd_rn(u, v) <= 1.0f) &&
         (t > 1e-4f) && !flat;
}

__device__ __forceinline__ void stage_tile(float* s_geo, const float* geo,
                                           int base, int T) {
  __syncthreads();
  for (int k = threadIdx.x; k < TILE * ROW; k += blockDim.x) {
    const int r = base + k / ROW;
    s_geo[k] = r < T ? geo[(size_t)base * ROW + k] : 0.0f;
  }
  __syncthreads();
}

__global__ void tri_closest_kernel(const float* __restrict__ ro_all,
                                   const float* __restrict__ rd_all,
                                   const float* __restrict__ far_all, int n,
                                   const float* __restrict__ geo,
                                   const float* __restrict__ ng_tab,
                                   const int* __restrict__ obj_tab, int T,
                                   float* __restrict__ t_out,
                                   int* __restrict__ row_out,
                                   float* __restrict__ u_out,
                                   float* __restrict__ v_out,
                                   float* __restrict__ ng_out,
                                   int* __restrict__ obj_out) {
  __shared__ float s_geo[TILE * ROW];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  float ro[3] = {0.0f, 0.0f, 0.0f}, rd[3] = {0.0f, 0.0f, 1.0f};
  if (live) {
    for (int c = 0; c < 3; ++c) {
      ro[c] = ro_all[(size_t)i * 3 + c];
      rd[c] = rd_all[(size_t)i * 3 + c];
    }
  }
  // invalid rows count as FAR (1e7); the first row reaching the minimum wins
  float best_t = __int_as_float(0x7f800000);  // +inf
  float best_u = 0.0f, best_v = 0.0f;
  int best_i = 0;
  for (int base = 0; base < T; base += TILE) {
    stage_tile(s_geo, geo, base, T);
    const int m = min(TILE, T - base);
    for (int j = 0; j < m; ++j) {
      float t, u, v;
      const bool ok = tri_test(ro, rd, s_geo + j * ROW, &t, &u, &v);
      const float tm = ok ? t : 1e7f;
      if (tm < best_t) {
        best_t = tm;
        best_u = u;
        best_v = v;
        best_i = base + j;
      }
    }
  }
  if (!live) return;
  const float far = far_all[i];
  const bool hit = best_t < far;
  t_out[i] = hit ? best_t : far;
  row_out[i] = hit ? best_i : -1;
  u_out[i] = hit ? best_u : 0.0f;
  v_out[i] = hit ? best_v : 0.0f;
  ng_out[(size_t)i * 3 + 0] = hit ? ng_tab[(size_t)best_i * 3 + 0] : 1.0f;
  ng_out[(size_t)i * 3 + 1] = hit ? ng_tab[(size_t)best_i * 3 + 1] : 0.0f;
  ng_out[(size_t)i * 3 + 2] = hit ? ng_tab[(size_t)best_i * 3 + 2] : 0.0f;
  obj_out[i] = hit ? obj_tab[best_i] : -1;
}

__global__ void tri_any_kernel(const float* __restrict__ ro_all,
                               const float* __restrict__ rd_all,
                               const float* __restrict__ far_all, int n,
                               const float* __restrict__ geo, int T,
                               bool* __restrict__ occ_out) {
  __shared__ float s_geo[TILE * ROW];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  float ro[3] = {0.0f, 0.0f, 0.0f}, rd[3] = {0.0f, 0.0f, 1.0f};
  float far = -3e38f;  // out-of-range threads never occlude
  if (live) {
    for (int c = 0; c < 3; ++c) {
      ro[c] = ro_all[(size_t)i * 3 + c];
      rd[c] = rd_all[(size_t)i * 3 + c];
    }
    far = far_all[i];
  }
  bool occ = false;
  for (int base = 0; base < T; base += TILE) {
    // whole block done: every thread takes the same exit (no barrier skew)
    if (__syncthreads_and(occ || !live)) break;
    stage_tile(s_geo, geo, base, T);
    const int m = min(TILE, T - base);
    for (int j = 0; j < m && !occ; ++j) {
      float t, u, v;
      occ = tri_test(ro, rd, s_geo + j * ROW, &t, &u, &v) && (t < far);
    }
  }
  if (live) occ_out[i] = occ;
}

// ---------------------------------------------------------------------------
// Media walk (B3): everything a shadow ray through null medium boundaries
// needs, in one pass, per ray:
//   * the blocker: the closest valid hit on a non-null row before far
//     (FAR / -1 / 0 on a miss: FAR, not far);
//   * K eps-chained null interfaces: slot k is the smallest null hit t with
//     prev < t < min(t_blk, far), ties to the lowest row; prev starts at 0
//     and becomes the slot's t + CHAIN_SEP after each slot, even an empty
//     one (t = FAR); empty slots are FAR / -1 / 0;
//   * overflow: a null hit beyond the K slots is still before the blocker
//     (the caller re-walks that lane sequentially).
// dn = dot(n_g, d) of the chosen row, summed as (a0*b0 + a1*b1) + a2*b2,
// plus 0.0 (the Pallas kernel's one-hot sum turns -0.0 into +0.0).
//
// The TPU kernel computes the (T, 2048) hit tables once and runs K + 1
// min-reductions over them. Here one thread per ray runs K + 2 sweeps over
// the table, staged in shared memory (kept resident when T <= TILE, as on
// every scene of the brute-force tier): one over the non-null rows for the
// blocker, K chained sweeps over the null rows, one over the null rows for
// overflow. Each sweep recomputes the hit math, which gives the same bits
// and keeps no per-row state in registers. The null flags are a per-row
// table rather than a list of null rows, so the wrapper needs no host round
// trip to count them. Lanes whose far bound is at or below RAY_EPS (dead
// lanes carry -3e38) cannot hit anything and skip the sweeps.
//
// Bound: at the vpt cbox's T = 36 (12 null rows) a ray takes 24 + 3 * 12
// pair tests (~47 operations each) from shared memory and moves 28 bytes in
// and 13 + 12 K bytes out, so it is issue-bound like the closest hit.

constexpr float kFar = 1e7f;
constexpr float kChainSep = 5e-5f;  // 0.5 * RAY_EPS

__device__ __forceinline__ void stage_rows(float* s_geo, bool* s_null,
                                           const float* geo,
                                           const bool* null_tab, int base,
                                           int T) {
  __syncthreads();
  for (int k = threadIdx.x; k < TILE * ROW; k += blockDim.x) {
    const int r = base + k / ROW;
    s_geo[k] = r < T ? geo[(size_t)base * ROW + k] : 0.0f;
  }
  for (int k = threadIdx.x; k < TILE; k += blockDim.x)
    s_null[k] = base + k < T ? null_tab[base + k] : false;
  __syncthreads();
}

__device__ __forceinline__ float normal_dot(const float* rd,
                                            const float* ng_tab, int row) {
  const float d = dot3(rd[0], rd[1], rd[2], ng_tab + (size_t)row * 3);
  return __fadd_rn(d, 0.0f);
}

__global__ void tri_track_kernel(
    const float* __restrict__ ro_all, const float* __restrict__ rd_all,
    const float* __restrict__ far_all, int n, const float* __restrict__ geo,
    const float* __restrict__ ng_tab, const int* __restrict__ obj_tab,
    const bool* __restrict__ null_tab, int T, int K,
    float* __restrict__ t_null, int* __restrict__ obj_null,
    float* __restrict__ dn_null, float* __restrict__ tb_out,
    int* __restrict__ ob_out, float* __restrict__ db_out,
    bool* __restrict__ ov_out) {
  __shared__ float s_geo[TILE * ROW];
  __shared__ bool s_null[TILE];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  float ro[3] = {0.0f, 0.0f, 0.0f}, rd[3] = {0.0f, 0.0f, 1.0f};
  float far = -3e38f;
  if (live) {
    for (int c = 0; c < 3; ++c) {
      ro[c] = ro_all[(size_t)i * 3 + c];
      rd[c] = rd_all[(size_t)i * 3 + c];
    }
    far = far_all[i];
  }
  const bool walk = far > 1e-4f;
  const bool resident = T <= TILE;  // one tile, staged once for all sweeps

  // closest blocker: strict < from FAR, so the lowest row wins a tie and
  // rows at FAR (invalid) never win
  float t_blk = kFar;
  int i_blk = -1;
  for (int base = 0; base < T; base += TILE) {
    stage_rows(s_geo, s_null, geo, null_tab, base, T);
    const int m = walk ? min(TILE, T - base) : 0;
    for (int j = 0; j < m; ++j) {
      if (s_null[j]) continue;
      float t, u, v;
      const float tm =
          tri_test(ro, rd, s_geo + j * ROW, &t, &u, &v) ? t : kFar;
      if (tm < t_blk) {
        t_blk = tm;
        i_blk = base + j;
      }
    }
  }
  const float t_cut = fminf(t_blk, far);

  // K chained null slots, then (k == K) the overflow sweep
  float prev = 0.0f;
  bool overflow = false;
  for (int k = 0; k <= K; ++k) {
    float best = kFar;
    int bi = -1;
    for (int base = 0; base < T; base += TILE) {
      if (!resident) stage_rows(s_geo, s_null, geo, null_tab, base, T);
      const int m = walk ? min(TILE, T - base) : 0;
      for (int j = 0; j < m; ++j) {
        if (!s_null[j]) continue;
        float t, u, v;
        const float tm =
            tri_test(ro, rd, s_geo + j * ROW, &t, &u, &v) ? t : kFar;
        if (tm < t_cut && tm > prev && tm < best) {
          best = tm;
          bi = base + j;
        }
      }
    }
    if (k == K) {
      overflow = bi >= 0;
      break;
    }
    if (live) {
      const bool hit = bi >= 0 && best < far;
      const size_t o = (size_t)k * n + i;
      t_null[o] = hit ? best : kFar;
      obj_null[o] = hit ? obj_tab[bi] : -1;
      dn_null[o] = hit ? normal_dot(rd, ng_tab, bi) : 0.0f;
    }
    prev = __fadd_rn(best, kChainSep);
  }
  if (!live) return;
  const bool hit_b = i_blk >= 0 && t_blk < far;
  tb_out[i] = hit_b ? t_blk : kFar;
  ob_out[i] = hit_b ? obj_tab[i_blk] : -1;
  db_out[i] = hit_b ? normal_dot(rd, ng_tab, i_blk) : 0.0f;
  ov_out[i] = overflow;
}

static int blocks_for(int n) { return (n + TILE - 1) / TILE; }

extern "C" int tri_closest_hit(const float* ro, const float* rd,
                               const float* far, int n, const float* geo,
                               const float* ng, const int* obj, int T,
                               float* t, int* row, float* u, float* v,
                               float* ng_out, int* obj_out, void* stream) {
  tri_closest_kernel<<<blocks_for(n), TILE, 0, (cudaStream_t)stream>>>(
      ro, rd, far, n, geo, ng, obj, T, t, row, u, v, ng_out, obj_out);
  return (int)cudaGetLastError();
}

extern "C" int tri_any_hit(const float* ro, const float* rd, const float* far,
                           int n, const float* geo, int T, bool* occ,
                           void* stream) {
  tri_any_kernel<<<blocks_for(n), TILE, 0, (cudaStream_t)stream>>>(
      ro, rd, far, n, geo, T, occ);
  return (int)cudaGetLastError();
}

extern "C" int tri_track_hits(const float* ro, const float* rd,
                              const float* far, int n, const float* geo,
                              const float* ng, const int* obj,
                              const bool* null_tab, int T, int K,
                              float* t_null, int* obj_null, float* dn_null,
                              float* tb, int* ob, float* db, bool* ov,
                              void* stream) {
  tri_track_kernel<<<blocks_for(n), TILE, 0, (cudaStream_t)stream>>>(
      ro, rd, far, n, geo, ng, obj, null_tab, T, K, t_null, obj_null, dn_null,
      tb, ob, db, ov);
  return (int)cudaGetLastError();
}
