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
// The table: the scene's `tri_geo` (T, 12) f32, made once per scene
// (scene/compile.py `tri_tables`), rows n d | U cu | V cv, read as three
// float4s; the winner's normal (`tri_ng`) and object id (`tri_obj`) are read
// from device memory once, after the sweep.
//
// What bounds them: issuing the pair tests. A whole test is some 72 SASS
// instructions under -fmad=false (six 3-term dots, the IEEE divide's ~10,
// u, v, the compares; the parent kernel's loop was 74 a row) against 12
// bytes of rays a test at most, so the card's f32 issue rate, not its
// memory, is the limit (NVIDIA H100 80GB HBM3, 700 W: ~0.1 ns a ray over
// the cbox's 34 rows, about 80% of the issue peak). Work that no lane of a
// warp needs is time saved; work that one lane needs costs the warp all
// the same.
//
// Closest hit (tri_closest_kernel): 256 threads a block, the table staged
// in shared memory in tiles of 256 rows (any T). Each block first packs
// its walking rays (far > RAY_EPS; dead lanes carry -3e38 and are written
// as a miss at once) into its first threads, so the warps past them issue
// nothing; with 128 walkers or fewer, S = 2, 4 or 8 consecutive threads
// take a ray, each every S-th row, and the least (t, row) of the parts is
// the first row reaching the least t, so a sparse wavefront keeps the
// block's warps busy (two or four rays a thread measured slower: more
// registers, fewer blocks). A spare lane tests the last packed ray again
// and keeps nothing (a made-up ray could send its warp down the divide's
// slow path on some row). The test itself is the parent's straight-line
// tri_test: splitting it (plane first, a warp vote, u and v only where
// some lane needs them) saved issue on coherent primary rays but cost more
// than it saved on incoherent bounce rays, where a warp of 32 needs u on
// every row, and the divide no longer overlapped the u and v dots. The
// argmin is the Pallas kernel's: from +inf, an invalid row competing at
// FAR (1e7), strict < in row order; hit = best t < far is decided after
// the sweep. So with far0 > FAR a ray with no valid row before FAR comes
// back as a "hit" at t = FAR on the first row whose t is FAR, with that
// row's own u and v.
//
// Any hit (tri_any_kernel): shadow rays, bounded by the light's distance,
// so most rows' planes lie behind the ray or beyond far, as in the media
// walk. Each block stages the whole table once (the wrapper refuses more
// than TILE rows, which the brute-force tier never has) and packs its
// walking rays as the closest hit does (dead lanes are written false at
// once), with 2-8 threads a ray when 128 or fewer walk. The row test is
// split and warp-voted (row_occludes: the plane against far first, u only
// where some lane needs it, v only where some lane's u lies in [0, 1]); a
// ray's threads stop at its first occluder and a warp leaves once all of
// its rays are occluded. On cbox's shadow rays three warp-rows in ten
// need the divide and one in sixteen needs v, so a row that every lane
// rejects at its plane (some 30 SASS instructions, the loop's tail among
// them) sets the time. On an H100 (700 W) the straight tri_test in the
// same loop measured 40% slower, one thread a ray at four fifths dead 20%
// slower, and the exit vote taken every second row slower too.
//
// The media-walk kernel (tri_track_kernel) is documented where it starts.

#include <cuda_runtime.h>

#define TILE 256

constexpr float kEps = 1e-4f;   // RAY_EPS
constexpr float kFar = 1e7f;    // FAR
constexpr float kChainSep = 5e-5f;  // CHAIN_SEP = 0.5 * RAY_EPS
constexpr int kNullCap = 16;  // null rows the media walk keeps in registers

__device__ __forceinline__ float dot3(float a0, float a1, float a2,
                                      const float* b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b[0]), __fmul_rn(a1, b[1])),
                   __fmul_rn(a2, b[2]));
}

__device__ __forceinline__ float dot3v(const float* a, float4 b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a[0], b.x), __fmul_rn(a[1], b.y)),
                   __fmul_rn(a[2], b.z));
}

// The whole test of one (ray, triangle) pair; returns valid, writes t/u/v.
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

// One row against each lane's ray, for a whole warp at once (every lane of
// the warp calls it with the same row): true where the row is a valid hit
// with lo < t < bound (lo >= RAY_EPS, bound > RAY_EPS), and then t, u, v as
// tri_test rounds them. The plane half comes first and each later half
// runs only when some lane of the warp still needs it: warp votes, and
// conditions combined without short-circuits, so each half is
// straight-line code and a warp whose lanes all reject skips the rest.
// Two rejections skip the divide and are exact:
//   * (d - o.n) * dir.n <= 0 (or NaN) gives t <= 0 or NaN; where the
//     product underflows to 0, |d - o.n| < 2^-149 / 1e-12 and t < RAY_EPS;
//   * |d - o.n| >= (bound * |dir.n|) * 1.000001, each product rounded,
//     means |d - o.n| / |dir.n| > bound (the factor outweighs both
//     roundings; |dir.n| >= 1e-12 and bound > 1e-4 keep the products
//     normal), so the rounded quotient is >= bound.
// A lane with want false takes part in the votes and gets false.
__device__ __forceinline__ bool row_hit(bool want, const float* ro,
                                        const float* rd, const float4* g,
                                        float lo, float bound, float* t_out,
                                        float* u_out, float* v_out) {
  const float4 nd = g[0];
  const float num = __fsub_rn(nd.w, dot3v(ro, nd));
  const float d_n = dot3v(rd, nd);
  bool c = want & (fabsf(d_n) >= 1e-12f) & (__fmul_rn(num, d_n) > 0.0f) &
           (fabsf(num) < __fmul_rn(__fmul_rn(bound, fabsf(d_n)), 1.000001f));
  if (!__any_sync(0xffffffffu, c)) return false;
  // lanes that reject divide 1 by 1 (no slow path for them)
  const float t = __fdiv_rn(c ? num : 1.0f, c ? d_n : 1.0f);
  c = c & (t > lo) & (t < bound);
  if (!__any_sync(0xffffffffu, c)) return false;
  const float4 U = g[1], V = g[2];
  const float u =
      __fsub_rn(__fadd_rn(dot3v(ro, U), __fmul_rn(t, dot3v(rd, U))), U.w);
  const float v =
      __fsub_rn(__fadd_rn(dot3v(ro, V), __fmul_rn(t, dot3v(rd, V))), V.w);
  *t_out = t;
  *u_out = u;
  *v_out = v;
  return c & (u >= 0.0f) & (v >= 0.0f) & (__fadd_rn(u, v) <= 1.0f);
}

__device__ __forceinline__ void stage_tile4(float4* s_geo,
                                            const float4* geo4, int base,
                                            int T) {
  __syncthreads();
  const int m = min(TILE, T - base) * 3;
  for (int k = threadIdx.x; k < m; k += blockDim.x)
    s_geo[k] = geo4[(size_t)base * 3 + k];
  __syncthreads();
}

// The walking rays of a block, packed: the block's rays first +
// threadIdx.x (below n) whose far bound exceeds RAY_EPS go to s_idx in ray
// order; each other ray is handed to dead(i, far) by the thread that read
// it. s_cnt holds TILE / 32 ints. Returns the count of packed rays, the
// same in every thread.
template <typename Dead>
__device__ __forceinline__ int pack_walkers(const float* far_all, int n,
                                            int first, int* s_idx,
                                            int* s_cnt, Dead dead) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = first + threadIdx.x;
  const float f = i < n ? far_all[i] : -3e38f;
  const bool walk = f > kEps;
  if (i < n && !walk) dead(i, f);
  const unsigned mask = __ballot_sync(0xffffffffu, walk);
  if (lane == 0) s_cnt[warp] = __popc(mask);
  __syncthreads();
  int total = 0, off = 0;
  for (int k = 0; k < TILE / 32; ++k) {
    off += k < warp ? s_cnt[k] : 0;
    total += s_cnt[k];
  }
  if (walk) s_idx[off + __popc(mask & ((1u << lane) - 1u))] = i;
  __syncthreads();
  return total;
}

// Rows part, part + S, ... of the table against one ray, tile by tile
// (every thread of the block stages): the argmin over (valid ? t : FAR),
// strict < in row order.
template <int S>
__device__ __forceinline__ void closest_sweep(
    const float* ro, const float* rd, int part, bool warp_has, float4* s_geo,
    const float4* geo4, int T, float& best_t, float& best_u, float& best_v,
    int& best_i) {
  for (int base = 0; base < T; base += TILE) {
    stage_tile4(s_geo, geo4, base, T);
    const int m = warp_has ? min(TILE, T - base) : 0;
    for (int j = part; j < m; j += S) {
      float t, u, v;
      const bool ok =
          tri_test(ro, rd, (const float*)(s_geo + 3 * j), &t, &u, &v);
      const float tm = ok ? t : kFar;
      if (tm < best_t) {
        best_t = tm;
        best_u = u;
        best_v = v;
        best_i = base + j;
      }
    }
  }
}

__global__ void tri_closest_kernel(const float* __restrict__ ro_all,
                                   const float* __restrict__ rd_all,
                                   const float* __restrict__ far_all, int n,
                                   const float4* __restrict__ geo4,
                                   const float* __restrict__ ng_tab,
                                   const int* __restrict__ obj_tab, int T,
                                   float* __restrict__ t_out,
                                   int* __restrict__ row_out,
                                   float* __restrict__ u_out,
                                   float* __restrict__ v_out,
                                   float* __restrict__ ng_out,
                                   int* __restrict__ obj_out) {
  __shared__ float4 s_geo[TILE * 3];
  __shared__ int s_idx[TILE];
  __shared__ int s_cnt[TILE / 32];
  auto miss = [&](int i, float far) {
    t_out[i] = far;
    row_out[i] = -1;
    u_out[i] = v_out[i] = 0.0f;
    ng_out[(size_t)i * 3 + 0] = 1.0f;
    ng_out[(size_t)i * 3 + 1] = 0.0f;
    ng_out[(size_t)i * 3 + 2] = 0.0f;
    obj_out[i] = -1;
  };
  // dead lanes (far <= RAY_EPS) are a miss already; the walking rays are
  // packed, so warps past the last of them issue nothing
  const int walkers =
      pack_walkers(far_all, n, blockIdx.x * TILE, s_idx, s_cnt, miss);
  if (walkers == 0) return;
  // few walkers: S consecutive threads a ray (a power of two up to 8),
  // each taking every S-th row, so the block keeps its warps busy
  const int S = walkers > TILE / 2   ? 1
                : walkers > TILE / 4 ? 2
                : walkers > TILE / 8 ? 4
                                     : 8;
  const int slot = threadIdx.x / S, part = threadIdx.x % S;
  // a slot past the last packed ray tests that ray again and keeps
  // nothing: a made-up ray could send its warp down the divide's slow
  // path on some row
  const bool has = slot < walkers;
  const int i = s_idx[has ? slot : walkers - 1];
  float ro[3], rd[3];
  for (int c = 0; c < 3; ++c) {
    ro[c] = ro_all[(size_t)i * 3 + c];
    rd[c] = rd_all[(size_t)i * 3 + c];
  }
  const float far = far_all[i];
  // from +inf, so a part's first row always takes it; every row gives a
  // finite tm, so a part with rows beats one without
  float best_t = __int_as_float(0x7f800000), best_u = 0.0f, best_v = 0.0f;
  int best_i = 0;
  // a warp with no packed ray stages rows with the block and tests none
  const bool warp_has = __any_sync(0xffffffffu, has);
  switch (S) {  // the same in the whole block; a fixed stride unrolls
    case 1:
      closest_sweep<1>(ro, rd, 0, warp_has, s_geo, geo4, T, best_t, best_u,
                       best_v, best_i);
      break;
    case 2:
      closest_sweep<2>(ro, rd, part, warp_has, s_geo, geo4, T, best_t,
                       best_u, best_v, best_i);
      break;
    case 4:
      closest_sweep<4>(ro, rd, part, warp_has, s_geo, geo4, T, best_t,
                       best_u, best_v, best_i);
      break;
    default:
      closest_sweep<8>(ro, rd, part, warp_has, s_geo, geo4, T, best_t,
                       best_u, best_v, best_i);
  }
  // the least (t, row) of the ray's parts: the first row reaching the
  // least t
  for (int o = 1; o < S; o <<= 1) {
    const float t2 = __shfl_xor_sync(0xffffffffu, best_t, o);
    const int i2 = __shfl_xor_sync(0xffffffffu, best_i, o);
    const float u2 = __shfl_xor_sync(0xffffffffu, best_u, o);
    const float v2 = __shfl_xor_sync(0xffffffffu, best_v, o);
    if (t2 < best_t || (t2 == best_t && i2 < best_i)) {
      best_t = t2;
      best_i = i2;
      best_u = u2;
      best_v = v2;
    }
  }
  if (!has || part != 0) return;
  if (!(best_t < far)) {
    miss(i, far);
    return;
  }
  t_out[i] = best_t;
  row_out[i] = best_i;
  u_out[i] = best_u;
  v_out[i] = best_v;
  ng_out[(size_t)i * 3 + 0] = ng_tab[(size_t)best_i * 3 + 0];
  ng_out[(size_t)i * 3 + 1] = ng_tab[(size_t)best_i * 3 + 1];
  ng_out[(size_t)i * 3 + 2] = ng_tab[(size_t)best_i * 3 + 2];
  obj_out[i] = obj_tab[best_i];
}

// One row against each lane's shadow ray, for a whole warp at once (every
// lane of the warp calls it with the same row): true where the row
// occludes, a valid hit with RAY_EPS < t < far, as tri_test decides it.
// The halves run as in row_hit, each only where some lane of the warp
// still needs it: the plane (the same two exact rejections before the
// divide, against far), then u, then v only where some lane's u lies in
// [0, 1] (u > 1 with v >= 0 rounds u + v above 1, so such a row is never
// valid). A lane with want false takes part in the votes and gets false.
__device__ __forceinline__ bool row_occludes(bool want, const float* ro,
                                             const float* rd,
                                             const float4* g, float far) {
  const float4 nd = g[0];
  const float num = __fsub_rn(nd.w, dot3v(ro, nd));
  const float d_n = dot3v(rd, nd);
  bool c = want & (fabsf(d_n) >= 1e-12f) & (__fmul_rn(num, d_n) > 0.0f) &
           (fabsf(num) < __fmul_rn(__fmul_rn(far, fabsf(d_n)), 1.000001f));
  if (!__any_sync(0xffffffffu, c)) return false;
  const float t = __fdiv_rn(c ? num : 1.0f, c ? d_n : 1.0f);
  c = c & (t > kEps) & (t < far);
  if (!__any_sync(0xffffffffu, c)) return false;
  const float4 U = g[1];
  const float u =
      __fsub_rn(__fadd_rn(dot3v(ro, U), __fmul_rn(t, dot3v(rd, U))), U.w);
  c = c & (u >= 0.0f) & (u <= 1.0f);
  if (!__any_sync(0xffffffffu, c)) return false;
  const float4 V = g[2];
  const float v =
      __fsub_rn(__fadd_rn(dot3v(ro, V), __fmul_rn(t, dot3v(rd, V))), V.w);
  return c & (v >= 0.0f) & (__fadd_rn(u, v) <= 1.0f);
}

// Rows part, part + S, ... of the staged table against the lane's ray,
// S consecutive lanes a ray (a power of two up to 8): true where one of
// the ray's lanes found an occluder. Every lane of the warp runs the same
// iterations (the votes need them all); a ray's lanes stop testing once
// one of them is occluded, and the warp leaves once all of its rays are.
template <int S>
__device__ __forceinline__ bool any_sweep(const float* ro, const float* rd,
                                          float far, bool has,
                                          const float4* s_geo, int T) {
  const int lane = threadIdx.x & 31, part = lane % S;
  const unsigned group = ((1u << S) - 1u) << (lane & ~(S - 1));
  bool occ = false, done = !has;
  for (int base = 0; base < T; base += S) {
    const int j = S == 1 ? base : min(base + part, T - 1);
    const bool hit = row_occludes(!done && base + part < T, ro, rd,
                                  s_geo + 3 * j, far);
    // the ray's occlusion: its own lane's, or any of its S lanes' (every
    // lane votes: no short-circuit before the ballot)
    const bool any = S == 1 ? hit
                            : (__ballot_sync(0xffffffffu, hit) & group) != 0;
    occ = occ || any;
    done = done || occ;
    if (__all_sync(0xffffffffu, done)) break;
  }
  return occ;
}

__global__ void tri_any_kernel(const float* __restrict__ ro_all,
                               const float* __restrict__ rd_all,
                               const float* __restrict__ far_all, int n,
                               const float4* __restrict__ geo4, int T,
                               bool* __restrict__ occ_out) {
  __shared__ float4 s_geo[TILE * 3];
  __shared__ int s_idx[TILE];
  __shared__ int s_cnt[TILE / 32];
  // the whole table (the wrapper refuses more than TILE rows); the
  // barriers of pack_walkers publish it
  for (int k = threadIdx.x; k < T * 3; k += blockDim.x) s_geo[k] = geo4[k];
  // dead lanes (far <= RAY_EPS) are never occluded; the walking rays are
  // packed, so warps past the last of them issue nothing
  const int walkers =
      pack_walkers(far_all, n, blockIdx.x * TILE, s_idx, s_cnt,
                   [&](int i, float) { occ_out[i] = false; });
  // few walkers: S consecutive threads a ray, each taking every S-th row
  const int S = walkers > TILE / 2   ? 1
                : walkers > TILE / 4 ? 2
                : walkers > TILE / 8 ? 4
                                     : 8;
  if ((threadIdx.x & ~31) / S >= walkers) return;
  // a slot past the last packed ray votes with the others and tests that
  // ray with want false (as in the closest hit)
  const int slot = threadIdx.x / S;
  const bool has = slot < walkers;
  const int i = s_idx[has ? slot : walkers - 1];
  float ro[3], rd[3];
  for (int c = 0; c < 3; ++c) {
    ro[c] = ro_all[(size_t)i * 3 + c];
    rd[c] = rd_all[(size_t)i * 3 + c];
  }
  const float far = far_all[i];
  bool occ;
  switch (S) {  // the same in the whole block; a fixed stride unrolls
    case 1:
      occ = any_sweep<1>(ro, rd, far, has, s_geo, T);
      break;
    case 2:
      occ = any_sweep<2>(ro, rd, far, has, s_geo, T);
      break;
    case 4:
      occ = any_sweep<4>(ro, rd, far, has, s_geo, T);
      break;
    default:
      occ = any_sweep<8>(ro, rd, far, has, s_geo, T);
  }
  if (has && threadIdx.x % S == 0) occ_out[i] = occ;
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
// What bounds it: issuing the pair tests, as above. The TPU kernel computes
// the (T, 2048) hit tables once and runs K + 1 min-reductions over them.
// Here one thread takes one ray. The block stages
// the whole table in shared memory once, reordered by the scene's row lists
// (`tri_solid_rows`, then `tri_null_rows`, each ascending, so "ties to the
// lowest row" is "ties to the lowest slot"; with all_null the rows in
// order, every one null); the wrapper refuses more than TILE rows, which
// the brute-force tier never has. Then:
//   * the blocker pass, one over the non-null rows, the plane first, u and
//     v only for a row that would beat the running blocker, which starts
//     at min(FAR, far) (a blocker at or beyond far is reported as none and
//     leaves the cut at far all the same);
//   * the null pass, one over the null rows, the plane first against the
//     cut min(t_blk, far): each row's t where it is a valid hit before the
//     cut, else FAR, kept in registers (a fully unrolled array of kNullCap,
//     indexed at compile time only, so nothing goes to local memory);
//   * the K chained selections and the overflow test compare those stored
//     values only: no hit math is done twice.
// A scene with more than kNullCap null rows takes the re-sweeping loop
// instead, in the same kernel: K + 1 sweeps over the null rows from shared
// memory, against min(cut, running best). kNullCap = 16 covers every main
// path (vpt cbox: 12 null rows of 36; BDPT cbox: none) in 56 registers (32
// took 67-70 and ran slower); the all-null extraction of a 34- or 36-row
// scene takes the loop. The walking rays are packed as in the closest hit.
//
// Here the split test pays: a shadow ray's bound is the light's distance,
// so most rows' planes lie beyond it, and a warp whose lanes all reject a
// row skips its divide and its u and v (row_hit: the sign of t and
// |d - o.n| >= bound |dir.n| (1 + 1e-6) reject before the divide). At the
// vpt cbox's T = 36 (12 null rows) a walking ray starts 36 tests where the
// parent kernel ran 24 + 3 * 12 whole ones.

__device__ __forceinline__ float normal_dot(const float* rd,
                                            const float* ng_tab, int row) {
  const float d = dot3(rd[0], rd[1], rd[2], ng_tab + (size_t)row * 3);
  return __fadd_rn(d, 0.0f);
}

__global__ void tri_track_kernel(
    const float* __restrict__ ro_all, const float* __restrict__ rd_all,
    const float* __restrict__ far_all, int n,
    const float4* __restrict__ geo4, const float* __restrict__ ng_tab,
    const int* __restrict__ obj_tab, const int* __restrict__ solid_rows,
    int n_solid, const int* __restrict__ null_rows, int n_null, int K,
    float* __restrict__ t_null, int* __restrict__ obj_null,
    float* __restrict__ dn_null, float* __restrict__ tb_out,
    int* __restrict__ ob_out, float* __restrict__ db_out,
    bool* __restrict__ ov_out) {
  __shared__ float4 s_geo[TILE * 3];
  __shared__ int s_row[TILE];
  __shared__ int s_idx[TILE];
  __shared__ int s_cnt[TILE / 32];
  // slot q < n_solid: row solid_rows[q]; slot n_solid + j: null_rows[j] (row
  // j when null_rows is null: every row null)
  const int m = n_solid + n_null;
  for (int k = threadIdx.x; k < m * 3; k += blockDim.x) {
    const int q = k / 3;
    const int row = q < n_solid ? solid_rows[q]
                    : null_rows ? null_rows[q - n_solid]
                                : q - n_solid;
    s_geo[k] = geo4[(size_t)row * 3 + k % 3];
    if (k % 3 == 0) s_row[q] = row;
  }
  const float4* s_null = s_geo + 3 * n_solid;
  // dead lanes (far <= RAY_EPS) have no hits and no overflow; the walking
  // rays are packed, so warps past the last of them issue nothing
  const int walkers = pack_walkers(
      far_all, n, blockIdx.x * TILE, s_idx, s_cnt, [&](int i, float) {
        for (int k = 0; k < K; ++k) {
          const size_t o = (size_t)k * n + i;
          t_null[o] = kFar;
          obj_null[o] = -1;
          dn_null[o] = 0.0f;
        }
        tb_out[i] = kFar;
        ob_out[i] = -1;
        db_out[i] = 0.0f;
        ov_out[i] = false;
      });
  // a warp past the last packed ray is done; in the last one the lanes
  // without a ray vote with the others and write nothing
  if ((threadIdx.x & ~31) >= walkers) return;
  // (a lane past the last packed ray tests that ray again and keeps
  // nothing, as in the closest hit)
  const bool has = threadIdx.x < walkers;
  const int i = s_idx[has ? threadIdx.x : walkers - 1];
  float ro[3], rd[3];
  for (int c = 0; c < 3; ++c) {
    ro[c] = ro_all[(size_t)i * 3 + c];
    rd[c] = rd_all[(size_t)i * 3 + c];
  }
  const float far = far_all[i];

  // closest blocker: strict < from min(FAR, far), so the lowest row wins a
  // tie and rows at FAR (invalid) never win; a blocker at or beyond far is
  // reported as none and leaves the cut at far all the same
  float t_blk = fminf(kFar, far);
  int q_blk = -1;
  for (int q = 0; q < n_solid; ++q) {
    float t, u, v;
    if (row_hit(has, ro, rd, s_geo + 3 * q, kEps, t_blk, &t, &u, &v)) {
      t_blk = t;
      q_blk = q;
    }
  }
  const float t_cut = fminf(t_blk, far);

  auto write_slot = [&](int k, float best, int j) {
    if (!has) return;
    const bool hit = j >= 0 && best < far;
    const int row = hit ? s_row[n_solid + j] : 0;
    const size_t o = (size_t)k * n + i;
    t_null[o] = hit ? best : kFar;
    obj_null[o] = hit ? obj_tab[row] : -1;
    dn_null[o] = hit ? normal_dot(rd, ng_tab, row) : 0.0f;
  };

  float prev = 0.0f;
  bool overflow = false;
  if (n_null <= kNullCap) {
    // each null row's hit t before the cut, else FAR
    float th[kNullCap];
#pragma unroll
    for (int j = 0; j < kNullCap; ++j) {
      th[j] = kFar;
      float t, u, v;
      if (j < n_null &&
          row_hit(has, ro, rd, s_null + 3 * j, kEps, t_cut, &t, &u, &v))
        th[j] = t;
    }
    for (int k = 0; k < K; ++k) {
      float best = kFar;
      int bj = -1;
#pragma unroll
      for (int j = 0; j < kNullCap; ++j) {
        if (j >= n_null) break;
        if (th[j] > prev && th[j] < best) {
          best = th[j];
          bj = j;
        }
      }
      write_slot(k, best, bj);
      prev = __fadd_rn(best, kChainSep);
    }
#pragma unroll
    for (int j = 0; j < kNullCap; ++j) {
      if (j >= n_null) break;
      overflow |= th[j] > prev && th[j] < kFar;
    }
  } else {
    // K chained sweeps, then (k == K) the overflow sweep
    for (int k = 0; k <= K; ++k) {
      float best = kFar;
      int bj = -1;
      const float lo = fmaxf(kEps, prev);
      for (int j = 0; j < n_null; ++j) {
        float t, u, v;
        if (row_hit(has, ro, rd, s_null + 3 * j, lo, fminf(t_cut, best), &t,
                    &u, &v)) {
          best = t;
          bj = j;
        }
      }
      if (k == K) {
        overflow = bj >= 0;
        break;
      }
      write_slot(k, best, bj);
      prev = __fadd_rn(best, kChainSep);
    }
  }
  if (!has) return;
  const bool hit_b = q_blk >= 0;
  const int row_b = hit_b ? s_row[q_blk] : 0;
  tb_out[i] = hit_b ? t_blk : kFar;
  ob_out[i] = hit_b ? obj_tab[row_b] : -1;
  db_out[i] = hit_b ? normal_dot(rd, ng_tab, row_b) : 0.0f;
  ov_out[i] = overflow;
}

static int blocks_for(int n) { return (n + TILE - 1) / TILE; }

extern "C" int tri_closest_hit(const float* ro, const float* rd,
                               const float* far, int n, const float* geo,
                               const float* ng, const int* obj, int T,
                               float* t, int* row, float* u, float* v,
                               float* ng_out, int* obj_out, void* stream) {
  tri_closest_kernel<<<blocks_for(n), TILE, 0, (cudaStream_t)stream>>>(
      ro, rd, far, n, (const float4*)geo, ng, obj, T, t, row, u, v, ng_out,
      obj_out);
  return (int)cudaGetLastError();
}

extern "C" int tri_any_hit(const float* ro, const float* rd, const float* far,
                           int n, const float* geo, int T, bool* occ,
                           void* stream) {
  if (T > TILE) return (int)cudaErrorInvalidValue;
  tri_any_kernel<<<blocks_for(n), TILE, 0, (cudaStream_t)stream>>>(
      ro, rd, far, n, (const float4*)geo, T, occ);
  return (int)cudaGetLastError();
}

// null_rows == nullptr: every row is null (n_solid must be 0)
extern "C" int tri_track_hits(const float* ro, const float* rd,
                              const float* far, int n, const float* geo,
                              const float* ng, const int* obj,
                              const int* solid_rows, int n_solid,
                              const int* null_rows, int n_null, int K,
                              float* t_null, int* obj_null, float* dn_null,
                              float* tb, int* ob, float* db, bool* ov,
                              void* stream) {
  if (n_solid + n_null > TILE) return (int)cudaErrorInvalidValue;
  tri_track_kernel<<<blocks_for(n), TILE, 0, (cudaStream_t)stream>>>(
      ro, rd, far, n, (const float4*)geo, ng, obj, solid_rows, n_solid,
      null_rows, n_null, K, t_null, obj_null, dn_null, tb, ob, db, ov);
  return (int)cudaGetLastError();
}

// which: 0 closest hit, 1 any hit, 2 media walk. out: registers a thread,
// local (spilled) bytes a thread, blocks of TILE resident on one SM, SMs,
// TILE, kNullCap.
extern "C" int tri_kernel_info(int which, int* out) {
  cudaFuncAttributes attr;
  const void* fn = which == 0   ? (const void*)tri_closest_kernel
                   : which == 1 ? (const void*)tri_any_kernel
                                : (const void*)tri_track_kernel;
  int err = (int)cudaFuncGetAttributes(&attr, fn);
  if (err) return err;
  int dev = 0;
  cudaGetDevice(&dev);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 2, fn, TILE,
                                                           0);
  if (err) return err;
  err = (int)cudaDeviceGetAttribute(out + 3, cudaDevAttrMultiProcessorCount,
                                    dev);
  out[4] = TILE;
  out[5] = kNullCap;
  return err;
}
