// Cluster-tier kernels for Hopper (sm_90a): the all-cluster sweep and the
// queue-pick schedule's front and pick passes, on the big-scene tier.
//
// Replace five Pallas TPU kernels of adapt_tpu/ops/cluster_pallas.py:
//   cluster_closest_kernel      `_closest_kernel` (:513, via
//                               `cluster_closest_hit`)
//   cluster_any_kernel          `_any_kernel` (:600, via `cluster_any_hit`)
//   cluster_front_kernel        `_front_kernel` (:1515, via
//                               `_front_candidates`)
//   cluster_pick_closest_kernel `_single_kernel` (:1385, via `_single_pass`)
//   cluster_pick_any_kernel     `_single_any_kernel` (:1691, in `qpick_any`)
//
// Tables (scene/compile.py `_cluster_cut`): the BVH is cut into C disjoint
// subtrees ("clusters") of at most CM prims, each a contiguous run of the
// tree's DFS prim order.
//   cl_aabb  (C, 6)     lo(3) hi(3) of each cluster
//   cl_front (C, 6)     the same boxes inflated a little (front pass)
//   cl_chunk (C, K, 6)  box of each run of 128 prims inside a cluster
//   cl_count (C,) i32   live prims of each cluster
//   cl_tree  (T, 8)     the BVH nodes above the cut, one leaf a cluster, in
//                       DFS order (scene/compile.py `cluster_tree`): lo(3)
//                       skip hi(3) first-cluster, the ints as int32 bits
//   rows     (C*CM, 18) prim-major: n|center(3) d|radius U(3) cu V(3) cv
//                       is_sphere gid n_g(3) obj; slots past a cluster's
//                       count are padding (gid -1) and never hit
// The int fields ride the f32 rows, exact below 2^24.
//
// What the TPU versions do for VMEM and (8,128) vector registers has no
// counterpart here: the any-lane cluster mask and its refresh, the per-tile
// front-to-back order, the DMA of a prim block into scratch, one-hot winner
// extraction, ray padding to lane blocks. Each kernel computes what its TPU
// kernel computes:
//
// * sweep (closest, any): the clusters in index order, for every ray. A
//   cluster is entered when the slab test of its box passes against the
//   lane's current best t (any hit: its far bound); inside, each 128-prim
//   chunk is gated by its own box the same way, then its live rows are
//   tested and the least t below the bound kept, the lowest slot on a tie
//   (what a loop in slot order with strict < keeps). Clusters are DFS
//   ranges, so index order with that tie rule keeps the first prim in DFS
//   order: the tie rule of the BVH walk (bvh_intersect.cu). The
//   closest-hit kernel finishes the winner in the kernel (gid, u, v, n_g,
//   obj, sphere flag; a sphere's normal from its hit point); an any-hit
//   lane stops after the chunk of its first hit.
// * front: one thread per ray keeps, in registers, the entered cluster
//   (inflated boxes) with the least entry distance max(t_near, 0) (ties to
//   the lowest id, C when none) and the second least entry distance (3e38
//   when fewer than two), as a loop over the clusters in index order with
//   strict < keeps them. It walks the tree above the cut instead of
//   testing every box (below).
// * pick (closest, any): one block per tile of TILE = 128 consecutive rays
//   reads its own pick (cluster id, -1: nothing to do) and tests each ray
//   against that cluster's live rows in slot order: closest starts from
//   t = far, wid = wid0 and keeps strict improvements, wid = cluster * CM
//   + slot; any ORs t < far. The rows are staged in shared memory first,
//   as the TPU kernels DMA them into VMEM, and each ray's rows are split
//   over four threads (below).
//
// Exactness: the prim test has the operation order of the TPU kernels'
// `_prim_chunk_test`: every dot is (x0*y0 + x1*y1) + x2*y2 and
// u = (o.U + t*(d.U)) - cu (the BVH kernels compute (o + t*d).U - cu), every
// operation rounded once (explicit __f*_rn; the library is built with
// -fmad=false), min/max propagating NaN as torch's do. The plain PyTorch
// versions (ops/cluster_kernels.py) repeat these steps, so kernel and plain
// agree bit for bit.
//
// Bound: the rows of a 290k-prim scene are 29.7 MB (20.9 MB of them live;
// the sweeps' 64-byte copy 26.4 MB) and its boxes under 0.2 MB, all inside
// the H100's 50 MB L2, so no kernel here is bound by HBM bytes. The sweeps
// are bound by the operations they execute: every ray pays C box tests,
// from a table in shared memory (38.7 KB at C = 1,613; a table above
// SMEM_MAX bytes is refused), one box at a time for the whole warp (a
// broadcast), some thirty operations a box. The front pass is bound by
// the box tests its walk needs (PERF.md). The prim test leaves a
// row as soon as its t cannot win, before the four u/v dots. The pick
// kernels are bound by the chains of row tests of their longest tiles
// (below).
//
// The sweep kernels (B6a, B6b) are built around what held their first port
// (one thread per ray) at 50x its bound: (1) a warp whose lanes
// entered different clusters or chunks ran their row loops one after
// another, each row 18 scalar loads of a 72-byte row that straddles
// sectors (ops/cluster_kernels.py `warp_divergence`: a warp ran ~20 row
// iterations for every 32 row tests its lanes needed on bounce rays);
// (2) chunk boxes read from global memory inside those branches; (3)
// 128-thread blocks that each staged the box table, 20 warps an SM. Now:
//   * warp-cooperative chunks: lanes still visit clusters in index order,
//     each gated on its own bound; at each cluster and chunk the warp takes
//     the ballot of the lanes that enter, and for each of them in turn the
//     32 lanes split the chunk's live rows (lane k rows k, k + 32, ...), the
//     ray coming by shuffle. B6a reduces to the least (t, slot) below the
//     lane's best at the chunk's start, B6b ORs t < far with a warp vote.
//     Each (ray, row) t is computed as before, and a loop in slot order
//     with strict < ends at that same least (t, slot); B6b's result, an OR
//     gated on a fixed far bound, holds in any order. So both stay
//     bit-equal to the plain versions;
//   * aligned rows: the 14 fields a test reads as one 64-byte row of four
//     float4s (`cl_rows_v4`, scene/compile.py `cluster_v4`), coalesced
//     across the warp; only a winner reads n_g and obj from the 18-wide
//     rows;
//   * a cluster's chunk boxes and count in one load for the warp (lane j
//     the j-th word) when some lane enters it; the cluster boxes read from
//     shared memory as three 8-byte broadcasts and tested with
//     one-instruction NaN min/max (same comparisons, same branches);
//   * 256-thread blocks: five fit an SM with their box tables, 40 warps.
// What is left (PERF.md): mostly the box tests, which every lane makes
// for every cluster, then the round trip that fetches an entered cluster's
// chunk boxes; the rows themselves take little. Prefetching every
// cluster's chunk boxes one cluster ahead, testing boxes two or four at a
// time, 128- or 512-thread blocks and stopping B6b's rows at the first 32
// that hit measured no faster (or slower) in scratch builds.
//
// The front kernel (B6c) was the flat loop: all C boxes for every ray
// (1,613 on knot290k), each six scalar shared loads. Clusters are DFS
// ranges of the BVH, so the nodes above the cut form a tree whose DFS
// visits them in index order (`cl_tree`). The kernel walks it without a
// stack, one thread a ray: a row whose box the ray misses, or enters
// strictly after the lane's running second, is skipped with its subtree
// (its skip); an inner row entered otherwise is followed by the next row;
// a leaf is one cluster, with its own cl_front box, and updates (first,
// cid, second) without branches. Exact: every step of the slab test
// rounds monotonically and an inner box holds its clusters' boxes as the
// slab test sees them, so a skipped cluster the ray enters has an entry
// above the second and changes nothing (ops/cluster_kernels.py
// `cluster_front_culled` repeats the walk step for step). The walk tests
// some 16-21 rows a ray on knot290k's rays in place of 1,613. The tree is
// read by __ldg of float4 rows (lanes are at different rows; 101 KB on
// knot290k, held in L1), the next row loaded beside the current one; no
// shared memory, so the front pass takes any cluster count. The box
// test's min/max are one instruction each where they only feed
// comparisons; the entry distance, an output, is max(t_near, 0) as before.
//
// The pick kernels (B6d, B6e) first read the picked cluster's 72-byte rows
// one at a time straight from L2, in three dependent steps a row (the
// padding slot, the plane, then U and V), behind an early return that kept
// the next row's loads from starting: a chain of load latencies for every
// row of the cluster, for each of the tile's 128 threads alike. Now:
//   * thread 0 of a block with a pick stages the cluster's live rows of
//     the float4 pack (`cl_rows_v4`, 64 B a row, at most PICK_ROWS = 256
//     in 16 KB of dynamic shared memory) with one TMA bulk copy
//     (cp.async.bulk ... mbarrier::complete_tx) for each stage of
//     PICK_STAGE rows, each stage completing its own mbarrier (one arrival
//     that announces the bytes, then the copy's bytes). A thread waits on
//     a stage's barrier before it tests that stage's rows; no stage is
//     reused, so nothing is released and a thread may stop waiting at any
//     point: an any-hit thread stops at its first hit and a warp whose
//     lanes have all hit leaves the loop. The block must not retire with a
//     copy still writing its shared memory, so the any-hit kernel's
//     thread 0 waits on every stage before the block ends (every
//     closest-hit thread waits on all of them anyway). The copies need
//     16-byte aligned addresses and sizes: rows are 64 B and the wrapper
//     checks the pack's start;
//   * a row is read from shared memory by broadcast loads (every thread
//     of the block reads the same row; the compiler loads the flags and
//     the plane first, U and V only behind the plane test), two rows an
//     iteration unrolled;
//   * PICK_SPLIT = 4 threads a ray (512 a block for the 128-ray tile):
//     thread (ray r, part q) tests rows q, q + 4, ... in slot order with
//     strict <, and part 0 takes the least (t, slot) of the parts that
//     improved on far (B6e: ORs them). A loop in slot order with strict <
//     ends at the least t below far, the lowest slot on a tie, so each
//     part ends at that minimum over its rows and the least of the parts'
//     is the whole loop's: bit-equal to the plain versions. A pass lasts
//     as long as its longest tiles: most tiles pick a small cluster (the
//     room's walls: some 14 row tests a ray on knot290k's bounce rays),
//     a few a cluster of 256 rows, and with one thread a ray each of
//     their threads ran those rows as one dependent chain, so a pass with
//     7% of its tiles active took as long as one with 79% (PERF.md);
//   * the prim test is prim_test4, the sweeps' own. What bounds the
//     kernels now is still the longest tiles' chains, 64 rows a thread,
//     some 40 SASS instructions a row that stops at its plane distance
//     (the IEEE divide a reciprocal, five FFMA and a slow-path check).

#include <cuda_runtime.h>

#define ROW 18
#define RAY_EPS 1e-4f
#define FAR 1e7f
#define BIG 3e38f
#define SWEEP_BLOCK 256
#define FRONT_BLOCK 256
#define TILE 128
#define FULL 0xffffffffu
#define CHUNK 128
// the pick kernels stage at most PICK_ROWS rows of 64 B (16 KB) a block,
// in bulk copies of PICK_STAGE rows, one mbarrier each, and split a tile's
// rows over PICK_SPLIT threads a ray; keep PICK_ROWS and PICK_SPLIT equal
// to ops/cluster_kernels.py's
#define PICK_ROWS 256
#define PICK_STAGE 32
#define PICK_STAGES (PICK_ROWS / PICK_STAGE)
#define PICK_SPLIT 4
// largest box table (a block may use 227 KB of shared memory); keep equal
// to ops/cluster_kernels.py BOX_TABLE_MAX
#define SMEM_MAX (200 * 1024)

// torch.maximum: NaN in, NaN out
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

__device__ __forceinline__ float dot3(const float* x, const float* y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x[0], y[0]), __fmul_rn(x[1], y[1])),
                   __fmul_rn(x[2], y[2]));
}

struct Ray {
  float o[3], d[3], inv[3];
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ ro,
                                        const float* __restrict__ rd, int i) {
  Ray r;
  for (int a = 0; a < 3; ++a) {
    r.o[a] = __ldg(ro + (size_t)i * 3 + a);
    r.d[a] = __ldg(rd + (size_t)i * 3 + a);
    const float safe = fabsf(r.d[a]) < 1e-9f ? 1e-9f : r.d[a];
    r.inv[a] = __fdiv_rn(1.0f, safe);
  }
  return r;
}

// The block's copy of a (C, 6) box table in shared memory.
__device__ __forceinline__ void stage_boxes(const float* __restrict__ table,
                                            int C, float* s_box) {
  for (int k = threadIdx.x; k < C * 6; k += blockDim.x)
    s_box[k] = __ldg(table + k);
  __syncthreads();
}

// A prim row of the float4 pack (scene/compile.py `cluster_v4`): n|center
// d|radius, U cu, V cv, is_sphere gid pad pad.
struct PrimRow {
  float4 q[4];
};

__device__ __forceinline__ PrimRow load_row(const float4* __restrict__ rows4,
                                            int k) {
  const float4* row = rows4 + 4 * (size_t)k;
  return {{__ldg(row), __ldg(row + 1), __ldg(row + 2), __ldg(row + 3)}};
}

// One prim row of the float4 pack (cluster_pallas.py `_prim_chunk_test`)
// for the ray (o, d): its hit distance, or FAR on a miss. A row whose t
// cannot lie in (RAY_EPS, t_max) leaves early: the caller accepts only
// t < t_max, so the result is the same. A sphere row holds its center in
// n and its radius in d (a quadratic); a triangle's is a plane test, then
// the dual basis.
__device__ __forceinline__ float prim_test4(const float* o, const float* d,
                                            const PrimRow& row, float t_max) {
  if (row.q[3].y < 0.0f) return FAR;             // padding slot
  const float a[3] = {row.q[0].x, row.q[0].y, row.q[0].z};
  const float b = row.q[0].w;
  if (row.q[3].x > 0.5f) {
    float c[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) c[k] = __fsub_rn(a[k], o[k]);
    const float cn2 = dot3(c, c);
    const float proj = dot3(c, d);
    const float c2r = __fsub_rn(cn2, __fmul_rn(proj, proj));
    const float r2 = __fmul_rn(b, b);
    const float cut = __fsqrt_rn(max_nan(__fsub_rn(r2, c2r), 0.0f));
    const bool outside = cn2 > __fadd_rn(r2, 1e-4f);
    const float t_sph = __fadd_rn(proj, outside ? -cut : cut);
    return ((c2r < r2) && (t_sph > RAY_EPS)) ? t_sph : FAR;
  }
  const float o_n = dot3(o, a);
  const float d_n = dot3(d, a);
  const bool flat = fabsf(d_n) < 1e-12f;
  const float t = __fdiv_rn(__fsub_rn(b, o_n), flat ? 1e-12f : d_n);
  if (flat || !(t > RAY_EPS) || !(t < t_max)) return FAR;
  const float U[3] = {row.q[1].x, row.q[1].y, row.q[1].z};
  const float V[3] = {row.q[2].x, row.q[2].y, row.q[2].z};
  const float u =
      __fsub_rn(__fadd_rn(dot3(o, U), __fmul_rn(t, dot3(d, U))), row.q[1].w);
  const float v =
      __fsub_rn(__fadd_rn(dot3(o, V), __fmul_rn(t, dot3(d, V))), row.q[2].w);
  const bool ok = (u >= 0.0f) && (v >= 0.0f) && (__fadd_rn(u, v) <= 1.0f);
  return ok ? t : FAR;
}

// torch.minimum / torch.maximum in one instruction each (min.NaN /
// max.NaN), for values that only feed comparisons: which NaN or which zero
// comes out changes no comparison, so the gates take the same branches.
__device__ __forceinline__ float min_nan1(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float max_nan1(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// Entry and exit distances of the ray through the box lo(3) hi(3)
// (cluster_pallas.py `_slab_lanes`), min/max in one instruction each.
__device__ __forceinline__ void slab1(const Ray& r, const float* box,
                                      float& tn, float& tf) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float t1 = __fmul_rn(__fsub_rn(box[a], r.o[a]), r.inv[a]);
    const float t2 = __fmul_rn(__fsub_rn(box[3 + a], r.o[a]), r.inv[a]);
    const float lo = min_nan1(t1, t2), hi = max_nan1(t1, t2);
    tn = a == 0 ? lo : max_nan1(tn, lo);
    tf = a == 0 ? hi : min_nan1(tf, hi);
  }
}

// The ray enters the box lo(3) hi(3) before t_max.
__device__ __forceinline__ bool enters6(const Ray& r, const float* box,
                                        float t_max) {
  float tn = 0.0f, tf = 0.0f;
  slab1(r, box, tn, tf);
  return (tf >= max_nan1(tn, 0.0f)) && (tn < t_max);
}

// `enters6` on box c of the shared table: three 8-byte loads, one broadcast
// each (a box is 24 B, so every box starts on an 8-byte boundary).
__device__ __forceinline__ bool enters_smem(const Ray& r, const float* table,
                                            int c, float t_max) {
  const float2* b = reinterpret_cast<const float2*>(table + 6 * c);
  const float2 b0 = b[0], b1 = b[1], b2 = b[2];
  const float box[6] = {b0.x, b0.y, b1.x, b1.y, b2.x, b2.y};
  return enters6(r, box, t_max);
}

// The ray of lane src, in every lane.
__device__ __forceinline__ void ray_of(const Ray& r, int src, float* o,
                                       float* d) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o[k] = __shfl_sync(FULL, r.o[k], src);
    d[k] = __shfl_sync(FULL, r.d[k], src);
  }
}

// B6a's chunk step: lane src entered the chunk of m live rows at slot
// base. The 32 lanes split its rows (lane k tests rows k, k + 32, ...)
// against src's ray and src's best t at the chunk's start, then reduce to
// the least (t, slot). That is what src's own loop in slot order with
// strict < ends at: the least t below the start, the lowest slot on a tie;
// every t is computed as before.
__device__ __forceinline__ void closest_chunk(
    const Ray& r, const float4* __restrict__ rows4, int src, int base, int m,
    float& best, int& wid) {
  const int lane = threadIdx.x & 31;
  float o[3], d[3];
  ray_of(r, src, o, d);
  const float start = __shfl_sync(FULL, best, src);
  float tm = start;
  int km = CHUNK;                                // none below the start
#pragma unroll
  for (int j = 0; j < CHUNK / 32; ++j) {
    const int k = lane + 32 * j;
    if (k < m) {
      const float t = prim_test4(o, d, load_row(rows4, base + k), start);
      if (t < tm) {
        tm = t;
        km = k;
      }
    }
  }
  // the warp's least (t, slot), by two warp reductions: tm is above
  // RAY_EPS and never NaN (it starts at src's best, which is, and only a t
  // above RAY_EPS or FAR replaces it), so its bits order as the floats do
  const unsigned tb = __reduce_min_sync(FULL, __float_as_uint(tm));
  const int kb =
      (int)__reduce_min_sync(FULL, __float_as_uint(tm) == tb ? km : CHUNK);
  if (lane == src && kb < CHUNK) {
    best = __uint_as_float(tb);
    wid = base + kb;
  }
}

// B6b's chunk step: the 32 lanes test all of src's rows (lane k rows k,
// k + 32, ..., their loads issued together) against its ray and far bound,
// and a warp vote ORs t < far over them. The result ORs t < far over the
// rows of the chunks entered, all gated on the fixed far bound: no order
// of the rows changes it, nor testing rows past the first hit.
__device__ __forceinline__ void any_chunk(const Ray& r,
                                          const float4* __restrict__ rows4,
                                          int src, int base, int m, float far,
                                          bool& hit) {
  const int lane = threadIdx.x & 31;
  float o[3], d[3];
  ray_of(r, src, o, d);
  const float f = __shfl_sync(FULL, far, src);
  bool h = false;
#pragma unroll
  for (int j = 0; j < CHUNK / 32; ++j) {
    const int k = lane + 32 * j;
    if (k < m) h = (prim_test4(o, d, load_row(rows4, base + k), f) < f) | h;
  }
  if (__any_sync(FULL, h) && lane == src) hit = true;
}

// The sweep of one warp, shared by B6a and B6b. Every lane visits the
// clusters in index order and gates each on its bound (B6a: its running
// best t, B6b: its far bound), the box table in shared memory. When some
// lane enters cluster c, lane j < 6 K loads float j of the cluster's chunk
// boxes (one load for them all) and the count; the entering lanes gate
// each chunk the same way, then the chunk step runs once for each lane
// that entered it, lanes in ascending order, all 32 lanes together. A lane
// takes part while `walks` and not `hit`; a warp with none stops.
template <bool ANY>
__device__ __forceinline__ void sweep_warp(
    const Ray& r, const float* table, const float* __restrict__ cl_chunk,
    const int* __restrict__ cl_count, const float4* __restrict__ rows4, int C,
    int K, int CM, bool walks, float& bound, int& wid, bool& hit) {
  const int lane = threadIdx.x & 31;
  if (!__any_sync(FULL, walks)) return;
  for (int c = 0; c < C; ++c) {
    const unsigned em = __ballot_sync(
        FULL, walks && !hit && enters_smem(r, table, c, bound));
    if (!em) continue;
    const int cnt = __ldg(cl_count + c);
    const float cb =
        lane < 6 * K ? __ldg(cl_chunk + (size_t)c * K * 6 + lane) : 0.0f;
    for (int q = 0; q * CHUNK < cnt; ++q) {
      float box[6];
#pragma unroll
      for (int j = 0; j < 6; ++j) box[j] = __shfl_sync(FULL, cb, 6 * q + j);
      unsigned qm = __ballot_sync(
          FULL, ((em >> lane) & 1u) && !hit && enters6(r, box, bound));
      const int base = c * CM + q * CHUNK;
      const int m = min(cnt - q * CHUNK, CHUNK);
      while (qm) {
        const int src = __ffs(qm) - 1;
        qm &= qm - 1;
        if (ANY)
          any_chunk(r, rows4, src, base, m, bound, hit);
        else
          closest_chunk(r, rows4, src, base, m, bound, wid);
      }
    }
    if (ANY && !__any_sync(FULL, walks && !hit)) return;
  }
}

// One lane a ray, each lane's ray loaded whatever its index (a lane past n
// takes ray n - 1 and does nothing with it), so that all 32 lanes of a
// warp take part in every shuffle.
__device__ __forceinline__ int ray_index(int n) {
  return min((int)(blockIdx.x * blockDim.x + threadIdx.x), n - 1);
}

__global__ void __launch_bounds__(SWEEP_BLOCK) cluster_closest_kernel(
    const float* __restrict__ ro, const float* __restrict__ rd,
    const float* __restrict__ far0, int n, const float* __restrict__ cl_aabb,
    const float* __restrict__ cl_chunk, const int* __restrict__ cl_count,
    const float* __restrict__ rows, const float4* __restrict__ rows4, int C,
    int K, int CM, float* __restrict__ t_out, int* __restrict__ gid_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    float* __restrict__ ng_out, int* __restrict__ obj_out,
    int* __restrict__ sph_out) {
  extern __shared__ float box[];
  stage_boxes(cl_aabb, C, box);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const Ray r = load_ray(ro, rd, ray_index(n));
  float best = __ldg(far0 + ray_index(n));
  int wid = -1;
  bool hit = false;
  // a far bound that admits no hit (dead lanes carry -3e38): no sweep
  sweep_warp<false>(r, box, cl_chunk, cl_count, rows4, C, K, CM,
                    i < n && best > RAY_EPS, best, wid, hit);
  if (i >= n) return;
  // finish the winner (cluster_pallas.py `_select_winner`)
  float u = 0.0f, v = 0.0f, ng[3] = {1.0f, 0.0f, 0.0f};
  int gid = -1, obj = -1, sph = 0;
  if (wid >= 0) {
    const float* row = rows + (size_t)wid * ROW;
    float U[3], V[3];
    for (int k = 0; k < 3; ++k) {
      U[k] = __ldg(row + 4 + k);
      V[k] = __ldg(row + 8 + k);
      ng[k] = __ldg(row + 14 + k);
    }
    gid = (int)__ldg(row + 13);
    obj = (int)__ldg(row + 17);
    sph = __ldg(row + 12) > 0.5f ? 1 : 0;
    u = __fsub_rn(__fadd_rn(dot3(r.o, U), __fmul_rn(best, dot3(r.d, U))),
                  __ldg(row + 7));
    v = __fsub_rn(__fadd_rn(dot3(r.o, V), __fmul_rn(best, dot3(r.d, V))),
                  __ldg(row + 11));
    if (sph) {
      float h[3];
      for (int k = 0; k < 3; ++k)
        h[k] = __fsub_rn(__fadd_rn(r.o[k], __fmul_rn(best, r.d[k])),
                         __ldg(row + k));
      const float inv_n =
          __fdiv_rn(1.0f, __fsqrt_rn(max_nan(dot3(h, h), 1e-24f)));
      for (int k = 0; k < 3; ++k) ng[k] = __fmul_rn(h[k], inv_n);
    }
  }
  t_out[i] = best;
  gid_out[i] = gid;
  u_out[i] = u;
  v_out[i] = v;
  for (int k = 0; k < 3; ++k) ng_out[(size_t)i * 3 + k] = ng[k];
  obj_out[i] = obj;
  sph_out[i] = sph;
}

__global__ void __launch_bounds__(SWEEP_BLOCK) cluster_any_kernel(
    const float* __restrict__ ro, const float* __restrict__ rd,
    const float* __restrict__ far0, int n, const float* __restrict__ cl_aabb,
    const float* __restrict__ cl_chunk, const int* __restrict__ cl_count,
    const float4* __restrict__ rows4, int C, int K, int CM,
    bool* __restrict__ occ) {
  extern __shared__ float box[];
  stage_boxes(cl_aabb, C, box);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const Ray r = load_ray(ro, rd, ray_index(n));
  float far = __ldg(far0 + ray_index(n));
  int wid = -1;
  bool hit = false;
  sweep_warp<true>(r, box, cl_chunk, cl_count, rows4, C, K, CM,
                   i < n && far > RAY_EPS, far, wid, hit);
  if (i < n) occ[i] = hit;
}

// A row of cl_tree: lo.xyz | skip, hi.xyz | first cluster (int bits).
struct TreeRow {
  float4 lo, hi;
};

__device__ __forceinline__ TreeRow load_tree(const float4* __restrict__ tree,
                                             int c) {
  return {__ldg(tree + 2 * (size_t)c), __ldg(tree + 2 * (size_t)c + 1)};
}

// B6c. Each lane walks cl_tree from row 0 until its cursor passes the last
// row.
__global__ void __launch_bounds__(FRONT_BLOCK) cluster_front_kernel(
    const float* __restrict__ ro, const float* __restrict__ rd,
    const float* __restrict__ far0, int n, const float4* __restrict__ tree,
    int T, int C, int* __restrict__ cid_out, float* __restrict__ nxt_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(ro, rd, i);
  const float far = __ldg(far0 + i);
  float first = BIG, second = BIG;
  int cid = C;
  int cursor = 0;
  TreeRow node = load_tree(tree, 0);
  while (cursor < T) {
    const TreeRow next = load_tree(tree, min(cursor + 1, T - 1));
    const float box[6] = {node.lo.x, node.lo.y, node.lo.z,
                          node.hi.x, node.hi.y, node.hi.z};
    float tn = 0.0f, tf = 0.0f;
    slab1(r, box, tn, tf);
    tn = max_nan1(-BIG, tn);
    tf = min_nan1(BIG, tf);
    // the entry distance max(t_near, 0): +0 for either zero, NaN for NaN
    const float ent = max_nan(tn, 0.0f);
    const bool enter = (tf >= ent) && (tn < far);
    const int skip = __float_as_int(node.lo.w);
    const bool leaf = skip == cursor + 1;
    // a leaf: the update of the loop in index order (keyed is never NaN)
    const float keyed = leaf && enter ? ent : BIG;
    const bool lt1 = keyed < first;
    second = lt1 ? first : fminf(second, keyed);
    first = lt1 ? keyed : first;
    cid = lt1 ? __float_as_int(node.hi.w) : cid;
    // an inner row: into its subtree, or past it
    const int to = !leaf && enter && ent <= second ? cursor + 1 : skip;
    if (to == cursor + 1) {
      node = next;
    } else if (to < T) {
      node = load_tree(tree, to);
    }
    cursor = to;
  }
  cid_out[i] = cid;
  nxt_out[i] = second;
}

// The address of p in the block's shared memory, as PTX takes it.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Thread 0 of a block with a pick: rows4 rows first .. first + cnt - 1
// (cnt <= PICK_ROWS) into s_rows, stage s (rows s * PICK_STAGE ..) by one
// bulk copy that completes bar[s]: one arrival that announces its bytes,
// then the copy's bytes. Every address and size is a multiple of 16 B.
__device__ __forceinline__ void stage_rows(const float4* __restrict__ rows4,
                                           int first, int cnt,
                                           float4* s_rows,
                                           unsigned long long* bar) {
  const int stages = (cnt + PICK_STAGE - 1) / PICK_STAGE;
  for (int s = 0; s < stages; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                     smem_addr(bar + s))
                 : "memory");
  // the barriers' initialisation, seen by the copies (the async proxy)
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  for (int s = 0; s < stages; ++s) {
    const unsigned bytes = 64u * min(PICK_STAGE, cnt - s * PICK_STAGE);
    const unsigned b = smem_addr(bar + s);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                     "r"(b),
                 "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_addr(s_rows + 4 * s * PICK_STAGE)),
        "l"(rows4 + 4 * ((size_t)first + s * PICK_STAGE)), "r"(bytes),
        "r"(b)
        : "memory");
  }
}

// Until the stage's copy has landed (each barrier completes its phase 0
// once).
__device__ __forceinline__ void wait_stage(const unsigned long long* bar) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}" : "=r"(done) : "r"(smem_addr(bar))
        : "memory");
}

// Row k of the staged cluster: four 16-byte loads, each a broadcast (every
// thread of the block reads the same row).
__device__ __forceinline__ PrimRow smem_row(const float4* s_rows, int k) {
  const float4* row = s_rows + 4 * k;
  return {{row[0], row[1], row[2], row[3]}};
}

// B6d. A block with a pick stages its rows; thread (ray r, part q) of
// PICK_SPLIT parts tests rows q, q + PICK_SPLIT, ... in slot order against
// ray r, waiting on each stage's barrier, then part 0 takes the least
// (t, slot) of the parts that improved on far.
__global__ void __launch_bounds__(TILE * PICK_SPLIT)
    cluster_pick_closest_kernel(
        const int* __restrict__ picks, const float* __restrict__ ro,
        const float* __restrict__ rd, const float* __restrict__ far0,
        const int* __restrict__ wid0, int n, const int* __restrict__ cl_count,
        const float4* __restrict__ rows4, int CM, float* __restrict__ t_out,
        int* __restrict__ wid_out) {
  extern __shared__ float4 s_rows[];
  __shared__ __align__(8) unsigned long long bar[PICK_STAGES];
  __shared__ float s_t[TILE * PICK_SPLIT];
  __shared__ int s_w[TILE * PICK_SPLIT];
  const int r = threadIdx.x % TILE, part = threadIdx.x / TILE;
  const int i = blockIdx.x * TILE + r;
  const int j = min(i, n - 1);       // a lane past n: ray n - 1, no output
  const int pick = __ldg(picks + blockIdx.x);        // the same in the block
  const float far = __ldg(far0 + j);
  float best = far;
  int wid = __ldg(wid0 + j);
  if (pick >= 0) {
    const int cnt = __ldg(cl_count + pick);
    const int base = pick * CM;
    if (threadIdx.x == 0) stage_rows(rows4, base, cnt, s_rows, bar);
    __syncthreads();                                 // barriers initialised
    const Ray ray = load_ray(ro, rd, j);
    for (int s = 0; s * PICK_STAGE < cnt; ++s) {
      wait_stage(bar + s);
      const int end = min(cnt, (s + 1) * PICK_STAGE);
#pragma unroll 2
      for (int k = s * PICK_STAGE + part; k < end; k += PICK_SPLIT) {
        const float t = prim_test4(ray.o, ray.d, smem_row(s_rows, k), best);
        if (t < best) {
          best = t;
          wid = base + k;
        }
      }
    }
    s_t[threadIdx.x] = best;
    s_w[threadIdx.x] = wid;
    __syncthreads();
    if (part == 0)
      for (int q = 1; q < PICK_SPLIT; ++q) {
        // a part that improved has tq < far: on a tie in t the lower slot
        const float tq = s_t[r + q * TILE];
        const int wq = s_w[r + q * TILE];
        if (tq < best || (tq == best && tq < far && wq < wid)) {
          best = tq;
          wid = wq;
        }
      }
  }
  if (i < n && part == 0) {
    t_out[i] = best;
    wid_out[i] = wid;
  }
}

// B6e. As B6d, each thread stopping at its first hit (a warp leaves the
// row loop when all its lanes have), part 0 ORing the parts; thread 0
// then waits for every stage, so that no copy outlives the block.
__global__ void __launch_bounds__(TILE * PICK_SPLIT) cluster_pick_any_kernel(
    const int* __restrict__ picks, const float* __restrict__ ro,
    const float* __restrict__ rd, const float* __restrict__ far0, int n,
    const int* __restrict__ cl_count, const float4* __restrict__ rows4,
    int CM, bool* __restrict__ occ) {
  extern __shared__ float4 s_rows[];
  __shared__ __align__(8) unsigned long long bar[PICK_STAGES];
  __shared__ bool s_hit[TILE * PICK_SPLIT];
  const int r = threadIdx.x % TILE, part = threadIdx.x / TILE;
  const int i = blockIdx.x * TILE + r;
  const int j = min(i, n - 1);
  const int pick = __ldg(picks + blockIdx.x);
  bool hit = false;
  if (pick >= 0) {
    const int cnt = __ldg(cl_count + pick);
    if (threadIdx.x == 0) stage_rows(rows4, pick * CM, cnt, s_rows, bar);
    __syncthreads();
    const Ray ray = load_ray(ro, rd, j);
    const float far = __ldg(far0 + j);
    for (int s = 0; s * PICK_STAGE < cnt && !hit; ++s) {
      wait_stage(bar + s);
      const int end = min(cnt, (s + 1) * PICK_STAGE);
#pragma unroll 2
      for (int k = s * PICK_STAGE + part; k < end && !hit; k += PICK_SPLIT)
        hit = prim_test4(ray.o, ray.d, smem_row(s_rows, k), far) < far;
    }
    s_hit[threadIdx.x] = hit;
    __syncthreads();
    if (part == 0)
      for (int q = 1; q < PICK_SPLIT; ++q) hit |= s_hit[r + q * TILE];
    if (threadIdx.x == 0)
      for (int s = 0; s * PICK_STAGE < cnt; ++s) wait_stage(bar + s);
  }
  if (i < n && part == 0) occ[i] = hit;
}

static int blocks_for(int n, int per) { return (n + per - 1) / per; }

// Shared-memory bytes of a (C, 6) box table.
static size_t box_smem(int C) { return (size_t)C * 6 * sizeof(float); }

// Lets the kernel take `bytes` of dynamic shared memory; a table above
// SMEM_MAX is an invalid value.
template <typename Kernel>
static int allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The sweep kernels take the chunk boxes of a cluster in one warp load:
// at most 5 chunks (30 floats) a cluster.
static bool sweep_chunks_fit(int K) { return K >= 1 && 6 * K <= 32; }

extern "C" int cluster_closest_hit(
    const float* ro, const float* rd, const float* far0, int n,
    const float* cl_aabb, const float* cl_chunk, const int* cl_count,
    const float* rows, const float* rows4, int C, int K, int CM, float* t,
    int* gid, float* u, float* v, float* ng, int* obj, int* sph,
    void* stream) {
  if (!sweep_chunks_fit(K)) return (int)cudaErrorInvalidValue;
  const size_t smem = box_smem(C);
  const int err = allow_smem(cluster_closest_kernel, smem);
  if (err) return err;
  cluster_closest_kernel<<<blocks_for(n, SWEEP_BLOCK), SWEEP_BLOCK, smem,
                           (cudaStream_t)stream>>>(
      ro, rd, far0, n, cl_aabb, cl_chunk, cl_count, rows,
      (const float4*)rows4, C, K, CM, t, gid, u, v, ng, obj, sph);
  return (int)cudaGetLastError();
}

extern "C" int cluster_any_hit(const float* ro, const float* rd,
                               const float* far0, int n, const float* cl_aabb,
                               const float* cl_chunk, const int* cl_count,
                               const float* rows4, int C, int K, int CM,
                               bool* occ, void* stream) {
  if (!sweep_chunks_fit(K)) return (int)cudaErrorInvalidValue;
  const size_t smem = box_smem(C);
  const int err = allow_smem(cluster_any_kernel, smem);
  if (err) return err;
  cluster_any_kernel<<<blocks_for(n, SWEEP_BLOCK), SWEEP_BLOCK, smem,
                       (cudaStream_t)stream>>>(
      ro, rd, far0, n, cl_aabb, cl_chunk, cl_count, (const float4*)rows4, C,
      K, CM, occ);
  return (int)cudaGetLastError();
}

extern "C" int cluster_front(const float* ro, const float* rd,
                             const float* far0, int n, const float* tree,
                             int T, int C, int* cid, float* nxt,
                             void* stream) {
  if (T < 1) return (int)cudaErrorInvalidValue;
  cluster_front_kernel<<<blocks_for(n, FRONT_BLOCK), FRONT_BLOCK, 0,
                         (cudaStream_t)stream>>>(
      ro, rd, far0, n, (const float4*)tree, T, C, cid, nxt);
  return (int)cudaGetLastError();
}

// A pick block's dynamic shared memory: CM rows of 64 B, at most
// PICK_ROWS; the pack must start on a 16-byte boundary (bulk copies).
static bool pick_fits(int CM, const float* rows4) {
  return CM >= 1 && CM <= PICK_ROWS && (size_t)rows4 % 16 == 0;
}

static size_t pick_smem(int CM) { return (size_t)CM * 64; }

extern "C" int cluster_pick_closest(const int* picks, const float* ro,
                                    const float* rd, const float* far0,
                                    const int* wid0, int n,
                                    const int* cl_count, const float* rows4,
                                    int CM, float* t, int* wid, void* stream) {
  if (!pick_fits(CM, rows4)) return (int)cudaErrorInvalidValue;
  cluster_pick_closest_kernel<<<blocks_for(n, TILE), TILE * PICK_SPLIT,
                                pick_smem(CM),
                                (cudaStream_t)stream>>>(
      picks, ro, rd, far0, wid0, n, cl_count, (const float4*)rows4, CM, t,
      wid);
  return (int)cudaGetLastError();
}

extern "C" int cluster_pick_any(const int* picks, const float* ro,
                                const float* rd, const float* far0, int n,
                                const int* cl_count, const float* rows4,
                                int CM, bool* occ, void* stream) {
  if (!pick_fits(CM, rows4)) return (int)cudaErrorInvalidValue;
  cluster_pick_any_kernel<<<blocks_for(n, TILE), TILE * PICK_SPLIT,
                            pick_smem(CM),
                            (cudaStream_t)stream>>>(
      picks, ro, rd, far0, n, cl_count, (const float4*)rows4, CM, occ);
  return (int)cudaGetLastError();
}

// What the compiler and the card give a kernel (0: sweep closest hit, 1:
// sweep any hit, 2: front, 3: pick closest hit, 4: pick any hit) for a
// table of C clusters of CM slots: out[0] registers a thread, out[1] local
// memory bytes a thread (spills), out[2] blocks resident on one SM (a
// sweep's with the box table in shared memory, a pick's with its CM rows),
// out[3] the SMs, out[4] threads a block.
extern "C" int cluster_kernel_info(int which, int C, int CM, int* out) {
  cudaFuncAttributes attr;
  const void* fns[] = {(const void*)cluster_closest_kernel,
                       (const void*)cluster_any_kernel,
                       (const void*)cluster_front_kernel,
                       (const void*)cluster_pick_closest_kernel,
                       (const void*)cluster_pick_any_kernel};
  if (which < 0 || which > 4 || (which >= 3 && (CM < 1 || CM > PICK_ROWS)))
    return (int)cudaErrorInvalidValue;
  const void* fn = fns[which];
  const size_t smem = which <= 1 ? box_smem(C)
                      : which == 2 ? 0
                                   : pick_smem(CM);
  int err = which == 0   ? allow_smem(cluster_closest_kernel, smem)
            : which == 1 ? allow_smem(cluster_any_kernel, smem)
                         : 0;
  if (err) return err;
  err = (int)cudaFuncGetAttributes(&attr, fn);
  if (err) return err;
  int dev = 0;
  cudaGetDevice(&dev);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[4] = which <= 1   ? SWEEP_BLOCK
           : which == 2 ? FRONT_BLOCK
                        : TILE * PICK_SPLIT;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 2, fn,
                                                           out[4], smem);
  if (err) return err;
  return (int)cudaDeviceGetAttribute(out + 3,
                                     cudaDevAttrMultiProcessorCount, dev);
}
