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
// * sweep (closest, any): one thread per ray visits the clusters in index
//   order. A cluster is entered when the slab test of its box passes
//   against the lane's current best t (any hit: its far bound); inside,
//   each 128-prim chunk is gated by its own box the same way, then its live
//   rows are tested in slot order with strict <. Clusters are DFS ranges, so
//   index order with strict < keeps the first prim in DFS order on a tie:
//   the tie rule of the BVH walk (bvh_intersect.cu). The closest-hit kernel
//   finishes the winner in the kernel (gid, u, v, n_g, obj, sphere flag; a
//   sphere's normal from its hit point); the any-hit lane stops at its
//   first hit.
// * front: one thread per ray over the inflated boxes keeps, in registers,
//   the entered cluster with the least entry distance max(t_near, 0) (ties
//   to the lowest id, C when none) and the second least entry distance
//   (3e38 when fewer than two).
// * pick (closest, any): one block per tile of TILE = 128 consecutive rays
//   reads its own pick (cluster id, -1: nothing to do) and every thread
//   tests its ray against that cluster's live rows in slot order: closest
//   starts from t = far, wid = wid0 and keeps strict improvements, wid =
//   cluster * CM + slot; any ORs t < far.
//
// Exactness: the prim test has the operation order of the TPU kernels'
// `_prim_chunk_test`: every dot is (x0*y0 + x1*y1) + x2*y2 and
// u = (o.U + t*(d.U)) - cu (the BVH kernels compute (o + t*d).U - cu), every
// operation rounded once (explicit __f*_rn; the library is built with
// -fmad=false), min/max propagating NaN as torch's do. The plain PyTorch
// versions (ops/cluster_kernels.py) repeat these steps, so kernel and plain
// agree bit for bit.
//
// Bound: the rows of a 290k-prim scene are 29.7 MB (20.9 MB of them live) and
// its boxes under 0.2 MB, all inside the H100's 50 MB L2, so no kernel here
// is bound by HBM bytes. The sweeps and the front pass are bound by the
// operations they execute: every ray pays C box tests (each warp reads one
// box at a time from shared memory, a broadcast; six scalar loads and some
// thirty operations a box), and in the sweeps a warp whose lanes enter
// different clusters runs their row loops one after another (divergence),
// each lane streaming its own 72-byte rows through L1. The box tables go to
// shared memory (38.7 KB at C = 1,613; a table above SMEM_MAX bytes is
// refused); the prim test leaves a row as soon as its t
// cannot win, before the four u/v dots. The pick kernels read one row per
// block at a time (a broadcast) straight from L2, one dependent round trip a
// row, so the latency of those loads bounds them, not their operation count.
// Packing a box into two 16-byte loads, visiting clusters front to back,
// sorting rays by cluster for the sweeps, staging a block's rows in shared
// memory and testing several rows per lane are later work.

#include <cuda_runtime.h>

#define ROW 18
#define RAY_EPS 1e-4f
#define FAR 1e7f
#define BIG 3e38f
#define BLOCK 128
#define TILE 128
#define CHUNK 128
// largest box table (a block may use 227 KB of shared memory); keep equal
// to ops/cluster_kernels.py BOX_TABLE_MAX
#define SMEM_MAX (200 * 1024)

// torch.minimum / torch.maximum: NaN in, NaN out
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || isnan(a)) ? a : b;
}
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

// Entry and exit distances of the ray through a box of 6 floats (shared or
// global memory).
__device__ __forceinline__ void slab(const Ray& r, const float* box,
                                     float* t_near, float* t_far) {
  float tn = 0.0f, tf = 0.0f;
  for (int a = 0; a < 3; ++a) {
    const float t1 = __fmul_rn(__fsub_rn(box[a], r.o[a]), r.inv[a]);
    const float t2 = __fmul_rn(__fsub_rn(box[3 + a], r.o[a]), r.inv[a]);
    const float lo = min_nan(t1, t2), hi = max_nan(t1, t2);
    tn = a == 0 ? lo : max_nan(tn, lo);
    tf = a == 0 ? hi : min_nan(tf, hi);
  }
  *t_near = tn;
  *t_far = tf;
}

// The ray enters the box before t_max (cluster_pallas.py `_slab_lanes`).
__device__ __forceinline__ bool enters(const Ray& r, const float* box,
                                       float t_max) {
  float tn, tf;
  slab(r, box, &tn, &tf);
  return (tf >= max_nan(tn, 0.0f)) && (tn < t_max);
}

// One prim row (cluster_pallas.py `_prim_chunk_test`): its hit distance, or
// FAR on a miss. A row whose t cannot lie in (RAY_EPS, t_max) leaves early:
// the caller accepts only t < t_max, so the result is the same.
__device__ __forceinline__ float prim_test(const Ray& r,
                                           const float* __restrict__ row,
                                           float t_max) {
  if (__ldg(row + 13) < 0.0f) return FAR;        // padding slot
  float a[3];
  for (int k = 0; k < 3; ++k) a[k] = __ldg(row + k);
  const float b = __ldg(row + 3);
  if (__ldg(row + 12) > 0.5f) {
    // sphere: quadratic (center in a, radius in b)
    float c[3];
    for (int k = 0; k < 3; ++k) c[k] = __fsub_rn(a[k], r.o[k]);
    const float cn2 = dot3(c, c);
    const float proj = dot3(c, r.d);
    const float c2r = __fsub_rn(cn2, __fmul_rn(proj, proj));
    const float r2 = __fmul_rn(b, b);
    const float cut = __fsqrt_rn(max_nan(__fsub_rn(r2, c2r), 0.0f));
    const bool outside = cn2 > __fadd_rn(r2, 1e-4f);
    const float t_sph = __fadd_rn(proj, outside ? -cut : cut);
    return ((c2r < r2) && (t_sph > RAY_EPS)) ? t_sph : FAR;
  }
  // triangle: plane, then the dual basis
  const float o_n = dot3(r.o, a);
  const float d_n = dot3(r.d, a);
  const bool flat = fabsf(d_n) < 1e-12f;
  const float t = __fdiv_rn(__fsub_rn(b, o_n), flat ? 1e-12f : d_n);
  if (flat || !(t > RAY_EPS) || !(t < t_max)) return FAR;
  float U[3], V[3];
  for (int k = 0; k < 3; ++k) {
    U[k] = __ldg(row + 4 + k);
    V[k] = __ldg(row + 8 + k);
  }
  const float u = __fsub_rn(
      __fadd_rn(dot3(r.o, U), __fmul_rn(t, dot3(r.d, U))), __ldg(row + 7));
  const float v = __fsub_rn(
      __fadd_rn(dot3(r.o, V), __fmul_rn(t, dot3(r.d, V))), __ldg(row + 11));
  const bool ok = (u >= 0.0f) && (v >= 0.0f) && (__fadd_rn(u, v) <= 1.0f);
  return ok ? t : FAR;
}

// The block's copy of a (C, 6) box table in shared memory.
__device__ __forceinline__ void stage_boxes(const float* __restrict__ table,
                                            int C, float* s_box) {
  for (int k = threadIdx.x; k < C * 6; k += blockDim.x)
    s_box[k] = __ldg(table + k);
  __syncthreads();
}

__global__ void __launch_bounds__(BLOCK) cluster_closest_kernel(
    const float* __restrict__ ro, const float* __restrict__ rd,
    const float* __restrict__ far0, int n, const float* __restrict__ cl_aabb,
    const float* __restrict__ cl_chunk, const int* __restrict__ cl_count,
    const float* __restrict__ rows, int C, int K, int CM,
    float* __restrict__ t_out, int* __restrict__ gid_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    float* __restrict__ ng_out, int* __restrict__ obj_out,
    int* __restrict__ sph_out) {
  extern __shared__ float box[];
  stage_boxes(cl_aabb, C, box);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(ro, rd, i);
  float best = __ldg(far0 + i);
  int wid = -1;
  // a far bound that admits no hit (dead lanes carry -3e38): no sweep
  const int n_cl = best > RAY_EPS ? C : 0;
  for (int c = 0; c < n_cl; ++c) {
    if (!enters(r, box + 6 * c, best)) continue;
    const int cnt = __ldg(cl_count + c);
    for (int q = 0; q * CHUNK < cnt; ++q) {
      if (!enters(r, cl_chunk + ((size_t)c * K + q) * 6, best)) continue;
      const int base = c * CM + q * CHUNK;
      const int m = min(cnt - q * CHUNK, CHUNK);
      for (int k = 0; k < m; ++k) {
        const float t = prim_test(r, rows + (size_t)(base + k) * ROW, best);
        if (t < best) {
          best = t;
          wid = base + k;
        }
      }
    }
  }
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

__global__ void __launch_bounds__(BLOCK) cluster_any_kernel(
    const float* __restrict__ ro, const float* __restrict__ rd,
    const float* __restrict__ far0, int n, const float* __restrict__ cl_aabb,
    const float* __restrict__ cl_chunk, const int* __restrict__ cl_count,
    const float* __restrict__ rows, int C, int K, int CM,
    bool* __restrict__ occ) {
  extern __shared__ float box[];
  stage_boxes(cl_aabb, C, box);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(ro, rd, i);
  const float far = __ldg(far0 + i);
  bool hit = false;
  const int n_cl = far > RAY_EPS ? C : 0;
  for (int c = 0; c < n_cl && !hit; ++c) {
    if (!enters(r, box + 6 * c, far)) continue;
    const int cnt = __ldg(cl_count + c);
    for (int q = 0; q * CHUNK < cnt && !hit; ++q) {
      if (!enters(r, cl_chunk + ((size_t)c * K + q) * 6, far)) continue;
      const int base = c * CM + q * CHUNK;
      const int m = min(cnt - q * CHUNK, CHUNK);
      for (int k = 0; k < m && !hit; ++k)
        hit = prim_test(r, rows + (size_t)(base + k) * ROW, far) < far;
    }
  }
  occ[i] = hit;
}

__global__ void __launch_bounds__(BLOCK) cluster_front_kernel(
    const float* __restrict__ ro, const float* __restrict__ rd,
    const float* __restrict__ far0, int n, const float* __restrict__ cl_front,
    int C, int* __restrict__ cid_out, float* __restrict__ nxt_out) {
  extern __shared__ float box[];
  stage_boxes(cl_front, C, box);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(ro, rd, i);
  const float far = __ldg(far0 + i);
  float first = BIG, second = BIG;
  int cid = C;
  for (int c = 0; c < C; ++c) {
    float tn, tf;
    slab(r, box + 6 * c, &tn, &tf);
    tn = max_nan(-BIG, tn);
    tf = min_nan(BIG, tf);
    const float ent = max_nan(tn, 0.0f);
    const float keyed = ((tf >= ent) && (tn < far)) ? ent : BIG;
    if (keyed < first) {
      second = first;
      first = keyed;
      cid = c;
    } else if (keyed < second) {
      second = keyed;
    }
  }
  cid_out[i] = cid;
  nxt_out[i] = second;
}

__global__ void __launch_bounds__(TILE) cluster_pick_closest_kernel(
    const int* __restrict__ picks, const float* __restrict__ ro,
    const float* __restrict__ rd, const float* __restrict__ far0,
    const int* __restrict__ wid0, int n, const int* __restrict__ cl_count,
    const float* __restrict__ rows, int CM, float* __restrict__ t_out,
    int* __restrict__ wid_out) {
  const int i = blockIdx.x * TILE + threadIdx.x;
  if (i >= n) return;
  const int pick = __ldg(picks + blockIdx.x);
  float best = __ldg(far0 + i);
  int wid = __ldg(wid0 + i);
  if (pick >= 0) {
    const Ray r = load_ray(ro, rd, i);
    const int cnt = __ldg(cl_count + pick);
    const int base = pick * CM;
    for (int k = 0; k < cnt; ++k) {
      const float t = prim_test(r, rows + (size_t)(base + k) * ROW, best);
      if (t < best) {
        best = t;
        wid = base + k;
      }
    }
  }
  t_out[i] = best;
  wid_out[i] = wid;
}

__global__ void __launch_bounds__(TILE) cluster_pick_any_kernel(
    const int* __restrict__ picks, const float* __restrict__ ro,
    const float* __restrict__ rd, const float* __restrict__ far0, int n,
    const int* __restrict__ cl_count, const float* __restrict__ rows, int CM,
    bool* __restrict__ occ) {
  const int i = blockIdx.x * TILE + threadIdx.x;
  if (i >= n) return;
  const int pick = __ldg(picks + blockIdx.x);
  bool hit = false;
  if (pick >= 0) {
    const Ray r = load_ray(ro, rd, i);
    const float far = __ldg(far0 + i);
    const int cnt = __ldg(cl_count + pick);
    const int base = pick * CM;
    for (int k = 0; k < cnt && !hit; ++k)
      hit = prim_test(r, rows + (size_t)(base + k) * ROW, far) < far;
  }
  occ[i] = hit;
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

extern "C" int cluster_closest_hit(
    const float* ro, const float* rd, const float* far0, int n,
    const float* cl_aabb, const float* cl_chunk, const int* cl_count,
    const float* rows, int C, int K, int CM, float* t, int* gid, float* u,
    float* v, float* ng, int* obj, int* sph, void* stream) {
  const size_t smem = box_smem(C);
  const int err = allow_smem(cluster_closest_kernel, smem);
  if (err) return err;
  cluster_closest_kernel<<<blocks_for(n, BLOCK), BLOCK, smem,
                           (cudaStream_t)stream>>>(
      ro, rd, far0, n, cl_aabb, cl_chunk, cl_count, rows, C, K, CM, t, gid, u,
      v, ng, obj, sph);
  return (int)cudaGetLastError();
}

extern "C" int cluster_any_hit(const float* ro, const float* rd,
                               const float* far0, int n, const float* cl_aabb,
                               const float* cl_chunk, const int* cl_count,
                               const float* rows, int C, int K, int CM,
                               bool* occ, void* stream) {
  const size_t smem = box_smem(C);
  const int err = allow_smem(cluster_any_kernel, smem);
  if (err) return err;
  cluster_any_kernel<<<blocks_for(n, BLOCK), BLOCK, smem,
                       (cudaStream_t)stream>>>(
      ro, rd, far0, n, cl_aabb, cl_chunk, cl_count, rows, C, K, CM, occ);
  return (int)cudaGetLastError();
}

extern "C" int cluster_front(const float* ro, const float* rd,
                             const float* far0, int n, const float* cl_front,
                             int C, int* cid, float* nxt, void* stream) {
  const size_t smem = box_smem(C);
  const int err = allow_smem(cluster_front_kernel, smem);
  if (err) return err;
  cluster_front_kernel<<<blocks_for(n, BLOCK), BLOCK, smem,
                         (cudaStream_t)stream>>>(ro, rd, far0, n, cl_front, C,
                                                 cid, nxt);
  return (int)cudaGetLastError();
}

extern "C" int cluster_pick_closest(const int* picks, const float* ro,
                                    const float* rd, const float* far0,
                                    const int* wid0, int n,
                                    const int* cl_count, const float* rows,
                                    int CM, float* t, int* wid, void* stream) {
  cluster_pick_closest_kernel<<<blocks_for(n, TILE), TILE, 0,
                                (cudaStream_t)stream>>>(
      picks, ro, rd, far0, wid0, n, cl_count, rows, CM, t, wid);
  return (int)cudaGetLastError();
}

extern "C" int cluster_pick_any(const int* picks, const float* ro,
                                const float* rd, const float* far0, int n,
                                const int* cl_count, const float* rows, int CM,
                                bool* occ, void* stream) {
  cluster_pick_any_kernel<<<blocks_for(n, TILE), TILE, 0,
                            (cudaStream_t)stream>>>(picks, ro, rd, far0, n,
                                                    cl_count, rows, CM, occ);
  return (int)cudaGetLastError();
}
