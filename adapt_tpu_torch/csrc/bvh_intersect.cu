// BVH closest-hit and any-hit kernels for Hopper (sm_90a): the big-scene tier.
//
// Replace the Pallas TPU kernels adapt_tpu/ops/cluster_pallas.py
// `_closest_sl_kernel` (:647, closest hit, via `cluster_closest_raw`) and
// `_any_sl_kernel` (:766, any hit, via `cluster_any_hit`). Those sweep a
// cluster cut of the BVH in 128-lane blocks with per-tile shortlists in
// SMEM, a layout made for the TPU's VMEM and static shapes. Here each
// thread walks the JAX package's own BVH for one ray, the walk of
// adapt_tpu/ops/bvh.py `traverse`: nodes in DFS order; a node whose box the
// ray enters before its best t so far is followed by node + 1, otherwise
// the walk jumps to `skip`. No stack. A leaf (cnt > 0) holds prims
// base .. base + cnt - 1.
//
// Exactness: the kernels hold hit for hit to their plain PyTorch twin
// (ops/bvh.py `walk`). Same visit order, strict < so the first prim wins a
// tie, and the same operation order: each dot is (x0*y0 + x1*y1) + x2*y2,
// u = (o + t*d).U - cu, every operation rounded once (explicit __f*_rn and
// the library is built with -fmad=false). min/max propagate NaN as torch's
// do. A lane whose far bound admits no hit (far0 <= RAY_EPS; dead lanes
// carry -3e38) does not walk.
//
// Bound: the tables of a 290k-prim scene (16.2 MB of prims, ~6 MB of nodes)
// fit in the H100's 50 MB L2, so the walk is bound by the latency of its
// dependent loads (node -> box test -> next node), not by HBM bytes; the
// arithmetic is ~25 operations a node and ~40 a prim.
//
// The closest-hit kernel (B5a) is designed around that latency:
//   * aligned vector rows (scene/compile.py `v4_packs`): a node is 32 B,
//     two float4 loads in one sector (lo.xyz | base + cnt << 24 as int
//     bits, hi.xyz | skip), a prim 64 B, four float4 loads (n|center d|r,
//     U cu, V cv, is_sphere gid pad pad), in place of 9 and 14 scalar loads
//     from rows that straddle sectors;
//   * more loads in flight on a walk's chain: node cursor + 1, the next in
//     DFS order, is loaded beside node cursor (a walk that enters box after
//     box finds it on its way), and a leaf's next prim row beside the test
//     of the current one; the box test's min/max are one instruction each;
//   * persistent warps: the grid is what the SMs hold at once (one wave),
//     and a warp whose lanes are all done takes the next 32 rays with one
//     atomicAdd on a counter the wrapper zeroes, so no second wave runs
//     part-empty behind the first one's slowest rays (taking rays lane by
//     lane, as soon as each lane is done, measured no faster: the longest
//     walks set the time);
//   * while-while (Aila and Laine, HPG 2009): a lane descends inner nodes
//     until it enters a leaf, then the warp tests its lanes' leaves
//     together, instead of lanes at inner nodes and lanes in a prim loop
//     taking turns.
// None of it changes a lane's visit order or its arithmetic. On incoherent
// bounce rays the kernel's time is that of its few longest walks (hundreds
// of dependent node and prim loads each), not of the average one: wider
// nodes and treelets, which shorten those chains, are later work.
//
// The any-hit kernel (B5b) takes B5a's float4 rows, the next node and
// prim row loaded beside the current ones and the one-instruction box
// min/max, but stays one thread a ray in 128-thread blocks: its result,
// the OR over the leaves the ray enters at its fixed far0 of "a prim's t <
// far0", lets a lane stop at its first hit, and a dead lane (far0 <=
// RAY_EPS: compacted-away lanes, lanes the queue-pick cleanup does not
// take) costs one load and leaves. Persistent warps that refill idle lanes
// from a ray counter, lane by lane or once all 32 are idle, with a
// batch's dead rays skipped by ballot and the while-while walk, measured
// slower on shadow rays and on the queue-pick cleanup's sparse set
// (PERF.md): a warp of 32 consecutive rays walks the same nodes, and one
// refilled ray by ray walks 32 paths.

#include <cuda_runtime.h>

#define RAY_EPS 1e-4f
#define FAR 1e7f
#define BLOCK 128
#define FULL 0xffffffffu

// torch.maximum: NaN in, NaN out
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

// torch.minimum / torch.maximum in one instruction each (min.NaN /
// max.NaN, sm_80 and later), for values that only feed comparisons: which
// NaN or which zero comes out changes no comparison, so the walk takes the
// same branches.
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

// A node row of the vector pack: lo.xyz | base + cnt << 24 (int bits),
// hi.xyz | skip (int bits). A prim row: n|center d|radius, U cu, V cv,
// is_sphere gid pad pad.
struct NodeRow {
  float4 lo, hi;
};
struct PrimRow {
  float4 q[4];
};

__device__ __forceinline__ NodeRow load_node(const float4* __restrict__ nodes,
                                             int c) {
  return {__ldg(nodes + 2 * (size_t)c), __ldg(nodes + 2 * (size_t)c + 1)};
}
__device__ __forceinline__ PrimRow load_prim(const float4* __restrict__ prims,
                                             int k) {
  const float4* row = prims + 4 * (size_t)k;
  return {{__ldg(row), __ldg(row + 1), __ldg(row + 2), __ldg(row + 3)}};
}

// The ray enters the node's box before t_max (ops/bvh.py `_slab_test`).
__device__ __forceinline__ bool slab_test4(const Ray& r, const NodeRow& nd,
                                           float t_max) {
  const float lo[3] = {nd.lo.x, nd.lo.y, nd.lo.z};
  const float hi[3] = {nd.hi.x, nd.hi.y, nd.hi.z};
  float t_near = 0.0f, t_far = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float t1 = __fmul_rn(__fsub_rn(lo[k], r.o[k]), r.inv[k]);
    const float t2 = __fmul_rn(__fsub_rn(hi[k], r.o[k]), r.inv[k]);
    const float l = min_nan1(t1, t2), h = max_nan1(t1, t2);
    t_near = k == 0 ? l : max_nan1(t_near, l);
    t_far = k == 0 ? h : min_nan1(t_far, h);
  }
  return (t_far >= max_nan1(t_near, 0.0f)) && (t_near < t_max);
}

// One prim row (ops/bvh.py `_leaf_prim_test`): t, or FAR on a miss; u, v
// by the triangle formula, on sphere rows too.
__device__ __forceinline__ float prim_test4(const Ray& r, const PrimRow& row,
                                            float* u_out, float* v_out) {
  const float4 p0 = row.q[0], p1 = row.q[1], p2 = row.q[2];
  const float a[3] = {p0.x, p0.y, p0.z}, U[3] = {p1.x, p1.y, p1.z},
              V[3] = {p2.x, p2.y, p2.z};
  const float b = p0.w;
  const bool is_sph = row.q[3].x > 0.5f;
  const float o_n = dot3(r.o, a);
  const float d_n = dot3(r.d, a);
  const bool flat = fabsf(d_n) < 1e-12f;
  const float t_tri = __fdiv_rn(__fsub_rn(b, o_n), flat ? 1e-12f : d_n);
  float hp[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    hp[k] = __fadd_rn(r.o[k], __fmul_rn(t_tri, r.d[k]));
  const float u = __fsub_rn(dot3(hp, U), p1.w);
  const float v = __fsub_rn(dot3(hp, V), p2.w);
  *u_out = u;
  *v_out = v;
  if (!is_sph) {
    const bool ok = (u >= 0.0f) && (v >= 0.0f) && (__fadd_rn(u, v) <= 1.0f) &&
                    (t_tri > RAY_EPS) && !flat;
    return ok ? t_tri : FAR;
  }
  float s2c[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) s2c[k] = __fsub_rn(a[k], r.o[k]);
  const float cn2 = dot3(s2c, s2c);
  const float proj = dot3(r.d, s2c);
  const float c2r = __fsub_rn(cn2, __fmul_rn(proj, proj));
  const float r2 = __fmul_rn(b, b);
  const float cut = __fsqrt_rn(max_nan(__fsub_rn(r2, c2r), 0.0f));
  const bool outside = cn2 > __fadd_rn(r2, 1e-4f);
  const float t_sph = __fadd_rn(proj, outside ? -cut : cut);
  return ((c2r < r2) && (t_sph > RAY_EPS)) ? t_sph : FAR;
}

// B5a. Launched with at most as many blocks as the SMs hold at once; every
// lane loops: (1) a lane whose walk is over writes its ray, and once every
// lane of the warp is idle, the warp takes the next 32 rays with one
// atomicAdd on *next_ray; (2) each walking lane descends from its cursor
// until it enters a leaf or its walk ends; (3) the warp tests the leaves'
// prims together.
__global__ void __launch_bounds__(BLOCK)
    bvh_closest_kernel(const float* __restrict__ ro,
                       const float* __restrict__ rd,
                       const float* __restrict__ far0, int n,
                       const float4* __restrict__ nodes, int M,
                       const float4* __restrict__ prims,
                       float* __restrict__ t_out, int* __restrict__ prim_out,
                       float* __restrict__ u_out, float* __restrict__ v_out,
                       int* __restrict__ next_ray) {
  const int lane = threadIdx.x & 31;
  Ray r;
  float best_t = 0.0f, best_u = 0.0f, best_v = 0.0f;
  int best_prim = -1;
  int ray = -1;    // the lane's ray, -1 between rays
  int cursor = M;  // >= M: no walk in progress
  for (;;) {
    // (1) finish, and refill an idle warp
    if (ray >= 0 && cursor >= M) {
      t_out[ray] = best_t;
      prim_out[ray] = best_prim;
      u_out[ray] = best_u;
      v_out[ray] = best_v;
      ray = -1;
    }
    if (!__any_sync(FULL, ray >= 0)) {
      int first = 0;
      if (lane == 0) first = atomicAdd(next_ray, 32);
      first = __shfl_sync(FULL, first, 0);
      if (first >= n) break;
      if (first + lane < n) {
        ray = first + lane;
        r = load_ray(ro, rd, ray);
        best_t = __ldg(far0 + ray);
        best_u = best_v = 0.0f;
        best_prim = -1;
        cursor = best_t > RAY_EPS ? 0 : M;
      }
    }
    // (2) descend to the next leaf the ray enters. Node cursor + 1, the
    // next in DFS order, is loaded beside node cursor: a walk that enters
    // box after box finds it on its way.
    int base = 0, cnt = 0;
    if (cursor < M) {
      NodeRow node = load_node(nodes, cursor);
      for (;;) {
        const NodeRow next = load_node(nodes, min(cursor + 1, M - 1));
        if (!slab_test4(r, node, best_t)) {
          cursor = __float_as_int(node.hi.w);
          if (cursor >= M) break;
          node = load_node(nodes, cursor);
          continue;
        }
        ++cursor;
        const int w = __float_as_int(node.lo.w);
        if (w >> 24) {
          base = w & 0xffffff;
          cnt = w >> 24;
          break;
        }
        if (cursor >= M) break;
        node = next;
      }
    }
    // (3) the warp's leaves, together; prim k + 1's row is loaded beside
    // prim k's test
    __syncwarp();
    PrimRow row;
    if (cnt > 0) row = load_prim(prims, base);
    for (int k = 0; k < cnt; ++k) {
      const PrimRow next = k + 1 < cnt ? load_prim(prims, base + k + 1) : row;
      float u, v;
      const float t = prim_test4(r, row, &u, &v);
      if (t < best_t) {
        best_t = t;
        best_u = u;
        best_v = v;
        best_prim = (int)row.q[3].y;
      }
      row = next;
    }
  }
}

// B5b. A lane walks from the root, node cursor + 1 loaded beside node
// cursor, and tests a leaf's prims with the next prim row loaded beside
// the current one, until a hit or the end of the tree.
__global__ void __launch_bounds__(BLOCK)
    bvh_any_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                   const float* __restrict__ far0, int n,
                   const float4* __restrict__ nodes, int M,
                   const float4* __restrict__ prims, bool* __restrict__ occ) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float far = __ldg(far0 + i);
  bool hit = false;
  if (far > RAY_EPS) {
    const Ray r = load_ray(ro, rd, i);
    int cursor = 0;
    NodeRow node = load_node(nodes, 0);
    while (!hit) {
      const NodeRow next = load_node(nodes, min(cursor + 1, M - 1));
      if (!slab_test4(r, node, far)) {
        cursor = __float_as_int(node.hi.w);
        if (cursor >= M) break;
        node = load_node(nodes, cursor);
        continue;
      }
      ++cursor;
      const int w = __float_as_int(node.lo.w);
      const int cnt = w >> 24, base = w & 0xffffff;
      PrimRow row;
      if (cnt > 0) row = load_prim(prims, base);
      for (int k = 0; k < cnt; ++k) {
        const PrimRow nx = k + 1 < cnt ? load_prim(prims, base + k + 1) : row;
        float u, v;
        if (prim_test4(r, row, &u, &v) < far) {
          hit = true;
          break;
        }
        row = nx;
      }
      if (cursor >= M) break;
      node = next;
    }
  }
  occ[i] = hit;
}

static int blocks_for(int n) { return (n + BLOCK - 1) / BLOCK; }

// Blocks of B5a that the card's SMs hold at once (queried once).
static int resident_closest_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bvh_closest_kernel,
                                                  BLOCK, 0);
    blocks = sms * per_sm;
  }
  return blocks;
}

extern "C" int bvh_closest_hit(const float* ro, const float* rd,
                               const float* far0, int n, const float* nodes,
                               int M, const float* prims, float* t, int* prim,
                               float* u, float* v, int* next_ray,
                               void* stream) {
  const int grid = min(blocks_for(n), resident_closest_blocks());
  if (grid <= 0) return (int)cudaErrorInvalidConfiguration;
  bvh_closest_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      ro, rd, far0, n, (const float4*)nodes, M, (const float4*)prims, t, prim,
      u, v, next_ray);
  return (int)cudaGetLastError();
}

extern "C" int bvh_any_hit(const float* ro, const float* rd,
                           const float* far0, int n, const float* nodes, int M,
                           const float* prims, bool* occ, void* stream) {
  bvh_any_kernel<<<blocks_for(n), BLOCK, 0, (cudaStream_t)stream>>>(
      ro, rd, far0, n, (const float4*)nodes, M, (const float4*)prims, occ);
  return (int)cudaGetLastError();
}

// What the compiler and the card give a kernel (0: B5a, 1: B5b): out[0]
// registers a thread, out[1] local memory bytes a thread (spills), out[2]
// blocks of BLOCK threads resident on one SM, out[3] the SMs, out[4] BLOCK.
extern "C" int bvh_kernel_info(int which, int* out) {
  cudaFuncAttributes attr;
  const void* fn = which == 0 ? (const void*)bvh_closest_kernel
                              : (const void*)bvh_any_kernel;
  int err = (int)cudaFuncGetAttributes(&attr, fn);
  if (err) return err;
  int dev = 0;
  cudaGetDevice(&dev);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 2, fn, BLOCK,
                                                           0);
  if (err) return err;
  err = (int)cudaDeviceGetAttribute(out + 3, cudaDevAttrMultiProcessorCount,
                                    dev);
  out[4] = BLOCK;
  return err;
}
