// BVH closest-hit and any-hit kernels for Hopper (sm_90a): the big-scene tier.
//
// Replace the Pallas TPU kernels adapt_tpu/ops/cluster_pallas.py
// `_closest_sl_kernel` (:647, closest hit, via `cluster_closest_raw`) and
// `_any_sl_kernel` (:766, any hit, via `cluster_any_hit`). Those sweep a
// cluster cut of the BVH in 128-lane blocks with per-tile shortlists in
// SMEM, a layout made for the TPU's VMEM and static shapes. Here each
// thread walks the JAX package's own BVH tables for one ray, the walk of
// adapt_tpu/ops/bvh.py `traverse`:
//
//   nodes (M, 9) f32: lo(3) hi(3) base cnt skip, in DFS order. A node whose
//     box the ray enters before its best t so far is followed by node + 1;
//     otherwise the walk jumps to `skip`. No stack. A leaf (cnt > 0) holds
//     prims base .. base + cnt - 1 of
//   prims (P, 14) f32: n|center(3) d|radius U(3) cu V(3) cv is_sphere gid.
//
// The int fields ride the f32 rows; they are exact below 2^24, which the
// scene compiler enforces.
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
// arithmetic is ~25 operations a node and ~40 a prim. The design keeps the
// loads on the read-only path (__ldg, const __restrict__) and the walk in
// registers; rays of a warp diverge on bounces and are not sorted. Wider
// nodes, treelets in shared memory and ray sorting are later work.

#include <cuda_runtime.h>

#define NODE 9
#define PRIM 14
#define RAY_EPS 1e-4f
#define FAR 1e7f
#define BLOCK 128

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

// The ray enters the node's box before t_max (ops/bvh.py `_slab_test`).
__device__ __forceinline__ bool slab_test(const Ray& r,
                                          const float* __restrict__ nd,
                                          float t_max) {
  float t_near = 0.0f, t_far = 0.0f;
  for (int a = 0; a < 3; ++a) {
    const float t1 = __fmul_rn(__fsub_rn(__ldg(nd + a), r.o[a]), r.inv[a]);
    const float t2 =
        __fmul_rn(__fsub_rn(__ldg(nd + 3 + a), r.o[a]), r.inv[a]);
    const float lo = min_nan(t1, t2), hi = max_nan(t1, t2);
    t_near = a == 0 ? lo : max_nan(t_near, lo);
    t_far = a == 0 ? hi : min_nan(t_far, hi);
  }
  return (t_far >= max_nan(t_near, 0.0f)) && (t_near < t_max);
}

// One prim row (ops/bvh.py `_leaf_prim_test`): t, or FAR on a miss; u, v
// by the triangle formula, on sphere rows too.
__device__ __forceinline__ float prim_test(const Ray& r,
                                           const float* __restrict__ row,
                                           float* u_out, float* v_out) {
  float a[3], U[3], V[3];
  for (int k = 0; k < 3; ++k) {
    a[k] = __ldg(row + k);
    U[k] = __ldg(row + 4 + k);
    V[k] = __ldg(row + 8 + k);
  }
  const float b = __ldg(row + 3);
  const bool is_sph = __ldg(row + 12) > 0.5f;
  // triangle: plane + dual basis
  const float o_n = dot3(r.o, a);
  const float d_n = dot3(r.d, a);
  const bool flat = fabsf(d_n) < 1e-12f;
  const float t_tri = __fdiv_rn(__fsub_rn(b, o_n), flat ? 1e-12f : d_n);
  float hp[3];
  for (int k = 0; k < 3; ++k)
    hp[k] = __fadd_rn(r.o[k], __fmul_rn(t_tri, r.d[k]));
  const float u = __fsub_rn(dot3(hp, U), __ldg(row + 7));
  const float v = __fsub_rn(dot3(hp, V), __ldg(row + 11));
  *u_out = u;
  *v_out = v;
  if (!is_sph) {
    const bool ok = (u >= 0.0f) && (v >= 0.0f) && (__fadd_rn(u, v) <= 1.0f) &&
                    (t_tri > RAY_EPS) && !flat;
    return ok ? t_tri : FAR;
  }
  // sphere: quadratic (center in a, radius in b)
  float s2c[3];
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

__global__ void __launch_bounds__(BLOCK)
    bvh_closest_kernel(const float* __restrict__ ro,
                       const float* __restrict__ rd,
                       const float* __restrict__ far0, int n,
                       const float* __restrict__ nodes, int M,
                       const float* __restrict__ prims,
                       float* __restrict__ t_out, int* __restrict__ prim_out,
                       float* __restrict__ u_out, float* __restrict__ v_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(ro, rd, i);
  float best_t = __ldg(far0 + i), best_u = 0.0f, best_v = 0.0f;
  int best_prim = -1;
  int cursor = best_t > RAY_EPS ? 0 : M;
  while (cursor < M) {
    const float* nd = nodes + (size_t)cursor * NODE;
    if (!slab_test(r, nd, best_t)) {
      cursor = (int)__ldg(nd + 8);
      continue;
    }
    const int cnt = (int)__ldg(nd + 7);
    if (cnt > 0) {
      const int base = (int)__ldg(nd + 6);
      for (int k = 0; k < cnt; ++k) {
        const float* row = prims + (size_t)(base + k) * PRIM;
        float u, v;
        const float t = prim_test(r, row, &u, &v);
        if (t < best_t) {
          best_t = t;
          best_u = u;
          best_v = v;
          best_prim = (int)__ldg(row + 13);
        }
      }
    }
    ++cursor;
  }
  t_out[i] = best_t;
  prim_out[i] = best_prim;
  u_out[i] = best_u;
  v_out[i] = best_v;
}

__global__ void __launch_bounds__(BLOCK)
    bvh_any_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                   const float* __restrict__ far0, int n,
                   const float* __restrict__ nodes, int M,
                   const float* __restrict__ prims, bool* __restrict__ occ) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(ro, rd, i);
  const float far = __ldg(far0 + i);
  bool hit = false;
  int cursor = far > RAY_EPS ? 0 : M;
  while (cursor < M && !hit) {
    const float* nd = nodes + (size_t)cursor * NODE;
    if (!slab_test(r, nd, far)) {
      cursor = (int)__ldg(nd + 8);
      continue;
    }
    const int cnt = (int)__ldg(nd + 7);
    const int base = (int)__ldg(nd + 6);
    for (int k = 0; k < cnt && !hit; ++k) {
      float u, v;
      hit = prim_test(r, prims + (size_t)(base + k) * PRIM, &u, &v) < far;
    }
    ++cursor;
  }
  occ[i] = hit;
}

static int blocks_for(int n) { return (n + BLOCK - 1) / BLOCK; }

extern "C" int bvh_closest_hit(const float* ro, const float* rd,
                               const float* far0, int n, const float* nodes,
                               int M, const float* prims, float* t, int* prim,
                               float* u, float* v, void* stream) {
  bvh_closest_kernel<<<blocks_for(n), BLOCK, 0, (cudaStream_t)stream>>>(
      ro, rd, far0, n, nodes, M, prims, t, prim, u, v);
  return (int)cudaGetLastError();
}

extern "C" int bvh_any_hit(const float* ro, const float* rd,
                           const float* far0, int n, const float* nodes, int M,
                           const float* prims, bool* occ, void* stream) {
  bvh_any_kernel<<<blocks_for(n), BLOCK, 0, (cudaStream_t)stream>>>(
      ro, rd, far0, n, nodes, M, prims, occ);
  return (int)cudaGetLastError();
}
