"""BVH walk over the skip-offset flat layout: the plain PyTorch twin of
the BVH kernels (port of adapt_tpu/ops/bvh.py `traverse`).

The native builder (native/) emits nodes in DFS order; each node stores
`skip`, the node to visit when its box test fails, and descending on a hit
is `cursor + 1`. A per-lane cursor walks the tree with no stack. This is a
lane-synchronous loop: each step reads one node row per lane still
walking, tests its box against the lane's best t so far, and on a leaf
tests up to LEAF_MAX prim rows in order, keeping a hit only when strictly
closer (the first prim wins a tie). It is the semantics of both
csrc/bvh_intersect.cu kernels, with the same operation order: every dot
product is (x0*y0 + x1*y1) + x2*y2 and every operation rounds once.

Lanes whose far bound admits no hit (far0 <= RAY_EPS: dead lanes carry
far0 = -3e38) never walk and come back with t = far0, prim = -1. Only a
valid prim slot can win; the JAX walk also lets an empty slot (t = FAR)
win when far0 > FAR, which no scene-scale max_t reaches.
"""
from __future__ import annotations

import torch

from .intersect_kernels import FAR, RAY_EPS, far_bound

LEAF_MAX = 4          # must match native kLeafMax
# operations of one box test and one prim test as the walk writes them
# (adds, multiplies, divides, min/max, compares), for the kernels' bound
NODE_OPS = 25
PRIM_OPS = 40


def _d3(x, y):
    return (x[:, 0] * y[:, 0] + x[:, 1] * y[:, 1]) + x[:, 2] * y[:, 2]


def _slab_test(ray_o, inv_d, lo, hi, t_max):
    """Ray/box slab test: the box is entered before t_max (reference
    ti_bvh.py:30-53 semantics, adapt_tpu/ops/bvh.py:28-35)."""
    t1 = (lo - ray_o) * inv_d
    t2 = (hi - ray_o) * inv_d
    t_near = torch.minimum(t1, t2).amax(dim=-1)
    t_far = torch.maximum(t1, t2).amin(dim=-1)
    return (t_far >= t_near.clamp(min=0.0)) & (t_near < t_max)


def _leaf_prim_test(row, ray_o, ray_d):
    """One prim per lane from its packed (n,14) row (adapt_tpu/ops/bvh.py
    :38-72). Row layout: n|center(0:3) d|radius(3) U(4:7) cu(7) V(8:11)
    cv(11) is_sphere(12) gid(13). Returns (t, gid, u, v); t = FAR on a
    miss. u, v are the triangle formula's, on sphere rows too."""
    a = row[:, 0:3]
    b = row[:, 3]
    is_sph = row[:, 12] > 0.5
    gid = row[:, 13].to(torch.int32)
    # triangle: plane + dual basis
    o_n = _d3(ray_o, a)
    d_n = _d3(ray_d, a)
    flat = torch.abs(d_n) < 1e-12
    t_tri = (b - o_n) / torch.where(flat, 1e-12, d_n)
    hitp = ray_o + t_tri[:, None] * ray_d
    u = _d3(hitp, row[:, 4:7]) - row[:, 7]
    v = _d3(hitp, row[:, 8:11]) - row[:, 11]
    tri_ok = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t_tri > RAY_EPS) \
        & ~flat
    # sphere: quadratic (center in a, radius in b)
    s2c = a - ray_o
    cn2 = _d3(s2c, s2c)
    proj = _d3(ray_d, s2c)
    c2r = cn2 - proj * proj
    r2 = b * b
    cut = torch.sqrt(torch.clamp(r2 - c2r, min=0.0))
    outside = cn2 > r2 + 1e-4
    t_sph = proj + torch.where(outside, -cut, cut)
    sph_ok = (c2r < r2) & (t_sph > RAY_EPS)
    t = torch.where(is_sph, torch.where(sph_ok, t_sph, FAR),
                    torch.where(tri_ok, t_tri, FAR))
    return t, gid, u, v


def walk(scene, ray_o, ray_d, far0, any_hit=False, stats=False):
    """Closest hit (or, with any_hit, a hit) of every ray before far0.

    Returns (t, prim, u, v): t = far0, prim = -1, u = v = 0 on a miss;
    prim is the global prim id. With any_hit a lane stops at its first
    leaf with a hit. With stats, also returns per-lane (node visits, prim
    tests) as int32 tensors: the work these rays need, for the kernels'
    bound."""
    nodes, prims = scene.bvh_node_pack, scene.bvh_prim_pack
    M, P = nodes.shape[0], prims.shape[0]
    N, dev = ray_o.shape[0], ray_o.device
    inv_d = 1.0 / torch.where(torch.abs(ray_d) < 1e-9, 1e-9, ray_d)
    cursor = torch.where(far0 > RAY_EPS, 0, M)
    best_t = far0.clone()
    best_prim = torch.full((N,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(N, device=dev)
    best_v = torch.zeros(N, device=dev)
    visits = torch.zeros(N, dtype=torch.int32, device=dev)
    tests = torch.zeros(N, dtype=torch.int32, device=dev)

    while True:
        lane = torch.nonzero(cursor < M).squeeze(1)   # lanes still walking
        if lane.numel() == 0:
            break
        c = cursor[lane]
        o, d = ray_o[lane], ray_d[lane]
        node = nodes[c]
        base = node[:, 6].long()
        cnt = node[:, 7].long()
        skip = node[:, 8].long()
        bt, bp = best_t[lane], best_prim[lane]
        bu, bv = best_u[lane], best_v[lane]
        hit_box = _slab_test(o, inv_d[lane], node[:, 0:3], node[:, 3:6], bt)
        leaf = hit_box & (cnt > 0)
        n_tests = torch.zeros_like(c)
        for k in range(LEAF_MAX):
            valid = leaf & (k < cnt)
            row = prims[torch.clamp(base + k, max=P - 1)]
            t, gid, u, v = _leaf_prim_test(row, o, d)
            better = valid & (t < bt)
            bp = torch.where(better, gid, bp)
            bu = torch.where(better, u, bu)
            bv = torch.where(better, v, bv)
            bt = torch.where(better, t, bt)
            n_tests += valid
        best_t[lane], best_prim[lane] = bt, bp
        best_u[lane], best_v[lane] = bu, bv
        visits[lane] += 1
        tests[lane] += n_tests.to(torch.int32)
        nxt = torch.where(hit_box, c + 1, skip)
        if any_hit:
            nxt = torch.where(bp >= 0, M, nxt)
        cursor[lane] = nxt
    out = (best_t, best_prim, best_u, best_v)
    return out + (visits, tests) if stats else out


def traverse(scene, ray_o, ray_d, max_t=None, any_hit=False, alive=None,
             stats=False):
    """adapt_tpu/ops/bvh.py `traverse` on the port's tables: the far
    bound from max_t (hits strictly before max_t - RAY_EPS) and alive
    (dead lanes get t = -3e38 and no hit), then `walk`."""
    return walk(scene, ray_o, ray_d, far_bound(ray_o, max_t, alive),
                any_hit=any_hit, stats=stats)
