"""The cluster tier: CUDA kernels, their plain PyTorch versions, and the
queue-pick schedule (port of the non-default schedules of
adapt_tpu/ops/cluster_pallas.py).

Five wrappers replace five Pallas TPU kernels:

* `cluster_closest_hit` / `cluster_any_hit`: `_closest_kernel` (via
  `cluster_closest_hit`) and `_any_kernel` (via `cluster_any_hit`), the
  sweep of all clusters in index order with box gates;
* `cluster_front`: `_front_kernel` (via `_front_candidates`), each ray's
  front-most entered cluster and the entry distance of its second, by a
  walk of the tree above the cut (`cl_tree`) that skips whole ranges of
  clusters which cannot change either (`cluster_front_culled` repeats it
  step for step; `cluster_front_plain` tests every box);
* `cluster_pick_closest` / `cluster_pick_any`: `_single_kernel` (via
  `_single_pass`) and `_single_any_kernel` (in `qpick_any`), each tile of
  TILE consecutive rays against the one cluster its pick names, whose rows
  (at most PICK_ROWS) the kernel stages in shared memory by TMA.

On a CUDA tensor each wrapper launches its hand-written kernel
(csrc/cluster_intersect.cu, built by ops/_build.py) or raises; on a CPU
tensor it runs the plain version beside it, which repeats the kernel's
steps in the same operation order (each dot (x0*y0 + x1*y1) + x2*y2,
u = (o.U + t*(d.U)) - cu, every operation rounded once), so that the two
agree bit for bit on the card. ops/_build.py launches the kernels and
counts them.

`resolve_winner` (a plain function, as in the JAX package) turns a winner
slot into (gid, u, v, n_g, obj). `qpick_closest` and `qpick_any` are the
queue-pick schedule: one front pass, one stable sort by (front cluster,
direction octant), P pick passes, then the exact cleanup of the residual
lanes with the tightened far bound, which here is the BVH walk
(ops/bvh_kernels.py, the counterpart of the JAX package's shortlist pass).
"""
from __future__ import annotations

import ctypes

import torch

from .. import obs
from . import _build, bvh_kernels
from .bvh import _slab_test
from .intersect_kernels import DEAD, FAR, RAY_EPS, _is_cpu, twin

TILE = 128             # rays of one pick tile (the JAX package's LANE_B)
QP_P = 2               # pick passes of the queue-pick schedule (its QP_P)
BIG = 3e38             # "no entry" distance of the front pass
# largest (C, 6) box table in bytes: the sweep kernels keep it in a block's
# shared memory (csrc/cluster_intersect.cu SMEM_MAX)
BOX_TABLE_MAX = 200 * 1024
# most 128-prim chunks a cluster the sweep kernels take (one warp load of
# 6 floats a chunk box: csrc/cluster_intersect.cu `sweep_chunks_fit`)
SWEEP_CHUNKS = 5
# most slots a cluster the pick kernels take: they stage a cluster's rows
# of `cl_rows_v4` (64 B each) in a block's shared memory; and the threads
# a ray they split those rows over (csrc/cluster_intersect.cu PICK_ROWS,
# PICK_SPLIT)
PICK_ROWS = 256
PICK_SPLIT = 4
# (ray, box) or (ray, row) pairs per table of the plain versions; bounds
# their memory
PLAIN_LANES = 1 << 22
# operations of one box test (6 subtractions, 6 products, 11 min/max, 2
# compares, the and); of a prim test up to its plane distance (two 3-term
# dots, b - o.n, the division, |d.n| and four compares: flat, padding,
# t > eps, t < t_max), which is all a row costs whose t cannot win; and of a
# whole prim test (six dots, t, u, v, the flat test, u + v and six
# compares), for the kernels' bounds
BOX_OPS = 26
PLANE_OPS = 17
PRIM_OPS = 47

# ----------------------------- plain versions -----------------------------

def _inv_dir(ray_d):
    return 1.0 / torch.where(torch.abs(ray_d) < 1e-9, 1e-9, ray_d)


def _prim_tables(rows, ro, rd, spheres, plane=False):
    """Hit distance of every (ray, row) pair, FAR on a miss: rows
    (..., R, 18), rays (..., B, 3) -> (..., B, R). Operation order of
    cluster_pallas.py `_prim_chunk_test`; `spheres` False skips the sphere
    quadratic (no row is a sphere). With `plane`, also the table of plane
    distances for the work counts: a pair needs the whole test only where
    this lies under the bound it is tested against (FAR where the plane
    test already fails, 0 on a sphere row, which always takes its
    quadratic)."""
    def f(k):
        return rows[..., None, :, k]                     # (..., 1, R)

    def d3(vec, c):
        return (vec[..., 0:1] * f(c) + vec[..., 1:2] * f(c + 1)) \
            + vec[..., 2:3] * f(c + 2)

    b = f(3)
    o_n, d_n = d3(ro, 0), d3(rd, 0)
    flat = torch.abs(d_n) < 1e-12
    t_tri = (b - o_n) / torch.where(flat, 1e-12, d_n)
    u = d3(ro, 4) + t_tri * d3(rd, 4) - f(7)
    v = d3(ro, 8) + t_tri * d3(rd, 8) - f(11)
    ok = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t_tri > RAY_EPS) & ~flat
    t = torch.where(ok, t_tri, FAR)
    if spheres:
        cx = f(0) - ro[..., 0:1]
        cy = f(1) - ro[..., 1:2]
        cz = f(2) - ro[..., 2:3]
        cn2 = (cx * cx + cy * cy) + cz * cz
        proj = (cx * rd[..., 0:1] + cy * rd[..., 1:2]) + cz * rd[..., 2:3]
        c2r = cn2 - proj * proj
        r2 = b * b
        cut = torch.sqrt(torch.clamp(r2 - c2r, min=0.0))
        t_sph = proj + torch.where(cn2 > r2 + 1e-4, -cut, cut)
        sph_ok = (c2r < r2) & (t_sph > RAY_EPS)
        t = torch.where(f(12) > 0.5, torch.where(sph_ok, t_sph, FAR), t)
    t = torch.where(f(13) < 0.0, FAR, t)
    if not plane:
        return t
    cand = torch.where((t_tri > RAY_EPS) & ~flat & (f(13) >= 0.0), t_tri, FAR)
    return t, torch.where((f(12) > 0.5) & (f(13) >= 0.0), 0.0, cand)


def _first_min(t):
    """(min over the last axis, the lowest index that holds it)."""
    best = t.amin(dim=-1)
    idx = torch.arange(t.shape[-1], device=t.device)
    return best, torch.where(t == best[..., None], idx,
                             t.shape[-1]).amin(dim=-1)


def _whole_tests(tt, cand, t0):
    """How many pairs of a closest-hit visit need the whole prim test: row
    k is tested against the best t before it, min(t0, tt[..., :k])."""
    before = torch.cat([t0[..., None], tt[..., :-1]], dim=-1)
    return _count(cand < torch.cummin(before, dim=-1).values)


def _count(x):
    """x.sum() read to the host: the plain versions' work counts."""
    return int(obs.host_read(x.sum(), "cluster.stats"))


def _pieces(n, width):
    """Ranges of at most PLAIN_LANES // width items (one empty range when
    n == 0, so an empty batch gives empty outputs)."""
    step = max(1, PLAIN_LANES // max(width, 1))
    return [(s, min(n, s + step)) for s in range(0, max(n, 1), step)]


def _has_spheres(scene):
    return scene.sph_gid.shape[0] > 0


def _sweep_plain(scene, ray_o, ray_d, far0, any_hit=False, stats=False,
                 visits=None):
    """The sweep of both sweep kernels, step for step: clusters in index
    order; a cluster is entered when its box passes the slab test against
    the lane's running best t (any hit: its far bound, and never once
    occluded); inside, each 128-prim chunk is gated by its own box the
    same way and its live rows are tested in slot order, strict <.

    Returns (t, wid, occluded, work): wid = cluster * CM + slot of the
    winner (-1: none); work is None, or with stats (box_tests, prim_tests,
    whole_tests): the box tests and (ray, row) tests these rays need (an
    occluded lane's stop at its first hit) and how many of the latter go
    past the plane distance, for the kernels' bounds. A list `visits`
    gets one (base, m, lanes, rows) per chunk entered: its first slot and
    live rows, the lanes that enter it (ascending) and the rows each of
    them tests (m, or up to its first hit), for `warp_divergence`."""
    C, CM = scene.n_clusters, scene.cluster_size
    K = scene.cl_chunk.shape[1]
    CK = CM // K
    counts = obs.host_read(scene.cl_count, "cluster.counts").tolist()
    spheres = _has_spheres(scene)
    inv = _inv_dir(ray_d)
    N, dev = ray_o.shape[0], ray_o.device
    t = far0.clone()
    wid = torch.full((N,), -1, dtype=torch.int32, device=dev)
    occ = torch.zeros(N, dtype=torch.bool, device=dev)
    walking = far0 > RAY_EPS
    box_tests = prim_tests = whole_tests = 0
    for c in range(C if N else 0):
        live = walking & ~occ
        if stats:
            box_tests += _count(live)
        lanes = torch.nonzero(live & _slab_test(
            ray_o, inv, scene.cl_aabb[c, 0:3], scene.cl_aabb[c, 3:6],
            t)).squeeze(1)
        for q in range(-(-counts[c] // CK)):
            if lanes.numel() == 0:
                break
            box_tests += lanes.numel()
            sub = lanes[_slab_test(ray_o[lanes], inv[lanes],
                                   scene.cl_chunk[c, q, 0:3],
                                   scene.cl_chunk[c, q, 3:6], t[lanes])]
            base = c * CM + q * CK
            m = min(counts[c] - q * CK, CK)
            rows = scene.cl_rows[base:base + m]
            tested = torch.full_like(sub, m)
            for s, e in _pieces(sub.numel(), m):
                ln = sub[s:e]
                tt = _prim_tables(rows, ray_o[ln], ray_d[ln], spheres,
                                  plane=stats)
                if stats:
                    tt, cand = tt
                if any_hit:
                    before = tt < far0[ln, None]
                    occ[ln] = before.any(dim=1)
                    if stats or visits is not None:
                        slot = torch.arange(m, device=dev)
                        first = torch.where(before, slot, m - 1).amin(dim=1)
                        tested[s:e] = first + 1
                    if stats:
                        prim_tests += _count(first + 1)
                        whole_tests += _count((cand < far0[ln, None])
                                              & (slot <= first[:, None]))
                else:
                    if stats:
                        whole_tests += _whole_tests(tt, cand, t[ln])
                    bt, bi = _first_min(tt)
                    better = bt < t[ln]
                    t[ln] = torch.where(better, bt, t[ln])
                    wid[ln] = torch.where(better, (base + bi).to(torch.int32),
                                          wid[ln])
                    prim_tests += ln.numel() * m
            if visits is not None and sub.numel():
                visits.append((base, m, sub, tested))
            if any_hit:
                lanes = lanes[~occ[lanes]]
    work = (box_tests, prim_tests, whole_tests) if stats else None
    return t, wid, occ, work


def warp_divergence(visits):
    """(row tests, warp row iterations one thread a ray, warp row
    iterations warp-cooperative) of a sweep's `visits`, a warp being 32
    consecutive lanes. One thread a ray (the kernels' first port): a warp
    runs the row loop of each chunk that any of its lanes enters, as long
    as its longest lane's. Warp-cooperative (csrc/cluster_intersect.cu):
    the 32 lanes test all m live rows of one entering lane's chunk
    together, ceil(m / 32) iterations a lane and chunk (the any hit too,
    which votes once a chunk). 32 x iterations / row tests is the
    divergence factor: 1 when every iteration does 32 row tests that the
    lanes need, 32 when it does one."""
    tests = thread_iters = warp_iters = 0
    for _base, m, lanes, rows in visits:
        tests += _count(rows)
        warps, inv = torch.unique(lanes // 32, return_inverse=True)
        longest = torch.zeros_like(warps).scatter_reduce(
            0, inv, rows, "amax", include_self=False)
        thread_iters += _count(longest)
        warp_iters += lanes.numel() * -(-m // 32)
    return tests, thread_iters, warp_iters


def _sphere_uv(n_g, is_sph, u, v):
    """Spherical u, v from the (final) sphere normal on sphere lanes
    (cluster_pallas.py:1825-1831)."""
    sph_u = (torch.atan2(n_g[:, 1], n_g[:, 0]) + torch.pi) / (2.0 * torch.pi)
    sph_v = torch.arccos(torch.clamp(n_g[:, 2], -1.0, 1.0)) / torch.pi
    return torch.where(is_sph, sph_u, u), torch.where(is_sph, sph_v, v)


def _finish(scene, wid, t, ray_o, ray_d):
    """What the closest-hit kernel reads off its winner row: (gid, u, v,
    n_g, obj, is_sphere) with the triangle formula's u, v, a sphere's
    normal from its hit point, and the miss defaults (-1 ids, u = v = 0,
    n_g = (1, 0, 0)). The sphere normal divides by a square root where the
    JAX package multiplies by `rsqrt`: both of the card's roundings of
    1 / sqrt are then the same in the kernel and here."""
    miss = wid < 0
    r = scene.cl_rows[wid.clamp(min=0).long()]

    def d3(vec, c):
        return (vec[:, 0] * r[:, c] + vec[:, 1] * r[:, c + 1]) \
            + vec[:, 2] * r[:, c + 2]

    gid = torch.where(miss, -1, r[:, 13].to(torch.int32))
    obj = torch.where(miss, -1, r[:, 17].to(torch.int32))
    u = d3(ray_o, 4) + t * d3(ray_d, 4) - r[:, 7]
    v = d3(ray_o, 8) + t * d3(ray_d, 8) - r[:, 11]
    n_g = r[:, 14:17]
    is_sph = (r[:, 12] > 0.5) & ~miss
    if _has_spheres(scene):
        h = ray_o + t[:, None] * ray_d - r[:, 0:3]
        inv_n = 1.0 / torch.sqrt(torch.clamp(
            (h[:, 0] * h[:, 0] + h[:, 1] * h[:, 1]) + h[:, 2] * h[:, 2],
            min=1e-24))
        n_g = torch.where(is_sph[:, None], h * inv_n[:, None], n_g)
    default_n = torch.tensor([1.0, 0.0, 0.0], device=wid.device)
    return (gid, torch.where(miss, 0.0, u), torch.where(miss, 0.0, v),
            torch.where(miss[:, None], default_n, n_g), obj, is_sph)


def resolve_winner(scene, wid, t, ray_o, ray_d):
    """(gid, u, v, n_g, obj) of winner slots wid = cluster * CM + slot
    (-1: miss), outside any kernel (port of cluster_pallas.py
    `_resolve_winner`): one row read per lane, spherical u, v on sphere
    lanes."""
    gid, u, v, n_g, obj, is_sph = _finish(scene, wid, t, ray_o, ray_d)
    u, v = _sphere_uv(n_g, is_sph, u, v)
    return gid, u, v, n_g, obj


def cluster_closest_hit_plain(scene, ray_o, ray_d, far0, stats=False,
                              visits=None):
    """`cluster_closest_hit` in plain PyTorch (any device). With stats,
    also (box tests, prim tests, whole prim tests) of the sweep; `visits`
    as `_sweep_plain` fills it."""
    t, wid, _occ, work = _sweep_plain(scene, ray_o, ray_d, far0, stats=stats,
                                      visits=visits)
    out = (t,) + resolve_winner(scene, wid, t, ray_o, ray_d)
    return out + work if stats else out


def cluster_any_hit_plain(scene, ray_o, ray_d, far0, stats=False,
                          visits=None):
    """`cluster_any_hit` in plain PyTorch (any device). With stats, also
    the sweep's three work counts; `visits` as `_sweep_plain` fills it."""
    _t, _wid, occ, work = _sweep_plain(scene, ray_o, ray_d, far0,
                                       any_hit=True, stats=stats,
                                       visits=visits)
    return (occ, *work) if stats else occ


def cluster_front_plain(scene, ray_o, ray_d, far0):
    """`cluster_front` in plain PyTorch (any device): per ray the entered
    cluster (inflated boxes) of least entry distance max(t_near, 0), ties
    to the lowest id, C when none; and the second least entry distance,
    BIG when fewer than two."""
    C = scene.n_clusters
    lo, hi = scene.cl_front[None, :, 0:3], scene.cl_front[None, :, 3:6]
    ids = torch.arange(C, device=ray_o.device)
    cids, nxts = [], []
    for s, e in _pieces(ray_o.shape[0], C):
        o = ray_o[s:e, None, :]
        inv = _inv_dir(ray_d[s:e])[:, None, :]
        t1 = (lo - o) * inv
        t2 = (hi - o) * inv
        tn = torch.clamp(torch.minimum(t1, t2).amax(dim=-1), min=-BIG)
        tf = torch.clamp(torch.maximum(t1, t2).amin(dim=-1), max=BIG)
        ent = torch.clamp(tn, min=0.0)
        hit = (tf >= ent) & (tn < far0[s:e, None])
        keyed = torch.where(hit, ent, BIG)
        first, cid = _first_min(keyed)
        second = torch.where(ids[None] == cid[:, None], BIG, keyed).amin(dim=1)
        has = first < BIG
        cids.append(torch.where(has, cid, C).to(torch.int32))
        nxts.append(torch.where(has, second, BIG))
    return torch.cat(cids), torch.cat(nxts)


def cluster_front_culled(scene, ray_o, ray_d, far0):
    """The front kernel's walk over `cl_tree`, step for step, in plain
    PyTorch (any device): (cid, nxt, box_tests (N,) i32, the rows each ray
    tests). Equal to `cluster_front_plain`, for this reason.

    Every row's box test is that of `cluster_front_plain` on its box: entry
    ent = max(clamp(t_near, -BIG), 0), entered when clamp(t_far, BIG) >= ent
    and t_near < far0. A leaf is one cluster with its own box, and updates
    (first, cid, second) as the loop over the clusters in index order
    does: the entered cluster of least ent, the lowest id on a tie, and
    the second least ent. The walk descends into an inner row only when
    the ray enters its box with ent at or below the running second; it
    skips the subtree when the ray misses the box or its ent is strictly
    greater. That skips no cluster that could change a result: each step
    of the slab test (subtract, multiply by the same inverse, min, max,
    clamp) rounds monotonically, and an inner box holds its clusters'
    boxes, so a cluster it holds that the ray enters has an ent at or
    above the row's, hence above the second, which changes neither the
    first nor the second (the second only falls as the walk goes on).
    Rows are visited in DFS order, which is the clusters' index order."""
    tree = scene.cl_tree
    T, C = tree.shape[0], scene.n_clusters
    words = tree.view(torch.int32)
    lo, hi = tree[:, 0:3], tree[:, 4:7]
    skip, first_id = words[:, 3].long(), words[:, 7]
    N, dev = ray_o.shape[0], ray_o.device
    inv = _inv_dir(ray_d)
    cursor = torch.zeros(N, dtype=torch.long, device=dev)
    first = torch.full((N,), BIG, device=dev)
    second = torch.full((N,), BIG, device=dev)
    cid = torch.full((N,), C, dtype=torch.int32, device=dev)
    tests = torch.zeros(N, dtype=torch.int32, device=dev)
    while True:
        lane = torch.nonzero(cursor < T).squeeze(1)
        if lane.numel() == 0:
            break
        c = cursor[lane]
        o = ray_o[lane]
        t1 = (lo[c] - o) * inv[lane]
        t2 = (hi[c] - o) * inv[lane]
        tn = torch.clamp(torch.minimum(t1, t2).amax(dim=-1), min=-BIG)
        tf = torch.clamp(torch.maximum(t1, t2).amin(dim=-1), max=BIG)
        ent = torch.clamp(tn, min=0.0)
        enter = (tf >= ent) & (tn < far0[lane])
        leaf = skip[c] == c + 1
        keyed = torch.where(leaf & enter, ent, BIG)
        f, s = first[lane], second[lane]
        lt1 = keyed < f
        second[lane] = torch.where(lt1, f, torch.where(keyed < s, keyed, s))
        first[lane] = torch.where(lt1, keyed, f)
        cid[lane] = torch.where(lt1, first_id[c], cid[lane])
        descend = ~leaf & enter & (ent <= s)
        cursor[lane] = torch.where(descend, c + 1, skip[c])
        tests[lane] += 1
    return cid, second, tests


def _tiles(n):
    return -(-n // TILE)


def _pick_plain(scene, ray_o, ray_d, picks, visit):
    """Each tile of TILE consecutive rays against the rows of the cluster
    its pick names: `visit(ids (m, TILE) ray ids, real (m, TILE) lanes
    that exist, tt (m, TILE, CM) hit distances (FAR on padding slots), cand
    (the plane distances of `_prim_tables`), base (m,) first slot, count
    (m,) live rows)` for pieces of the active tiles; it returns the (ray,
    row) tests its lanes need and how many of them are whole. Returns the
    two sums."""
    N, dev = ray_o.shape[0], ray_o.device
    CM = scene.cluster_size
    rows = scene.cl_rows.view(-1, CM, 18)
    act = torch.nonzero(picks >= 0).squeeze(1)
    lane = torch.arange(TILE, device=dev)
    spheres = _has_spheres(scene)
    tests = whole = 0
    for s, e in _pieces(act.numel(), TILE * CM) if act.numel() else ():
        tile = act[s:e]
        pk = picks[tile].long()
        ids = tile[:, None] * TILE + lane[None]          # (m, TILE)
        real = ids < N
        ids = ids.clamp(max=N - 1)
        tt, cand = _prim_tables(rows[pk], ray_o[ids], ray_d[ids], spheres,
                                plane=True)
        a, b = visit(ids, real, tt, cand, pk * CM, scene.cl_count[pk])
        tests, whole = tests + int(a), whole + int(b)
    return tests, whole


def cluster_pick_closest_plain(scene, ray_o, ray_d, far0, wid0, picks,
                               stats=False):
    """`cluster_pick_closest` in plain PyTorch (any device). With stats,
    also the (ray, row) tests made, every live row of an active tile, and
    how many of them are whole."""
    t, wid = far0.clone(), wid0.clone()

    def visit(ids, real, tt, cand, base, count):
        whole = _whole_tests(tt, torch.where(real[..., None], cand, FAR),
                             t[ids]) if stats else 0
        bt, bi = _first_min(tt)
        better = (bt < t[ids]) & real
        t[ids[better]] = bt[better]
        wid[ids[better]] = (base[:, None] + bi)[better].to(torch.int32)
        return (real.sum(dim=1) * count).sum(), whole
    tests, whole = _pick_plain(scene, ray_o, ray_d, picks, visit)
    return (t, wid, tests, whole) if stats else (t, wid)


def cluster_pick_any_plain(scene, ray_o, ray_d, far0, picks, stats=False):
    """`cluster_pick_any` in plain PyTorch (any device). With stats, also
    the (ray, row) tests made, a lane's rows up to its first hit, and how
    many of them are whole."""
    occ = torch.zeros(ray_o.shape[0], dtype=torch.bool, device=ray_o.device)

    def visit(ids, real, tt, cand, base, count):
        far = far0[ids][..., None]
        before = tt < far
        occ[ids[before.any(dim=-1) & real]] = True
        slot = torch.arange(tt.shape[-1], device=tt.device)
        first = torch.where(before, slot, tt.shape[-1]).amin(dim=-1)
        whole = (cand < far) & (slot <= first[..., None]) & real[..., None]
        return ((torch.minimum(first + 1, count[:, None]) * real).sum(),
                whole.sum())
    tests, whole = _pick_plain(scene, ray_o, ray_d, picks, visit)
    return (occ, tests, whole) if stats else occ


# -------------------------------- wrappers --------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_LIB = _build.Library(__name__, "cluster_intersect", {
    "cluster_closest_hit": (
        "cluster_closest_hit", "cluster_closest_kernel",
        [_P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I] + [_P] * 8),
    "cluster_any_hit": (
        "cluster_any_hit", "cluster_any_kernel",
        [_P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P]),
    "cluster_front": (
        "cluster_front", "cluster_front_kernel",
        [_P, _P, _P, _I, _P, _I, _I, _P, _P, _P]),
    "cluster_pick_closest": (
        "cluster_pick_closest", "cluster_pick_closest_kernel",
        [_P, _P, _P, _P, _P, _I, _P, _P, _I, _P, _P, _P]),
    "cluster_pick_any": (
        "cluster_pick_any", "cluster_pick_any_kernel",
        [_P, _P, _P, _P, _I, _P, _P, _I, _P, _P])},
    queries={"cluster_kernel_info": [_I, _I, _I, _P]})
# each wrapper's kernel, by the name the profiler gives it
kernel_names = _LIB.kernel_names


def _operands(scene, ray_o, ray_d, far0, extra=()):
    """Device, type, shape and size checks of everything the kernels read;
    contiguous rays. The cluster tables must already be contiguous.
    extra: (name, tensor, shape, dtype) of a kernel's further inputs."""
    n = ray_o.shape[0]
    C, CM = scene.n_clusters, scene.cluster_size
    K = scene.cl_chunk.shape[1]
    f32, i32 = torch.float32, torch.int32
    tables = (("cl_aabb", scene.cl_aabb, (C, 6), f32),
              ("cl_front", scene.cl_front, (C, 6), f32),
              ("cl_chunk", scene.cl_chunk, (C, K, 6), f32),
              ("cl_count", scene.cl_count, (C,), i32),
              ("cl_rows", scene.cl_rows, (C * CM, 18), f32))
    for name, x, shape, dtype in (
            ("ray_o", ray_o, (n, 3), f32), ("ray_d", ray_d, (n, 3), f32),
            ("far0", far0, (n,), f32)) + tables + tuple(extra):
        if x.device != ray_o.device or x.dtype != dtype \
                or tuple(x.shape) != shape:
            raise ValueError(f"{name}: want {dtype} of shape {shape} on "
                             f"{ray_o.device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    for name, x, _shape, _dtype in tables:
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if CM % K or CM // K != 128:
        raise ValueError(f"the kernels take 128-prim chunks, got {CM}/{K}")
    return ray_o.contiguous(), ray_d.contiguous(), far0.contiguous(), n


def _aligned(name, x):
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and start on a 16-byte "
                         "boundary")


def _rows4_operands(scene, ray_o, ray_d, far0, extra=()):
    """`_operands` (with a kernel's further inputs `extra`) and the float4
    rows `cl_rows_v4`, contiguous and on a 16-byte boundary."""
    C, CM = scene.n_clusters, scene.cluster_size
    rows4 = scene.cl_rows_v4
    out = _operands(scene, ray_o, ray_d, far0,
                    (("cl_rows_v4", rows4, (C * CM, 16), torch.float32),)
                    + tuple(extra))
    _aligned("cl_rows_v4", rows4)
    return out


def _sweep_operands(scene, ray_o, ray_d, far0):
    """`_rows4_operands` and what the sweep kernels add: a box table that
    fits shared memory and at most SWEEP_CHUNKS chunks a cluster (the
    kernels load a cluster's chunk boxes in one warp load)."""
    C = scene.n_clusters
    if C * 24 > BOX_TABLE_MAX:
        raise ValueError(f"{C} clusters: the sweep kernels keep the box "
                         f"table in shared memory, at most "
                         f"{BOX_TABLE_MAX // 24}")
    out = _rows4_operands(scene, ray_o, ray_d, far0)
    if scene.cl_chunk.shape[1] > SWEEP_CHUNKS:
        raise ValueError(f"the sweep kernels take at most {SWEEP_CHUNKS} "
                         f"chunks a cluster, got {scene.cl_chunk.shape[1]}")
    return out


def _pick_operands(scene, ray_o, ray_d, far0, extra):
    """`_rows4_operands` (the kernels copy the rows into shared memory by
    TMA bulk copies, which take 16-byte aligned addresses) and clusters
    of at most PICK_ROWS slots, whose rows fit the staged buffer."""
    CM = scene.cluster_size
    out = _rows4_operands(scene, ray_o, ray_d, far0, extra)
    if CM > PICK_ROWS:
        raise ValueError(f"clusters of {CM} slots: the pick kernels stage "
                         f"at most {PICK_ROWS} rows of 64 B in shared "
                         "memory")
    return out


def _front_operands(scene, ray_o, ray_d, far0):
    """`_operands` and the front kernel's tree `cl_tree` (T, 8) f32,
    contiguous and on a 16-byte boundary (its rows are float4 loads)."""
    tree = scene.cl_tree
    out = _operands(scene, ray_o, ray_d, far0,
                    (("cl_tree", tree, (tree.shape[0], 8), torch.float32),))
    _aligned("cl_tree", tree)
    return out


def kernel_info(n, C, CM):
    """{kernel: (registers a thread, spilled bytes a thread, blocks
    resident on one SM (the sweeps with a table of C clusters in shared
    memory, the pick kernels with a cluster's CM rows), SMs, threads a
    block, waves)} of the five cluster kernels for n rays: one thread a
    ray, PICK_SPLIT for the pick kernels. Needs the card."""
    out = {}
    for which, name in ((0, "cluster_closest_hit"), (1, "cluster_any_hit"),
                        (2, "cluster_front"), (3, "cluster_pick_closest"),
                        (4, "cluster_pick_any")):
        vals = (ctypes.c_int * 5)()
        _LIB.query("cluster_kernel_info", f"{name} info", which, C, CM,
                   ctypes.addressof(vals))
        regs, spill, per_sm, sms, block = vals
        rays = block // PICK_SPLIT if which >= 3 else block
        out[name] = (regs, spill, per_sm, sms, block,
                     -(-n // (per_sm * sms * rays)))
    return out


def cluster_closest_hit(scene, ray_o, ray_d, far0):
    """Closest hit strictly before far0 by the all-cluster sweep.

    Returns (t, gid, u, v, n_g, obj): t = far0, gid = obj = -1, u = v = 0
    and n_g = (1, 0, 0) on a miss; sphere lanes carry their final normal
    and spherical u, v."""
    if _is_cpu(ray_o):
        return twin(cluster_closest_hit_plain, scene, ray_o, ray_d, far0)
    ro, rd, far, n = _sweep_operands(scene, ray_o, ray_d, far0)
    dev = ro.device
    t, u, v = (torch.empty(n, device=dev) for _ in range(3))
    gid, obj, sph = (torch.empty(n, dtype=torch.int32, device=dev)
                     for _ in range(3))
    n_g = torch.empty((n, 3), device=dev)
    if n == 0:
        return t, gid, u, v, n_g, obj
    _LIB.launch("cluster_closest_hit", dev, n,
                ro.data_ptr(), rd.data_ptr(), far.data_ptr(), n,
                scene.cl_aabb.data_ptr(), scene.cl_chunk.data_ptr(),
                scene.cl_count.data_ptr(), scene.cl_rows.data_ptr(),
                scene.cl_rows_v4.data_ptr(), scene.n_clusters,
                scene.cl_chunk.shape[1], scene.cluster_size,
                t.data_ptr(), gid.data_ptr(), u.data_ptr(), v.data_ptr(),
                n_g.data_ptr(), obj.data_ptr(), sph.data_ptr())
    if _has_spheres(scene):
        u, v = _sphere_uv(n_g, sph > 0, u, v)
    return t, gid, u, v, n_g, obj


def cluster_any_hit(scene, ray_o, ray_d, far0):
    """True where any prim lies strictly before far0 (all-cluster sweep)."""
    if _is_cpu(ray_o):
        return twin(cluster_any_hit_plain, scene, ray_o, ray_d, far0)
    ro, rd, far, n = _sweep_operands(scene, ray_o, ray_d, far0)
    occ = torch.empty(n, dtype=torch.bool, device=ro.device)
    if n == 0:
        return occ
    _LIB.launch("cluster_any_hit", ro.device, n,
                ro.data_ptr(), rd.data_ptr(), far.data_ptr(), n,
                scene.cl_aabb.data_ptr(), scene.cl_chunk.data_ptr(),
                scene.cl_count.data_ptr(), scene.cl_rows_v4.data_ptr(),
                scene.n_clusters, scene.cl_chunk.shape[1], scene.cluster_size,
                occ.data_ptr())
    return occ


def cluster_front(scene, ray_o, ray_d, far0):
    """(cid (N,) i32, nxt (N,) f32): each ray's front-most entered cluster
    (C when it enters none before far0) and the entry distance of the
    second (BIG when fewer than two), over the inflated boxes: a lower
    bound of every hit outside the front cluster. The kernel walks
    `cl_tree` as `cluster_front_culled` does."""
    if _is_cpu(ray_o):
        return twin(cluster_front_plain, scene, ray_o, ray_d, far0)
    ro, rd, far, n = _front_operands(scene, ray_o, ray_d, far0)
    cid = torch.empty(n, dtype=torch.int32, device=ro.device)
    nxt = torch.empty(n, device=ro.device)
    if n == 0:
        return cid, nxt
    _LIB.launch("cluster_front", ro.device, n,
                ro.data_ptr(), rd.data_ptr(), far.data_ptr(), n,
                scene.cl_tree.data_ptr(), scene.cl_tree.shape[0],
                scene.n_clusters, cid.data_ptr(), nxt.data_ptr())
    return cid, nxt


def cluster_pick_closest(scene, ray_o, ray_d, far0, wid0, picks):
    """One pick pass: tile i (rays i * TILE ...) tests the live rows of
    cluster picks[i] (-1: none), tightening t from far0 and keeping
    wid = cluster * CM + slot of each strict improvement over wid0.
    Returns (t (N,), wid (N,) i32)."""
    if _is_cpu(ray_o):
        return twin(cluster_pick_closest_plain, scene, ray_o, ray_d, far0,
                    wid0, picks)
    n = ray_o.shape[0]
    ro, rd, far, n = _pick_operands(
        scene, ray_o, ray_d, far0,
        (("wid0", wid0, (n,), torch.int32),
         ("picks", picks, (_tiles(n),), torch.int32)))
    wid0, picks = wid0.contiguous(), picks.contiguous()
    t = torch.empty(n, device=ro.device)
    wid = torch.empty(n, dtype=torch.int32, device=ro.device)
    if n == 0:
        return t, wid
    _LIB.launch("cluster_pick_closest", ro.device, n,
                picks.data_ptr(), ro.data_ptr(), rd.data_ptr(),
                far.data_ptr(), wid0.data_ptr(), n,
                scene.cl_count.data_ptr(), scene.cl_rows_v4.data_ptr(),
                scene.cluster_size, t.data_ptr(), wid.data_ptr())
    return t, wid


def cluster_pick_any(scene, ray_o, ray_d, far0, picks):
    """One any-hit pick pass: True where a live row of the tile's picked
    cluster lies strictly before far0."""
    if _is_cpu(ray_o):
        return twin(cluster_pick_any_plain, scene, ray_o, ray_d, far0, picks)
    n = ray_o.shape[0]
    ro, rd, far, n = _pick_operands(
        scene, ray_o, ray_d, far0,
        (("picks", picks, (_tiles(n),), torch.int32),))
    picks = picks.contiguous()
    occ = torch.empty(n, dtype=torch.bool, device=ro.device)
    if n == 0:
        return occ
    _LIB.launch("cluster_pick_any", ro.device, n,
                picks.data_ptr(), ro.data_ptr(), rd.data_ptr(),
                far.data_ptr(), n, scene.cl_count.data_ptr(),
                scene.cl_rows_v4.data_ptr(), scene.cluster_size,
                occ.data_ptr())
    return occ


# ------------------------- the queue-pick schedule -------------------------

def tile_picks(cid_sorted, C, P):
    """Per tile the first P distinct front clusters, and per lane whether
    its own is among them (port of cluster_pallas.py `_tile_picks`).

    cid_sorted: (N,) i32, ascending within each tile of TILE rays (C: the
    lane enters no cluster). Returns (picks: P tensors (tiles,) i32, -1 =
    none; covered (N,) bool)."""
    N = cid_sorted.shape[0]
    nt = _tiles(N)
    rows = torch.nn.functional.pad(cid_sorted, (0, nt * TILE - N),
                                   value=C).view(nt, TILE)
    valid = rows < C
    prev = torch.cat([torch.full_like(rows[:, :1], -1), rows[:, :-1]], dim=1)
    firsts = valid & (rows != prev)
    rank = torch.cumsum(firsts.to(torch.int32), dim=1) - 1
    picks = [torch.where(firsts & (rank == p), rows, -1).amax(dim=1)
             .to(torch.int32) for p in range(P)]
    return picks, (valid & (rank < P)).view(-1)[:N]


def _front_sort(scene, ray_o, ray_d, far0):
    """The front pass and the one sort of the schedule: rays ordered by
    (front cluster, direction octant), lanes that enter no cluster last.
    Returns (perm, ro, rd, far, cid, nxt), all but perm in sorted order."""
    C = scene.n_clusters
    cid0, nxt0 = cluster_front(scene, ray_o, ray_d, far0)
    pos = (ray_d > 0).to(torch.int32)
    octant = pos[:, 0] + 2 * pos[:, 1] + 4 * pos[:, 2]
    key = torch.where(cid0 < C, cid0 * 8 + octant, 8 * C + 7)
    perm = torch.sort(key, stable=True).indices
    return (perm, ray_o[perm], ray_d[perm], far0[perm], cid0[perm],
            nxt0[perm])


def _unsort(perm, x):
    out = torch.empty_like(x)
    out[perm] = x
    return out


def qpick_closest(scene, ray_o, ray_d, far0):
    """Queue-pick closest hit: (t (N,), wid (N,) i32) in the callers'
    order (port of cluster_pallas.py `qpick_closest`), with QP_P pick
    passes.

    A covered lane's front cluster is tested in full by a pick pass; every
    other cluster it enters starts at or after nxt, so nxt >= t proves
    that no closer hit lies outside. All other lanes that enter a cluster
    take the exact cleanup (the BVH walk) with far tightened to their t;
    a hit it finds is strictly closer and its prim id maps to the slot
    through cl_slot."""
    C, P = scene.n_clusters, QP_P
    perm, ro, rd, t, cid, nxt = _front_sort(scene, ray_o, ray_d, far0)
    picks, covered = tile_picks(cid, C, P)
    wid = torch.full_like(cid, -1)
    for p in range(P):
        t, wid = cluster_pick_closest(scene, ro, rd, t, wid, picks[p])
    residual = (cid < C) & (~covered | (nxt < t))
    t2, prim2, _u, _v = bvh_kernels.bvh_closest_hit(
        scene, ro, rd, torch.where(residual, t, DEAD))
    closer = residual & (prim2 >= 0)
    t = torch.where(closer, t2, t)
    wid = torch.where(closer, scene.cl_slot[prim2.clamp(min=0).long()], wid)
    return _unsort(perm, t), _unsort(perm, wid)


def qpick_any(scene, ray_o, ray_d, far0):
    """Queue-pick any hit: occluded (N,) bool in the callers' order (port
    of cluster_pallas.py `qpick_any`). A covered lane that no pick
    occluded and that enters no second cluster is a settled miss; every
    other entering, unoccluded lane takes the exact cleanup."""
    C, P = scene.n_clusters, QP_P
    perm, ro, rd, far, cid, nxt = _front_sort(scene, ray_o, ray_d, far0)
    picks, covered = tile_picks(cid, C, P)
    occ = torch.zeros_like(covered)
    for p in range(P):
        occ = occ | cluster_pick_any(scene, ro, rd, far, picks[p])
    residual = (cid < C) & ~occ & (~covered | (nxt < BIG))
    occ2 = bvh_kernels.bvh_any_hit(scene, ro, rd,
                                   torch.where(residual, far, DEAD))
    return _unsort(perm, occ | (residual & occ2))
