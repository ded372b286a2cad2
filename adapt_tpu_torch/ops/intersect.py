"""Wavefront ray-scene intersection (port of adapt_tpu/ops/intersect.py).

Two tiers, chosen as the JAX package chooses on its accelerator
(adapt_tpu/scene/compile.py:628-632):

* small scenes (fewer than BVH_THRESHOLD prims, or at most 256 triangles
  and 256 prims): every triangle is tested against every ray by the
  hand-written kernels of ops/intersect_kernels.py; spheres use the
  reference's quadratic form in plain PyTorch;
* every other scene (the big tier), triangles and spheres alike, by the
  kernels `cfg.big_tier` names: "bvh" (the default), the BVH kernels of
  ops/bvh_kernels.py walk the scene's BVH; "sweep", the cluster kernels of
  ops/cluster_kernels.py sweep every cluster of the BVH's cluster cut;
  "qpick", the queue-pick schedule there (front pass, one sort, pick
  passes, exact cleanup by the BVH walk). The three give the same hits
  but for rays that graze an edge or tie exactly (the cluster kernels
  round u and v in another order than the BVH kernels).

Media walks on the brute-force tier take `ray_track_hits` (kernel B3 plus
the sphere roots): the closest blocker and the null medium interfaces in
front of it, in one pass.

Hits are found without a graph: every search here runs under no_grad,
as the kernels' outputs never carry one. The decorators cover what is
plain PyTorch here (the sphere roots, the interaction record); the
kernel wrappers' CPU twins run under no_grad of their own
(intersect_kernels.twin), so a wrapper called alone returns no graph
either. Which prim a ray hits is a constant. Where the hit lies on it is
a function of the ray, as in the JAX package: when the ray of a closest-
hit query needs a gradient (a direction sampled from a glossy lobe or a
refraction, a scatter point drawn from a medium's extinction),
`ray_intersect` re-evaluates the hit's distance, barycentrics and
normals on the found prim in PyTorch (`_follow_ray`), with forward
values that are the kernel's own, bit for bit. The media walk's
interface distances (`ray_track_hits`, kernel B3, which returns no prim
ids) stay constants: renderer/vpt.py `track_ray` takes that walk's
gradient from its closest-hit loop. Geometry and camera-pose gradients
are not implemented: they need the visibility edges, which no query
samples.

On the CPU the wrappers run their plain twins. The JAX package's one-hot
gathers and wavefront sorts are TPU workarounds with no counterpart here:
lookups are plain indexing.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import obs
from ..constants import INV_PI, INV_2PI
from . import bvh_kernels, cluster_kernels, intersect_kernels as kernels
from .math3d import axis_vec, cross, dot, fma_dot, normalize, sqrt0

RAY_EPS = kernels.RAY_EPS
FAR = kernels.FAR
DEAD = kernels.DEAD


@dataclasses.dataclass
class Interaction:
    """SoA interaction record for a ray batch (reference tracer/interaction.py)."""
    obj_id: torch.Tensor   # (N,) i32, -1 = miss
    prim_id: torch.Tensor  # (N,) i32 global prim index
    t: torch.Tensor        # (N,) hit distance (far0 on miss)
    n_g: torch.Tensor      # (N,3) geometric normal
    n_s: torch.Tensor      # (N,3) shading normal
    uv: torch.Tensor       # (N,2) local barycentric uv (or sphere angles)
    tex: torch.Tensor | None = None   # (N,3) albedo; None = untextured

    @property
    def is_hit(self):
        return self.obj_id >= 0


def _sphere_hit(ray_o, ray_d, center, radius):
    """Reference sphere test (tracer_base.py:183-198): (N,S) hit distance
    or -1. cn2 - proj^2 cancels (at distance 12 from a sphere of radius
    0.5 it keeps ~10 of 24 bits), so one ULP of either moves a grazing
    hit by 1e-4 relative: both are taken as the JAX package computes them
    on the CPU, chains of fused multiply-adds (`fma_dot`)."""
    s2c = center[None, :, :] - ray_o[:, None, :]        # (N,S,3)
    cn2 = fma_dot(s2c, s2c)
    proj = fma_dot(ray_d[:, None, :], s2c)
    r2 = (radius * radius)[None, :]
    c2r = cn2 - proj * proj
    cut = torch.sqrt(torch.clamp(r2 - c2r, min=0.0))
    outside = cn2 > r2 + 1e-4
    ray_t = proj + torch.where(outside, -cut, cut)
    return torch.where(c2r < r2, ray_t, -1.0)


BIG_TIERS = ("bvh", "sweep", "qpick")


def _bvh_tier(scene, cfg):
    """The big tier's kernels serve this scene (else the brute-force
    ones)."""
    T, P = scene.tri_n.shape[0], scene.n_prims
    big = cfg.use_bvh and not (0 < T <= 256 and P <= 256)
    if big and cfg.big_tier not in BIG_TIERS:
        raise ValueError(f"big_tier must be one of {BIG_TIERS}, got "
                         f"{cfg.big_tier!r}")
    return big


def _rays(scene, cfg, ray_o, *_, **__):
    """An intersection span's attributes: rays, and the kernels' tier."""
    return {"n": ray_o.shape[0],
            "tier": cfg.big_tier if _bvh_tier(scene, cfg) else "brute"}


@obs.spanned("isect.closest", _rays)
def ray_intersect(scene, cfg, ray_o, ray_d, max_t=None, alive=None):
    """Closest-hit intersection for a ray batch; returns Interaction.

    max_t: optional (N,) clip distance (hits accepted strictly before
    max_t - eps). alive: optional (N,) bool; dead lanes are forced to miss
    (far0 = -3e38) and come back with t = -3e38. Under autograd, a ray
    that needs a gradient moves its hit along the found prim
    (`_follow_ray`)."""
    it = _closest_hit(scene, cfg, ray_o, ray_d, max_t, alive)
    if torch.is_grad_enabled() and (ray_o.requires_grad
                                    or ray_d.requires_grad):
        it = _follow_ray(scene, cfg, ray_o, ray_d, it)
    return it


def _follow_ray(scene, cfg, ray_o, ray_d, it):
    """The interaction with its distance, barycentrics and normals as
    differentiable functions of the ray on each lane's found prim: the
    triangle's plane and edges (what the JAX package's triangle test
    differentiates), the sphere root the query took. Straight through:
    each field is the query's value plus (f - f.detach()), so the forward
    values do not change by a bit. Lanes that missed, and the quantities
    of the other prim kind, are masked before anything can divide by 0."""
    hit = it.obj_id >= 0
    prim = it.prim_id.long()
    sph = scene.prim_is_sphere[prim] & hit
    tri = hit & ~sph

    def follow(value, exact, where):
        return value + torch.where(where, exact - exact.detach(), 0.0)

    # triangles: Moller-Trumbore on e1, e2, p0 (pre0, pre1, pre2)
    e1, e2 = scene.pre0[prim], scene.pre1[prim]
    pvec = cross(ray_d, e2)
    det = dot(e1, pvec)
    inv = 1.0 / torch.where(tri & (det != 0.0), det, 1.0)
    tvec = ray_o - scene.pre2[prim]
    qvec = cross(tvec, e1)
    u_tri = dot(tvec, pvec) * inv
    v_tri = dot(ray_d, qvec) * inv
    t_tri = dot(e2, qvec) * inv
    t = torch.where(sph, 0.0, t_tri)
    uv = [follow(it.uv[:, 0], u_tri, tri), follow(it.uv[:, 1], v_tri, tri)]
    n_g, n_s = it.n_g, it.n_s
    if scene.sph_center.shape[0] > 0:
        # the root the query took: the nearer one when t <= proj
        center, radius = scene.pre0[prim], scene.pre1[prim][:, 0]
        s2c = center - ray_o
        proj = dot(ray_d, s2c)
        cut = sqrt0(torch.clamp(radius * radius
                                - (dot(s2c, s2c) - proj * proj), min=0.0))
        near = it.t <= proj.detach()
        t = torch.where(sph, proj + torch.where(near, -cut, cut), t)
        rel = ray_o + t[:, None] * ray_d - center
        n_sph = rel / torch.clamp(
            sqrt0(dot(rel, rel, keepdims=True)), min=1e-12)
        # away from the poles, where atan2 and arccos have no derivative
        pole = (n_sph[:, 0] ** 2 + n_sph[:, 1] ** 2 < 1e-6).detach()
        away = sph & ~pole
        x = torch.where(away, n_sph[:, 0], 1.0)
        y = torch.where(away, n_sph[:, 1], 0.0)
        z = torch.where(away, n_sph[:, 2], 0.0)
        uv = [follow(uv[0], (torch.atan2(y, x) + torch.pi) * INV_2PI, away),
              follow(uv[1], torch.arccos(z) * INV_PI, away)]
        n_g = follow(n_g, n_sph, sph[:, None])
        n_s = follow(n_s, n_sph, sph[:, None])
    t = follow(it.t, t, hit)
    if cfg.has_v_normal:
        vn = scene.prim_vn[prim]
        w0 = (1.0 - uv[0] - uv[1])[:, None]
        n_v = vn[:, 0] * w0 + vn[:, 1] * uv[0][:, None] \
            + vn[:, 2] * uv[1][:, None]
        ok = tri & (torch.abs(vn).sum(dim=(1, 2)) > 1e-6)
        n_v = torch.where(ok[:, None], n_v, axis_vec(0, ray_o.device))
        n_s = follow(n_s, normalize(n_v), ok[:, None])
    return dataclasses.replace(it, t=t, n_g=n_g, n_s=n_s,
                               uv=torch.stack(uv, dim=-1))


@torch.no_grad()
def _closest_hit(scene, cfg, ray_o, ray_d, max_t, alive):
    far0 = kernels.far_bound(ray_o, max_t, alive)
    if _bvh_tier(scene, cfg) and cfg.big_tier != "bvh":
        if cfg.big_tier == "sweep":
            t, gid, u, v, ng, obj = cluster_kernels.cluster_closest_hit(
                scene, ray_o, ray_d, far0)
        else:
            t, wid = cluster_kernels.qpick_closest(scene, ray_o, ray_d, far0)
            gid, u, v, ng, obj = cluster_kernels.resolve_winner(
                scene, wid, t, ray_o, ray_d)
        # sphere normals and uv are final already: no sphere block
        no_sphere = torch.zeros_like(gid, dtype=torch.bool)
        return _assemble_interaction(scene, cfg, ray_o, ray_d, t, gid, u, v,
                                     no_sphere, pre_ng=ng, pre_obj=obj,
                                     pre_final=True)
    if _bvh_tier(scene, cfg):
        best_t, prim, u, v = bvh_kernels.bvh_closest_hit(scene, ray_o, ray_d,
                                                         far0)
        is_sphere_hit = scene.prim_is_sphere[prim.clamp(min=0)] & (prim >= 0)
        return _assemble_interaction(scene, cfg, ray_o, ray_d, best_t, prim,
                                     u, v, is_sphere_hit)
    N = ray_o.shape[0]
    best_t = far0
    best_prim = torch.full((N,), -1, dtype=torch.int32, device=ray_o.device)
    best_u = torch.zeros(N, device=ray_o.device)
    best_v = torch.zeros(N, device=ray_o.device)
    pre_ng = pre_obj = None
    if scene.tri_n.shape[0] > 0:
        best_t, row, best_u, best_v, pre_ng, pre_obj = \
            kernels.tri_closest_hit(scene, ray_o, ray_d, far0)
        gid = scene.tri_gid[row.clamp(min=0)]
        best_prim = torch.where(row >= 0, gid, -1)

    is_sphere_hit = torch.zeros(N, dtype=torch.bool, device=ray_o.device)
    if scene.sph_center.shape[0] > 0:
        ts = _sphere_hit(ray_o, ray_d, scene.sph_center, scene.sph_radius)
        ts = torch.where(ts > RAY_EPS, ts, FAR)
        si = torch.argmin(ts, dim=1)
        st = ts.gather(1, si[:, None])[:, 0]
        better = st < best_t
        best_prim = torch.where(better, scene.sph_gid[si], best_prim)
        best_t = torch.where(better, st, best_t)
        is_sphere_hit = better

    return _assemble_interaction(scene, cfg, ray_o, ray_d, best_t, best_prim,
                                 best_u, best_v, is_sphere_hit, pre_ng,
                                 pre_obj)


def _assemble_interaction(scene, cfg, ray_o, ray_d, best_t, best_prim,
                          best_u, best_v, is_sphere_hit, pre_ng=None,
                          pre_obj=None, pre_final=False):
    """Interaction record from raw hit data (reference
    tracer_base.py:215-237). pre_ng/pre_obj: per-lane normal and object id
    the closest-hit kernel already read from its table. pre_final: sphere
    normals and uv are final too (the cluster tier), so the sphere block
    is skipped."""
    hit = best_prim >= 0
    prim = best_prim.clamp(min=0)
    spheres = scene.sph_center.shape[0] > 0 and not pre_final
    if pre_obj is not None:
        obj_id = pre_obj
        if spheres:
            obj_id = torch.where(is_sphere_hit, scene.prim_obj[prim],
                                 pre_obj)
    else:
        obj_id = scene.prim_obj[prim]
    obj_id = torch.where(hit, obj_id, -1)

    n_g = pre_ng if pre_ng is not None else scene.prim_ng[prim]
    if spheres:
        hit_p = ray_o + best_t[:, None] * ray_d
        n_sphere = normalize(hit_p - scene.pre0[prim])   # center in pre0
        sph_u = (torch.atan2(n_sphere[:, 1], n_sphere[:, 0]) + torch.pi) \
            * INV_2PI
        sph_v = torch.arccos(torch.clamp(n_sphere[:, 2], -1.0, 1.0)) * INV_PI
        n_g = torch.where(is_sphere_hit[:, None], n_sphere, n_g)
        best_u = torch.where(is_sphere_hit, sph_u, best_u)
        best_v = torch.where(is_sphere_hit, sph_v, best_v)

    if cfg.has_v_normal:
        vn = scene.prim_vn[prim]                          # (N,3,3)
        w0 = (1.0 - best_u - best_v)[:, None]
        n_s_tri = vn[:, 0] * w0 + vn[:, 1] * best_u[:, None] \
            + vn[:, 2] * best_v[:, None]
        # spheres / missing vertex normals fall back to n_g
        vn_ok = torch.abs(vn).sum(dim=(1, 2)) > 1e-6
        n_s = torch.where((vn_ok & ~is_sphere_hit)[:, None], n_s_tri, n_g)
        n_s = normalize(n_s)
    else:
        n_s = n_g

    default_n = axis_vec(0, ray_o.device)
    n_g = torch.where(hit[:, None], n_g, default_n)
    n_s = torch.where(hit[:, None], n_s, default_n)
    return Interaction(obj_id=obj_id.to(torch.int32),
                       prim_id=prim.to(torch.int32), t=best_t, n_g=n_g,
                       n_s=n_s, uv=torch.stack([best_u, best_v], dim=-1))


@torch.no_grad()
@obs.spanned("isect.any", _rays)
def does_intersect(scene, cfg, ray_o, ray_d, max_t=None, alive=None):
    """Boolean occlusion test (shadow rays): any hit strictly before max_t.
    Dead lanes (alive False) come back un-occluded."""
    far = kernels.far_bound(ray_o, max_t, alive)
    if _bvh_tier(scene, cfg):
        any_hit = {"bvh": bvh_kernels.bvh_any_hit,
                   "sweep": cluster_kernels.cluster_any_hit,
                   "qpick": cluster_kernels.qpick_any}[cfg.big_tier]
        return any_hit(scene, ray_o, ray_d, far)
    occluded = torch.zeros(ray_o.shape[0], dtype=torch.bool,
                           device=ray_o.device)
    if scene.tri_n.shape[0] > 0:
        occluded |= kernels.tri_any_hit(scene, ray_o, ray_d, far)
    if scene.sph_center.shape[0] > 0:
        ts = _sphere_hit(ray_o, ray_d, scene.sph_center, scene.sph_radius)
        occluded |= ((ts > RAY_EPS) & (ts < far[:, None])).any(dim=1)
    return occluded


def _is_null_obj(scene, obj_id):
    """Null BSDF flag per object id (medium boundary, bsdf.py:238-240)."""
    idx = obj_id.clamp(min=0)
    return (obj_id >= 0) & scene.mat_is_bsdf[idx] & (scene.mat_type[idx] < 0)


@obs.spanned("isect.track", _rays)
@torch.no_grad()
def ray_track_hits(scene, cfg, ray_o, ray_d, max_t, alive=None, K=2,
                   all_null=False):
    """Everything a media walk needs along each ray, in one batch: the
    closest blocking (non-null) hit and the first K null medium
    interfaces in front of it (port of adapt_tpu/ops/intersect.py:643-763).

    Triangles go through kernel B3 (intersect_kernels.tri_track_hits);
    spheres merge in here: null spheres contribute both quadratic roots
    (the walk sees entry, then exit), non-null spheres tighten the
    blocker. Lanes with more than K null interfaces before the blocker
    raise `overflow`, and the caller re-walks them sequentially, so any
    K >= 1 is exact. all_null treats every prim as an interface (no
    blocker): the plain first-K-interfaces extraction of `ray_k_hits`.

    Returns (t_null (K,N), obj_null (K,N), dn_null (K,N), t_blk (N,),
    obj_blk (N,), dn_blk (N,), overflow (N,)); empty null slots are
    FAR / -1 / 0 and valid ones a prefix; dn = dot(n_g, d). Only for the
    brute-force tier with triangles, as the JAX package keeps it to its
    Pallas tier."""
    if _bvh_tier(scene, cfg) or scene.tri_n.shape[0] == 0:
        raise ValueError("ray_track_hits serves the brute-force tier of a "
                         "scene with triangles")
    far0 = kernels.far_bound(ray_o, max_t, alive)
    S = scene.sph_center.shape[0]
    tn_, on_, dn_, tb, ob, db, ovf = kernels.tri_track_hits(
        scene, ray_o, ray_d, far0, K, all_null)
    if S == 0:
        return tn_, on_, dn_, tb, ob, db, ovf

    # sphere roots: reference quadratic (tracer_base.py:183-198)
    N = ray_o.shape[0]
    s2c = scene.sph_center[None, :, :] - ray_o[:, None, :]       # (N,S,3)
    cn2 = dot(s2c, s2c)
    proj = dot(ray_d[:, None, :], s2c)
    r2 = (scene.sph_radius * scene.sph_radius)[None, :]
    c2r = cn2 - proj * proj
    hit_disc = c2r < r2
    cut = torch.sqrt(torch.clamp(r2 - c2r, min=0.0))
    r_safe = torch.clamp(scene.sph_radius, min=1e-12)[None, :]
    sph_obj = scene.prim_obj[scene.sph_gid]
    sph_null = torch.ones(S, dtype=torch.bool, device=ray_o.device) \
        if all_null else _is_null_obj(scene, sph_obj)
    roots_t, roots_dn = [], []
    for sign in (-1.0, 1.0):
        t_s = proj + sign * cut                                   # (N,S)
        roots_t.append(torch.where(hit_disc & (t_s > RAY_EPS), t_s, FAR))
        roots_dn.append((t_s - proj) / r_safe)
    sph_obj_rows = sph_obj[:, None].expand(S, N)

    def pick(cand, objs, dns):
        """(t, obj, dn) of the smallest of the (M, N) candidates below
        far0, ties to the lowest row, and the min itself (FAR when none)."""
        best, row, found = kernels._pick(cand.T)
        hit = found & (best < far0)
        o = objs.gather(0, row[None])[0]
        d = dns.gather(0, row[None])[0] + 0.0
        return (torch.where(hit, best, FAR),
                torch.where(hit, o, -1).to(torch.int32),
                torch.where(hit, d, 0.0)), best

    # non-null spheres tighten the blocker (their first valid root)
    if not all_null:
        bt = torch.cat([tb[None]] + [torch.where(sph_null[None, :], FAR,
                                                 rt).T for rt in roots_t])
        (tb, ob, db), _ = pick(bt, torch.cat([ob[None], sph_obj_rows,
                                              sph_obj_rows]),
                               torch.cat([db[None]] + [r.T for r in roots_dn]))

    # null sphere roots merge into the interface chain
    t_cut = torch.minimum(tb, far0)
    mt = torch.cat([torch.where(tn_ < t_cut[None], tn_, FAR)]
                   + [torch.where(sph_null[None, :] & (rt < t_cut[:, None]),
                                  rt, FAR).T for rt in roots_t])  # (M,N)
    mobj = torch.cat([on_, sph_obj_rows, sph_obj_rows])
    mdn = torch.cat([dn_] + [r.T for r in roots_dn])
    outs = []
    prev = torch.zeros(N, device=ray_o.device)
    for _k in range(K):
        slot, best = pick(torch.where(mt > prev[None], mt, FAR), mobj, mdn)
        outs.append(slot)
        prev = best + kernels.CHAIN_SEP
    rem = torch.where(mt > prev[None], mt, FAR).amin(dim=0)
    ovf = ovf | ((rem < far0) & (rem < FAR))
    t_k, o_k, d_k = (torch.stack(x) for x in zip(*outs))
    return t_k, o_k, d_k, tb, ob, db, ovf


@torch.no_grad()
def ray_k_hits(scene, cfg, ray_o, ray_d, max_t, alive=None, K=7):
    """First K surface interfaces along each ray, front to back: the
    all-null case of ray_track_hits (every prim an interface). Returns
    (t, obj, dn), each (K, N)."""
    tn_, on_, dn_, _tb, _ob, _db, _ovf = ray_track_hits(
        scene, cfg, ray_o, ray_d, max_t, alive=alive, K=K, all_null=True)
    return tn_, on_, dn_
