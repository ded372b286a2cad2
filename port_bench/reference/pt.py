"""Plain unidirectional path tracing (next-event estimation, Russian
roulette) of chosen pixels over chosen progressive passes: the
benchmark's reference for the film of the PT cells.

The estimator is the one the renderer documents (its README and module
docstrings): one camera ray a pixel a pass, jittered in a 4 x 4 stratum
by the pass count; per bounce D = 7 + 4 * max(shadow rays, 1) uniforms
keyed by (pass key, bounce, pixel); Russian roulette on uniform 0 from
bounce 4 on when the throughput's largest channel falls below 0.1; the
material's sample on uniforms 1-6 (cosine-weighted for lambertian, the
Fresnel blend's half vector or its lambertian lobe, the dielectric's
Fresnel choice) drawn before the light samples; each shadow ray's light
picked uniformly on uniform 7 + 4 s; the radiance summed over max_bounce
bounces and accumulated pass by pass into the film. Each
pass's keys come from the renderer's seed by the documented chain
(key, sub = split(key) a pass; trace key, camera key = split(sub)).

Every (pixel, pass) lane is independent, so any set of them can be traced
in one batch. Intersections test every triangle, or on the tree tier
every triangle of the blocks whose boxes a ray enters; ties in t go to the
lowest row (where the renderer's BVH takes the first in its walk: equal t
on two triangles happens only on a shared edge). `dtype` is the precision of every float the reference keeps:
float32 is the reference, bfloat16 its control.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import rng
from .scene import FRESNEL_BLEND, GLASS, LAMBERTIAN, POINT, Scene, \
    triangle_tables

RAY_EPS = 1e-4
FAR = 1e7
DEAD = -3e38
INV_PI = 1.0 / math.pi
PI2 = 2.0 * math.pi
PAIRS = 1 << 23        # (lane, triangle) pairs a chunk of the hit tests
BOXES = 1 << 25        # (lane, block) pairs a chunk of the tree tier's boxes


def dot(a, b, keepdims=False):
    p = a * b
    s = (p[..., 0] + p[..., 1]) + p[..., 2]
    return s[..., None] if keepdims else s


def normalize(v):
    return v / torch.clamp(torch.sqrt(dot(v, v, True)), min=1e-12)


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def to_frame(n, local):
    """`local` (y up) rotated into the frame whose y axis is n: the
    rotation taking +y to n (Rodrigues), applied directly."""
    y = torch.zeros_like(n)
    y[:, 1] = 1.0
    axis = cross(y, n)
    cos_t = dot(y, n, True)
    a2 = dot(axis, axis, True)
    k = axis / torch.clamp(torch.sqrt(torch.where(a2 == 0.0, 1.0, a2)),
                           min=1e-12)
    out = (local * cos_t + cross(axis, local)
           + k * dot(k, local, True) * (1.0 - cos_t))
    return torch.where(torch.abs(cos_t) >= 1.0 - 1e-5,
                       torch.sign(cos_t) * local, out)


def walks_a_tree(T):
    """The renderer tests every triangle against every ray up to 256
    triangles; above, it walks a BVH, whose triangle test takes the
    barycentrics from the hit point (dot(o + t d, U) - cu) instead of from
    two dot products (dot(o, U) + t dot(d, U) - cu). The two round
    differently, so the reference takes the tier's test."""
    return T > 256


class Tables:
    """The scene's arrays on `device` in `dtype`. On the tree tier the
    triangles are cut into blocks of BLOCK consecutive rows, each with its
    bounding box, so a ray tests only the rows of the boxes it crosses."""

    BLOCK = 128

    def __init__(self, scene: Scene, device, dtype):
        def t(x, dt=dtype):
            return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dt)
        self.geo = t(triangle_tables(scene.prims))
        self.tree = walks_a_tree(scene.prims.shape[0])
        if self.tree:
            T, K = scene.prims.shape[0], self.BLOCK
            B = -(-T // K)
            corners = np.concatenate(
                [scene.prims, np.repeat(scene.prims[-1:], B * K - T, 0)])
            corners = corners.reshape(B, K * 3, 3)
            pad = 1e-3 * (1.0 + np.abs(corners).max())
            self.box_lo = t(corners.min(axis=1) - pad)
            self.box_hi = t(corners.max(axis=1) + pad)
        self.n_g = t(scene.n_g)
        self.vn = t(scene.vn)
        self.uv = t(scene.uv)
        self.obj = t(scene.obj, torch.int64)
        self.kind = t(scene.kind, torch.int64)
        self.kinds = sorted(set(scene.kind.tolist()))
        self.kd, self.ks, self.kg = t(scene.kd), t(scene.ks), t(scene.kg)
        self.ior = t(scene.ior)
        self.world_ior = t(scene.world_ior)
        self.light_kind = t(scene.light_kind, torch.int64)
        self.light_kinds = sorted(set(scene.light_kind.tolist()))
        self.light_pos = t(scene.light_pos)
        self.light_int = t(scene.light_int)
        self.light_dir = t(scene.light_dir)
        self.light_cos = t(scene.light_cos)
        self.textured = bool(scene.tex[:, 0].any())
        self.tex = t(scene.tex)
        self.atlas = t(scene.atlas)
        self.cam_t = t(scene.cam_t)
        self.cam_r = t(scene.cam_r)


def _hit_tables(geo, ro, rd):
    """(n, T) t/u/v/valid of every (ray, row) pair."""
    def d3(vec, c):
        return (vec[:, 0:1] * geo[:, c] + vec[:, 1:2] * geo[:, c + 1]) \
            + vec[:, 2:3] * geo[:, c + 2]
    o_n, d_n = d3(ro, 0), d3(rd, 0)
    flat = torch.abs(d_n) < 1e-12
    t = (geo[:, 3] - o_n) / torch.where(flat, 1e-12, d_n)
    u = d3(ro, 4) + t * d3(rd, 4) - geo[:, 7]
    v = d3(ro, 8) + t * d3(rd, 8) - geo[:, 11]
    valid = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > RAY_EPS) & ~flat
    return t, u, v, valid


def _pair_tests(rows, ro, rd):
    """t/u/v/valid of ray i against row i (the tree tier's test)."""
    def d3(x, y):
        return (x[:, 0] * y[:, 0] + x[:, 1] * y[:, 1]) + x[:, 2] * y[:, 2]
    o_n, d_n = d3(ro, rows[:, 0:3]), d3(rd, rows[:, 0:3])
    flat = torch.abs(d_n) < 1e-12
    t = (rows[:, 3] - o_n) / torch.where(flat, 1e-12, d_n)
    p = ro + t[:, None] * rd
    u = d3(p, rows[:, 4:7]) - rows[:, 7]
    v = d3(p, rows[:, 8:11]) - rows[:, 11]
    valid = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > RAY_EPS) & ~flat
    return t, u, v, valid


def _candidates(tab, ro, rd, far):
    """Batches of (lane, row) pairs, at most PAIRS a batch: the rows of
    every block whose box the lane's ray enters before far (a NaN in the
    slab test keeps the block)."""
    K, B = tab.BLOCK, tab.box_lo.shape[0]
    step = max(1, BOXES // B)
    live = torch.nonzero(far > RAY_EPS).squeeze(1)
    for s in range(0, live.shape[0], step):
        ids = live[s:s + step]
        o, inv = ro[ids, None], 1.0 / rd[ids, None]
        t1 = (tab.box_lo[None] - o) * inv
        t2 = (tab.box_hi[None] - o) * inv
        near = torch.minimum(t1, t2).amax(dim=-1)
        fa = torch.maximum(t1, t2).amin(dim=-1)
        enter = ((fa >= near.clamp(min=0.0)) & (near < far[ids, None])) \
            | torch.isnan(near) | torch.isnan(fa)
        lane, blk = torch.nonzero(enter, as_tuple=True)
        for c in range(0, lane.shape[0], PAIRS // K):
            ln, bk = lane[c:c + PAIRS // K], blk[c:c + PAIRS // K]
            rows = (bk[:, None] * K
                    + torch.arange(K, device=ro.device)).reshape(-1)
            ln = ids[ln].repeat_interleave(K)
            keep = rows < tab.geo.shape[0]
            yield ln[keep], rows[keep]


def _tree_closest(tab, ro, rd, far):
    """The nearest hit, ties to the lowest row: the least (t, row) key,
    t's bits above the row (t > 0, so its bits order as it does)."""
    L, T = ro.shape[0], tab.geo.shape[0]
    key = torch.full((L,), torch.iinfo(torch.int64).max, dtype=torch.int64,
                     device=ro.device)
    for lane, rows in _candidates(tab, ro, rd, far):
        t, _u, _v, valid = _pair_tests(tab.geo[rows], ro[lane], rd[lane])
        ok = valid & (t < far[lane])
        bits = t[ok].float().view(torch.int32).long()
        key.scatter_reduce_(0, lane[ok], (bits << 32) | rows[ok], "amin")
    hit = key < torch.iinfo(torch.int64).max
    row = torch.where(hit, key & 0xFFFFFFFF, 0)
    t, u, v, _ = _pair_tests(tab.geo[row], ro, rd)
    return (torch.where(hit, t, far), torch.where(hit, row, -1),
            torch.where(hit, u, 0.0), torch.where(hit, v, 0.0))


def _tree_occluded(tab, ro, rd, far):
    occ = torch.zeros(ro.shape[0], dtype=torch.bool, device=ro.device)
    for lane, rows in _candidates(tab, ro, rd, far):
        t, _u, _v, valid = _pair_tests(tab.geo[rows], ro[lane], rd[lane])
        occ[lane[valid & (t < far[lane])]] = True
    return occ


def closest(tab, ro, rd, far):
    """Per lane: (t, row or -1, u, v) of the nearest triangle hit before
    `far`, ties to the lowest row; t = far on a miss."""
    if tab.tree:
        return _tree_closest(tab, ro, rd, far)
    T = tab.geo.shape[0]
    step = max(1, PAIRS // T)
    out = []
    for s in range(0, ro.shape[0], step):
        t, u, v, valid = _hit_tables(tab.geo, ro[s:s + step], rd[s:s + step])
        tm = torch.where(valid, t, FAR)
        best = tm.amin(dim=1)
        rows = torch.arange(T, device=tm.device)
        row = torch.where(tm == best[:, None], rows, T).amin(dim=1)
        hit = best < far[s:s + step]
        pick = row[:, None].clamp(max=T - 1)
        out.append((torch.where(hit, best, far[s:s + step]),
                    torch.where(hit, row, -1),
                    torch.where(hit, u.gather(1, pick)[:, 0], 0.0),
                    torch.where(hit, v.gather(1, pick)[:, 0], 0.0)))
    return [torch.cat(x) for x in zip(*out)]


def occluded(tab, ro, rd, far):
    if tab.tree:
        return _tree_occluded(tab, ro, rd, far)
    T = tab.geo.shape[0]
    step = max(1, PAIRS // T)
    out = []
    for s in range(0, ro.shape[0], step):
        t, _u, _v, valid = _hit_tables(tab.geo, ro[s:s + step],
                                       rd[s:s + step])
        out.append((valid & (t < far[s:s + step, None])).any(dim=1))
    return torch.cat(out)


def _bilinear(atlas, x, y):
    H, W = atlas.shape[0], atlas.shape[1]
    x0, y0 = torch.floor(x), torch.floor(y)
    rx, ry = (x - x0)[:, None], (y - y0)[:, None]
    x0i = x0.to(torch.int32).clamp(0, W - 1).long()
    y0i = y0.to(torch.int32).clamp(0, H - 1).long()
    x1i, y1i = (x0i + 1).clamp(0, W - 1), (y0i + 1).clamp(0, H - 1)
    top = atlas[y0i, x0i] * (1.0 - rx) + atlas[y0i, x1i] * rx
    bot = atlas[y1i, x0i] * (1.0 - rx) + atlas[y1i, x1i] * rx
    return top * (1.0 - ry) + bot * ry


def _albedo(tab, obj, row, u, v):
    """The albedo texture's color at each hit, -1 where the object has
    none or the ray missed: the vertex uvs interpolated at the hit,
    wrapped to [0, size - 1), a bilinear tap in the atlas."""
    uvc = tab.uv[row]
    w0 = (1.0 - u - v)[:, None]
    tuv = uvc[:, 1] * u[:, None] + uvc[:, 2] * v[:, None] + uvc[:, 0] * w0
    rec = tab.tex[obj.clamp(min=0)]
    valid = (obj >= 0) & (rec[:, 0] > 0.0)
    w = torch.clamp(rec[:, 1], min=2.0)
    h = torch.clamp(rec[:, 2], min=2.0)
    x = torch.remainder(tuv[:, 0] * 1.0 * w, w - 1.0) + rec[:, 3]
    y = torch.remainder(tuv[:, 1] * 1.0 * h, h - 1.0) + rec[:, 4]
    return torch.where(valid[:, None], _bilinear(tab.atlas, x, y), -1.0)


def surface(scene, tab, ro, rd, far):
    """The closest hits: {t, hit, obj, n_g, n_s, tex}; the shading normal
    interpolates the vertex normals where the mesh has them, tex is the
    albedo texture's color (None when no object has one)."""
    t, row, u, v = closest(tab, ro, rd, far)
    hit = row >= 0
    r = row.clamp(min=0)
    x_axis = torch.zeros_like(ro)
    x_axis[:, 0] = 1.0
    n_g = torch.where(hit[:, None], tab.n_g[r], x_axis)
    n_s = n_g
    if scene.has_vn:
        vn = tab.vn[r]
        w0 = (1.0 - u - v)[:, None]
        n_v = vn[:, 0] * w0 + vn[:, 1] * u[:, None] + vn[:, 2] * v[:, None]
        ok = torch.abs(vn).sum(dim=(1, 2)) > 1e-6
        n_s = normalize(torch.where(ok[:, None], n_v, tab.n_g[r]))
        n_s = torch.where(hit[:, None], n_s, x_axis)
    obj = torch.where(hit, tab.obj[r], -1)
    tex = _albedo(tab, obj, r, u, v) if tab.textured else None
    return dict(t=t, hit=hit, obj=obj, n_g=n_g, n_s=n_s, tex=tex)


# --- materials: what a hit's BxDF returns for a pair of directions
# (incid into the surface, out away from it), and its sample ---

def _albedo_or_kd(m, sf):
    if sf["tex"] is None:
        return m["kd"]
    return torch.where((sf["tex"][:, 0] >= 0.0)[:, None], sf["tex"], m["kd"])


def _lambert_eval(m, sf, out):
    cos_t = torch.clamp(dot(sf["n_s"], out), min=0.0)
    return _albedo_or_kd(m, sf) * INV_PI * cos_t[:, None]


def _reflect(ray, normal):
    d = dot(ray, normal, True)
    return normalize(ray - 2.0 * normal * d), d[..., 0]


def _blend_azimuth(half, n, dot_half):
    """cos^2 and sin^2 of the half vector's azimuth about n, measured
    from n's frame's x axis."""
    x_axis = torch.zeros_like(half)
    x_axis[:, 0] = 1.0
    proj = normalize(half - dot_half[:, None] * n)
    cos_phi2 = dot(to_frame(n, x_axis), proj) ** 2
    return cos_phi2, 1.0 - cos_phi2


def _blend_eval(m, sf, incid, out):
    """Ashikhmin-Shirley's anisotropic Fresnel blend, cosine-weighted;
    kg = (n_u, n_v, sqrt((n_u + 1)(n_v + 1)) / 8 pi)."""
    n = sf["n_s"]
    half = out - incid
    dot_out = dot(n, out)
    ok = (dot_out > 0.0) & (torch.abs(half).amax(dim=-1) > 1e-4)
    half = normalize(half)
    dot_in = -dot(n, incid)
    dot_half = torch.abs(dot(n, half))
    dot_hk = torch.abs(dot(half, out))
    ks, kg = m["ks"], m["kg"]
    fresnel = ks + (1.0 - ks) * torch.pow(1.0 - dot_hk, 5.0)[:, None]
    cos_phi2, sin_phi2 = _blend_azimuth(half, n, dot_half)
    denom = torch.clamp(dot_hk * torch.maximum(dot_in, dot_out), min=1e-9)
    specular = kg[:, 2:3] * torch.pow(
        dot_half[:, None], (kg[:, 0] * cos_phi2 + kg[:, 1] * sin_phi2)
        [:, None]) * fresnel / denom[:, None]
    diffuse = 28.0 / (23.0 * math.pi) * _albedo_or_kd(m, sf) * (1.0 - ks)
    p_in = torch.pow(1.0 - dot_in / 2.0, 5.0)
    p_out = torch.pow(1.0 - dot_out / 2.0, 5.0)
    diffuse = diffuse * ((1.0 - p_in) * (1.0 - p_out))[:, None]
    return torch.where(ok[:, None], (specular + diffuse) * dot_out[:, None],
                       0.0)


def _blend_half(u1, u2, nu, nv):
    """The Fresnel blend's half-vector sample (y up) and its exponent."""
    e = u1 * 4.0
    inner = e - torch.floor(e)
    tan_phi = torch.sqrt((nu + 1.0) / (nv + 1.0)) \
        * torch.tan(0.5 * math.pi * inner)
    cos_phi2 = 1.0 / (1.0 + tan_phi * tan_phi)
    sin_phi2 = 1.0 - cos_phi2
    cos_phi = torch.sqrt(cos_phi2)
    cos_phi = torch.where((e > 1.0) & (e <= 3.0), -cos_phi, cos_phi)
    sin_phi = torch.sqrt(sin_phi2) * torch.sign(2.0 - e)
    power = nu * cos_phi2 + nv * sin_phi2
    cos_t = torch.pow(1.0 - u2, 1.0 / (power + 1.0))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    return torch.stack([cos_phi * sin_t, cos_t, sin_phi * sin_t], -1), power


def _glass_terms(m, sf, d, world_ior):
    """What the dielectric shares for direction d: its cosine, total
    internal reflection, the mirror and Snell directions, the Fresnel
    reflectance (unpolarized)."""
    n = sf["n_s"]
    dot_n = dot(d, n)
    entering = dot_n < 0.0
    ni = torch.where(entering, world_ior, m["ior"])
    nr = torch.where(entering, m["ior"], world_ior)
    mirror = normalize(d - 2.0 * n * dot_n[:, None])
    ratio = ni / nr
    cos_r2 = 1.0 - ratio * ratio * (1.0 - dot_n * dot_n)
    sq = torch.sqrt(torch.clamp(cos_r2, min=0.0))
    ratio1 = (ni / nr) * torch.ones_like(dot_n)
    refr = normalize(ratio1[:, None] * d - (ratio1 * dot_n - torch.sign(dot_n)
                                            * sq)[:, None] * n)
    refr = torch.where((cos_r2 > 0.0)[:, None], refr, 0.0)
    ci = torch.abs(dot_n)
    n1ci, n2ci, n1cr, n2cr = ni * ci, nr * ci, ni * sq, nr * sq
    rs = (n1ci - n2cr) / torch.clamp(torch.abs(n1ci + n2cr), min=1e-12) \
        * torch.sign(n1ci + n2cr)
    rp = (n1cr - n2ci) / torch.clamp(torch.abs(n1cr + n2ci), min=1e-12) \
        * torch.sign(n1cr + n2ci)
    return cos_r2 < 0.0, mirror, refr, 0.5 * (rs * rs + rp * rp)


def bxdf_eval(tab, m, sf, incid, out):
    """f cos of each lane's material for (incid, out)."""
    n_g = sf["n_g"]
    same = dot(incid, n_g) * dot(out, n_g) < 0.0
    res = torch.zeros_like(m["kd"])
    for k in tab.kinds:
        if k == LAMBERTIAN:
            val = torch.where(same[:, None], _lambert_eval(m, sf, out), 0.0)
        elif k == FRESNEL_BLEND:
            val = torch.where(same[:, None], _blend_eval(m, sf, incid, out),
                              0.0)
        else:
            total, mirror, refr, F = _glass_terms(m, sf, out, tab.world_ior)
            base = _albedo_or_kd(m, sf)
            near_refl = dot(mirror, incid) > 1.0 - 1e-4
            val = torch.where(
                total[:, None],
                torch.where((dot(mirror, incid) > 1.0 - 5e-5)[:, None],
                            base, 0.0),
                torch.where((dot(refr, incid) > 1.0 - 1e-4)[:, None],
                            base * ((1.0 - F) * 1.0)[:, None],
                            torch.where(near_refl[:, None],
                                        base * F[:, None], 0.0)))
        res = torch.where((m["kind"] == k)[:, None], val, res)
    return res


def bxdf_sample(tab, m, sf, incid, u):
    """(direction, f cos, pdf) of each lane's material; u: (L,6)."""
    n = sf["n_s"]
    cos_t = torch.sqrt(u[:, 0])
    phi = PI2 * u[:, 1]
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    lam_dir = to_frame(n, torch.stack([torch.cos(phi) * sin_t, cos_t,
                                       torch.sin(phi) * sin_t], dim=-1))
    lam_pdf = cos_t * INV_PI
    out = torch.zeros_like(incid)
    out[:, 1] = 1.0
    spec = torch.ones_like(m["kd"])
    pdf = torch.ones_like(lam_pdf)
    for k in tab.kinds:
        if k == LAMBERTIAN:
            t_dir, t_spec, t_pdf = lam_dir, _lambert_eval(m, sf, lam_dir), \
                lam_pdf
        elif k == FRESNEL_BLEND:
            local, power = _blend_half(u[:, 2], u[:, 3], m["kg"][:, 0],
                                       m["kg"][:, 1])
            half = to_frame(n, local)
            mirror, d_in = _reflect(incid, half)
            half_pdf = m["kg"][:, 2] * torch.pow(
                torch.clamp(dot(half, n), min=0.0), power)
            spec_pdf = half_pdf / torch.clamp(torch.abs(d_in), min=1e-7)
            t_dir = torch.where((u[:, 4] > 0.5)[:, None], lam_dir, mirror)
            t_pdf = 0.5 * (spec_pdf + torch.abs(dot(t_dir, n)) * INV_PI)
            t_spec = torch.where((dot(n, mirror) > 0.0)[:, None],
                                 _blend_eval(m, sf, incid, t_dir), 0.0)
        else:
            total, mirror, refr, F = _glass_terms(m, sf, incid,
                                                  tab.world_ior)
            refract = ~total & (u[:, 0] > F)
            t_dir = torch.where(refract[:, None], refr, mirror)
            t_pdf = torch.where(total, 1.0, torch.where(refract, 1.0 - F, F))
            t_spec = _albedo_or_kd(m, sf) \
                * torch.where(refract, 1.0, 1.0)[:, None] * t_pdf[:, None]
        sel = (m["kind"] == k)[:, None]
        if k != GLASS:
            # a BRDF's sample never leaves below the geometric surface
            t_spec = torch.where((dot(t_dir, sf["n_g"]) <= 0.0)[:, None],
                                 0.0, t_spec)
        out = torch.where(sel, t_dir, out)
        spec = torch.where(sel, t_spec, spec)
        pdf = torch.where(sel[:, 0], t_pdf, pdf)
    return out, spec, pdf


def light_sample(tab, eid, p):
    """(position, intensity) of light eid toward p: a point light's
    intensity falls as 1/d^2 (capped at 1), a spot's as 1/d^2 inside its
    cone and is 0 outside."""
    e_pos, e_int = tab.light_pos[eid], tab.light_int[eid]
    kind = tab.light_kind[eid]
    out = e_int
    for k in tab.light_kinds:
        to_hit = p - e_pos
        if k == POINT:
            atten = torch.clamp(
                1.0 / torch.clamp(dot(to_hit, to_hit), min=1e-5), max=1.0)
            val = e_int * atten[:, None]
        else:
            depth = torch.clamp(torch.sqrt(dot(to_hit, to_hit)), min=1e-5)
            inside = dot(to_hit / depth[:, None], tab.light_dir[eid]) \
                > tab.light_cos[eid]
            val = torch.where(inside[:, None],
                              e_int / (depth * depth)[:, None], 0.0)
        out = torch.where((kind == k)[:, None], val, out)
    return e_pos, out


def pass_keys(seed: int, passes: int):
    """[(trace key, camera key)] of passes 1..passes of a renderer made
    with `seed`."""
    k = rng.key(seed)
    out = []
    for _ in range(passes):
        k, sub = rng.split(k)
        out.append(tuple(rng.split(sub)))
    return out


def trace(scene: Scene, tab: Tables, keys, cnt, pix, dtype):
    """Radiance (L,3) of lanes (pass, pixel): keys (trace key, camera
    key) as four (L,) int64 word tensors, cnt (L,) the pass counts, pix
    (L,) flat pixel ids (x-major: i * h + j)."""
    st = scene.settings
    tk1, tk2, ck1, ck2 = keys
    dev = pix.device
    L = pix.shape[0]
    w, h = scene.w, scene.h
    i = torch.div(pix, h, rounding_mode="floor").to(dtype)
    j = (pix % h).to(dtype)
    if st["anti_alias"]:
        u0 = rng.uniform_at(ck1, ck2, 2 * pix, dtype)
        u1 = rng.uniform_at(ck1, ck2, 2 * pix + 1, dtype)
        if st["stratified"]:
            m = (cnt % 16).to(torch.float64)
            vx = (torch.floor(m % 4.0) * 0.25).to(dtype) + u0 * 0.25
            vy = (torch.floor(m / 4.0) * 0.25).to(dtype) + u1 * 0.25
        else:
            vx = u0 * (1.0 - 2e-4) + 1e-4
            vy = u1 * (1.0 - 2e-4) + 1e-4
    else:
        vx = torch.full((L,), 0.5, device=dev, dtype=dtype)
        vy = vx
    inv_f = 1.0 / float(scene.focal)
    nd = normalize(torch.stack([(0.5 * w + vx - i) * inv_f,
                                (j - 0.5 * h - vy) * inv_f,
                                torch.ones(L, device=dev, dtype=dtype)], -1))
    r = tab.cam_r
    ray_d = torch.stack([(nd[:, 0] * r[k, 0] + nd[:, 1] * r[k, 1])
                         + nd[:, 2] * r[k, 2] for k in range(3)], dim=-1)
    ray_o = tab.cam_t.expand(L, 3)

    n_sr = st["num_shadow_ray"]
    D = 7 + 4 * max(n_sr, 1)
    far = torch.full((L,), FAR, device=dev, dtype=dtype)
    sf = surface(scene, tab, ray_o, ray_d, far)
    color = torch.zeros((L, 3), device=dev, dtype=dtype)
    contribution = torch.ones((L, 3), device=dev, dtype=dtype)
    active = torch.ones(L, dtype=torch.bool, device=dev)
    jj = torch.arange(D, device=dev)[None, :]
    E = tab.light_pos.shape[0]
    for b in range(st["max_bounce"]):
        active = active & sf["hit"]
        fk1, fk2 = rng.fold_in((tk1, tk2), b)
        lk1, lk2 = rng.fold_in((fk1, fk2), pix)
        u = rng.uniform_at(lk1[:, None], lk2[:, None], jj, dtype)
        max_val = contribution.amax(dim=-1)
        if st["use_rr"]:
            cand = (max_val < st["rr_threshold"]) & (b >= st["rr_bounce_th"])
            killed = cand & (u[:, 0] > max_val)
            boost = torch.where(cand, 1.0 / (max_val + 1e-7), 1.0)
            contribution = contribution * boost[:, None]
            active = active & ~killed
        else:
            active = active & (max_val >= 1e-4)
        p = ray_o + torch.where(active, sf["t"], 0.0)[:, None] * ray_d
        o = sf["obj"].clamp(min=0)
        m = dict(kind=tab.kind[o], kd=tab.kd[o], ks=tab.ks[o], kg=tab.kg[o],
                 ior=tab.ior[o])

        # the continuation is drawn before the light samples
        new_d, spec, pdf = bxdf_sample(tab, m, sf, ray_d, u[:, 1:7])

        direct = torch.zeros((L, 3), device=dev, dtype=dtype)
        for s in range(n_sr):
            eid = torch.clamp((u[:, 7 + 4 * s] * E).to(torch.int32),
                              max=E - 1).long()
            e_pos, l_int = light_sample(tab, eid, p)
            to_l = e_pos - p
            dist = torch.sqrt(dot(to_l, to_l))
            l_dir = to_l / torch.clamp(dist[:, None], min=1e-12)
            s_far = torch.where(active, torch.where(dist > 0.0,
                                                    dist - RAY_EPS, FAR),
                                DEAD)
            blocked = occluded(tab, p, l_dir, s_far)
            f = bxdf_eval(tab, m, sf, ray_d, l_dir)
            # every light is a delta in position: no MIS weight; the pick's
            # pdf is 1/E
            weight = torch.ones_like(dist) \
                / torch.full_like(dist, 1.0 / E)
            contrib = f * l_int * weight[:, None]
            direct = direct + torch.where((~blocked)[:, None], contrib, 0.0)
        direct = direct / float(max(n_sr, 1))
        color = color + torch.where(active[:, None], direct * contribution,
                                    0.0)
        if b == st["max_bounce"] - 1:
            break
        contribution = contribution * spec \
            / torch.clamp(pdf, min=1e-9)[:, None]
        sf = surface(scene, tab, p, new_d,
                     torch.where(active, FAR, DEAD).to(dtype))
        ray_o, ray_d = p, new_d
    return torch.nan_to_num(color, nan=0.0)


def film(scene: Scene, seed: int, passes: int, pix: torch.Tensor,
         dtype=torch.float32, lanes: int = 1 << 18):
    """(S,3) float32: the film of pixels `pix` (flat ids, on the device
    the reference runs on) after `passes` progressive passes of a
    renderer made with `seed`, summed pass by pass in order, in batches of
    about `lanes` (pixel, pass) lanes."""
    dev = pix.device
    tab = Tables(scene, dev, dtype)
    keys = pass_keys(seed, passes)
    S = pix.shape[0]
    acc = torch.zeros((S, 3), device=dev, dtype=dtype)
    per = max(1, lanes // max(S, 1))
    for p0 in range(0, passes, per):
        ps = range(p0, min(passes, p0 + per))
        words = torch.tensor([[*keys[p][0], *keys[p][1]] for p in ps],
                             dtype=torch.int64, device=dev)
        words = words.repeat_interleave(S, dim=0)
        cnt = torch.tensor([p + 1 for p in ps], device=dev) \
            .repeat_interleave(S)
        rad = trace(scene, tab, tuple(words.T), cnt, pix.repeat(len(ps)),
                    dtype).reshape(len(ps), S, 3)
        for k in range(len(ps)):
            acc = acc + rad[k]
    return acc.float()
