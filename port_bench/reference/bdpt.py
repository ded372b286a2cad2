"""Plain bidirectional path tracing, with its time-of-flight histogram, of
chosen pixels over chosen progressive passes: the benchmark's reference
for the film of the BDPT cells (transient or steady state).

The estimator is the one the renderer documents (adapt_tpu_torch's
renderer/bdpt.py docstrings and README), written here again from that
description, strategy by strategy, in plain PyTorch:

- a pass's keys: (key, sub) = split(key) a pass, then split(sub, 4) gives
  (walk, camera subpath, light subpath, connections); the camera subpath
  key splits into (walk key, camera-ray key), the light subpath key into
  (walk key, light pick, emission);
- each walk draws, per bounce, a split for the mean free path (no media
  here: nothing is drawn from it) and 6 uniforms of a whole-wavefront
  draw (lane i's are elements 6i..6i+5), places a vertex where the lane
  still walks (its forward pdf in area measure, the time of flight so far,
  its throughput), and writes the backward pdf of the vertex before it;
  no Russian roulette, a lane stops below a throughput of 5e-5, on a miss,
  past the last time bin, or after max_bounce vertices;
- every (s, t) strategy with s + t - 2 <= max_bounce, numbered in the
  double loop over t (outer) and s: s = 0 (the camera subpath hits a
  light), t = 1 (a light vertex connected to the camera and splatted into
  the pixel it projects to, over all N light subpaths), s = 1 (a light
  sampled from a camera vertex, its pick and point from the strategy's
  own key, fold_in(connection key, its number)), and the general
  connection of two vertices, each weighted by the balance heuristic over
  the pdf ratios of both subpaths (the ratio of each end vertex and of
  the one before it recomputed for the connection), a shadow ray between
  the two ends;
- a strategy's path time is the sum of its subpaths' times and the
  connecting segment's; a transient pass bins each strategy's radiance at
  floor((time - t_min) / interval) where t_min < time < t_min + bins x
  interval and the radiance is positive, one strategy after another (the
  order the renderer takes where its groups run strategy by strategy, as
  the connection group does at 512^2: `bdpt.FLAT_MAX_CHUNKS`), t = 1 at
  its raster pixel, every other at its own.

Departures from upstream AdaPT that the renderer keeps, and so does this
reference: the camera's pdf is 0 (`pdf_camera`), so camera-side pdf chains
start at remap(0) = 1; the t = 1 connection hands the camera sample the
direction from the camera to the vertex, so only vertices behind the
camera reach the film (here: none; computed all the same, over every light
subpath); the decomposition transient_lit falls back to transient_cam in
the renderer, and this reference reads transient_cam alone; null surfaces
are skipped by the renderer, and this reference reads none (the scene
reader refuses null BSDFs); a t = 1 path's time counts the camera segment
twice (once as the connection, once as the shadow ray's propagation), as
the renderer's does.

It renders lambertian surfaces lit by point lights in a transparent
world, with no textures (`load` refuses the rest). Intersections test
every triangle (reference/pt.py). `dtype` is the precision of every float
the reference keeps: float32 is the reference, bfloat16 its control.
"""
from __future__ import annotations

import dataclasses
import math
import xml.etree.ElementTree as ET

import torch

from . import pt as ref_pt
from . import rng
from .pt import DEAD, FAR, INV_PI, RAY_EPS, dot, normalize
from .scene import LAMBERTIAN, POINT, Scene
from .scene import load as load_scene

SURFACE, EMITTER, CAMERA = 0, 2, 3
POS_DELTA, DIR_DELTA, IN_FSPACE, SPEC_DELTA = 0x01, 0x02, 0x10, 0x20
RAD, IMP = 0, 1
THP_MIN = 5e-5          # a walk stops below this throughput
CAP = 32                # the renderer's most vertices a subpath, less one
PI2 = 2.0 * math.pi


@dataclasses.dataclass
class Cell:
    """The scene with the sensor's BDPT and transient settings. `w` x `h`
    is the number of film entries: pixels x time bins of a transient
    film (an entry's flat id is pixel x bins + bin), the film's pixels
    otherwise."""
    scene: Scene
    bins: int               # time bins; 0 in steady state
    t_min: float
    interval: float
    use_mis: bool
    strategies: tuple       # (start_t, end_t, start_s, end_s)
    w: int
    h: int


def load(xml_path: str, overrides: dict) -> Cell:
    """The scene and its sensor's settings; raises on what the reference
    does not render: another decomposition than transient_cam, a world
    medium other than a transparent one, materials other than lambertian,
    lights other than points, textures (and what reference/scene.py
    refuses)."""
    sc = load_scene(xml_path, overrides)
    root = ET.parse(xml_path).getroot()
    vals = {n.get("name"): n.get("value")
            for n in root.find("sensor")
            if n.tag in ("integer", "float", "boolean", "string")}
    vals.update({k: str(v) for k, v in overrides.items()})
    world = root.find("world")
    medium = None if world is None else world.find("medium")
    if medium is not None and medium.get("type") != "transparent":
        raise NotImplementedError(f"a {medium.get('type')} world medium")
    if set(sc.kind.tolist()) != {LAMBERTIAN}:
        raise NotImplementedError("materials other than lambertian")
    if set(sc.light_kind.tolist()) != {POINT}:
        raise NotImplementedError("lights other than point lights")
    if sc.tex[:, 0].any():
        raise NotImplementedError("textures")
    decomp = vals.get("decomposition", "none")
    bins = int(vals.get("sample_count", "0")) if "decomposition" in vals \
        else 0
    if decomp not in ("none", "transient_cam"):
        raise NotImplementedError(f"decomposition {decomp}")
    if decomp == "none":
        bins = 0
    strategies = tuple(int(vals.get(k, d)) for k, d in (
        ("start_t", 1), ("end_t", 100), ("start_s", 0), ("end_s", 100)))
    n_pix = sc.w * sc.h
    return Cell(scene=sc, bins=bins,
                t_min=float(vals.get("min_time", "0.0")),
                interval=float(vals.get("interval", "1.0")),
                use_mis=vals.get("use_mis", "true").lower() == "true",
                strategies=strategies,
                w=n_pix if bins else sc.w, h=bins if bins else sc.h)


# ------------------------------ small pieces ------------------------------

def _split(k, n):
    return [rng.threefry(k[0], k[1], 0, i) for i in range(n)]


def _uniforms(k, lanes, n, dtype):
    """Lane i's n uniforms of a whole-wavefront draw uniform(k, (N, n)),
    under each lane's key k (two (L,) words)."""
    j = torch.arange(n, device=lanes.device)[None, :]
    return rng.uniform_at(k[0][:, None], k[1][:, None], lanes[:, None] * n + j,
                          dtype)


def _norm(v):
    return torch.sqrt(dot(v, v))


def _remap(x):
    return torch.where(x > 0.0, x, 1.0)


def _has_normal(v):
    return (v["n_s"] != 0.0).any(dim=-1)


def _not_delta(v):
    return (v["bits"] & SPEC_DELTA) == 0


def _connectible(v):
    surf_or_emit = (v["vtype"] == SURFACE) | (v["vtype"] == EMITTER)
    return torch.where(surf_or_emit, (v["bits"] & DIR_DELTA) == 0, True)


def _surf(v):
    """The surface record reference/pt.py's BxDFs read."""
    return {"n_s": v["n_s"], "n_g": v["n_g"], "tex": None}


def _mat(tab, obj):
    o = obj.clamp(min=0)
    return dict(kind=tab.kind[o], kd=tab.kd[o], ks=tab.ks[o], kg=tab.kg[o],
                ior=tab.ior[o])


def _lambert_pdf(n_s, out, incid):
    """Solid-angle pdf of the cosine-weighted sample for the pair (incid
    into the surface, out away from it): 0 unless they lie on opposite
    sides of the shading normal."""
    dot_out, dot_in = dot(n_s, out), dot(n_s, incid)
    return torch.where(dot_out * dot_in < 0.0, dot_out * INV_PI, 0.0)


def _eval(tab, v, out):
    """f cos at surface vertex v toward `out` (its ray in is `incid`)."""
    return ref_pt.bxdf_eval(tab, _mat(tab, v["obj"]), _surf(v), v["ray_in"],
                            out)


def _to_area(pdf_sa, at_pos, at_ns, at_has_n, from_pos):
    """A solid-angle pdf at from_pos turned into an area density at
    at_pos (cosine at at_pos where it has a normal)."""
    diff = at_pos - from_pos
    n2 = torch.clamp(dot(diff, diff), min=1e-12)
    pdf = pdf_sa / n2
    cosine = torch.abs(dot(at_ns, diff / torch.sqrt(n2)[:, None]))
    pdf = torch.where(at_has_n, pdf * cosine, pdf)
    return torch.where(pdf_sa > 0.0, pdf, 0.0)


def _pdf_point_light(cur, to_pos, to_ns, to_has_n):
    """A point light's emission pdf (uniform over the sphere) toward
    to_pos, as an area density there."""
    diff = to_pos - cur["pos"]
    inv_len = 1.0 / torch.clamp(_norm(diff), min=1e-9)
    d = diff * inv_len[:, None]
    pdf = torch.full_like(inv_len, INV_PI * 0.25)
    pdf = torch.where(to_has_n, pdf * torch.abs(dot(d, to_ns)), pdf)
    return pdf * inv_len * inv_len


def _ratio(cur, prev_pos, nxt):
    """The pdf ratio the MIS sweep takes at vertex nxt: the area density
    of sampling nxt from cur (cur's ray in from prev_pos, None: none) over
    nxt's own forward density, each remapped (0 counts as 1)."""
    ray_out = nxt["pos"] - cur["pos"]
    out_norm = _norm(ray_out)
    out_dir = ray_out / torch.clamp(out_norm, min=1e-9)[:, None]
    to_has_n = _has_normal(nxt)
    if prev_pos is None:
        ray_in = torch.zeros_like(out_dir)
    else:
        ray_in = normalize(cur["pos"] - prev_pos)
    pdf_sa = _lambert_pdf(cur["n_s"], out_dir, ray_in)
    pdf_sa = torch.where(cur["vtype"] == CAMERA, 0.0, pdf_sa)   # pdf_camera
    pdf_sa = torch.where(out_norm > 0.0, pdf_sa, 0.0)
    area = _to_area(pdf_sa, nxt["pos"], nxt["n_s"], to_has_n, cur["pos"])
    area = torch.where(cur["vtype"] == EMITTER,
                       _pdf_point_light(cur, nxt["pos"], nxt["n_s"],
                                        to_has_n), area)
    return _remap(area) / _remap(nxt["pdf_fwd"])


# --------------------------------- walks ---------------------------------

def _buffers(D, L, dev, dtype):
    buf = {k: torch.full((D, L), -1 if k in ("vtype", "obj", "emit") else 0,
                         dtype=torch.int64, device=dev)
           for k in ("vtype", "obj", "emit", "bits")}
    for k in ("pdf_fwd", "pdf_bwd", "time"):
        buf[k] = torch.zeros((D, L), dtype=dtype, device=dev)
    for k in ("n_s", "n_g", "pos", "ray_in", "beta"):
        buf[k] = torch.zeros((D, L, 3), dtype=dtype, device=dev)
    return buf


def _slot(buf, d):
    """Vertex d of every lane (d < 0 reads slot 0)."""
    return {k: v[max(d, 0)] for k, v in buf.items()}


def _put(buf, d, mask, **vals):
    for k, v in vals.items():
        old = buf[k][d]
        buf[k][d] = torch.where(mask if v.ndim == 1 else mask[:, None], v,
                                old)


def _walk(cell, tab, key, buf, lanes, ray_o, ray_d, pdf0, beta, mode,
          time0, max_bnc):
    """Continue the subpaths from slot 0 (written by the caller); returns
    their vertex counts, slot 0 included."""
    sc = cell.scene
    L, dev, dtype = lanes.shape[0], lanes.device, ray_o.dtype
    max_time = cell.t_min + cell.interval * max(cell.bins, 1)
    thp, ray_pdf = beta, pdf0
    acc_time = time0
    last_pos, prev_ns = ray_o, buf["n_s"][0]
    vnum = torch.zeros(L, dtype=torch.int64, device=dev)
    active = torch.ones(L, dtype=torch.bool, device=dev)
    sf = ref_pt.surface(sc, tab, ray_o, ray_d,
                        torch.full((L,), FAR, dtype=dtype, device=dev))
    for i in range(max_bnc):
        hit, depth, n_s, n_g = sf["hit"], sf["t"], sf["n_s"], sf["n_g"]
        active = active & hit
        in_free = ~hit | (dot(n_g, ray_d) < 0.0)
        key, _k_mfp = _split(key, 2)
        active = active & (thp.amax(dim=-1) >= THP_MIN)
        hit_point = ray_o + ray_d * depth[:, None]
        m = _mat(tab, sf["obj"])
        ior = torch.where(in_free, tab.world_ior, m["ior"])
        acc_time = acc_time + torch.where(active, depth * ior, 0.0)
        if cell.bins:
            active = active & (acc_time <= max_time)
        place = active
        pdf_fwd = _to_area(ray_pdf, hit_point, n_s, torch.ones_like(place),
                           last_pos)
        vnum = vnum + place.long()
        key, k_new = _split(key, 2)
        u = _uniforms(k_new, lanes, 6, dtype)
        new_d, spec, pdf = ref_pt.bxdf_sample(tab, m, sf, ray_d, u)
        _put(buf, i + 1, place,
             vtype=torch.full_like(vnum, SURFACE), obj=sf["obj"],
             emit=torch.full_like(vnum, -1),
             bits=torch.where(in_free, IN_FSPACE, 0), pdf_fwd=pdf_fwd,
             time=acc_time, pos=hit_point, n_s=n_s, n_g=n_g, ray_in=ray_d,
             beta=thp)
        walk_on = active & (vnum < max_bnc)
        dead = (spec.amax(dim=-1) <= 0.0) | (pdf <= 0.0)
        thp_next = thp * torch.where(
            walk_on[:, None], spec / torch.clamp(pdf, min=1e-9)[:, None],
            1.0)
        if mode == IMP:
            # the shading normal's correction of importance transport
            num = dot(n_s, new_d) * dot(n_g, ray_d)
            den = dot(n_g, new_d) * dot(n_s, ray_d)
            csn = torch.abs(num / torch.where(torch.abs(den) < 1e-9, 1e-9,
                                              den))
            thp_next = thp_next * torch.where(walk_on, csn, 1.0)[:, None]
        # the backward pdf of the vertex placed before this one
        bwd = _to_area(_lambert_pdf(n_s, -ray_d, -new_d), last_pos, prev_ns,
                       (prev_ns != 0.0).any(dim=-1), hit_point)
        _put(buf, i, place & walk_on, pdf_bwd=bwd)
        ray_pdf = pdf
        active = walk_on & ~dead
        last_pos = torch.where(place[:, None], hit_point, last_pos)
        prev_ns = torch.where(place[:, None], n_s, prev_ns)
        ray_o, ray_d, thp = hit_point, new_d, thp_next
        if i < max_bnc - 1:
            sf = ref_pt.surface(sc, tab, ray_o, ray_d, torch.where(
                active, FAR, DEAD).to(dtype))
    return vnum + 1


def camera_rays(cell, tab, key, cnt, pix, dtype):
    """Each lane's camera ray through its pixel `pix` (x-major flat ids),
    jittered in a 4 x 4 stratum by its pass count `cnt`."""
    sc = cell.scene
    st = sc.settings
    w, h = sc.w, sc.h
    L = pix.shape[0]
    i = torch.div(pix, h, rounding_mode="floor").to(dtype)
    j = (pix % h).to(dtype)
    if st["anti_alias"]:
        u = _uniforms(key, pix, 2, dtype)
        if st["stratified"]:
            m = (cnt % 16).to(torch.float64)
            vx = (torch.floor(m % 4.0) * 0.25).to(dtype) + u[:, 0] * 0.25
            vy = (torch.floor(m / 4.0) * 0.25).to(dtype) + u[:, 1] * 0.25
        else:
            vx = u[:, 0] * (1.0 - 2e-4) + 1e-4
            vy = u[:, 1] * (1.0 - 2e-4) + 1e-4
    else:
        vx = vy = torch.full((L,), 0.5, dtype=dtype, device=pix.device)
    inv_f = 1.0 / float(sc.focal)
    nd = normalize(torch.stack([(0.5 * w + vx - i) * inv_f,
                                (j - 0.5 * h - vy) * inv_f,
                                torch.ones(L, dtype=dtype,
                                           device=pix.device)], -1))
    r = tab.cam_r
    ray_d = torch.stack([(nd[:, 0] * r[k, 0] + nd[:, 1] * r[k, 1])
                         + nd[:, 2] * r[k, 2] for k in range(3)], dim=-1)
    return tab.cam_t.expand(L, 3), ray_d


def eye_paths(cell, tab, key, cnt, pix, max_bnc, dtype):
    """(buffers, vertex counts) of the camera subpaths of pixels `pix`,
    each lane under its pass's key and count."""
    dev = pix.device
    L = pix.shape[0]
    key, cam_key = _split(key, 2)
    ray_o, ray_d = camera_rays(cell, tab, cam_key, cnt, pix, dtype)
    buf = _buffers(max_bnc + 1, L, dev, dtype)
    every = torch.ones(L, dtype=torch.bool, device=dev)
    _put(buf, 0, every, vtype=torch.full((L,), CAMERA, device=dev),
         bits=torch.full((L,), POS_DELTA | IN_FSPACE, device=dev),
         pos=ray_o, beta=torch.ones_like(ray_o))
    zero = torch.zeros(L, dtype=dtype, device=dev)
    vnum = _walk(cell, tab, key, buf, pix, ray_o, ray_d, zero,
                 torch.ones_like(ray_o), RAD, zero, max_bnc)
    return buf, vnum


def light_paths(cell, tab, key, lanes, max_bnc, dtype):
    """(buffers, vertex counts) of light subpaths `lanes` (lane i's draws
    are lane i's of the renderer's whole-wavefront draws), each under its
    pass's key."""
    dev = lanes.device
    n = lanes.shape[0]
    key, k_pick, k_le = _split(key, 3)
    E = tab.light_pos.shape[0]
    u_pick = _uniforms(k_pick, lanes, 1, dtype)[:, 0]
    eid = torch.clamp((u_pick * E).to(torch.int32), max=E - 1).long()
    u_le = _uniforms(k_le, lanes, 5, dtype)
    # a point light emits uniformly over the sphere
    cos_t = 2.0 * u_le[:, 0] - 1.0
    phi = PI2 * u_le[:, 1]
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    ray_d = torch.stack([torch.cos(phi) * sin_t, cos_t,
                         torch.sin(phi) * sin_t], dim=-1)
    pdf_dir = torch.full_like(cos_t, 0.25 / math.pi)
    ray_o = tab.light_pos[eid]
    inten = tab.light_int[eid]
    vertex_pdf = torch.ones_like(cos_t) * torch.full_like(cos_t, 1.0 / E)
    buf = _buffers(max_bnc + 1, n, dev, dtype)
    _put(buf, 0, torch.ones(n, dtype=torch.bool, device=dev),
         vtype=torch.full((n,), EMITTER, device=dev),
         emit=eid, bits=torch.full((n,), POS_DELTA | IN_FSPACE, device=dev),
         pdf_fwd=vertex_pdf, n_s=ray_d, n_g=ray_d, pos=ray_o, beta=inten)
    ok = (pdf_dir > 0.0) & (inten.amax(dim=-1) > 0.0) & (vertex_pdf > 0.0)
    # the cosine at the light, whose normal is the ray's own direction
    beta = inten * torch.abs(dot(ray_d, ray_d))[:, None] \
        / torch.clamp(vertex_pdf * pdf_dir, min=1e-12)[:, None]
    beta = torch.where(ok[:, None], beta, 0.0)
    vnum = _walk(cell, tab, key, buf, lanes, ray_o, ray_d, pdf_dir, beta,
                 IMP, torch.zeros_like(cos_t), max_bnc)
    return buf, torch.where(ok, vnum, 1)


# ------------------------------ connections ------------------------------

def strategies(cell, max_bnc):
    """[(s, t, number)] in the double loop's order, numbered from 1."""
    start_t, end_t, start_s, end_s = cell.strategies
    out, k = [], 0
    for t in range(max(start_t, 1), min(end_t - 1, max_bnc + 1) + 1):
        for s in range(max(start_s, 0), min(end_s - 1, max_bnc + 1) + 1):
            depth = s + t - 2
            if (s == 1 and t == 1) or depth < 0 \
                    or depth > cell.scene.settings["max_bounce"]:
                continue
            k += 1
            out.append((s, t, k))
    return out


def _mis(cam_buf, lit_buf, cam_side, lit_side, s, t):
    """The balance heuristic's weight of strategy (s, t): 1 / (1 + the sum
    of the pdf ratios of every other way to make the same path), the
    ratios of both end vertices and of the vertex before each recomputed
    for the connection. Lanes: those of the sides; cam_buf None for t = 1
    (its camera vertex is the sampled one)."""
    total = torch.zeros_like(cam_side["pdf_fwd"])
    lit0_nd = (lit_buf["bits"][0] & (POS_DELTA | DIR_DELTA)) == 0
    cam_prev = _slot(cam_buf, t - 2) if t >= 2 else None
    lit_prev = _slot(lit_buf, s - 2) if s >= 2 else None
    r_lit_end = _ratio(cam_side, None if t == 1 else cam_prev["pos"],
                       lit_side)
    r_cam_end = _ratio(lit_side, None if s == 1 else lit_prev["pos"],
                       cam_side)
    if t >= 2:
        # camera side: the connection's end, then back toward the camera
        # (whose own term never counts)
        steps = _remap(cam_buf["pdf_bwd"]) / _remap(cam_buf["pdf_fwd"])
        nd = (cam_buf["bits"] & SPEC_DELTA) == 0
        r_prev = _ratio(cam_side, lit_side["pos"], cam_prev)
        total = total + torch.where(_not_delta(cam_prev), r_cam_end, 0.0)
        ri = r_cam_end
        for k in range(t - 2, -1, -1):
            ri = ri * (torch.where(r_prev > 0.0, r_prev, steps[k])
                       if k == t - 2 else steps[k])
            if k >= 1:
                total = total + torch.where(nd[k] & nd[k - 1], ri, 0.0)
    # light side: the connection's end, then back toward the light
    steps = _remap(lit_buf["pdf_bwd"]) / _remap(lit_buf["pdf_fwd"])
    nd = (lit_buf["bits"] & SPEC_DELTA) == 0
    cur_nd = lit0_nd if s == 1 else _not_delta(lit_prev)
    total = total + torch.where(cur_nd, r_lit_end, 0.0)
    if s >= 2:
        r_prev = _ratio(lit_side, cam_side["pos"], lit_prev)
        ri = r_lit_end
        for k in range(s - 2, -1, -1):
            ri = ri * (torch.where(r_prev > 0.0, r_prev, steps[k])
                       if k == s - 2 else steps[k])
            before = lit0_nd if k == 0 else nd[k - 1]
            total = total + torch.where(nd[k] & before, ri, 0.0)
    return 1.0 / (1.0 + total)


def _visible(tab, pos, direction, depth, need):
    """1 where the segment from pos along direction is clear up to depth
    (lanes that need no test: 1)."""
    far = torch.where(need, torch.where(depth > 0.0, depth - RAY_EPS, FAR),
                      DEAD).to(depth.dtype)
    return ~ref_pt.occluded(tab, pos, direction, far)


def _finish(cell, tab, le, calc_tr, pos, conn_dir, depth, path_time, w):
    """The shadow ray, the MIS weight, and the path time of the lanes that
    carry radiance."""
    need = calc_tr & (le.amax(dim=-1) > 0.0)
    clear = _visible(tab, pos, conn_dir, depth, need)
    le = torch.where(need[:, None], le * torch.where(clear, 1.0, 0.0)
                     .to(le.dtype)[:, None], le)
    path_time = path_time + torch.where(need, depth * tab.world_ior, 0.0)
    if not cell.use_mis:
        w = torch.ones_like(w)
    res = torch.where((le.amax(dim=-1) > 0.0)[:, None], le * w[:, None],
                      0.0)
    res = torch.nan_to_num(res, nan=0.0, posinf=0.0, neginf=0.0)
    return res, torch.where(res.amax(dim=-1) > 0.0, path_time, 0.0)


def _sample_camera(cell, tab, toward, depth):
    """(importance over the pdf, pixel id or -1) of the camera seen along
    `toward` (the renderer hands it the direction from the camera to the
    vertex)."""
    sc = cell.scene
    r = tab.cam_r
    cam_n = torch.stack([r[k, 2] for k in range(3)])
    dot_n = -dot(toward, cam_n[None].expand_as(toward))
    x = -toward
    local = [(x[:, 0] * r[0, k] + x[:, 1] * r[1, k]) + x[:, 2] * r[2, k]
             for k in range(3)]
    z = local[2]
    safe_z = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    focal = float(sc.focal)
    pi = torch.floor(sc.w * 0.5 + 1.0 - local[0] / safe_z * focal) \
        .to(torch.int32)
    pj = torch.floor(sc.h * 0.5 + 1.0 + local[1] / safe_z * focal) \
        .to(torch.int32)
    valid = (dot_n > 0.0) & (z > 0.0) & (pi >= 0) & (pj >= 0) \
        & (pi < sc.w) & (pj < sc.h)
    area = float(sc.w * sc.h) * (1.0 / focal) * (1.0 / focal)
    c = torch.clamp(dot_n, min=1e-9)
    c2 = c * c
    pdf = torch.where(valid, depth * depth / c, 0.0)
    we = torch.where(valid, 1.0 / (area * (c2 * c2)), 0.0)
    raster = torch.where(valid, pi.long() * sc.h + pj.long(), -1)
    return we, pdf, raster, cam_n


def connect_t1(cell, tab, lit_buf, lit_vnum, s):
    """Strategy (s, 1) over every light subpath: (radiance, pixel or -1,
    path time)."""
    v = _slot(lit_buf, s - 1)
    ok = (s <= lit_vnum) & _connectible(v)
    diff = tab.cam_t - v["pos"]
    depth = _norm(diff)
    conn_dir = diff / torch.clamp(depth[:, None], min=1e-9)
    we, cam_pdf, raster, cam_n = _sample_camera(cell, tab, -conn_dir, depth)
    ok = ok & (cam_pdf > 0.0)
    fr = _eval(tab, v, conn_dir)
    cam_beta = (we / torch.clamp(cam_pdf, min=1e-9))[:, None]
    le = torch.where(ok[:, None], v["beta"] * fr * cam_beta, 0.0)
    n = le.shape[0]
    cam = {k: torch.zeros_like(x) for k, x in v.items()}
    cam.update(vtype=torch.full_like(v["vtype"], CAMERA),
               bits=torch.full_like(v["bits"], POS_DELTA | IN_FSPACE),
               pos=tab.cam_t.expand(n, 3), n_s=cam_n.expand(n, 3),
               n_g=cam_n.expand(n, 3))
    w = _mis(None, lit_buf, cam, v, s, 1)
    res, ptime = _finish(cell, tab, le, ok & (fr.amax(dim=-1) > 0.0),
                         v["pos"], conn_dir, depth, v["time"] + depth, w)
    return res, torch.where(ok, raster, -1), ptime


def connect_s1(cell, tab, k_con, cam_buf, cam_vnum, lit_buf, lanes, t, k):
    """Strategy (1, t) for the camera subpaths of `lanes`: a light point
    sampled from the camera vertex with the strategy's own key (from each
    lane's pass's connection key)."""
    v = _slot(cam_buf, t - 1)
    dtype = v["pdf_fwd"].dtype
    ok = (t <= cam_vnum) & (v["vtype"] != EMITTER) & _connectible(v)
    # the third key draws an area light's point: a point light has none
    _k, k_pick, _k_hit = _split(rng.fold_in(k_con, k), 3)
    E = tab.light_pos.shape[0]
    u_pick = _uniforms(k_pick, lanes, 1, dtype)[:, 0]
    eid = torch.clamp((u_pick * E).to(torch.int32), max=E - 1).long()
    e_pdf = torch.full_like(u_pick, 1.0 / E)
    e_pos = tab.light_pos[eid]
    to_hit = v["pos"] - e_pos
    atten = torch.clamp(1.0 / torch.clamp(dot(to_hit, to_hit), min=1e-5),
                        max=1.0)
    e_int = tab.light_int[eid] * atten[:, None]
    diff = e_pos - v["pos"]
    depth = _norm(diff)
    conn_dir = diff / torch.clamp(depth[:, None], min=1e-9)
    ok = ok & (e_int.amax(dim=-1) > 0.0)
    fr = _eval(tab, v, conn_dir)
    lit_beta = e_int / torch.clamp(e_pdf, min=1e-9)[:, None]
    le = torch.where(ok[:, None], v["beta"] * fr * lit_beta, 0.0)
    light = {k2: torch.zeros_like(x) for k2, x in v.items()}
    light.update(vtype=torch.full_like(v["vtype"], EMITTER), emit=eid,
                 bits=torch.full_like(v["bits"], POS_DELTA | IN_FSPACE),
                 pos=e_pos, beta=lit_beta)
    w = _mis(cam_buf, lit_buf, v, light, 1, t)
    return _finish(cell, tab, le, ok & (fr.amax(dim=-1) > 0.0), v["pos"],
                   conn_dir, depth, v["time"], w)


def connect_general(cell, tab, cam_buf, cam_vnum, lit_buf, lit_vnum, s, t):
    """Strategy (s, t), s, t >= 2: camera vertex t - 1 joined to light
    vertex s - 1 of the same lane."""
    cv, lv = _slot(cam_buf, t - 1), _slot(lit_buf, s - 1)
    ok = (t <= cam_vnum) & (s <= lit_vnum) & (cv["vtype"] != EMITTER) \
        & _connectible(cv) & _connectible(lv)
    diff = lv["pos"] - cv["pos"]
    depth = _norm(diff)
    conn_dir = diff / torch.clamp(depth[:, None], min=1e-9)
    ok = ok & (depth > 0.0)
    fr_cam = _eval(tab, cv, conn_dir)
    fr_lit = _eval(tab, lv, -conn_dir)
    inv_d2 = 1.0 / torch.clamp(depth * depth, min=1e-12)
    le = torch.where(ok[:, None], cv["beta"] * fr_cam * fr_lit * lv["beta"]
                     * inv_d2[:, None], 0.0)
    w = _mis(cam_buf, lit_buf, cv, lv, s, t)
    calc = ok & (fr_cam.amax(dim=-1) > 0.0) & (fr_lit.amax(dim=-1) > 0.0)
    return _finish(cell, tab, le, calc, cv["pos"], conn_dir, depth,
                   lv["time"] + cv["time"], w)


# --------------------------------- film ---------------------------------

def pass_keys(seed: int, passes: int):
    """[(walk, camera subpath, light subpath, connections)] keys of passes
    1..passes of a renderer made with `seed`."""
    k = rng.key(seed)
    out = []
    for _ in range(passes):
        k, sub = rng.split(k)
        out.append(tuple(_split(sub, 4)))
    return out


def _bin(cell, acc, radiance, ptime, rows):
    """Add each lane's radiance into its row's bin of `acc` (R, bins, 3)
    where its time falls inside the bins; rows: the acc row of each lane,
    -1 for none."""
    tid = torch.floor((ptime - cell.t_min) / cell.interval).to(torch.int64)
    keep = (ptime > cell.t_min) \
        & (ptime < cell.t_min + cell.interval * cell.bins) \
        & (radiance.amax(dim=-1) > 0.0) & (rows >= 0)
    tid = tid.clamp(0, cell.bins - 1)
    sel = keep.nonzero()[:, 0]
    acc.index_put_((rows[sel], tid[sel]), radiance[sel], accumulate=True)


def _add(cell, acc, radiance, ptime, rows):
    """A strategy's radiance into the film rows `rows` (-1: none): into
    its time bin, or into the steady film."""
    if cell.bins:
        _bin(cell, acc, radiance, ptime, rows)
    else:
        ok = rows >= 0
        acc.index_put_((rows[ok],), radiance[ok], accumulate=True)


def film(cell: Cell, seed: int, passes: int, entries: torch.Tensor,
         dtype=torch.float32, lanes: int = 1 << 21):
    """(S, 3) float32: film entries `entries` (flat ids, on the device the
    reference runs on) after `passes` progressive passes of a renderer
    made with `seed`: a transient film's (pixel, bin) entries, or pixels
    of a steady one. The pixels of the entries are traced, and every light
    subpath (for t = 1); passes go in batches of about `lanes` light
    subpaths, each lane keyed by its pass (the sums then run in another
    order than the renderer's pass by pass)."""
    # no float32 product may run in TF32 (the reference takes none, and
    # keeps it so)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sc = cell.scene
    dev = entries.device
    tab = ref_pt.Tables(sc, dev, dtype)
    N = sc.w * sc.h
    pix_of = torch.div(entries, cell.bins, rounding_mode="floor") \
        if cell.bins else entries
    pix, row_of = torch.unique(pix_of, return_inverse=True)
    P = pix.shape[0]
    row = torch.full((N,), -1, dtype=torch.int64, device=dev)
    row[pix] = torch.arange(P, device=dev)
    shape = (P, cell.bins, 3) if cell.bins else (P, 3)
    acc = torch.zeros(shape, dtype=dtype, device=dev)
    max_bnc = min(sc.settings["max_bounce"], CAP)
    table = strategies(cell, max_bnc)
    keys = pass_keys(seed, passes)
    per = max(1, lanes // N)
    for p0 in range(0, passes, per):
        B = min(passes, p0 + per) - p0
        words = torch.tensor([[w for k in keys[p][1:] for w in k]
                              for p in range(p0, p0 + B)],
                             dtype=torch.int64, device=dev)
        # the eye lanes: (pass, pixel of an entry); the light lanes:
        # (pass, every lane of the wavefront)
        pe = torch.arange(B, device=dev).repeat_interleave(P)
        eye_pix = pix.repeat(B)
        own = torch.arange(P, device=dev).repeat(B)
        cam_buf, cam_vnum = eye_paths(
            cell, tab, (words[pe, 0], words[pe, 1]), p0 + 1 + pe, eye_pix,
            max_bnc, dtype)
        pl = torch.arange(B, device=dev).repeat_interleave(N)
        all_lit, all_vnum = light_paths(
            cell, tab, (words[pl, 2], words[pl, 3]),
            torch.arange(N, device=dev).repeat(B), max_bnc, dtype)
        del pl
        mine = pe * N + eye_pix        # each eye lane's own light subpath
        lit_buf = {k: v[:, mine] for k, v in all_lit.items()}
        lit_vnum = all_vnum[mine]
        k_con = (words[pe, 4], words[pe, 5])
        for s, t, k in table:          # s = 0: no camera vertex is on a light
            if t == 1:
                rad, raster, ptime = connect_t1(cell, tab, all_lit, all_vnum,
                                                s)
                rows = torch.where(raster >= 0, row[raster.clamp(min=0)], -1)
            elif s == 1:
                rad, ptime = connect_s1(cell, tab, k_con, cam_buf, cam_vnum,
                                        lit_buf, eye_pix, t, k)
                rows = own
            elif s >= 2:
                rad, ptime = connect_general(cell, tab, cam_buf, cam_vnum,
                                             lit_buf, lit_vnum, s, t)
                rows = own
            else:
                continue
            _add(cell, acc, rad, ptime, rows)
        del all_lit, lit_buf, cam_buf
    if cell.bins:
        return acc[row_of, entries % cell.bins].float()
    return acc[row_of].float()
