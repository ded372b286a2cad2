"""Emitter sampling (port of adapt_tpu/ops/emitter_ops.py: point and area
lights).

Per-ray emitter parameters are plain index lookups into the SceneData
emitter tables; only the emitter kinds present in the scene are evaluated
(cfg.emitter_kinds), and a kind the port does not have yet raises.
"""
from __future__ import annotations

import torch

from ..constants import EmitterTag, BIT_POS_DELTA
from .math3d import axis_vec, delocalize_rotate, dot, normalize
from .sampling import cosine_hemisphere, sample_triangle, uniform_sphere


def sample_light_index(cfg, u, no_sample):
    """Uniform light pick with exclusion (reference path_tracer.py:537-554).
    Returns (idx, pdf, valid)."""
    E = cfg.n_emitters
    if E == 0:
        return (torch.zeros(u.shape, dtype=torch.int32, device=u.device),
                torch.ones_like(u),
                torch.zeros(u.shape, dtype=torch.bool, device=u.device))
    base_idx = torch.clamp((u * E).to(torch.int32), max=E - 1)
    pdf = torch.full_like(u, 1.0 / E)
    valid = torch.ones(u.shape, dtype=torch.bool, device=u.device)
    if E <= 1:
        return base_idx, pdf, valid & ~(no_sample >= 0)
    ex_idx = torch.clamp((u * (E - 1)).to(torch.int32), max=E - 2)
    ex_idx = ex_idx + (ex_idx >= no_sample).to(torch.int32)
    excl = no_sample >= 0
    idx = torch.where(excl, ex_idx, base_idx)
    pdf = torch.where(excl, 1.0 / (E - 1), pdf)
    return idx, pdf, valid


def _area_sample_hit(scene, eid, hit_pos, u, e_int, e_inv_area):
    """Area-light branch of sample_hit (abtract_source.py:98-132): a point
    on the light's mesh (uniform triangle pick, then uniform on the
    triangle) or, for a sphere light, on the hemisphere facing the
    shading point; the pdf converted to solid angle."""
    obj = scene.emit_obj[eid].clamp(min=0)
    is_sphere = scene.obj_is_sphere[obj] > 0
    start = scene.obj_start[obj]
    cnt = scene.obj_cnt[obj].clamp(min=1)

    # triangle branch: uniform pick (assumes similar triangle areas, as
    # the reference does)
    tri_local = torch.minimum((u[:, 0] * cnt).to(torch.int32), cnt - 1)
    tri_id = start + tri_local
    tri_pos = sample_triangle(scene.pre0[tri_id], scene.pre1[tri_id],
                              u[:, 1], u[:, 2]) + scene.pre2[tri_id]
    tri_normal = scene.prim_ng[tri_id]

    # sphere branch: hemisphere toward the shading point
    center = scene.pre0[start]                  # sphere center in pre0
    radius = scene.pre1[start][:, 0]
    to_hit = normalize(hit_pos - center)
    local_dir, sph_pdf = uniform_sphere(u[:, 1], u[:, 2])
    sph_normal = delocalize_rotate(to_hit, local_dir)
    sph_pos = center + sph_normal * radius[:, None]
    sph_pdf_area = sph_pdf / torch.clamp(radius * radius, min=1e-12)

    ret_pos = torch.where(is_sphere[:, None], sph_pos, tri_pos)
    normal = torch.where(is_sphere[:, None], sph_normal, tri_normal)
    ret_pdf = torch.where(is_sphere, sph_pdf_area, e_inv_area)

    diff = hit_pos - ret_pos
    dot_light = dot(normalize(diff), normal)
    facing = dot_light > 0.0
    ret_pdf = torch.where(facing, ret_pdf * dot(diff, diff)
                          / torch.clamp(dot_light, min=1e-12), 1.0)
    ret_int = torch.where((facing & (ret_pdf > 0.0))[:, None],
                          e_int / torch.clamp(ret_pdf, min=1e-12)[:, None],
                          0.0)
    return ret_pos, ret_int, ret_pdf, normal


def sample_hit(scene, cfg, eid, hit_pos, u):
    """NEE light sample toward `hit_pos`; returns (pos, intensity, pdf,
    normal) (reference abtract_source.py:82-158). For area lights the
    intensity is already divided by the solid-angle pdf. u: (N,3)."""
    N = hit_pos.shape[0]
    kind = scene.emit_kind[eid]
    e_pos = scene.emit_pos[eid]
    e_int = scene.emit_intensity[eid]
    ret_pos = e_pos
    ret_int = e_int
    ret_pdf = torch.ones(N, device=hit_pos.device)
    normal = torch.zeros((N, 3), device=hit_pos.device)
    for k in cfg.emitter_kinds:
        m = kind == k
        if k == EmitterTag.POINT:
            to_hit = hit_pos - e_pos
            atten = torch.clamp(
                1.0 / torch.clamp(dot(to_hit, to_hit), min=1e-5), max=1.0)
            ret_int = torch.where(m[:, None], e_int * atten[:, None],
                                  ret_int)
        elif k == EmitterTag.AREA:
            a_pos, a_int, a_pdf, a_n = _area_sample_hit(
                scene, eid, hit_pos, u, e_int, scene.emit_inv_area[eid])
            ret_pos = torch.where(m[:, None], a_pos, ret_pos)
            ret_int = torch.where(m[:, None], a_int, ret_int)
            ret_pdf = torch.where(m, a_pdf, ret_pdf)
            normal = torch.where(m[:, None], a_n, normal)
        else:
            raise NotImplementedError(
                f"emitter kind {k} is not ported yet (ROADMAP.md queue A "
                "item 9)")
    return ret_pos, ret_int, ret_pdf, normal


def _rotate(anchor, local_dir):
    """The JAX package's name (emitter_ops.py:24) for delocalize_rotate,
    kept so sample_le reads like the reference."""
    return delocalize_rotate(anchor, local_dir)


def sample_le(scene, cfg, eid, u):
    """Emission sampling for light subpaths (abtract_source.py:160-208).

    u: (N,5). The area branch consumes all five (triangle pick, two for
    the position, two for the direction): sharing one between position and
    direction would correlate them, and the estimator divides by
    pdf_pos * pdf_dir as if they were independent. The point branch takes
    u[:, :2]. Returns (ray_o, ray_d, pdf_pos, pdf_dir, normal)."""
    N = eid.shape[0]
    dev = u.device
    ray_o = scene.emit_pos[eid]
    ray_d = axis_vec(1, dev).expand(N, 3)
    normal = ray_d
    pdf_dir = torch.zeros(N, device=dev)
    pdf_pos = torch.ones(N, device=dev)
    kind = scene.emit_kind[eid]
    for k in cfg.emitter_kinds:
        m = kind == k
        if k == EmitterTag.POINT:
            d, pdf = uniform_sphere(u[:, 0], u[:, 1])
            ray_d = torch.where(m[:, None], d, ray_d)
            normal = torch.where(m[:, None], d, normal)
            pdf_dir = torch.where(m, pdf, pdf_dir)
        elif k == EmitterTag.AREA:
            obj = scene.emit_obj[eid].clamp(min=0)
            is_sphere = scene.obj_is_sphere[obj] > 0
            start = scene.obj_start[obj]
            cnt = scene.obj_cnt[obj].clamp(min=1)
            tri_local = torch.minimum((u[:, 0] * cnt).to(torch.int32),
                                      cnt - 1)
            tri_id = start + tri_local
            tri_n = scene.prim_ng[tri_id]
            tri_o = sample_triangle(scene.pre0[tri_id], scene.pre1[tri_id],
                                    u[:, 1], u[:, 2]) + scene.pre2[tri_id]
            sph_n, _ = uniform_sphere(u[:, 1], u[:, 2])
            center = scene.pre0[start]
            radius = scene.pre1[start][:, 0]
            sph_o = center + sph_n * radius[:, None]
            a_n = torch.where(is_sphere[:, None], sph_n, tri_n)
            a_o = torch.where(is_sphere[:, None], sph_o, tri_o)
            local_d, c_pdf = cosine_hemisphere(u[:, 3], u[:, 4])
            a_d = _rotate(a_n, local_d)
            ray_o = torch.where(m[:, None], a_o, ray_o)
            ray_d = torch.where(m[:, None], a_d, ray_d)
            normal = torch.where(m[:, None], a_n, normal)
            pdf_dir = torch.where(m, c_pdf, pdf_dir)
            pdf_pos = torch.where(m, scene.emit_inv_area[eid], pdf_pos)
        else:
            raise NotImplementedError(
                f"emitter kind {k} is not ported yet (ROADMAP.md queue A "
                "item 9)")
    return ray_o, ray_d, pdf_pos, pdf_dir, normal


def eval_le(scene, eid, inci_dir, normal):
    """Area-light radiance toward -inci_dir (abtract_source.py:210-218)."""
    is_area = scene.emit_kind[eid] == EmitterTag.AREA
    dot_light = -dot(normalize(inci_dir), normal)
    lit = is_area & (dot_light > 0.0)
    return torch.where(lit[:, None], scene.emit_intensity[eid], 0.0)


def solid_angle_pdf(scene, eid, n_s, depth, incid_dir):
    """Area pdf -> solid-angle pdf for hitting an area light
    (abtract_source.py:220-232)."""
    area_pdf = torch.where(scene.emit_kind[eid] == EmitterTag.AREA,
                           scene.emit_inv_area[eid], 0.0)
    dot_res = torch.abs(dot(incid_dir, n_s))
    return torch.where(dot_res > 0.0,
                       area_pdf * depth * depth
                       / torch.clamp(dot_res, min=1e-12), 0.0)


def is_delta_pos(scene, eid):
    return (scene.emit_bits[eid] & BIT_POS_DELTA) > 0
