"""BxDF evaluation / sampling / pdf (port of adapt_tpu/ops/bxdf_ops.py).

Every BRDF (blinn-phong, lambertian, specular, GGX microfacet, modified
Phong, Fresnel blend, Oren-Nayar, thin coat) and every BSDF
(det-refraction, lambertian transmission, NULL: a medium boundary that
light passes straight through), the material gather and the unified
surface dispatch. Each model is a branchless batched function over the
whole wavefront; the dispatcher evaluates only the models present in the
scene (cfg.brdf_types, cfg.bsdf_types) and blends with masks; BxDF
mixture lanes are overlaid on that (ops/mixture_ops.py) where the caller
passes the scene. Operations follow the JAX package's order, so results
round as it does. On a CUDA device the unified dispatch `surface_eval`,
`surface_sample` and `surface_pdf` runs in one hand-written kernel a call
(ops/shade_kernels.py), which gives the plain version's bits
(`surface_*_plain`, the eager code below); `shade_kernels.route` says
which calls it takes.

Conventions (as in the reference):
  incid : ray direction pointing INTO the surface (camera->surface)
  out   : scattered direction pointing AWAY from the surface
  n_s/n_g : shading / geometric normals
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .. import obs
from ..constants import BRDFTag, BSDFTag, INV_PI, TRANSPORT_RAD, TRANSPORT_UNI
from . import shade_kernels
from .geo_optics import (fresnel_equation, fresnel_eval, inci_reflect_dir,
                         refraction_cos2, schlick_fresnel, snell_refraction)
from .math3d import (axis_vec, convert_to_raw, cross, delocalize_rotate, dot,
                     localize_rotate, normalize, sqrt0)
from .sampling import (cosine_hemisphere, fresnel_hemisphere,
                       mod_phong_hemisphere)

EPS = 1e-7


@dataclasses.dataclass
class MatParams:
    """Per-ray gathered material parameters."""
    kind: torch.Tensor      # (N,) i32 BRDFTag / BSDFTag
    is_bsdf: torch.Tensor   # (N,) bool
    is_delta: torch.Tensor  # (N,) bool
    kd: torch.Tensor        # (N,3)
    ks: torch.Tensor        # (N,3)
    kg: torch.Tensor        # (N,3)
    mean: torch.Tensor      # (N,3)
    ior: torch.Tensor       # (N,) attached-medium ior
    emit: torch.Tensor      # (N,) i32 attached emitter id (-1 = none)


def gather_mat(scene, obj_id) -> MatParams:
    """Per-object material rows by (clamped) object id."""
    idx = obj_id.clamp(min=0)
    return MatParams(kind=scene.mat_type[idx], is_bsdf=scene.mat_is_bsdf[idx],
                     is_delta=scene.mat_is_delta[idx], kd=scene.mat_kd[idx],
                     ks=scene.mat_ks[idx], kg=scene.mat_kg[idx],
                     mean=scene.mat_mean[idx], ior=scene.medium.ior[idx],
                     emit=scene.obj_emitter[idx])


def diffuse_color(mat, it):
    """Texture override of k_d; it.tex is None on untextured scenes."""
    if it.tex is None:
        return mat.kd
    return torch.where((it.tex[:, 0] >= 0.0)[:, None], it.tex, mat.kd)


# ======================= BRDF evals (cosine-weighted) =======================

def eval_lambertian(mat, it, normal, out):
    cos_t = torch.clamp(dot(normal, out), min=0.0)
    return diffuse_color(mat, it) * INV_PI * cos_t[:, None]


def eval_blinn_phong(mat, it, incid, out):
    half = out - incid
    degenerate = torch.abs(half).amax(dim=-1) <= EPS
    half = torch.where(degenerate[:, None], 0.0, normalize(half))
    dot_clamp = torch.clamp(dot(half, it.n_s), min=0.0)
    glossy = torch.pow(dot_clamp[:, None], mat.kg)
    cos_t = torch.clamp(dot(it.n_s, out), min=0.0)
    return (diffuse_color(mat, it)
            + mat.ks * (0.5 * (mat.kg + 2.0) * glossy)) \
        * INV_PI * cos_t[:, None]


def eval_mod_phong(mat, it, incid, out):
    dot_normal = dot(it.n_s, out)
    reflect_d = normalize(2.0 * it.n_s * dot_normal[:, None] - out)
    dot_view = torch.clamp(-dot(incid, reflect_d), min=0.0)
    glossy = torch.pow(dot_view[:, None], mat.kg) * mat.ks
    spec = 0.5 * (mat.kg + 2.0) * glossy * INV_PI * dot_normal[:, None]
    spec = spec + eval_lambertian(mat, it, it.n_s, out)
    return torch.where((dot_normal > 0.0)[:, None], spec, 0.0)


def _fresnel_cos2_sin2(half_vec, normal, dot_half):
    """Azimuth (cos^2, sin^2) of the half vector in the tangent frame
    (reference brdf.py:247-250)."""
    x_axis = axis_vec(0, half_vec.device).expand(half_vec.shape)
    transed_x = delocalize_rotate(normal, x_axis)   # R @ [1,0,0]
    proj = normalize(half_vec - dot_half[:, None] * normal)
    cos_phi2 = dot(transed_x, proj) ** 2
    return cos_phi2, 1.0 - cos_phi2


def eval_fresnel_blend(mat, it, incid, out):
    """Ashikhmin-Shirley anisotropic Fresnel blend (brdf.py:253-275).
    kg = (n_u, n_v, precomputed sqrt((nu+1)(nv+1))/8pi)."""
    half_vec = out - incid
    dot_out = dot(it.n_s, out)
    ok = (dot_out > 0.0) & (torch.abs(half_vec).amax(dim=-1) > 1e-4)
    half_vec = normalize(half_vec)
    dot_in = -dot(it.n_s, incid)
    dot_half = torch.abs(dot(it.n_s, half_vec))
    dot_hk = torch.abs(dot(half_vec, out))
    fresnel = schlick_fresnel(mat.ks, dot_hk)
    cos_phi2, sin_phi2 = _fresnel_cos2_sin2(half_vec, it.n_s, dot_half)
    denom = torch.clamp(dot_hk * torch.maximum(dot_in, dot_out), min=1e-9)
    specular = mat.kg[:, 2:3] * torch.pow(
        dot_half[:, None],
        (mat.kg[:, 0] * cos_phi2 + mat.kg[:, 1] * sin_phi2)[:, None]) \
        * fresnel / denom[:, None]
    diffuse = 28.0 / (23.0 * math.pi) * diffuse_color(mat, it) \
        * (1.0 - mat.ks)
    pow5_in = torch.pow(1.0 - dot_in / 2.0, 5.0)
    pow5_out = torch.pow(1.0 - dot_out / 2.0, 5.0)
    diffuse = diffuse * ((1.0 - pow5_in) * (1.0 - pow5_out))[:, None]
    spec = (specular + diffuse) * dot_out[:, None]
    return torch.where(ok[:, None], spec, 0.0)


def eval_oren_nayar(mat, it, incid, out):
    """Oren-Nayar diffuse; kg = (A, B, thin-coat ior) (brdf.py:313-342)."""
    raw_wi = convert_to_raw(-incid, it.n_s)
    raw_wo = convert_to_raw(out, it.n_s)
    sin_i, sin_o = raw_wi[:, 1], raw_wo[:, 1]
    both = (sin_i > 1e-5) & (sin_o > 1e-5)
    d_cos = raw_wi[:, 2] * raw_wo[:, 2] + raw_wi[:, 3] * raw_wo[:, 3]
    max_cos = torch.where(both, torch.clamp(d_cos, min=0.0), 0.0)
    abs_ci, abs_co = torch.abs(raw_wi[:, 0]), torch.abs(raw_wo[:, 0])
    i_bigger = abs_ci > abs_co
    sin_alpha = torch.where(i_bigger, sin_o, sin_i)
    tan_beta = torch.where(i_bigger, sin_i / torch.clamp(abs_ci, min=1e-9),
                           sin_o / torch.clamp(abs_co, min=1e-9))
    factor = mat.kg[:, 0] + mat.kg[:, 1] * max_cos * sin_alpha * tan_beta
    return diffuse_color(mat, it) * INV_PI * (factor * abs_co)[:, None]


def eval_thin_coat(mat, it, incid, out):
    """Fresnel-coated Oren-Nayar plastic (brdf.py:390-407); kg[2] holds
    the coating IOR."""
    ior = mat.kg[:, 2]
    reflect, _ = inci_reflect_dir(incid, it.n_s)
    dot_in = dot(incid, it.n_s)
    refra_in, cos_r2_in = snell_refraction(incid, it.n_s, dot_in,
                                           torch.ones_like(ior), ior)
    in_F = fresnel_equation(1.0, ior, torch.abs(dot_in),
                            sqrt0(torch.clamp(cos_r2_in, min=0.0)))
    is_mirror = torch.abs(dot(out, reflect)) > (1.0 - 1e-4)
    mirror_spec = mat.ks * in_F[:, None]
    dot_out = dot(out, it.n_s)
    refra_out, cos_r2_out = snell_refraction(out, it.n_s, dot_out,
                                             torch.ones_like(ior), ior)
    out_F = fresnel_equation(1.0, ior, torch.abs(dot_out),
                             sqrt0(torch.clamp(cos_r2_out, min=0.0)))
    on = eval_oren_nayar(mat, it, refra_in, refra_out) \
        * (1.0 - torch.maximum(in_F, out_F))[:, None]
    return torch.where(is_mirror[:, None], mirror_spec, on)


def _thin_coat_fresnel(mat, it, incid):
    """Incident Fresnel term of the coating (brdf.py:410-422)."""
    ior = mat.kg[:, 2]
    dot_in = dot(incid, it.n_s)
    ratio = 1.0 / ior
    cos_r2 = 1.0 - ratio * ratio * (1.0 - dot_in * dot_in)
    return fresnel_equation(1.0, ior, torch.abs(dot_in),
                            sqrt0(torch.clamp(cos_r2, min=0.0)))


# ================= GGX / Trowbridge-Reitz microfacet =================
# Anisotropic GGX with Heitz visible-normal sampling, in the y-up local
# frame; k_g[0]/k_g[1] = alpha_x/alpha_y, k_s[0..1] = the dielectric
# Fresnel iors (sampler/microfacet.py:28-177, brdf.py:426-499).

def _ggx_d(wh_l, ax, ay):
    """GGX normal distribution D in the y-up local frame."""
    cos2 = wh_l[:, 1] * wh_l[:, 1]
    e = (wh_l[:, 0] ** 2 / torch.clamp(ax * ax, min=1e-9)
         + wh_l[:, 2] ** 2 / torch.clamp(ay * ay, min=1e-9))
    denom = math.pi * ax * ay * (cos2 + e) ** 2
    return torch.where(cos2 > 1e-12, 1.0 / torch.clamp(denom, min=1e-12),
                       0.0)


def _ggx_lambda(w_l, ax, ay):
    """Smith masking Lambda (reference trow_reitz_lambda)."""
    cos2 = w_l[:, 1] * w_l[:, 1]
    a2 = (ax * w_l[:, 0]) ** 2 + (ay * w_l[:, 2]) ** 2
    tan2 = a2 / torch.clamp(cos2, min=1e-9)
    return 0.5 * (-1.0 + torch.sqrt(1.0 + tan2))


def _ggx_g1(w_l, ax, ay):
    return 1.0 / (1.0 + _ggx_lambda(w_l, ax, ay))


def _ggx_g(wo_l, wi_l, ax, ay):
    return 1.0 / (1.0 + _ggx_lambda(wo_l, ax, ay)
                  + _ggx_lambda(wi_l, ax, ay))


def _ggx_sample_wh(wo_l, ax, ay, u1, u2):
    """Heitz 2018 VNDF sampling in the y-up local frame."""
    vh = normalize(torch.stack([ax * wo_l[:, 0], wo_l[:, 1],
                                ay * wo_l[:, 2]], dim=-1))
    lensq = vh[:, 0] ** 2 + vh[:, 2] ** 2
    inv_len = 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-12))
    T1 = torch.where((lensq > 1e-9)[:, None],
                     torch.stack([-vh[:, 2] * inv_len,
                                  torch.zeros_like(inv_len),
                                  vh[:, 0] * inv_len], dim=-1),
                     axis_vec(0, vh.device).expand(vh.shape))
    T2 = cross(vh, T1)
    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    t1 = r * torch.cos(phi)
    t2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[:, 1])
    t2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - t1 * t1, min=0.0)) \
        + s * t2
    nh = (t1[:, None] * T1 + t2[:, None] * T2
          + sqrt0(torch.clamp(1.0 - t1 * t1 - t2 * t2, min=0.0))[:, None]
          * vh)
    wh = torch.stack([ax * nh[:, 0], torch.clamp(nh[:, 1], min=1e-6),
                      ay * nh[:, 2]], dim=-1)
    return normalize(wh)


def _ggx_local(n_s, v):
    """World -> y-up local frame of n_s."""
    return localize_rotate(n_s, v)


def _ggx_alphas(mat):
    return (torch.clamp(mat.kg[:, 0], min=1e-4),
            torch.clamp(mat.kg[:, 1], min=1e-4))


def eval_microfacet(mat, it, incid, out):
    """Cosine-weighted Torrance-Sparrow GGX (reference brdf.py:471-499)."""
    ax, ay = _ggx_alphas(mat)
    cos_o = dot(it.n_s, out)
    cos_i = dot(it.n_s, incid)
    ok = cos_o * cos_i < 0.0
    wh = normalize(out - incid)
    # keep wh in the upper hemisphere of the local frame
    wh = torch.where(dot(wh, it.n_s)[:, None] < 0.0, -wh, wh)
    wh_l = _ggx_local(it.n_s, wh)
    wo_l = _ggx_local(it.n_s, -incid)
    wi_l = _ggx_local(it.n_s, out)
    F = fresnel_eval(dot(wh, out), mat.ks[:, 0], mat.ks[:, 1])
    val = (diffuse_color(mat, it) * (_ggx_d(wh_l, ax, ay)
           * _ggx_g(wo_l, wi_l, ax, ay) * F)[:, None]
           / torch.clamp(4.0 * torch.abs(cos_i), min=1e-9)[:, None])
    return torch.where(ok[:, None], val, 0.0)


def _ggx_pdf(mat, it, incid, out):
    """Solid-angle pdf of the VNDF sample for incid -> out."""
    ax, ay = _ggx_alphas(mat)
    wh = normalize(out - incid)
    wh = torch.where(dot(wh, it.n_s)[:, None] < 0.0, -wh, wh)
    wh_l = _ggx_local(it.n_s, wh)
    wo_l = _ggx_local(it.n_s, -incid)
    wo_l = torch.where(wo_l[:, 1:2] < 0.0, -wo_l, wo_l)
    dot_wo_wh = torch.abs(dot(wo_l, wh_l))
    pdf_vndf = _ggx_g1(wo_l, ax, ay) * _ggx_d(wh_l, ax, ay) * dot_wo_wh \
        / torch.clamp(torch.abs(wo_l[:, 1]), min=1e-9)
    return pdf_vndf / torch.clamp(4.0 * dot_wo_wh, min=1e-9)


def _sample_microfacet(mat, it, incid, u):
    """VNDF importance sampling (reference brdf.py:430-452)."""
    ax, ay = _ggx_alphas(mat)
    wo_l = _ggx_local(it.n_s, -incid)
    flip = wo_l[:, 1:2] < 0.0
    wo_l = torch.where(flip, -wo_l, wo_l)
    wh_l = _ggx_sample_wh(wo_l, ax, ay, u[:, 2], u[:, 3])
    wh = delocalize_rotate(it.n_s, wh_l)
    wh = torch.where(flip, -wh, wh)
    out, _ = inci_reflect_dir(incid, wh)
    spec = eval_microfacet(mat, it, incid, out)
    dot_wo_wh = torch.abs(dot(wo_l, wh_l))
    pdf = _ggx_g1(wo_l, ax, ay) * _ggx_d(wh_l, ax, ay) * dot_wo_wh \
        / torch.clamp(torch.abs(wo_l[:, 1]), min=1e-9) \
        / torch.clamp(4.0 * dot_wo_wh, min=1e-9)
    bad = dot(out, it.n_s) * dot(incid, it.n_s) >= 0.0
    spec = torch.where(bad[:, None], 0.0, spec)
    pdf = torch.where(bad, 1.0, pdf)
    return out, spec, pdf


_BRDF_EVALS = {
    BRDFTag.BLINN_PHONG: eval_blinn_phong,
    BRDFTag.LAMBERTIAN: lambda m, it, i, o: eval_lambertian(m, it, it.n_s, o),
    BRDFTag.MOD_PHONG: eval_mod_phong,
    BRDFTag.FRESNEL_BLEND: eval_fresnel_blend,
    BRDFTag.OREN_NAYAR: eval_oren_nayar,
    BRDFTag.THIN_COAT: eval_thin_coat,
    BRDFTag.SPECULAR: lambda m, it, i, o: torch.zeros_like(m.kd),
    BRDFTag.MICROFACET: eval_microfacet,
}


def brdf_eval(cfg, mat, it, incid, out):
    """Unified BRDF eval with hemisphere gate (reference brdf.py:503-526)."""
    same_hemi = dot(incid, it.n_g) * dot(out, it.n_g) < 0.0
    res = torch.zeros_like(mat.kd)
    for tag in cfg.brdf_types:
        spec = _BRDF_EVALS[tag](mat, it, incid, out)
        res = torch.where((mat.kind == tag)[:, None], spec, res)
    return torch.where(same_hemi[:, None], res, 0.0)


# ============================ BRDF sampling ============================

def _sample_lambertian(mat, it, normal, u1, u2):
    local_dir, pdf = cosine_hemisphere(u1, u2)
    out = delocalize_rotate(normal, local_dir)
    return out, eval_lambertian(mat, it, normal, out), pdf


def brdf_sample(cfg, mat, it, incid, u):
    """Unified BRDF sampling; u is (N, 6) uniforms. Returns (dir,
    cosine-weighted throughput, pdf, is_specular) with the
    geometric-normal leak guard (reference brdf.py:557-559).
    is_specular is the delta flag: the specular BRDF, and the thin coat's
    mirror lobe."""
    N = incid.shape[0]
    dev = incid.device
    out = axis_vec(1, dev).expand(N, 3)
    spec = torch.ones_like(mat.kd)
    pdf = torch.ones(N, device=dev)
    is_specular = torch.zeros(N, dtype=torch.bool, device=dev)

    lam_dir, lam_spec, lam_pdf = _sample_lambertian(mat, it, it.n_s,
                                                    u[:, 0], u[:, 1])
    for tag in cfg.brdf_types:
        t_delta = None
        if tag in (BRDFTag.LAMBERTIAN, BRDFTag.OREN_NAYAR):
            t_dir, t_spec, t_pdf = lam_dir, lam_spec, lam_pdf
            if tag == BRDFTag.OREN_NAYAR:
                t_spec = eval_oren_nayar(mat, it, incid, lam_dir)
        elif tag == BRDFTag.BLINN_PHONG:
            t_dir, t_pdf = lam_dir, lam_pdf
            t_spec = eval_blinn_phong(mat, it, incid, lam_dir)
        elif tag == BRDFTag.SPECULAR:
            t_dir, _ = inci_reflect_dir(incid, it.n_s)
            t_spec = diffuse_color(mat, it)
            t_pdf = torch.ones(N, device=dev)
            t_delta = torch.ones(N, dtype=torch.bool, device=dev)
        elif tag == BRDFTag.MOD_PHONG:
            t_dir, t_spec, t_pdf = _sample_mod_phong(mat, it, incid, u,
                                                     lam_dir, lam_spec,
                                                     lam_pdf)
        elif tag == BRDFTag.FRESNEL_BLEND:
            t_dir, t_spec, t_pdf = _sample_fresnel_blend(mat, it, incid, u,
                                                         lam_dir)
        elif tag == BRDFTag.THIN_COAT:
            t_dir, t_spec, t_pdf, t_delta = _sample_thin_coat(mat, it,
                                                              incid, u)
        else:  # MICROFACET
            t_dir, t_spec, t_pdf = _sample_microfacet(mat, it, incid, u)
        m = (mat.kind == tag) & ~mat.is_bsdf
        out = torch.where(m[:, None], t_dir, out)
        spec = torch.where(m[:, None], t_spec, spec)
        pdf = torch.where(m, t_pdf, pdf)
        if t_delta is not None:
            is_specular = torch.where(m, t_delta, is_specular)

    # shading-normal leak guard
    leak = dot(out, it.n_g) <= 0.0
    spec = torch.where(leak[:, None], 0.0, spec)
    return out, spec, pdf, is_specular


def _sample_mod_phong(mat, it, incid, u, lam_dir, lam_spec, lam_pdf):
    """Reference brdf.py:209-229."""
    eps = u[:, 2]
    p_diffuse = diffuse_color(mat, it).amax(dim=-1)
    p_spec = mat.ks.amax(dim=-1)
    # glossy lobe around the reflected view direction
    local_dir, g_pdf = mod_phong_hemisphere(u[:, 3], u[:, 4],
                                            mat.mean[:, 2])
    normal = delocalize_rotate(it.n_s, local_dir)
    g_dir = normalize(-2.0 * normal * dot(incid, normal)[:, None] + incid)
    g_spec = eval_mod_phong(mat, it, incid, g_dir)

    take_diffuse = eps < p_diffuse
    take_glossy = (~take_diffuse) & (eps < p_diffuse + p_spec)
    out = torch.where(take_diffuse[:, None], lam_dir,
                      torch.where(take_glossy[:, None], g_dir,
                                  axis_vec(1, lam_dir.device)
                                  .expand(lam_dir.shape)))
    spec = torch.where(take_diffuse[:, None], lam_spec,
                       torch.where(take_glossy[:, None], g_spec, 0.0))
    pdf = torch.where(take_diffuse, p_diffuse * lam_pdf,
                      torch.where(take_glossy, g_pdf * p_spec,
                                  1.0 - p_diffuse - p_spec))
    return out, spec, pdf


def _sample_fresnel_blend(mat, it, incid, u, lam_dir):
    """Reference brdf.py:278-286."""
    local_half, power_coeff = fresnel_hemisphere(u[:, 2], u[:, 3],
                                                 mat.kg[:, 0], mat.kg[:, 1])
    half = delocalize_rotate(it.n_s, local_half)
    reflected, dot_incid = inci_reflect_dir(incid, half)
    half_pdf = mat.kg[:, 2] * torch.pow(
        torch.clamp(dot(half, it.n_s), min=0.0), power_coeff)
    spec_pdf = half_pdf / torch.clamp(torch.abs(dot_incid), min=EPS)
    is_valid = dot(it.n_s, reflected) > 0.0
    take_lambert = u[:, 4] > 0.5
    out = torch.where(take_lambert[:, None], lam_dir, reflected)
    pdf = 0.5 * (spec_pdf + torch.abs(dot(out, it.n_s)) * INV_PI)
    spec = torch.where(is_valid[:, None],
                       eval_fresnel_blend(mat, it, incid, out), 0.0)
    return out, spec, pdf


def _sample_thin_coat(mat, it, incid, u):
    """Reference brdf.py:349-387, including its use of kg[0] in the
    incident Fresnel term (reproduced for output parity)."""
    ior = mat.kg[:, 2]
    ones = torch.ones_like(ior)
    dot_normal = dot(incid, it.n_s)
    refra_in, cos_r2 = snell_refraction(incid, it.n_s, dot_normal, ones,
                                        ior)
    in_F = fresnel_equation(1.0, mat.kg[:, 0], torch.abs(dot_normal),
                            sqrt0(torch.clamp(cos_r2, min=0.0)))
    take_reflect = u[:, 2] <= in_F

    # diffuse branch: cosine-hemisphere + second Fresnel event
    local_dir, lam_pdf = cosine_hemisphere(u[:, 0], u[:, 1])
    d_dir = delocalize_rotate(it.n_s, local_dir)
    dot_out = dot(d_dir, it.n_s)
    cos_r2_out = refraction_cos2(dot_out, ior, ones)
    total_ref = cos_r2_out < 0.0
    refra_out, _ = snell_refraction(d_dir, it.n_s, dot_out, ior, ones)
    out_F = fresnel_equation(ior, 1.0, torch.abs(dot_out),
                             sqrt0(torch.clamp(cos_r2_out, min=0.0)))
    # on internal total reflection the reference keeps the raw cosine pdf
    # and zero throughput (brdf.py:372-380); (1-F) applies only when the
    # ray escapes the coating
    d_pdf = torch.where(total_ref, lam_pdf, lam_pdf * (1.0 - in_F))
    d_spec = eval_oren_nayar(mat, it, refra_in, refra_out) \
        * ((1.0 - in_F) * (1.0 - out_F))[:, None]
    d_spec = torch.where(total_ref[:, None], 0.0, d_spec)
    d_dir_final = torch.where(total_ref[:, None], d_dir, refra_out)

    # mirror branch
    m_dir, _ = inci_reflect_dir(incid, it.n_s)
    m_spec = mat.ks * in_F[:, None]

    out = torch.where(take_reflect[:, None], m_dir, d_dir_final)
    spec = torch.where(take_reflect[:, None], m_spec, d_spec)
    pdf = torch.where(take_reflect, in_F, d_pdf)
    return out, spec, pdf, take_reflect


# ============================ BRDF pdf ============================

def brdf_pdf(cfg, mat, it, outdir, incid):
    """Solid-angle pdf of brdf_sample (reference brdf.py:562-601)."""
    dot_out = dot(it.n_s, outdir)
    dot_in = dot(it.n_s, incid)
    gate = dot_out * dot_in < 0.0
    pdf = torch.zeros_like(dot_out)
    cos_pdf = dot_out * INV_PI
    for tag in cfg.brdf_types:
        if tag in (BRDFTag.BLINN_PHONG, BRDFTag.LAMBERTIAN,
                   BRDFTag.OREN_NAYAR):
            t_pdf = cos_pdf
        elif tag == BRDFTag.MOD_PHONG:
            glossiness = mat.mean[:, 2]
            reflect_view, _ = inci_reflect_dir(incid, it.n_s)
            dot_ref = torch.clamp(dot(reflect_view, outdir), min=0.0)
            spec_pdf = 0.5 * (glossiness + 1.0) * INV_PI \
                * torch.pow(dot_ref, glossiness)
            p_d = diffuse_color(mat, it).amax(dim=-1)
            t_pdf = p_d * cos_pdf + mat.ks.amax(dim=-1) * spec_pdf
        elif tag == BRDFTag.THIN_COAT:
            reflect, _ = inci_reflect_dir(incid, it.n_s)
            in_F = _thin_coat_fresnel(mat, it, incid)
            mirror = torch.abs(dot(outdir, reflect)) > (1.0 - 1e-3)
            t_pdf = torch.where(mirror, in_F, (1.0 - in_F) * cos_pdf)
        elif tag == BRDFTag.FRESNEL_BLEND:
            half = normalize(outdir - incid)
            dot_half = dot(half, it.n_s)
            cos_phi2, sin_phi2 = _fresnel_cos2_sin2(half, it.n_s, dot_half)
            t_pdf = mat.kg[:, 2] * torch.pow(
                torch.clamp(dot_half, min=0.0),
                mat.kg[:, 0] * cos_phi2 + mat.kg[:, 1] * sin_phi2) \
                / torch.clamp(torch.abs(dot(incid, half)), min=1e-9)
            t_pdf = 0.5 * (t_pdf + cos_pdf)
        elif tag == BRDFTag.MICROFACET:
            t_pdf = _ggx_pdf(mat, it, incid, outdir)
        else:  # SPECULAR: delta
            t_pdf = torch.zeros_like(cos_pdf)
        pdf = torch.where(mat.kind == tag, t_pdf, pdf)
    return torch.where(gate, pdf, 0.0)


# ============================ BSDF (transmissive) ============================

def _iors(mat, it_out_dot, world_ior):
    """(ni, nr) ordered by whether the direction enters the object."""
    entering = it_out_dot < 0.0
    ni = torch.where(entering, world_ior, mat.ior)
    nr = torch.where(entering, mat.ior, world_ior)
    return ni, nr


def _rad_scale(mode, ni, nr):
    """ni^2 / nr^2 under radiance transport, else 1 (mode: a transport
    tag)."""
    scale = (ni * ni) / (nr * nr)
    return scale if mode == TRANSPORT_RAD else torch.ones_like(scale)


def _refraction_terms(mat, it, d, world_ior):
    """What the BSDF arms share for direction d (the arriving ray for
    sampling, the scattered one for eval and pdf): its cosine, the iors,
    the mirror and Snell directions, total internal reflection and the
    Fresnel reflectance."""
    dot_n = dot(d, it.n_s)
    ni, nr = _iors(mat, dot_n, world_ior)
    reflect = normalize(d - 2.0 * it.n_s * dot_n[:, None])
    cos_r2 = refraction_cos2(dot_n, ni, nr)
    refra_vec, _ = snell_refraction(d, it.n_s, dot_n, ni, nr)
    F = fresnel_equation(ni, nr, torch.abs(dot_n),
                         sqrt0(torch.clamp(cos_r2, min=0.0)))
    return dot_n, ni, nr, reflect, cos_r2 < 0.0, refra_vec, F


def bsdf_sample(cfg, mat, it, incid, u, world_ior, mode=TRANSPORT_UNI):
    """Sampling dispatch for the BSDF types present in the scene
    (reference bsdf.py:252-262). Returns (dir, throughput, pdf,
    is_delta)."""
    N = incid.shape[0]
    dev = incid.device
    out = torch.zeros_like(incid)
    spec = torch.zeros_like(mat.kd)
    pdf = torch.zeros(N, device=dev)
    is_delta = torch.zeros(N, dtype=torch.bool, device=dev)
    dot_normal, ni, nr, reflect, total, refra_vec, F = _refraction_terms(
        mat, it, incid, world_ior)
    base_color = diffuse_color(mat, it)
    rad_scale = _rad_scale(mode, ni, nr)

    for tag in cfg.bsdf_types:
        if tag == BSDFTag.DET_REFRACTION:
            # reference bsdf.py:77-105
            do_refract = (~total) & (u[:, 0] > F)
            t_dir = torch.where(do_refract[:, None], refra_vec, reflect)
            t_pdf = torch.where(total, 1.0,
                                torch.where(do_refract, 1.0 - F, F))
            t_int = base_color * torch.where(do_refract, rad_scale,
                                             1.0)[:, None]
            t_spec = t_int * t_pdf[:, None]
            t_delta = torch.ones(N, dtype=torch.bool, device=dev)
        elif tag == BSDFTag.LAMBERTIAN:
            # reference bsdf.py:139-175
            do_refract = (~total) & (u[:, 0] > F)
            local_dir, lam_pdf = cosine_hemisphere(u[:, 1], u[:, 2])
            normal = torch.sign(dot_normal)[:, None] * it.n_s
            d_dir = delocalize_rotate(normal, local_dir)
            cos_term = torch.clamp(dot(normal, d_dir), min=0.0)
            d_int = base_color * (INV_PI * cos_term * rad_scale)[:, None] \
                * (1.0 - F)[:, None]
            t_dir = torch.where(do_refract[:, None], d_dir, reflect)
            t_spec = torch.where(do_refract[:, None], d_int,
                                 base_color * F[:, None])
            t_spec = torch.where(total[:, None], base_color, t_spec)
            t_pdf = torch.where(do_refract, lam_pdf * (1.0 - F),
                                torch.where(total, 1.0, F))
            t_delta = ~do_refract
        else:  # NULL: passthrough (the volumetric tracer crosses it)
            t_dir = incid
            t_spec = torch.ones_like(mat.kd)
            t_pdf = torch.ones(N, device=dev)
            t_delta = torch.ones(N, dtype=torch.bool, device=dev)
        m = (mat.kind == tag) & mat.is_bsdf
        out = torch.where(m[:, None], t_dir, out)
        spec = torch.where(m[:, None], t_spec, spec)
        pdf = torch.where(m, t_pdf, pdf)
        is_delta = torch.where(m, t_delta, is_delta)
    return out, spec, pdf, is_delta


def bsdf_eval(cfg, mat, it, incid, out, world_ior, mode=TRANSPORT_UNI):
    """Eval dispatch (reference bsdf.py:242-250). `incid` is the arriving
    ray (into the surface), `out` the scattered direction evaluated; the
    iors come from `out` (reference bsdf.py:108-135 treats eval as
    light->eye transport)."""
    dot_out, ni, nr, ref_dir, total, refra_vec, F = _refraction_terms(
        mat, it, out, world_ior)
    base_color = diffuse_color(mat, it)
    rad_scale = _rad_scale(mode, ni, nr)
    near_ref = dot(ref_dir, incid) > 1.0 - 1e-4
    res = torch.zeros_like(mat.kd)

    for tag in cfg.bsdf_types:
        if tag == BSDFTag.DET_REFRACTION:
            near_refra = dot(refra_vec, incid) > 1.0 - 1e-4
            val = torch.where(
                total[:, None],
                torch.where((dot(ref_dir, incid) > 1.0 - 5e-5)[:, None],
                            base_color, 0.0),
                torch.where(near_refra[:, None],
                            base_color * ((1.0 - F) * rad_scale)[:, None],
                            torch.where(near_ref[:, None],
                                        base_color * F[:, None], 0.0)))
        elif tag == BSDFTag.LAMBERTIAN:
            dot_in = dot(incid, it.n_s)
            same_side = dot_in * dot_out < 0.0   # reflection configuration
            refl_val = torch.where((same_side & near_ref)[:, None],
                                   base_color * F[:, None], 0.0)
            trans_val = base_color * ((1.0 - F) * INV_PI
                                      * torch.abs(dot_out)
                                      * rad_scale)[:, None]
            val = torch.where(total[:, None],
                              torch.where(near_ref[:, None], base_color, 0.0),
                              torch.where(same_side[:, None], refl_val,
                                          trans_val))
        else:  # NULL
            val = torch.zeros_like(mat.kd)
        res = torch.where(((mat.kind == tag) & mat.is_bsdf)[:, None], val,
                          res)
    return res


def bsdf_pdf(cfg, mat, it, outdir, incid, world_ior):
    """Reference bsdf.py:211-236; outdir is the next-ray direction whose
    pdf is asked for, incid the arriving ray."""
    dot_out, ni, nr, ref_dir, total, refra_vec, F = _refraction_terms(
        mat, it, outdir, world_ior)
    near_ref = dot(ref_dir, incid) > 1.0 - 1e-4
    pdf = torch.zeros_like(dot_out)
    for tag in cfg.bsdf_types:
        if tag == BSDFTag.NULL:
            t_pdf = torch.where(dot(incid, outdir) > 1.0 - 1e-4, 1.0, 0.0)
        elif tag == BSDFTag.DET_REFRACTION:
            near_refra = dot(refra_vec, incid) > 1.0 - 1e-4
            t_pdf = torch.where(total, torch.where(near_ref, 1.0, 0.0),
                                torch.where(near_ref, F,
                                            torch.where(near_refra, 1.0 - F,
                                                        0.0)))
        else:  # LAMBERTIAN transmission
            dot_in = dot(incid, it.n_s)
            trans_cfg = dot_in * dot_out > 0.0
            t_pdf = torch.where(
                total, torch.where(near_ref, 1.0, 0.0),
                torch.where(near_ref, F,
                            torch.where(trans_cfg,
                                        (1.0 - F) * torch.abs(dot_out)
                                        * INV_PI, 0.0)))
        pdf = torch.where((mat.kind == tag) & mat.is_bsdf, t_pdf, pdf)
    return pdf


# ============================ unified dispatch ============================

def _apply_two_sides(cfg, mat, it, incid):
    """Flip normals for back-facing BRDF hits (reference path_tracer.py:449-453)."""
    if not cfg.brdf_two_sides:
        return it
    flip = ((dot(incid, it.n_s) > 0.0) & ~mat.is_bsdf)[:, None]
    return dataclasses.replace(it, n_s=torch.where(flip, -it.n_s, it.n_s),
                               n_g=torch.where(flip, -it.n_g, it.n_g))


def _mixture_lanes(scene, it):
    """(clamped mixture row, lane-is-mixture mask) for the overlay."""
    mix_id = scene.obj_mixture[it.obj_id.clamp(min=0).long()]
    return mix_id.clamp(min=0), (it.obj_id >= 0) & (mix_id >= 0)


def _mixture_eval(cfg, it, incid, out, world_ior, mode, scene, res):
    """res with the BxDF-mixture lanes' eval overlaid (it: after the
    two-sided flip)."""
    from . import mixture_ops
    mid, is_mix = _mixture_lanes(scene, it)
    m_res = mixture_ops.mixture_eval(scene, cfg, scene.mixture, mid, it,
                                     incid, out, world_ior, mode)
    return torch.where(is_mix[:, None], m_res, res)


def _mixture_sample(cfg, it, incid, u, world_ior, mode, scene, out, spec,
                    pdf, is_specular):
    """The sample with the BxDF-mixture lanes overlaid."""
    from . import mixture_ops
    mid, is_mix = _mixture_lanes(scene, it)
    m_out, m_spec, m_pdf, m_del = mixture_ops.mixture_sample(
        scene, cfg, scene.mixture, mid, it, incid, u, world_ior, mode)
    return (torch.where(is_mix[:, None], m_out, out),
            torch.where(is_mix[:, None], m_spec, spec),
            torch.where(is_mix, m_pdf, pdf),
            torch.where(is_mix, m_del, is_specular))


def _mixture_pdf(cfg, it, outdir, incid, world_ior, scene, pdf):
    """pdf with the BxDF-mixture lanes overlaid."""
    from . import mixture_ops
    mid, is_mix = _mixture_lanes(scene, it)
    m_pdf = mixture_ops.mixture_pdf(scene, cfg, scene.mixture, mid, it,
                                    outdir, incid, world_ior)
    return torch.where(is_mix, m_pdf, pdf)


def _has_mixture(scene):
    return scene is not None and scene.mixture is not None


def _arms(cfg, mat, *_, scene=None, **__):
    """A shading span's attributes: lanes, and the material arms issued
    (each BRDF and BSDF kind, and the mixture overlay)."""
    return {"n": mat.kd.shape[0],
            "arms": len(cfg.brdf_types) + len(cfg.bsdf_types)
            + int(_has_mixture(scene))}


@obs.spanned("shade.eval", _arms)
def surface_eval(cfg, mat, it, incid, out, world_ior, mode=TRANSPORT_UNI,
                 scene=None):
    """surface_eval_plain, in one CUDA kernel where shade_kernels.route
    allows."""
    if not shade_kernels.route(mat, it, (incid, out), world_ior):
        return surface_eval_plain(cfg, mat, it, incid, out, world_ior, mode,
                                  scene)
    res = shade_kernels.surface_eval(cfg, mat, it, incid, out, world_ior,
                                     mode)
    if _has_mixture(scene):
        res = _mixture_eval(cfg, _apply_two_sides(cfg, mat, it, incid),
                            incid, out, world_ior, mode, scene, res)
    return res


def surface_eval_plain(cfg, mat, it, incid, out, world_ior,
                       mode=TRANSPORT_UNI, scene=None):
    """PathTracer.eval for surface interactions (path_tracer.py:459-479).

    mode (TRANSPORT_RAD / _IMP / _UNI) scales the refracting BSDFs'
    transmission. scene: pass the SceneData to overlay BxDF-mixture lanes
    (reference bxdf/mixture.py); free when the scene has no mixtures
    (scene.mixture is None) or scene is omitted."""
    it = _apply_two_sides(cfg, mat, it, incid)
    res = torch.zeros_like(mat.kd)
    if cfg.brdf_types:
        res = torch.where(~mat.is_bsdf[:, None],
                          brdf_eval(cfg, mat, it, incid, out), res)
    if cfg.bsdf_types:
        res = torch.where(mat.is_bsdf[:, None],
                          bsdf_eval(cfg, mat, it, incid, out, world_ior,
                                    mode), res)
    if _has_mixture(scene):
        res = _mixture_eval(cfg, it, incid, out, world_ior, mode, scene, res)
    return res


@obs.spanned("shade.sample", _arms)
def surface_sample(cfg, mat, it, incid, u, world_ior, mode=TRANSPORT_UNI,
                   scene=None):
    """surface_sample_plain, in one CUDA kernel where shade_kernels.route
    allows."""
    if not shade_kernels.route(mat, it, (incid, u), world_ior):
        return surface_sample_plain(cfg, mat, it, incid, u, world_ior, mode,
                                    scene)
    res = shade_kernels.surface_sample(cfg, mat, it, incid, u, world_ior,
                                       mode)
    if _has_mixture(scene):
        res = _mixture_sample(cfg, _apply_two_sides(cfg, mat, it, incid),
                              incid, u, world_ior, mode, scene, *res)
    return res


def surface_sample_plain(cfg, mat, it, incid, u, world_ior,
                         mode=TRANSPORT_UNI, scene=None):
    """PathTracer.sample_new_ray surface path (path_tracer.py:447-457).
    mode, scene: see surface_eval_plain."""
    it = _apply_two_sides(cfg, mat, it, incid)
    N = incid.shape[0]
    out = axis_vec(1, incid.device).expand(N, 3)
    spec = torch.ones_like(mat.kd)
    pdf = torch.ones(N, device=incid.device)
    is_specular = torch.zeros(N, dtype=torch.bool, device=incid.device)
    if cfg.brdf_types:
        b_out, b_spec, b_pdf, b_del = brdf_sample(cfg, mat, it, incid, u)
        sel = ~mat.is_bsdf
        out = torch.where(sel[:, None], b_out, out)
        spec = torch.where(sel[:, None], b_spec, spec)
        pdf = torch.where(sel, b_pdf, pdf)
        is_specular = torch.where(sel, b_del, is_specular)
    if cfg.bsdf_types:
        s_out, s_spec, s_pdf, s_del = bsdf_sample(cfg, mat, it, incid, u,
                                                  world_ior, mode)
        sel = mat.is_bsdf
        out = torch.where(sel[:, None], s_out, out)
        spec = torch.where(sel[:, None], s_spec, spec)
        pdf = torch.where(sel, s_pdf, pdf)
        is_specular = torch.where(sel, s_del, is_specular)
    if _has_mixture(scene):
        return _mixture_sample(cfg, it, incid, u, world_ior, mode, scene,
                               out, spec, pdf, is_specular)
    return out, spec, pdf, is_specular


@obs.spanned("shade.pdf", _arms)
def surface_pdf(cfg, mat, it, outdir, incid, world_ior, scene=None):
    """surface_pdf_plain, in one CUDA kernel where shade_kernels.route
    allows."""
    if not shade_kernels.route(mat, it, (outdir, incid), world_ior):
        return surface_pdf_plain(cfg, mat, it, outdir, incid, world_ior,
                                 scene)
    pdf = shade_kernels.surface_pdf(cfg, mat, it, outdir, incid, world_ior)
    if _has_mixture(scene):
        pdf = _mixture_pdf(cfg, _apply_two_sides(cfg, mat, it, incid),
                           outdir, incid, world_ior, scene, pdf)
    return pdf


def surface_pdf_plain(cfg, mat, it, outdir, incid, world_ior, scene=None):
    """PathTracer.surface_pdf (path_tracer.py:481-494). scene: see
    surface_eval_plain."""
    it = _apply_two_sides(cfg, mat, it, incid)
    pdf = torch.zeros(incid.shape[:-1], device=incid.device)
    if cfg.brdf_types:
        pdf = torch.where(~mat.is_bsdf, brdf_pdf(cfg, mat, it, outdir, incid),
                          pdf)
    if cfg.bsdf_types:
        pdf = torch.where(mat.is_bsdf,
                          bsdf_pdf(cfg, mat, it, outdir, incid, world_ior), pdf)
    if _has_mixture(scene):
        pdf = _mixture_pdf(cfg, it, outdir, incid, world_ior, scene, pdf)
    return pdf
