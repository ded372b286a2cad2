"""BxDF evaluation / sampling / pdf (port of adapt_tpu/ops/bxdf_ops.py).

The port has the lambertian BRDF, the NULL BSDF (a medium boundary that
light passes straight through), the material gather and the unified
surface dispatch. Each model is a branchless batched function over the
whole wavefront; the dispatcher evaluates only the models present in the
scene (cfg.brdf_types, cfg.bsdf_types) and blends with masks. Any tag
that is not ported raises instead of being skipped.

Conventions (as in the reference):
  incid : ray direction pointing INTO the surface (camera->surface)
  out   : scattered direction pointing AWAY from the surface
"""
from __future__ import annotations

import dataclasses

import torch

from ..constants import BRDFTag, BSDFTag, INV_PI, TRANSPORT_UNI
from .math3d import axis_vec, dot, delocalize_rotate
from .sampling import cosine_hemisphere


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


def eval_lambertian(mat, it, normal, out):
    cos_t = torch.clamp(dot(normal, out), min=0.0)
    return diffuse_color(mat, it) * INV_PI * cos_t[:, None]


def _ported(cfg):
    """The BRDF tags present; raises on any BxDF tag the port does not
    have yet."""
    extra = set(cfg.brdf_types) - {BRDFTag.LAMBERTIAN}
    extra_bsdf = set(cfg.bsdf_types) - {BSDFTag.NULL}
    if extra or extra_bsdf:
        raise NotImplementedError(
            f"BxDF tags {sorted(extra) or sorted(extra_bsdf)} are not "
            "ported yet (ROADMAP.md queue A item 9)")
    return cfg.brdf_types


def _null(mat):
    return (mat.kind == BSDFTag.NULL) & mat.is_bsdf


def bsdf_sample(cfg, mat, it, incid, u, world_ior):
    """BSDF sampling dispatch (reference bsdf.py:252-262); the NULL tag
    passes the ray through: direction incid, throughput 1, pdf 1, delta
    (adapt_tpu/ops/bxdf_ops.py:591-595)."""
    _ported(cfg)
    null = _null(mat)
    out = torch.where(null[:, None], incid, 0.0)
    spec = torch.where(null[:, None], 1.0, torch.zeros_like(mat.kd))
    pdf = torch.where(null, 1.0, 0.0)
    return out, spec, pdf, null


def bsdf_eval(cfg, mat, it, incid, out, world_ior):
    """BSDF eval dispatch (reference bsdf.py:242-250): zero for NULL."""
    _ported(cfg)
    return torch.zeros_like(mat.kd)


def bsdf_pdf(cfg, mat, it, outdir, incid, world_ior):
    """BSDF pdf dispatch (reference bsdf.py:211-236): 1 for NULL where
    outdir continues incid, else 0."""
    _ported(cfg)
    passthrough = dot(incid, outdir) > 1.0 - 1e-4
    return torch.where(_null(mat) & passthrough, 1.0, 0.0)


def brdf_eval(cfg, mat, it, incid, out):
    """Unified BRDF eval with hemisphere gate (reference brdf.py:503-526)."""
    same_hemi = dot(incid, it.n_g) * dot(out, it.n_g) < 0.0
    res = torch.zeros_like(mat.kd)
    for tag in _ported(cfg):
        spec = eval_lambertian(mat, it, it.n_s, out)
        res = torch.where((mat.kind == tag)[:, None], spec, res)
    return torch.where(same_hemi[:, None], res, 0.0)


def _sample_lambertian(mat, it, normal, u1, u2):
    local_dir, pdf = cosine_hemisphere(u1, u2)
    out = delocalize_rotate(normal, local_dir)
    return out, eval_lambertian(mat, it, normal, out), pdf


def brdf_sample(cfg, mat, it, incid, u):
    """Unified BRDF sampling; u is (N, 6) uniforms. Returns (dir,
    cosine-weighted throughput, pdf, is_specular) with the
    geometric-normal leak guard (reference brdf.py:557-559)."""
    N = incid.shape[0]
    out = axis_vec(1, incid.device).expand(N, 3)
    spec = torch.ones_like(mat.kd)
    pdf = torch.ones(N, device=incid.device)
    is_specular = torch.zeros(N, dtype=torch.bool, device=incid.device)
    lam_dir, lam_spec, lam_pdf = _sample_lambertian(mat, it, it.n_s,
                                                    u[:, 0], u[:, 1])
    for tag in _ported(cfg):
        m = (mat.kind == tag) & ~mat.is_bsdf
        out = torch.where(m[:, None], lam_dir, out)
        spec = torch.where(m[:, None], lam_spec, spec)
        pdf = torch.where(m, lam_pdf, pdf)
    leak = dot(out, it.n_g) <= 0.0
    spec = torch.where(leak[:, None], 0.0, spec)
    return out, spec, pdf, is_specular


def brdf_pdf(cfg, mat, it, outdir, incid):
    """Solid-angle pdf of brdf_sample (reference brdf.py:562-601)."""
    dot_out = dot(it.n_s, outdir)
    dot_in = dot(it.n_s, incid)
    gate = dot_out * dot_in < 0.0
    pdf = torch.zeros_like(dot_out)
    cos_pdf = dot_out * INV_PI
    for tag in _ported(cfg):
        pdf = torch.where(mat.kind == tag, cos_pdf, pdf)
    return torch.where(gate, pdf, 0.0)


def _apply_two_sides(cfg, mat, it, incid):
    """Flip normals for back-facing BRDF hits (reference path_tracer.py:449-453)."""
    if not cfg.brdf_two_sides:
        return it
    flip = ((dot(incid, it.n_s) > 0.0) & ~mat.is_bsdf)[:, None]
    return dataclasses.replace(it, n_s=torch.where(flip, -it.n_s, it.n_s),
                               n_g=torch.where(flip, -it.n_g, it.n_g))


def surface_eval(cfg, mat, it, incid, out, world_ior, mode=TRANSPORT_UNI,
                 scene=None):
    """PathTracer.eval for surface interactions (path_tracer.py:459-479).

    mode (TRANSPORT_RAD / _IMP / _UNI) scales refraction only, in the JAX
    package's refracting BSDFs; the ported tags do not refract, so it
    changes nothing yet. scene feeds the JAX package's BxDF-mixture lanes;
    mixtures are refused at compile (ROADMAP.md queue A item 9), so it is
    unused. Both are taken so that callers read like the reference."""
    it = _apply_two_sides(cfg, mat, it, incid)
    res = torch.zeros_like(mat.kd)
    if _ported(cfg):
        res = torch.where(~mat.is_bsdf[:, None],
                          brdf_eval(cfg, mat, it, incid, out), res)
    if cfg.bsdf_types:
        res = torch.where(mat.is_bsdf[:, None],
                          bsdf_eval(cfg, mat, it, incid, out, world_ior), res)
    return res


def surface_sample(cfg, mat, it, incid, u, world_ior, mode=TRANSPORT_UNI,
                   scene=None):
    """PathTracer.sample_new_ray surface path (path_tracer.py:447-457).
    mode, scene: see surface_eval."""
    it = _apply_two_sides(cfg, mat, it, incid)
    N = incid.shape[0]
    out = axis_vec(1, incid.device).expand(N, 3)
    spec = torch.ones_like(mat.kd)
    pdf = torch.ones(N, device=incid.device)
    is_specular = torch.zeros(N, dtype=torch.bool, device=incid.device)
    if _ported(cfg):
        b_out, b_spec, b_pdf, b_del = brdf_sample(cfg, mat, it, incid, u)
        sel = ~mat.is_bsdf
        out = torch.where(sel[:, None], b_out, out)
        spec = torch.where(sel[:, None], b_spec, spec)
        pdf = torch.where(sel, b_pdf, pdf)
        is_specular = torch.where(sel, b_del, is_specular)
    if cfg.bsdf_types:
        s_out, s_spec, s_pdf, s_del = bsdf_sample(cfg, mat, it, incid, u,
                                                  world_ior)
        sel = mat.is_bsdf
        out = torch.where(sel[:, None], s_out, out)
        spec = torch.where(sel[:, None], s_spec, spec)
        pdf = torch.where(sel, s_pdf, pdf)
        is_specular = torch.where(sel, s_del, is_specular)
    return out, spec, pdf, is_specular


def surface_pdf(cfg, mat, it, outdir, incid, world_ior, scene=None):
    """PathTracer.surface_pdf (path_tracer.py:481-494). scene: see
    surface_eval."""
    it = _apply_two_sides(cfg, mat, it, incid)
    pdf = torch.zeros(incid.shape[:-1], device=incid.device)
    if _ported(cfg):
        pdf = torch.where(~mat.is_bsdf, brdf_pdf(cfg, mat, it, outdir, incid),
                          pdf)
    if cfg.bsdf_types:
        pdf = torch.where(mat.is_bsdf,
                          bsdf_pdf(cfg, mat, it, outdir, incid, world_ior), pdf)
    return pdf
