"""Geometric optics: reflection, Fresnel, Snell (port of
adapt_tpu/ops/geo_optics.py).

Branchless functions on (..., 3) direction batches, in the JAX package's
operation order (reference la/geo_optics.py:14-75).
"""
from __future__ import annotations

import torch

from .math3d import dot, normalize, sqrt0


def inci_reflect_dir(ray, normal):
    """Mirror reflection of an incident ray (pointing into the surface);
    returns (dir, cos)."""
    d = dot(ray, normal, keepdims=True)
    return normalize(ray - 2.0 * normal * d), d[..., 0]


def exit_reflect_dir(ray, normal):
    """Mirror reflection of an exitant ray (pointing away); returns
    (dir, cos)."""
    d = dot(ray, normal, keepdims=True)
    return normalize(2.0 * normal * d - ray), d[..., 0]


def schlick_fresnel(r_s, dot_val):
    """Schlick's approximation; r_s is (..., 3), dot_val (...,)."""
    p5 = torch.pow(1.0 - dot_val, 5.0)[..., None]
    return r_s + (1.0 - r_s) * p5


def fresnel_equation(n_in, n_out, cos_inc, cos_ref):
    """Dielectric Fresnel reflectance (unpolarized average)."""
    n1ci, n2ci = n_in * cos_inc, n_out * cos_inc
    n1cr, n2cr = n_in * cos_ref, n_out * cos_ref
    rs = (n1ci - n2cr) / torch.clamp(torch.abs(n1ci + n2cr), min=1e-12) \
        * torch.sign(n1ci + n2cr)
    rp = (n1cr - n2ci) / torch.clamp(torch.abs(n1cr + n2ci), min=1e-12) \
        * torch.sign(n1cr + n2ci)
    return 0.5 * (rs * rs + rp * rp)


def fresnel_eval(cos_v, n_in, n_tr):
    """Fresnel reflectance from one signed cosine (la/geo_optics.py:29-44)."""
    neg = cos_v < 0
    cos_value = torch.abs(cos_v)
    ior_in = torch.where(neg, n_tr, n_in)
    ior_tr = torch.where(neg, n_in, n_tr)
    sin_v = sqrt0(torch.clamp(1.0 - cos_value * cos_value, min=0.0))
    sin_t = ior_in / ior_tr * sin_v
    cos_tr = sqrt0(torch.clamp(1.0 - sin_t * sin_t, min=0.0))
    return fresnel_equation(ior_in, ior_tr, cos_value, cos_tr)


def refraction_cos2(dot_n, ni, nr):
    """Squared cosine of the refraction angle; negative => total
    reflection."""
    ratio = ni / nr
    return 1.0 - ratio * ratio * (1.0 - dot_n * dot_n)


def is_total_reflection(dot_normal, ni, nr):
    return refraction_cos2(dot_normal, ni, nr) < 0.0


def snell_refraction(incid, normal, dot_n, ni, nr):
    """Refracted direction by Snell's law; returns (dir, cos_r2).

    On total internal reflection (cos_r2 <= 0) the direction is zeroed:
    callers branch on cos_r2 (reference la/geo_optics.py:66-75)."""
    exiting = torch.sign(dot_n)
    ratio = (ni / nr) * torch.ones_like(dot_n)
    cos_r2 = refraction_cos2(dot_n, ni, nr)
    sqrt_c = sqrt0(torch.clamp(cos_r2, min=0.0))
    refra = normalize(ratio[..., None] * incid
                      - (ratio * dot_n - exiting * sqrt_c)[..., None] * normal)
    valid = (cos_r2 > 0.0)[..., None]
    return torch.where(valid, refra, 0.0), cos_r2
