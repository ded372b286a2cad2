"""Direction sampling (port of adapt_tpu/ops/sampling.py, the parts PT,
VPT and SSAO call).

Samplers are pure: uniforms come in as tensors, so the RNG schedule stays
at the integrator level. Local frames are y-up, as in the reference.
"""
from __future__ import annotations

import torch

from ..constants import INV_PI, INV_2PI, INV_4PI, PI2


def _spherical(cos_theta, phi):
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    return torch.stack([torch.cos(phi) * sin_theta, cos_theta,
                        torch.sin(phi) * sin_theta], dim=-1)


def cosine_hemisphere(u1, u2):
    """Cosine-weighted hemisphere around +y; returns (dir, pdf)."""
    cos_theta = torch.sqrt(u1)
    phi = PI2 * u2
    return _spherical(cos_theta, phi), cos_theta * INV_PI


def uniform_hemisphere(u1, u2):
    """Uniform direction on the hemisphere around +y; returns (dir,
    pdf)."""
    cos_theta = u1
    phi = PI2 * u2
    return _spherical(cos_theta, phi), torch.full_like(u1, INV_2PI)


def uniform_sphere(u1, u2):
    """Uniform direction on the unit sphere; returns (dir, pdf)."""
    cos_theta = 2.0 * u1 - 1.0
    phi = PI2 * u2
    return _spherical(cos_theta, phi), torch.full_like(u1, INV_4PI)


def sample_triangle(dv1, dv2, u1, u2):
    """Uniform point on a triangle spanned by edge vectors dv1, dv2
    (offset from the triangle origin vertex)."""
    pt = dv1 * u1[..., None] + dv2 * u2[..., None]
    flip = (u1 + u2 > 1.0)[..., None]
    return torch.where(flip, dv1 + dv2 - pt, pt)


def random_rgb_channel(u, vector):
    """Pick one RGB channel uniformly; returns (value, channel_idx), the
    value floored at 1e-5 (reference general_sampling.py:16-27)."""
    idx = torch.clamp((u * 3.0).to(torch.int64), max=2)
    val = vector.gather(-1, idx[..., None])[..., 0]
    return torch.clamp(val, min=1e-5), idx


def balance_heuristic(pdf_a, pdf_b):
    """Two-sample MIS balance heuristic; 0 when pdf_a ~ 0
    (reference sampler/general_sampling.py:120-123)."""
    return torch.where(pdf_a > 1e-7,
                       pdf_a / torch.clamp(pdf_a + pdf_b, min=1e-12), 0.0)
