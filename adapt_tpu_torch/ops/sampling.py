"""Direction sampling (port of adapt_tpu/ops/sampling.py).

Samplers are pure: uniforms come in as tensors, so the RNG schedule stays
at the integrator level. Local frames are y-up, as in the reference.
"""
from __future__ import annotations

import torch

from ..constants import INV_PI, INV_2PI, INV_4PI, PI, PI2, PI_DIV2, PI_DIV4
from .math3d import sqrt0


def _spherical(cos_theta, phi):
    sin_theta = sqrt0(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
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


def uniform_cone(u1, u2, cos_range):
    """Uniform direction in a cone around +y (cos in [cos_range, 1])."""
    cos_theta = 1.0 - u1 + cos_range * u1
    phi = PI2 * u2
    return _spherical(cos_theta, phi)


def mod_phong_hemisphere(u1, u2, alpha):
    """Lafortune-Willems modified-Phong lobe around +y; (dir, pdf)."""
    cos_theta = torch.pow(u1, 1.0 / (alpha + 1.0))
    phi = PI2 * u2
    pdf = 0.5 * (1.0 + alpha) * torch.pow(cos_theta, alpha) * INV_PI
    return _spherical(cos_theta, phi), pdf


def fresnel_hemisphere(u1, u2, nu, nv):
    """Ashikhmin-Shirley anisotropic half-vector sample; (dir,
    power_coeff) (reference sampler/general_sampling.py:95-108)."""
    eps1 = u1 * 4.0
    inner = eps1 - torch.floor(eps1)
    tan_phi = torch.sqrt((nu + 1.0) / (nv + 1.0)) \
        * torch.tan(0.5 * PI * inner)
    cos_phi2 = 1.0 / (1.0 + tan_phi * tan_phi)
    sin_phi2 = 1.0 - cos_phi2
    cos_phi = torch.sqrt(cos_phi2)
    cos_phi = torch.where((eps1 > 1.0) & (eps1 <= 3.0), -cos_phi, cos_phi)
    sin_phi = sqrt0(sin_phi2) * torch.sign(2.0 - eps1)
    power_coeff = nu * cos_phi2 + nv * sin_phi2
    cos_theta = torch.pow(1.0 - u2, 1.0 / (power_coeff + 1.0))
    sin_theta = sqrt0(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    d = torch.stack([cos_phi * sin_theta, cos_theta, sin_phi * sin_theta],
                    dim=-1)
    return d, power_coeff


def concentric_disk(u1, u2):
    """Concentric disk sample in the y=0 plane; returns (..., 3)."""
    ox = u1 * 2.0 - 1.0
    oy = u2 * 2.0 - 1.0
    use_x = torch.abs(ox) > torch.abs(oy)
    safe_ox = torch.where(ox == 0.0, 1.0, ox)
    safe_oy = torch.where(oy == 0.0, 1.0, oy)
    theta = torch.where(use_x, PI_DIV4 * (oy / safe_ox),
                        PI_DIV2 - PI_DIV4 * (ox / safe_oy))
    r = torch.where(use_x, ox, oy)
    out = torch.stack([r * torch.cos(theta), torch.zeros_like(r),
                       r * torch.sin(theta)], dim=-1)
    return torch.where(((ox == 0.0) | (oy == 0.0))[..., None], 0.0, out)


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
