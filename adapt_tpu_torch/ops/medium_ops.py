"""Homogeneous media and phase functions (port of adapt_tpu/ops/medium_ops.py).

Batched equivalents of the reference's Medium/PhaseFunction device structs
(bxdf/medium.py:85-125, bxdf/phase.py:20-81, sampler/phase_sampling.py):
closed-form transmittance, spectral mean-free-path sampling, and
HG / multi-HG / Rayleigh phase sampling and evaluation. Every function
takes per-ray parameter rows gathered from a MediumTable.

Sums over the three RGB channels or lobes are written out as
((x0 + x1) + x2), the order the JAX package's size-3 reductions take, so
a lane's result does not depend on the width of the batch it sits in.
"""
from __future__ import annotations

import math

import torch

from ..constants import MediumTag
from .math3d import axis_vec, rotate_between_apply
from .sampling import _spherical, random_rgb_channel

_F4PI = 1.0 / (4.0 * math.pi)


def _sum3(x):
    return (x[..., 0] + x[..., 1]) + x[..., 2]


def _signed_floor(x, eps):
    """x with its magnitude floored at eps, keeping its sign."""
    return torch.where(torch.abs(x) < eps,
                       torch.where(x < 0.0, -eps, eps), x)


# ------------------------------ phase functions ------------------------------

def eval_hg(g, cos_t):
    """Henyey-Greenstein phase value (reference phase.py:20-24)."""
    g2 = g * g
    denom = torch.clamp(1.0 + g2 - 2.0 * g * cos_t, min=1e-8)
    return _F4PI * (1.0 - g2) / (denom * torch.sqrt(denom))


def sample_hg(g, u):
    """Inverse-CDF HG cosine sample (reference phase_sampling.py:16-29).

    The 2g divisor keeps its sign: a positive floor would collapse every
    backscattering (g < 0) sample to |cos| = 1. The |g| < 1e-4 branch
    takes the singular region, so only a sign-preserving floor of the
    magnitude is needed elsewhere."""
    g2 = g * g
    sqr = (1.0 - g2) / _signed_floor(1.0 + g - 2.0 * g * u, 1e-8)
    cos_g = (1.0 + g2 - sqr * sqr) / _signed_floor(2.0 * g, 1e-8)
    cos_0 = 1.0 - 2.0 * u
    return torch.where(torch.abs(g) < 1e-4, cos_0,
                       torch.clamp(cos_g, -1.0, 1.0))


def eval_rayleigh(cos_t):
    """Rayleigh phase value 3/(16 pi) (1 + cos^2) (reference phase.py:27-29)."""
    return 3.0 / (16.0 * math.pi) * (1.0 + cos_t * cos_t)


def sample_rayleigh(u):
    """Exact inverse-CDF Rayleigh cosine sample
    (reference phase_sampling.py:31-40): Cardano's root of
    x^3 + 3x - 4w = 0, x = z - 1/z. The cube root's argument
    2w + sqrt(4w^2 + 1) is positive, so a real power takes it."""
    w = 2.0 * u - 1.0
    z = torch.pow(2.0 * w + torch.sqrt(4.0 * w * w + 1.0), 1.0 / 3.0)
    return torch.clamp(z - 1.0 / z, -1.0, 1.0)


def _multi_hg(par, lobe_pdf, cos_t):
    """Lobe-weighted mixture of the three HG lobes at cos_t."""
    vals = torch.stack([eval_hg(par[:, i], cos_t) for i in range(3)], dim=-1)
    return _sum3(lobe_pdf * vals)


def phase_sample(kind, par, lobe_pdf, incid, u, present_kinds):
    """Sample a new direction from the per-ray phase function.

    kind (N,) MediumTag; par (N,3) phase parameters; lobe_pdf (N,3)
    multi-HG lobe weights; incid (N,3) incident propagation direction; u
    (N,3) uniforms. Returns (new_dir, phase value); the value is also the
    sample's pdf (MIS), as in the reference. Lanes of other kinds sample
    the isotropic phase function."""
    cos_t = 1.0 - 2.0 * u[:, 0]
    val = torch.full(kind.shape, _F4PI, device=kind.device)
    for k in present_kinds:
        m = kind == k
        if k == MediumTag.HG:
            g = par[:, 0]
            c = sample_hg(g, u[:, 0])
            cos_t = torch.where(m, c, cos_t)
            val = torch.where(m, eval_hg(g, c), val)
        elif k == MediumTag.MULTI_HG:
            # pick one of 3 lobes by weight, sample it, eval the mixture
            cdf0 = lobe_pdf[:, 0]
            cdf1 = cdf0 + lobe_pdf[:, 1]
            lobe = (u[:, 2] >= cdf0).to(torch.int64) \
                + (u[:, 2] >= cdf1).to(torch.int64)
            g_sel = par.gather(1, lobe[:, None])[:, 0]
            c = sample_hg(g_sel, u[:, 0])
            cos_t = torch.where(m, c, cos_t)
            val = torch.where(m, _multi_hg(par, lobe_pdf, c), val)
        elif k == MediumTag.RAYLEIGH:
            c = sample_rayleigh(u[:, 0])
            cos_t = torch.where(m, c, cos_t)
            val = torch.where(m, eval_rayleigh(c), val)
    local = _spherical(cos_t, 2.0 * math.pi * u[:, 1])
    new_dir = rotate_between_apply(axis_vec(1, incid.device), incid, local)
    return new_dir, val


def phase_eval(kind, par, lobe_pdf, incid, out, present_kinds):
    """Phase function value for (incid -> out) (reference phase.py:62-81)."""
    cos_t = _sum3(incid * out)
    val = torch.full(kind.shape, _F4PI, device=kind.device)
    for k in present_kinds:
        m = kind == k
        if k == MediumTag.HG:
            val = torch.where(m, eval_hg(par[:, 0], cos_t), val)
        elif k == MediumTag.MULTI_HG:
            val = torch.where(m, _multi_hg(par, lobe_pdf, cos_t), val)
        elif k == MediumTag.RAYLEIGH:
            val = torch.where(m, eval_rayleigh(cos_t), val)
    return val


# --------------------------- homogeneous transport ---------------------------

def transmittance(u_e, is_scattering, depth):
    """Beer-Lambert Tr = exp(-sigma_e d) (reference medium.py:85-87)."""
    tr = torch.exp(-u_e * depth[..., None])
    return torch.where(is_scattering[..., None], tr, 1.0)


def sample_mfp(u_e, u_s, is_scattering, max_depth, u):
    """Spectral mean-free-path sampling (reference medium.py:89-108).

    Picks one RGB channel uniformly, samples an exponential flight
    distance with that channel's sigma_e, and weights by the
    channel-averaged pdf. u: (N,2) uniforms. Returns
    (is_medium_interaction, t, beta (N,3))."""
    ch_sigma, _ = random_rgb_channel(u[:, 0], u_e)
    ch_sigma = torch.clamp(ch_sigma, min=1e-8)
    t = -torch.log(torch.clamp(1.0 - u[:, 1], min=1e-12)) / ch_sigma
    in_medium = t < max_depth
    t = torch.minimum(t, max_depth)
    tr = torch.exp(-u_e * t[..., None])                     # (N,3)
    # pdf averaged over the 3 channel choices
    pdf_medium = _sum3(u_e * tr) / 3.0
    pdf_surface = _sum3(tr) / 3.0
    beta_medium = tr * u_s / torch.clamp(pdf_medium, min=1e-12)[..., None]
    beta_surface = tr / torch.clamp(pdf_surface, min=1e-12)[..., None]
    beta = torch.where(in_medium[..., None], beta_medium, beta_surface)
    ok = is_scattering & (max_depth > 0.0)
    return (ok & in_medium,
            torch.where(ok, t, max_depth),
            torch.where(ok[..., None], beta, 1.0))
