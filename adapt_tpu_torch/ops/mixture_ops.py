"""BxDF mixtures: a probabilistic combination of component materials
(port of adapt_tpu/ops/mixture_ops.py; the reference's `BxDFMixture`,
bxdf/mixture.py:30-121).

A mixture row holds up to four component material ids (rows of the
scene's material tables, which the compiler appends after the objects'
rows) with their sampling proportions. Sampling picks one component by
proportion (the lane's u[:, 5]) and delegates to it; eval and pdf are the
proportion-weighted sums over the present components.
"""
from __future__ import annotations

import dataclasses

import torch

from ..constants import TRANSPORT_UNI
from . import bxdf_ops
from .math3d import axis_vec

N_COMPONENTS = 4     # diffuse / glossy / specular / transmit slots


@dataclasses.dataclass
class MixtureTable:
    """Per-mixture component ids and proportions (reference
    mixture.py:30-45).

    comp_ids: (M, 4) i32 rows of the material tables (-1 = unused);
    probs: (M, 4) f32 sampling proportions (a sum below 1 leaves the rest
    absorbed)."""
    comp_ids: torch.Tensor
    probs: torch.Tensor


def _component_mats(scene, mix, mix_id):
    """Each of the four component slots' MatParams, lane by lane."""
    ids = mix.comp_ids[mix_id.long()]            # (N, 4)
    probs = mix.probs[mix_id.long()]             # (N, 4)
    mats = [bxdf_ops.gather_mat(scene, ids[:, c])
            for c in range(N_COMPONENTS)]
    return mats, probs, ids >= 0


def mixture_eval(scene, cfg, mix, mix_id, it, incid, out, world_ior,
                 mode=TRANSPORT_UNI):
    """Proportion-weighted sum of the component evals (mixture.py:62-80)."""
    mats, probs, present = _component_mats(scene, mix, mix_id)
    res = torch.zeros((incid.shape[0], 3), device=incid.device)
    for c in range(N_COMPONENTS):
        ev = bxdf_ops.surface_eval(cfg, mats[c], it, incid, out, world_ior,
                                   mode)
        w = torch.where(present[:, c], probs[:, c], 0.0)
        res = res + ev * w[:, None]
    return res


def mixture_pdf(scene, cfg, mix, mix_id, it, outdir, incid, world_ior):
    """Proportion-weighted pdf (mixture.py:99-121)."""
    mats, probs, present = _component_mats(scene, mix, mix_id)
    pdf = torch.zeros(incid.shape[0], device=incid.device)
    for c in range(N_COMPONENTS):
        p = bxdf_ops.surface_pdf(cfg, mats[c], it, outdir, incid, world_ior)
        pdf = pdf + torch.where(present[:, c], probs[:, c] * p, 0.0)
    return pdf


def mixture_sample(scene, cfg, mix, mix_id, it, incid, u, world_ior,
                   mode=TRANSPORT_UNI):
    """Pick a component by proportion, delegate sampling, scale the pdf
    (mixture.py:46-60). Returns (dir, spec, pdf, is_specular); a lane
    whose pick falls in the absorbed remainder returns zero spec."""
    N = incid.shape[0]
    dev = incid.device
    mats, probs, present = _component_mats(scene, mix, mix_id)
    probs = torch.where(present, probs, 0.0)
    cdf = torch.cumsum(probs, dim=1)
    comp = (u[:, 5:6] >= cdf).sum(dim=1)          # 4: absorbed
    out = axis_vec(1, dev).expand(N, 3)
    spec = torch.zeros((N, 3), device=dev)
    pdf = torch.ones(N, device=dev)
    is_spec = torch.zeros(N, dtype=torch.bool, device=dev)
    for c in range(N_COMPONENTS):
        m = comp == c
        d, s, p, isp = bxdf_ops.surface_sample(cfg, mats[c], it, incid, u,
                                               world_ior, mode)
        out = torch.where(m[:, None], d, out)
        spec = torch.where(m[:, None], s, spec)
        pdf = torch.where(m, p * probs[:, c], pdf)
        is_spec = torch.where(m, isp, is_spec)
    return out, spec, pdf, is_spec
