"""Direct Blinn-Phong preview (port of adapt_tpu/renderer/direct.py).

One wavefront pass: the primary hit by the closest-hit kernel (B1), a hard
shadow ray to emitter 0 by the any-hit kernel (B2), then Blinn-Phong
shading from that emitter as a point light. Depth and normal maps are side
outputs (the reference's direct_render.py:26-134 semantics). On a scene
loaded with device="cpu" the intersection wrappers run their plain
versions.
"""
from __future__ import annotations

import torch

from ..ops import bxdf_ops
from ..ops.intersect import ray_intersect, does_intersect
from ..ops.math3d import dot, normalize, norm
from .base import ProgressiveRenderer, camera_rays


def shadow_rays(scene, ray_o, ray_d, t):
    """(hit point, unit direction to emitter 0, distance to it) of each
    lane whose ray reached t; the shadow ray counts hits strictly before
    that distance (less RAY_EPS)."""
    hit_p = ray_o + t[:, None] * ray_d
    to_l = scene.emit_pos[0][None, :] - hit_p
    d = norm(to_l)
    return hit_p, to_l / torch.clamp(d[:, None], min=1e-12), d


def render_pass_direct(scene, cfg, key, cnt):
    """One preview pass; returns (color (N,3), depth (N,), normal (N,3)):
    depth 0 and normal 0 where the primary ray misses, the normal packed
    as n_s * 0.5 + 0.5."""
    ray_o, ray_d = camera_rays(scene, cfg, key, cnt)
    it = ray_intersect(scene, cfg, ray_o, ray_d)
    hit_p, ld, d = shadow_rays(scene, ray_o, ray_d, it.t)
    shadowed = does_intersect(scene, cfg, hit_p, ld, d)

    mat = bxdf_ops.gather_mat(scene, it.obj_id)
    half = normalize(ld - ray_d)
    cos_n = torch.clamp(dot(it.n_s, ld), min=0.0)
    spec_cos = torch.clamp(dot(it.n_s, half), min=0.0)
    shininess = torch.clamp(mat.kg[:, 0], min=1.0)
    atten = torch.clamp(1.0 / torch.clamp(d * d, min=1e-5), max=1.0)
    diffuse = mat.kd * cos_n[:, None]
    specular = mat.ks * (spec_cos[:, None] ** shininess[:, None])
    color = (diffuse + specular) * scene.emit_intensity[0][None, :] \
        * atten[:, None]
    color = torch.where((it.is_hit & ~shadowed)[:, None], color, 0.0)

    depth = torch.where(it.is_hit, it.t, 0.0)
    normal = torch.where(it.is_hit[:, None], it.n_s * 0.5 + 0.5, 0.0)
    return color, depth, normal


class DirectRenderer(ProgressiveRenderer):
    """Blinn-Phong direct-light preview (reference direct_render.py:26);
    `depth` (w, h) and `normal` (w, h, 3) hold the last pass's maps."""

    def __init__(self, scene, cfg, seed: int = 0):
        super().__init__(scene, cfg, seed)
        self.depth = torch.zeros((cfg.w, cfg.h), device=scene.device)
        self.normal = torch.zeros((cfg.w, cfg.h, 3), device=scene.device)

    def render_pass(self, key, cnt):
        color, depth, normal = render_pass_direct(self.scene, self.cfg, key,
                                                  cnt)
        self.depth = depth.reshape(self.cfg.w, self.cfg.h)
        self.normal = normal.reshape(self.cfg.w, self.cfg.h, 3)
        return color
