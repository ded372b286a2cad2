"""Screen-space ambient occlusion (port of adapt_tpu/renderer/ssao.py).

Two wavefront stages over all pixels, the primary hits by the closest-hit
kernel (B1):
  1. depth prepass: each pixel's primary-hit depth averaged over
     `depth_samples` camera passes (reference ssao.py:46-63), once, when
     the renderer is made;
  2. AO pass: `smp_hemisphere` uniform-hemisphere offsets around the
     shading normal, each re-rasterized into the camera and compared with
     the depth map under a smooth-step falloff (ssao.py:65-130).
The draws are the JAX package's (rng.split and rng.uniform in its order),
so a pass equals the reference's but where an offset rasterizes onto the
edge between two depth texels.
"""
from __future__ import annotations

import torch

from .. import rng
from ..ops.intersect import ray_intersect
from ..ops.math3d import delocalize_rotate, dot, norm
from ..ops.sampling import uniform_hemisphere
from .base import ProgressiveRenderer, camera_rays


def _smooth_step(e0, e1, x):
    t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def depth_prepass(scene, cfg, key):
    """Averaged primary-hit depth map, (N,): sample s traces camera rays
    with the key of the s-th split and count s (reference
    ssao.py:46-63)."""
    N = cfg.n_pixels
    acc = torch.zeros(N, device=scene.device)
    cnt = torch.zeros(N, device=scene.device)
    for s in range(cfg.depth_samples):
        key, sub = rng.split(key)
        ray_o, ray_d = camera_rays(scene, cfg, sub, s)
        it = ray_intersect(scene, cfg, ray_o, ray_d)
        acc = acc + torch.where(it.is_hit, it.t, 0.0)
        cnt = cnt + it.is_hit.to(torch.float32)
    return acc / torch.clamp(cnt, min=1.0)


def render_pass_ssao(scene, cfg, key, cnt, depth_map):
    """One AO sample pass; returns (N,3) occlusion as gray (0 where the
    primary ray misses)."""
    key, cam_key = rng.split(key)
    ray_o, ray_d = camera_rays(scene, cfg, cam_key, cnt)
    N = ray_o.shape[0]
    dev = ray_o.device
    it = ray_intersect(scene, cfg, ray_o, ray_d)
    pos = ray_o + it.t[:, None] * ray_d

    # cam_r @ (0, 0, 1) and rd @ cam_r written out as ordered f32 sums, as
    # camera_rays does, so no TF32 matrix product rounds them
    r = scene.cam_r
    cam_normal = torch.stack([(r[k, 0] * 0.0 + r[k, 1] * 0.0) + r[k, 2]
                              for k in range(3)])
    half_w, half_h = cfg.w * 0.5, cfg.h * 0.5

    def splat_depth(rd):
        """Rasterize world directions into the film and read the depth
        map there (reference ssao.py:64-90); the pixel index truncates
        toward zero, as the reference's int32 cast does."""
        local = [(rd[:, 0] * r[0, k] + rd[:, 1] * r[1, k])
                 + rd[:, 2] * r[2, k] for k in range(3)]
        z = local[2]
        safe_z = torch.where(torch.abs(z) < 1e-9, 1.0, z)
        lx = local[0] / safe_z
        ly = local[1] / safe_z
        pi = (half_w + 1.0 - lx * cfg.focal).to(torch.int32)
        pj = (half_h + 1.0 + ly * cfg.focal).to(torch.int32)
        ok = (dot(rd, cam_normal) > 0.0) & (z > 0.0) \
            & (pi >= cfg.start_x) & (pi < cfg.end_x) \
            & (pj >= cfg.start_y) & (pj < cfg.end_y)
        flat = torch.clamp(pi, 0, cfg.w - 1) * cfg.h \
            + torch.clamp(pj, 0, cfg.h - 1)
        return torch.where(ok, depth_map[flat.long()], 0.0)

    occ = torch.zeros(N, device=dev)
    for _s in range(cfg.smp_hemisphere):
        key, sub = rng.split(key)
        u = rng.uniform(sub, (N, 2), device=dev)
        local_dir, _ = uniform_hemisphere(u[:, 0], u[:, 1])
        world_dir = delocalize_rotate(it.n_s, local_dir)
        sample_p = pos + world_dir * cfg.sample_extent
        rd = sample_p - scene.cam_t[None, :]
        depth = norm(rd)
        rd = rd / torch.clamp(depth[:, None], min=1e-12)
        queried = splat_depth(rd) + 1e-3
        occluded = (depth >= queried).to(torch.float32) * _smooth_step(
            0.0, 1.0, cfg.sample_extent / torch.clamp(
                torch.abs(queried - depth), min=1e-9))
        occ = occ + occluded
    ao = 1.0 - occ / cfg.smp_hemisphere
    ao = torch.where(it.is_hit, ao, 0.0)
    return ao[:, None].expand(N, 3)


class SSAORenderer(ProgressiveRenderer):
    """SSAO (reference ssao.py:27): the depth prepass runs once, in
    __init__, on a key split from the seed's before the first pass."""

    def __init__(self, scene, cfg, seed: int = 0):
        super().__init__(scene, cfg, seed)
        self.key, sub = rng.split(self.key)
        self.depth_map = depth_prepass(scene, cfg, sub)

    def render_pass(self, key, cnt):
        return render_pass_ssao(self.scene, self.cfg, key, cnt,
                                self.depth_map)
