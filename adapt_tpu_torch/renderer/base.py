"""Renderer base: camera rays, film accumulation, progressive host loop.

Port of adapt_tpu/renderer/base.py: each `render()` call adds one sample
per pixel into an accumulation buffer; `pixels` is the running average.
The RNG stream is the JAX package's, bit for bit (rng.py).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import obs, rng
from ..convert import key_from_numpy, key_to_numpy
from ..ops.math3d import normalize

_EPS = 1e-4
_INV_EPS = 1.0 - 2.0 * _EPS


@obs.spanned("render.camera", lambda scene, cfg, key, cnt, pix_ids=None:
             {"n": cfg.n_pixels if pix_ids is None else pix_ids.shape[0]})
def camera_rays(scene, cfg, key, cnt, pix_ids=None):
    """One primary ray per pixel; returns (ray_o, ray_d) of (N,3).

    Pixel layout is x-major: flat index = i * h + j with i in [0,w) and j
    in [0,h) (reference tracer_base.py:136-157). The rotation by cam_r is
    written out as f32 sums ((x0*r0 + x1*r1) + x2*r2), so it rounds the
    same on every device and never goes through a TF32 matrix product."""
    w, h = cfg.w, cfg.h
    dev = scene.device
    if pix_ids is None:
        i = torch.arange(w, dtype=torch.float32, device=dev) \
            .repeat_interleave(h)
        j = torch.arange(h, dtype=torch.float32, device=dev).repeat(w)
    else:
        i = torch.div(pix_ids, h, rounding_mode="floor").to(torch.float32)
        j = (pix_ids % h).to(torch.float32)
    n = i.shape[0]
    if cfg.anti_alias:
        u = rng.uniform(key, (n, 2), device=dev)
        if cfg.stratified_sampling:
            mod_val = float(cnt % 16)
            vx = math.floor(mod_val % 4.0) * 0.25 + u[:, 0] * 0.25
            vy = math.floor(mod_val / 4.0) * 0.25 + u[:, 1] * 0.25
        else:
            vx = u[:, 0] * _INV_EPS + _EPS
            vy = u[:, 1] * _INV_EPS + _EPS
    else:
        vx = torch.full((n,), 0.5, device=dev)
        vy = torch.full((n,), 0.5, device=dev)
    inv_focal = 1.0 / float(cfg.focal)
    cam_dir = torch.stack([(0.5 * w + vx - i) * inv_focal,
                           (j - 0.5 * h - vy) * inv_focal,
                           torch.ones(n, device=dev)], dim=-1)
    nd = normalize(cam_dir)
    r = scene.cam_r
    ray_d = torch.stack([(nd[:, 0] * r[k, 0] + nd[:, 1] * r[k, 1])
                         + nd[:, 2] * r[k, 2] for k in range(3)], dim=-1)
    ray_o = scene.cam_t.expand(n, 3)
    return ray_o, ray_d


def crop_pix_ids(cfg, device=None):
    """Flat pixel ids (i*h + j) of the crop window, or None when no crop
    (reference tracer_base.py:39-55: only crop pixels are traced)."""
    w, h = cfg.w, cfg.h
    if (cfg.start_x, cfg.end_x, cfg.start_y, cfg.end_y) == (0, w, 0, h):
        return None
    i = np.arange(cfg.start_x, cfg.end_x)[:, None]
    j = np.arange(cfg.start_y, cfg.end_y)[None, :]
    return torch.from_numpy((i * h + j).reshape(-1)).to(device)


class ProgressiveRenderer:
    """Stateful host wrapper with the reference's incremental-display API."""

    def __init__(self, scene, cfg, seed: int = 0):
        self.scene = scene
        self.cfg = cfg
        self.key = rng.PRNGKey(seed)
        self.color = torch.zeros((cfg.w, cfg.h, 3), device=scene.device)
        self.cnt = 0

    def render_pass(self, key, cnt):
        raise NotImplementedError

    def render(self, *_args):
        """One progressive iteration: +1 spp into the accumulator."""
        self.cnt += 1
        with obs.span(obs.PASS, cnt=self.cnt, spp=1):
            self.key, sub = rng.split(self.key)
            radiance = torch.nan_to_num(self.render_pass(sub, self.cnt),
                                        nan=0.0)
            self.color = self.color + radiance.reshape(self.cfg.w,
                                                       self.cfg.h, 3)
        return self.color

    def render_batch(self, spp: int):
        """Accumulate `spp` samples."""
        for _ in range(spp):
            self.render()
        return self.color

    @property
    def pixels(self):
        """Running average, (w, h, 3)."""
        return self.color / max(self.cnt, 1)

    def image(self) -> np.ndarray:
        """Averaged frame as (h, w, 3) float32 numpy: the (w, h) y-up film
        transposed and flipped vertically (reference imwrite mapping)."""
        return obs.host_read(self.pixels.transpose(0, 1).flip(0),
                             "film.image").numpy()

    # --- checkpointing (reference path_tracer.py:181-211) ---
    _CHECK_KEYS = ("w", "h", "focal", "max_bounce",
                   "start_x", "end_x", "start_y", "end_y")

    def get_check_point(self) -> dict:
        chk = {k: getattr(self.cfg, k) for k in self._CHECK_KEYS}
        chk.update({
            "renderer": type(self).__name__,
            "accumulation": obs.host_read(self.color,
                                          "film.checkpoint").numpy(),
            "counter": self.cnt,
            "key": key_to_numpy(self.key),
        })
        return chk

    def load_check_point(self, chk: dict):
        want = type(self).__name__
        got = chk.get("renderer", want)
        if got != want:
            raise ValueError(
                f"checkpoint was written by renderer '{got}', cannot "
                f"resume into '{want}'")
        for k in self._CHECK_KEYS:
            if k in chk and chk[k] != getattr(self.cfg, k):
                raise ValueError(
                    f"checkpoint mismatch on '{k}': saved {chk[k]!r}, "
                    f"current config {getattr(self.cfg, k)!r}")
        self.color = torch.as_tensor(chk["accumulation"],
                                     device=self.scene.device)
        self.cnt = int(chk["counter"])
        self.key = key_from_numpy(chk["key"])
