"""Wavefront unidirectional path tracer with NEE + MIS (port of
adapt_tpu/renderer/pt.py).

The whole ray wavefront advances through the bounce pipeline in lockstep:
intersect -> russian roulette -> BSDF sample -> NEE -> emission MIS ->
re-intersect, with dead rays masked out. The random stream is the JAX
package's, consumed in the same order (pt.py:79-110, :183-189, :221,
:236-239), so renders compare to it pixel by pixel. The bounce loop is a
Python loop over a state dict; a length-compaction schedule
(renderer/compact.py) narrows it to the alive lanes at its splits.
Renderers of scenes with AUTO_MIN_PRIMS prims or more derive that
schedule from one probe pass (adapt_tpu/renderer/pt.py:357-392).

PT renders every scene the tables hold, as the JAX package's PT does:
every BRDF and BSDF, textures and mixtures, the four light kinds. It reads
no medium but the world's IOR and no grid volume; a null BSDF (a medium
boundary) passes the ray straight on as a delta of weight 1
(ops/bxdf_ops.py `surface_sample`, the JAX package's arm).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import obs, rng
from ..ops import bxdf_ops, emitter_ops
from ..ops.intersect import ray_intersect, does_intersect
from ..ops.math3d import norm
from ..ops.sampling import balance_heuristic
from ..ops.texture_ops import get_uv_item, process_ns
from . import compact
from .base import ProgressiveRenderer, camera_rays, crop_pix_ids

# Auto-compaction gate: scenes with at least this many prims derive a
# schedule from a first-pass alive probe (compact.derive_schedule); small
# scenes stay schedule-free (adapt_tpu/renderer/pt.py:357-361).
_AUTO_MIN_PRIMS = 20000


def _hit_light(mat, it):
    """Emitter id attached to the hit object, -1 if none / miss."""
    return torch.where(it.obj_id >= 0, mat.emit, -1)


def _finish_it(scene, cfg, it):
    """Normal/bump perturbation + albedo fetch at interaction creation
    (vanilla_renderer.py:42,66). The same object on an untextured scene:
    it.tex stays None, so the BxDFs read k_d without a select."""
    it = process_ns(scene, cfg, it)
    if scene.tex["albedo"].present:
        tex, _ = get_uv_item(scene, scene.tex["albedo"], it)
        it = dataclasses.replace(it, tex=tex)
    return it


def trace_pt(scene, cfg, key, ray_o, ray_d, schedule=(),
             collect_alive=False):
    """Trace a (N,3) ray wavefront through the bounce pipeline; returns
    the (N,3) radiance of each lane.

    schedule: length-compaction splits (renderer/compact.py); the per-lane
    draws are keyed by (bounce, original lane id), so a compacted trace
    equals the plain one lane for lane. collect_alive: also return the
    (max_bounce,) alive lane counts after each bounce (no compaction), the
    profile auto-compaction derives its schedule from."""
    N = ray_o.shape[0]
    dev = ray_o.device
    world_ior = scene.world_medium.ior[0]
    D = 7 + 4 * max(cfg.num_shadow_ray, 1)   # uniforms drawn per bounce

    it = _finish_it(scene, cfg, ray_intersect(scene, cfg, ray_o, ray_d))
    mat = bxdf_ops.gather_mat(scene, it.obj_id)
    init = dict(
        ray_o=ray_o, ray_d=ray_d, it=it, mat=mat,
        hit_light=_hit_light(mat, it),
        color=torch.zeros((N, 3), device=dev),
        contribution=torch.ones((N, 3), device=dev),
        emission_weight=torch.ones(N, device=dev),
        active=torch.ones(N, dtype=torch.bool, device=dev),
        pos=torch.arange(N, dtype=torch.int32, device=dev))

    def bounce(b, st):
        with obs.span("pt.bounce", b=b, n=st["active"].shape[0]):
            return _bounce(b, st)

    def _bounce(b, st):
        it, mat, hit_light = st["it"], st["mat"], st["hit_light"]
        ray_o, ray_d = st["ray_o"], st["ray_d"]
        contribution = st["contribution"]
        active = st["active"] & it.is_hit
        n = active.shape[0]
        u_all = rng.lane_uniform(rng.fold_in(key, b), st["pos"], D)

        # --- russian roulette (vanilla_renderer.py:50-57) ---
        max_val = contribution.amax(dim=-1)
        if cfg.use_rr:
            candidate = (max_val < cfg.rr_threshold) & (b >= cfg.rr_bounce_th)
            killed = candidate & (u_all[:, 0] > max_val)
            boost = torch.where(candidate, 1.0 / (max_val + 1e-7), 1.0)
            contribution = contribution * boost[:, None]
            active = active & ~killed
        else:
            active = active & (max_val >= 1e-4)
        obs.lanes(active)

        # dead lanes carry t = -3e38; clamp them to the origin so no
        # overflow breeds inf/nan in the masked branches below
        hit_point = ray_o + torch.where(active, it.t, 0.0)[:, None] * ray_d

        # --- BSDF sample for the continuation, drawn BEFORE NEE (the JAX
        # package's stream order) ---
        new_dir, indirect_spec, ray_pdf, is_specular = \
            bxdf_ops.surface_sample(cfg, mat, it, ray_d, u_all[:, 1:7],
                                    world_ior, scene=scene)

        # --- next-event estimation (vanilla_renderer.py:67-97) ---
        direct_int = torch.zeros((n, 3), device=dev)
        for s in range(cfg.num_shadow_ray):
            eid, emitter_pdf, valid = emitter_ops.sample_light_index(
                cfg, u_all[:, 7 + 4 * s], hit_light)
            emit_pos, shadow_int, direct_pdf, _n = emitter_ops.sample_hit(
                scene, cfg, eid, hit_point, u_all[:, 8 + 4 * s:11 + 4 * s])
            to_emitter = emit_pos - hit_point
            emitter_d = norm(to_emitter)
            light_dir = to_emitter / torch.clamp(emitter_d[:, None],
                                                 min=1e-12)
            occluded = does_intersect(scene, cfg, hit_point, light_dir,
                                      emitter_d, alive=active)
            direct_spec = bxdf_ops.surface_eval(cfg, mat, it, ray_d,
                                                light_dir, world_ior,
                                                scene=scene)
            if cfg.use_mis:
                light_pdf = emitter_pdf * direct_pdf
                bsdf_pdf = bxdf_ops.surface_pdf(cfg, mat, it, light_dir,
                                                ray_d, world_ior,
                                                scene=scene)
                mis_w = torch.where(emitter_ops.is_delta_pos(scene, eid), 1.0,
                                    balance_heuristic(light_pdf, bsdf_pdf))
            else:
                mis_w = torch.ones(n, device=dev)
            contrib = direct_spec * shadow_int \
                * (mis_w / emitter_pdf)[:, None]
            ok = valid & ~occluded
            direct_int = direct_int + torch.where(ok[:, None], contrib, 0.0)
        direct_int = direct_int / float(max(cfg.num_shadow_ray, 1))

        # --- emission hit (vanilla_renderer.py:99-101) ---
        emit_le = emitter_ops.eval_le(scene, hit_light.clamp(min=0), ray_d,
                                      it.n_s)
        emit_int = torch.where((hit_light >= 0)[:, None], emit_le, 0.0)
        color = st["color"] + torch.where(
            active[:, None],
            (direct_int + emit_int * st["emission_weight"][:, None])
            * contribution, 0.0)
        # the last bounce's continuation would feed nothing: stop here
        if b == cfg.max_bounce - 1:
            return dict(st, color=color, active=active)
        contribution = contribution * indirect_spec \
            / torch.clamp(ray_pdf, min=1e-9)[:, None]

        # --- next hit + emission MIS weight (vanilla_renderer.py:109-117) ---
        it = _finish_it(scene, cfg, ray_intersect(scene, cfg, hit_point,
                                                  new_dir, alive=active))
        mat = bxdf_ops.gather_mat(scene, it.obj_id)
        hit_light = _hit_light(mat, it)
        emission_weight = st["emission_weight"]
        if cfg.use_mis:
            surf_delta = mat.is_delta & (it.obj_id >= 0)
            can_mis = (hit_light >= 0) & ~surf_delta & ~is_specular
            # dead lanes' t = -3e38 squares to inf; the masked pdf's zero
            # cotangent times it would be a NaN gradient (forward values
            # are those of it.t: every can_mis lane is live)
            e_pdf = torch.where(
                can_mis,
                emitter_ops.solid_angle_pdf(scene, hit_light.clamp(min=0),
                                            it.n_s,
                                            torch.where(can_mis, it.t, 0.0),
                                            new_dir), 0.0)
            emission_weight = balance_heuristic(ray_pdf, e_pdf)
        return dict(ray_o=hit_point, ray_d=new_dir, it=it, mat=mat,
                    hit_light=hit_light, color=color,
                    contribution=contribution,
                    emission_weight=emission_weight, active=active,
                    pos=st["pos"])

    if collect_alive:
        st, counts = init, []
        for b in range(cfg.max_bounce):
            st = bounce(b, st)
            counts.append(st["active"].sum())
        return st["color"], torch.stack(counts)
    return compact.run_compacted(bounce, init, cfg.max_bounce, schedule)


def _scatter(cfg, pix, color):
    if pix is None:
        return color
    film = torch.zeros((cfg.n_pixels, 3), device=color.device)
    film[pix] = color
    return film


def render_pass_pt(scene, cfg, key, cnt, schedule=()):
    """One progressive sample for every pixel; returns (N, 3) radiance."""
    pix = crop_pix_ids(cfg, scene.device)
    key, cam_key = rng.split(key)
    ray_o, ray_d = camera_rays(scene, cfg, cam_key, cnt, pix_ids=pix)
    return _scatter(cfg, pix, trace_pt(scene, cfg, key, ray_o, ray_d,
                                       schedule=schedule))


def render_batch_pt(scene, cfg, key, cnt0, spp, schedule=()):
    """SUM of spp progressive samples, (N, 3); the JAX package's stream
    at fuse=1 (sample i: key fold_in i, camera key split off fold_in 0,
    trace key fold_in 7919)."""
    pix = crop_pix_ids(cfg, scene.device)
    acc = None
    for i in range(spp):
        with obs.span(obs.PASS, cnt=cnt0 + i, spp=1):
            sub = rng.fold_in(key, i)
            k_cam, _ = rng.split(rng.fold_in(sub, 0))
            ray_o, ray_d = camera_rays(scene, cfg, k_cam, cnt0 + i,
                                       pix_ids=pix)
            color = torch.nan_to_num(
                trace_pt(scene, cfg, rng.fold_in(sub, 7919), ray_o, ray_d,
                         schedule=schedule), nan=0.0)
            acc = color if acc is None else acc + color
    if acc is None:
        n = cfg.n_pixels if pix is None else pix.shape[0]
        acc = torch.zeros((n, 3), device=scene.device)
    return _scatter(cfg, pix, acc)


def probe_alive_pt(scene, cfg, key, cnt):
    """One full pass that also returns the (max_bounce,) alive counts:
    the auto-compaction probe. Returns (radiance (N,3), counts)."""
    key, cam_key = rng.split(key)
    ray_o, ray_d = camera_rays(scene, cfg, cam_key, cnt)
    return trace_pt(scene, cfg, key, ray_o, ray_d, collect_alive=True)


class Renderer(ProgressiveRenderer):
    """Unidirectional MIS path tracer (reference vanilla_renderer.py:22).

    Scenes of at least _AUTO_MIN_PRIMS prims probe the alive profile once,
    before their first pass, and length-compact every pass with the
    derived schedule."""

    def __init__(self, scene, cfg, seed: int = 0):
        super().__init__(scene, cfg, seed)
        self._auto = scene.n_prims >= _AUTO_MIN_PRIMS
        self._sched = None

    def _schedule(self):
        if self._auto and self._sched is None:
            # the probe draws from a fold_in of the current key (self.key
            # untouched) and its sample is discarded, so the stream and
            # the image equal a schedule-free renderer's exactly
            with obs.setup_span("setup.probe"):
                _, counts = probe_alive_pt(self.scene, self.cfg,
                                           rng.fold_in(self.key, 0x5EED), 1)
                profile = obs.host_read(counts, "pt.probe").numpy() \
                    .astype(np.float64) / self.cfg.n_pixels
            self._sched = compact.derive_schedule(profile,
                                                  self.cfg.max_bounce)
        return self._sched or ()

    def render_pass(self, key, cnt):
        return render_pass_pt(self.scene, self.cfg, key, cnt,
                              schedule=self._schedule())

    def render_batch(self, spp: int):
        sched = self._schedule()
        self.key, sub = rng.split(self.key)
        acc = render_batch_pt(self.scene, self.cfg, sub, self.cnt + 1, spp,
                              schedule=sched)
        self.cnt += spp
        self.color = self.color + acc.reshape(self.cfg.w, self.cfg.h, 3)
        return self.color
