"""Wavefront volumetric path tracer (port of adapt_tpu/renderer/vpt.py).

Every iteration advances the whole wavefront through

    effective-medium select -> mean-free-path sample -> null-surface
    passthrough -> NEE (transmittance-weighted shadow rays) -> phase/BxDF
    MIS -> continuation sample -> next-segment intersect

with per-lane masks. Null-surface crossings do not consume a bounce
(reference vpt.py:189-191), so the loop runs max_bounce + NULL_BUDGET
iterations with per-lane bounce counters.

Estimator semantics are the JAX package's, with its deliberate fix: the
emission-MIS weight comes from the *next* hit's emitter (as in
vanilla_renderer.py:109-117), not the current vertex's (reference
vpt.py:247-254).

Shadow rays through media take `track_ray`. On the brute-force tier it
is the batched K-hit walk (`ray_track_hits`, kernel B3), with the exact
sequential walk `_track_loop` for the lanes that overflow its K slots; the
BVH tier keeps the sequential walk, as the JAX package keeps the K-hit
walk to its Pallas tier.

The random stream is the JAX package's: per iteration D = 9 + 4 S
uniforms per lane from `lane_uniform(fold_in(key, i), pos, D)`, sliced as
in adapt_tpu/renderer/vpt.py:416-541, so renders compare to it pixel by
pixel. `VolumeRenderer.render_batch` draws the stream of the JAX
package's `render_batch_vpt(..., fuse=1)`; the JAX VolumeRenderer
defaults to fuse=4, a TPU width knob the port leaves out (one sample per
wavefront), so its images differ from that default's by the noise of
other samples, not in expectation.

Every pass is length-compacted with the JAX package's shipped schedule
((7, 2), (13, 8)) by renderer/compact.py, which carries the whole state,
the interaction included. Textures, normal maps and grid volumes are
refused at render (`check_supported`), so the JAX package's texture hooks
and volume branches have no counterpart here yet.
"""
from __future__ import annotations

import torch

from .. import rng
from ..ops import bxdf_ops, emitter_ops, medium_ops
from ..ops.intersect import (FAR, _bvh_tier, does_intersect, ray_intersect,
                             ray_track_hits)
# null BSDF = medium boundary (reference bsdf.py:238-240)
from ..ops.intersect import _is_null_obj as _is_null_surface
from ..ops.math3d import dot, norm
from ..ops.sampling import balance_heuristic
from ..scene.compile import check_supported
from . import compact
from .base import ProgressiveRenderer, camera_rays, crop_pix_ids
from .pt import _scatter

NULL_BUDGET = 8       # extra iterations to absorb null-surface crossings
TRACK_STEPS = 7       # max medium interfaces along a shadow ray (vpt.py:113)
# the JAX package's shipped ADAPT_VPT_COMPACT default
SCHEDULE = compact.parse_schedule("7:2,13:8")

_MEDIUM_FIELDS = ("kind", "ior", "u_a", "u_s", "u_e", "ph_par", "ph_pdf")


def effective_medium(scene, cfg, obj_id, in_free_space):
    """Per-lane effective medium (reference vpt.py:54-99 precedence): the
    world medium in free space when the world scatters, else the hit
    object's attached medium. Returns (rows, is_scattering)."""
    idx = obj_id.clamp(min=0)
    rows = {f: getattr(scene.medium, f)[idx] for f in _MEDIUM_FIELDS}
    obj_scat = (obj_id >= 0) & (rows["kind"] >= 0) & ~in_free_space
    if not cfg.world_scattering:
        return rows, obj_scat
    w = scene.world_medium
    for f in _MEDIUM_FIELDS:
        sel = in_free_space[:, None] if rows[f].ndim > 1 else in_free_space
        rows[f] = torch.where(sel, getattr(w, f)[0], rows[f])
    return rows, in_free_space | obj_scat


def world_bound_time(scene, ray_o, ray_d):
    """Exit distance from the world AABB (reference vpt.py:139-143)."""
    w_min = scene.obj_aabb_min.amin(dim=0)
    w_max = scene.obj_aabb_max.amax(dim=0)
    safe_d = torch.where(torch.abs(ray_d) < 1e-9, 1e-9, ray_d)
    t0 = (w_min[None, :] - ray_o) / safe_d
    t1 = (w_max[None, :] - ray_o) / safe_d
    return torch.maximum(t0, t1).amin(dim=-1)


def _track_segments_khit(scene, cfg, start_p, ray_d, depth, active):
    """The shadow-ray media walk from one ray_track_hits pass.

    Reproduces _track_loop slot for iteration: slots 0..h-1 are the null
    interfaces, slot h the last iteration the loop runs (the blocking
    hit, after which tr is 0, or the free segment to the target). A
    segment's medium resolves from the interface that ends it (front face:
    the segment was outside; back face: inside that object). Lanes with
    more than K null interfaces re-walk through _track_loop, which runs
    only when some active lane overflowed, so the result is exact for any
    K. K is the JAX package's max(1, min(TRACK_STEPS - 1, 2 n_null_objs)):
    a convex null object is crossed at most twice."""
    N = start_p.shape[0]
    dev = start_p.device
    K = max(1, min(TRACK_STEPS - 1, 2 * cfg.n_null_objs))
    w_ior = scene.world_medium.ior[0]
    tnk, onk, dnk, tb, ob, db, ovf = ray_track_hits(
        scene, cfg, start_p, ray_d, depth, alive=active, K=K)
    h = (tnk < FAR).sum(dim=0)                            # nulls per lane
    blocked_term = tb < FAR * 0.5

    # slot k of K + 1: null interface k (k < h), the terminal one (k == h)
    idx_k = torch.arange(K + 1, device=dev)[:, None]
    is_term = idx_k == h[None, :]

    def pad(a, fill):
        return torch.cat([a, torch.full((1, N), fill, dtype=a.dtype,
                                        device=dev)])

    tka = torch.where(is_term, torch.where(blocked_term, tb, depth)[None],
                      pad(tnk, FAR))
    oka = torch.where(is_term, torch.where(blocked_term, ob, -1)[None],
                      pad(onk, -1))
    dka = torch.where(is_term, torch.where(blocked_term, db, 0.0)[None],
                      pad(dnk, 0.0))
    hitk = (idx_k < h[None, :]) | (is_term & blocked_term[None, :])
    t_prev = torch.cat([torch.zeros((1, N), device=dev), tka[:-1]])
    # dead slots (k > h) see FAR garbage; the clamp keeps their masked
    # exp() finite
    seg = torch.clamp(tka - t_prev, min=0.0)
    in_free = ~hitk | (dka < 0.0)
    alive_k = (idx_k <= h[None, :]) \
        & ((idx_k == 0) | (depth[None, :] - t_prev > 5e-5))
    if active is not None:
        alive_k = alive_k & active[None, :]

    rows, scat = effective_medium(scene, cfg, oka.reshape(-1),
                                  in_free.reshape(-1))
    seg_tr = medium_ops.transmittance(rows["u_e"], scat, seg.reshape(-1)) \
        .reshape(K + 1, N, 3)
    ior = torch.where(in_free.reshape(-1), w_ior, rows["ior"]) \
        .reshape(K + 1, N)
    # products and sums over the slots in slot order, as the JAX
    # package's reductions take them
    tr = torch.ones((N, 3), device=dev)
    acc = torch.zeros(N, device=dev)
    for k in range(K + 1):
        tr = tr * torch.where(alive_k[k, :, None], seg_tr[k], 1.0)
        acc = acc + torch.where(alive_k[k], seg[k] * ior[k], 0.0)
    blocked = (alive_k & is_term & blocked_term[None, :]).any(dim=0)
    tr = torch.where(blocked[:, None], 0.0, tr)

    # exact fallback for the lanes that overflowed (dead lanes never do)
    ovf_l = ovf if active is None else ovf & active
    if bool(ovf_l.any()):
        tr_f, acc_f = _track_loop(scene, cfg, start_p, ray_d, depth, ovf_l)
        tr = torch.where(ovf[:, None], tr_f, tr)
        acc = torch.where(ovf, acc_f, acc)
    return tr, acc


def _track_loop(scene, cfg, start_p, ray_d, depth, active):
    """Sequential restart-from-the-hit-point media walk (reference
    vpt.py:101-137): the BVH tier's walk, and the exact fallback for the
    lanes _track_segments_khit could not cover. Stops when every lane is
    done or after TRACK_STEPS interfaces."""
    N = start_p.shape[0]
    dev = start_p.device
    w_ior = scene.world_medium.ior[0]
    tr = torch.ones((N, 3), device=dev)
    acc = torch.zeros(N, device=dev)
    p, remaining = start_p, depth
    alive = torch.ones(N, dtype=torch.bool, device=dev) if active is None \
        else active
    for _step in range(TRACK_STEPS):
        if not bool(alive.any()):
            break
        it = ray_intersect(scene, cfg, p, ray_d, max_t=remaining,
                           alive=alive)
        miss = ~it.is_hit
        seg = torch.where(miss, remaining, it.t)
        in_free = miss | (dot(it.n_g, ray_d) < 0.0)
        blocked = ~miss & alive
        if cfg.has_null_bsdf:
            blocked = blocked & ~_is_null_surface(scene, it.obj_id)
        rows, scat = effective_medium(scene, cfg, it.obj_id, in_free)
        seg_tr = medium_ops.transmittance(rows["u_e"], scat, seg)
        ior = torch.where(in_free, w_ior, rows["ior"])
        tr = torch.where(blocked[:, None], 0.0,
                         torch.where(alive[:, None], tr * seg_tr, tr))
        acc = acc + torch.where(alive, seg * ior, 0.0)
        p = p + ray_d * seg[:, None]
        remaining = remaining - seg
        # stop on a block, at the target, or leaving a non-scattering world
        alive = alive & ~blocked & (remaining > 5e-5)
        if not cfg.world_scattering:
            alive = alive & ~miss
    return tr, acc


def track_ray(scene, cfg, start_p, ray_d, depth, key=None, thp=None,
              active=None):
    """Transmittance and ior-weighted propagation time along a shadow
    path crossing up to TRACK_STEPS medium interfaces (reference
    vpt.py:101-137). Returns (tr (N,3), acc_depth (N,)); tr = 0 where a
    non-null surface blocks the segment. active: dead lanes take no
    intersection work (their results are unused). key and thp feed only
    the JAX package's grid-volume ratio tracking, which the port does not
    have yet: a scene with a grid volume raises. (The JAX `key_hint`, a
    TPU wavefront sort key, has no counterpart.)"""
    if cfg.volume_kind:
        raise NotImplementedError(
            "grid volumes are not ported yet (ROADMAP.md queue A item 14)")
    N = start_p.shape[0]
    w_ior = scene.world_medium.ior[0]
    if not (cfg.world_scattering or cfg.has_null_bsdf or cfg.volume_kind
            or cfg.medium_kinds):
        # no media anywhere: binary occlusion
        occ = does_intersect(scene, cfg, start_p, ray_d, depth, alive=active)
        return (torch.where(occ[:, None], 0.0, 1.0)
                * torch.ones((N, 3), device=start_p.device)), depth * w_ior
    if scene.tri_n.shape[0] > 0 and not _bvh_tier(scene, cfg):
        return _track_segments_khit(scene, cfg, start_p, ray_d, depth, active)
    return _track_loop(scene, cfg, start_p, ray_d, depth, active)


def trace_vpt(scene, cfg, key, ray_o, ray_d, schedule=SCHEDULE):
    """Trace a (N,3) wavefront with participating media; returns the
    (N,3) radiance of each lane. schedule: length-compaction splits
    (renderer/compact.py); a compacted trace equals the plain one lane
    for lane."""
    check_supported(scene, cfg, "vpt")
    N = ray_o.shape[0]
    dev = ray_o.device
    world_ior = scene.world_medium.ior[0]
    # a miss can still scatter when the world medium fills open space
    # (reference vpt.py:173-179)
    media_everywhere = cfg.world_scattering
    phase_kinds = tuple(sorted(set(cfg.medium_kinds)))
    S = max(cfg.num_shadow_ray, 1)
    D = 9 + 4 * S                   # uniforms drawn per iteration
    # null crossings are the only way an iteration advances without a
    # bounce, so only null BSDFs need the budget
    iters = cfg.max_bounce + (NULL_BUDGET if cfg.has_null_bsdf else 0)

    init = dict(
        ray_o=ray_o, ray_d=ray_d,
        it=ray_intersect(scene, cfg, ray_o, ray_d),
        color=torch.zeros((N, 3), device=dev),
        thp=torch.ones((N, 3), device=dev),
        emission_weight=torch.ones(N, device=dev),
        active=torch.ones(N, dtype=torch.bool, device=dev),
        bounce=torch.zeros(N, dtype=torch.int32, device=dev),
        pos=torch.arange(N, dtype=torch.int32, device=dev))

    def iteration(i, st):
        active, thp = st["active"], st["thp"]
        ray_o, ray_d = st["ray_o"], st["ray_d"]
        n = active.shape[0]
        # per-lane counter RNG keyed by (iteration, original lane id), so
        # compaction cannot change any lane's draws
        u_all = rng.lane_uniform(rng.fold_in(key, i), st["pos"], D)

        # --- russian roulette on the lane's bounce (vpt.py:160-168) ---
        max_val = thp.amax(dim=-1)
        if cfg.use_rr:
            cand = (max_val < cfg.rr_threshold) \
                & (st["bounce"] >= cfg.rr_bounce_th)
            killed = cand & (u_all[:, 0] > max_val)
            thp = thp * torch.where(cand, 1.0 / (max_val + 1e-7),
                                    1.0)[:, None]
            active = active & ~killed
        else:
            active = active & (max_val >= 1e-5)

        # --- the segment's end: the interaction carried from the last
        # iteration's next-segment intersect (vpt.py:170-181); dead lanes
        # carry t = -3e38 and stale hits, and every use below is masked ---
        it = st["it"]
        miss = ~it.is_hit
        if media_everywhere:
            wb = world_bound_time(scene, ray_o, ray_d)
            depth = torch.where(miss, torch.clamp(wb, min=0.0), it.t)
        else:
            depth = it.t
            active = active & it.is_hit
        in_free = miss | (dot(it.n_g, ray_d) < 0.0)
        obj_id = it.obj_id

        # --- mean free path sampling (vpt.py:183-186) ---
        rows, scat = effective_medium(scene, cfg, obj_id, in_free)
        is_mi, mfp, beta = medium_ops.sample_mfp(
            rows["u_e"], rows["u_s"], scat, depth, u_all[:, 1:3])
        active = active & ~(miss & ~is_mi)       # left the world bound
        hit_point = ray_o + ray_d * torch.where(active, mfp, 0.0)[:, None]
        thp = thp * torch.where(active[:, None], beta, 1.0)

        # --- null surface passthrough (vpt.py:189-191) ---
        is_null = ~is_mi & _is_null_surface(scene, obj_id) \
            if cfg.has_null_bsdf else torch.zeros_like(active)
        shade = active & ~is_null

        mat = bxdf_ops.gather_mat(scene, obj_id)
        hit_light = torch.where(is_mi | miss, -1, mat.emit)

        # --- NEE with transmittance (vpt.py:194-237) ---
        direct_int = torch.zeros((n, 3), device=dev)
        for s in range(cfg.num_shadow_ray):
            eid, emitter_pdf, valid = emitter_ops.sample_light_index(
                cfg, u_all[:, 3 + 4 * s], hit_light)
            emit_pos, shadow_int, direct_pdf, _n = emitter_ops.sample_hit(
                scene, cfg, eid, hit_point, u_all[:, 4 + 4 * s:7 + 4 * s])
            to_e = emit_pos - hit_point
            e_d = norm(to_e)
            l_dir = to_e / torch.clamp(e_d[:, None], min=1e-12)
            tr, _t = track_ray(scene, cfg, hit_point, l_dir, e_d,
                               active=active)
            shadow_int = shadow_int * tr
            # phase value at medium events, BxDF at surfaces
            ph_val = medium_ops.phase_eval(rows["kind"], rows["ph_par"],
                                           rows["ph_pdf"], ray_d, l_dir,
                                           phase_kinds)
            surf_val = bxdf_ops.surface_eval(cfg, mat, it, ray_d, l_dir,
                                             world_ior)
            d_spec = torch.where(is_mi[:, None], ph_val[:, None], surf_val)
            if cfg.use_mis:
                light_pdf = emitter_pdf * direct_pdf
                bsdf_pdf = torch.where(
                    is_mi, ph_val,
                    bxdf_ops.surface_pdf(cfg, mat, it, l_dir, ray_d,
                                         world_ior))
                mis_w = torch.where(emitter_ops.is_delta_pos(scene, eid), 1.0,
                                    balance_heuristic(light_pdf, bsdf_pdf))
            else:
                mis_w = torch.ones(n, device=dev)
            contrib = d_spec * shadow_int * (mis_w / emitter_pdf)[:, None]
            direct_int = direct_int + torch.where(valid[:, None], contrib,
                                                  0.0)
        direct_int = direct_int / float(S)

        # --- emission on hitting a light (vpt.py:240-242) ---
        emit_le = emitter_ops.eval_le(scene, hit_light.clamp(min=0),
                                      hit_point - ray_o, it.n_g)
        emit_int = torch.where((hit_light >= 0)[:, None], emit_le, 0.0)

        # --- continuation sampling (vpt.py:245) ---
        u_new = u_all[:, 3 + 4 * S:9 + 4 * S]
        s_dir, s_spec, s_pdf, is_specular = bxdf_ops.surface_sample(
            cfg, mat, it, ray_d, u_new, world_ior)
        p_dir, p_val = medium_ops.phase_sample(
            rows["kind"], rows["ph_par"], rows["ph_pdf"], ray_d,
            u_new[:, :3], phase_kinds)
        new_dir = torch.where(is_mi[:, None], p_dir, s_dir)
        # medium: perfect importance sampling, spec / pdf = 1
        cont = torch.where(is_mi[:, None], 1.0,
                           s_spec / torch.clamp(s_pdf, min=1e-9)[:, None])
        dead = ~is_mi & ((s_spec.amax(dim=-1) <= 0.0) | (s_pdf <= 0.0))

        color = st["color"] + torch.where(
            shade[:, None],
            (direct_int + emit_int * st["emission_weight"][:, None]) * thp,
            0.0)
        thp = thp * torch.where(shade[:, None], cont, 1.0)

        # null lanes keep their direction; shaded lanes take the new one
        out_dir = torch.where(is_null[:, None], ray_d, new_dir)
        bounce = st["bounce"] + shade.to(torch.int32)
        active = active & ~(shade & dead) & (bounce < cfg.max_bounce)
        out = dict(st, ray_o=hit_point, ray_d=out_dir, color=color, thp=thp,
                   active=active, bounce=bounce)
        # the last iteration's next segment and emission weight would feed
        # nothing: stop here
        if i == iters - 1:
            return out

        # --- next-segment intersect, the next iteration's `it` ---
        it_n = ray_intersect(scene, cfg, hit_point, out_dir, alive=active)
        # --- emission MIS weight from the NEXT hit (vanilla:109-117) ---
        if cfg.use_mis:
            mat_n = bxdf_ops.gather_mat(scene, it_n.obj_id)
            nl = torch.where(it_n.obj_id >= 0, mat_n.emit, -1)
            can = (nl >= 0) & ~mat_n.is_delta & ~is_specular
            e_pdf = torch.where(can, emitter_ops.solid_angle_pdf(
                scene, nl.clamp(min=0), it_n.n_s, it_n.t, out_dir), 0.0)
            ray_pdf = torch.where(is_mi, p_val, s_pdf)
            out["emission_weight"] = torch.where(
                shade, balance_heuristic(ray_pdf, e_pdf),
                st["emission_weight"])
        out["it"] = it_n
        return out

    return compact.run_compacted(iteration, init, iters, schedule)


def render_pass_vpt(scene, cfg, key, cnt, schedule=SCHEDULE):
    """One progressive sample for every pixel; returns (N, 3) radiance."""
    pix = crop_pix_ids(cfg, scene.device)
    key, cam_key = rng.split(key)
    ray_o, ray_d = camera_rays(scene, cfg, cam_key, cnt, pix_ids=pix)
    return _scatter(cfg, pix, trace_vpt(scene, cfg, key, ray_o, ray_d,
                                        schedule=schedule))


def render_batch_vpt(scene, cfg, key, cnt0, spp, schedule=SCHEDULE):
    """SUM of spp progressive samples, (N, 3): the JAX package's
    render_batch_vpt stream at fuse=1 (sample i: key fold_in i, camera key
    split off fold_in 0, trace key fold_in 7919)."""
    pix = crop_pix_ids(cfg, scene.device)
    n = cfg.n_pixels if pix is None else pix.shape[0]
    acc = torch.zeros((n, 3), device=scene.device)
    for i in range(spp):
        sub = rng.fold_in(key, i)
        k_cam, _ = rng.split(rng.fold_in(sub, 0))
        ray_o, ray_d = camera_rays(scene, cfg, k_cam, cnt0 + i, pix_ids=pix)
        acc = acc + torch.nan_to_num(
            trace_vpt(scene, cfg, rng.fold_in(sub, 7919), ray_o, ray_d,
                      schedule=schedule), nan=0.0)
    return _scatter(cfg, pix, acc)


class VolumeRenderer(ProgressiveRenderer):
    """Volumetric renderer (reference vpt.py:29). schedule: the
    length-compaction splits of every pass (the shipped SCHEDULE by
    default; () for none)."""

    def __init__(self, scene, cfg, seed: int = 0, schedule=SCHEDULE):
        check_supported(scene, cfg, "vpt")
        super().__init__(scene, cfg, seed)
        self.schedule = tuple(schedule)

    def render_pass(self, key, cnt):
        return render_pass_vpt(self.scene, self.cfg, key, cnt,
                               schedule=self.schedule)

    def render_batch(self, spp: int):
        self.key, sub = rng.split(self.key)
        acc = render_batch_vpt(self.scene, self.cfg, sub, self.cnt + 1, spp,
                               schedule=self.schedule)
        self.cnt += spp
        self.color = self.color + acc.reshape(self.cfg.w, self.cfg.h, 3)
        return self.color
