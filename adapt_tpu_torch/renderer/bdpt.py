"""Wavefront bidirectional path tracer (port of adapt_tpu/renderer/bdpt.py).

Both subpaths are generated by batched random walks that write into
depth-major vertex buffers (`_vertex_buffers`: scalars (D, N), vectors
(D, N, 3)); every (t, s) connection strategy is a batched evaluation over
the whole wavefront, with t and s Python ints, so the PBRT-style MIS ratio
sweep runs as a few row operations instead of a divergent per-pixel loop.
t == 1 strategies (light tracing) splat into the film through the sorted
film-splat kernel B4 (ops/splat.py), the reference's atomic +=
(bdpt.py:159-162).

The names are the JAX package's, so each function's counterpart is easy to
find; the randomness is its stream, bit for bit (whole-wavefront
`rng.uniform(key, (N, k))` draws with the same keys and shapes), so a pass
compares to it pixel by pixel. Faithfulness notes, as in the JAX package:

* `pdf_camera` returns 0, the reference's latent bug (bdpt.py:530-539), so
  camera-subpath pdf chains start at remap(0) = 1 in MIS;
* TRANSIENT_LIT falls back to TRANSIENT_CAM (bdpt.py:42-46);
* vertices on null surfaces are skipped;
* the t=1 connection hands `sample_camera` the direction from the camera
  to the vertex (JAX bdpt.py:1132), where that function wants the one
  toward the camera, so only vertices behind the camera reach the film:
  on cbox none do. The goldens hold this; the port keeps it.

What the port leaves out, because it works around the TPU and XLA, not the
semantics:

* the tile-splat switch `_tile_splat` and its ADAPT_TILE_SPLAT knob: the
  t=1 splat always takes kernel B4 on the card and its plain version on
  the CPU (the wrapper decides by the tensor's device);
* `generate_paths`, the fused two-walk wavefront, a measured dead end that
  `bdpt_pass_core` never calls;
* `tgather`, `cluster_key_hint` and the one-hot slot reads and writes:
  vertex slots are index reads and writes along the depth axis. The
  one-hot read `_gather_vertex` turned -0.0 into +0.0; the JAX package
  never calls it, and an index read keeps the sign (`_has_normal` tests
  `!= 0.0`, which -0.0 passes as +0.0 does);
* `lax.scan` itself, which exists for XLA's compile time, and with it
  `connect_strategy`'s single-strategy form (traced s and t): every group
  runs in chunks of at most FLAT_LANES // N strategies, as the JAX
  package's flat form (`run_group_flat`) does. A group of more than
  FLAT_MAX_CHUNKS chunks, which the JAX package scans (`run_group`),
  keeps the scan's semantics in those chunks: each strategy's
  ratio-tracking key comes from its own sub-key fold_in(k_con, k_idx)
  (bdpt.py:1156, :1216-1217) and its march runs as a call of its own
  would (a key a block of N lanes, `volume_ops._setup`), its radiance is
  added to the film one strategy after another (:1438), and a transient
  pass bins it one strategy at a time (:1440-1441). So FLAT_MAX_CHUNKS
  decides which random stream and which sum order a group takes, and
  FLAT_LANES stays, as a memory cap;
* the walk's unroll by 2 (a TPU loop-overhead measure).

The MIS sweep tables (`_mis_weight`) run the JAX package's associative
scan as the sequential recurrence it computes; the association differs,
so weights differ from the JAX package's by float rounding (~1 ulp per
factor). The port writes the vertex buffers in place.

Every BxDF, BxDF mixtures, textures and all four light kinds render; a
textured scene's vertices carry their albedo in a `tex` plane. On a scene
with a grid volume each walk segment delta-tracks it (a volume event
places a medium vertex, sampled with the volume's phase function) and
each connection multiplies by its ratio-tracking transmittance
(`track_ray`). As in the JAX package, a volume vertex's connection
evaluates the phase function of the medium rows of its object, not the
volume's.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from .. import obs, rng
from ..constants import (EmitterTag, INV_2PI, INV_PI, TRANSPORT_IMP,
                         TRANSPORT_RAD, VERTEX_CAMERA, VERTEX_EMITTER,
                         VERTEX_MEDIUM, VERTEX_SURFACE)
from ..ops import bxdf_ops, emitter_ops, medium_ops, volume_ops
from ..ops.intersect import Interaction, ray_intersect
from ..ops.math3d import dot, norm, normalize
from ..ops.splat import splat_sorted_accumulate
from ..ops.texture_ops import get_uv_item, process_ns
from .base import ProgressiveRenderer, camera_rays, crop_pix_ids
from .vpt import _is_null_surface, effective_medium, track_ray, \
    volume_phase_kinds, volume_phase_rows, world_bound_time

CAP = 32            # max vertices per subpath - 1 (reference N_MAX_BOUNCE)
CAP_CROP = 400      # crop-window cap (reference T_MAX_BOUNCE): buffers scale
#                     with crop pixels, so deep transient paths stay
#                     affordable
NULL_BUDGET = 4
# lanes a flat chunk of strategies may take: each chunk runs its strategies
# as one (K*N,) wavefront through connect_strategy; the cap bounds the
# chunk's temporaries (16 strategies at 512^2)
FLAT_LANES = 4 << 20
# a group of more chunks than this takes the JAX package's scan form
# (bdpt.py:59-60; tests set it to 0 to force that form at toy size)
FLAT_MAX_CHUNKS = 4

# vertex bool bits (reference path_utils.py / bdpt.py get_bool)
B_POS_DELTA = 0x01
B_DIR_DELTA = 0x02
B_IS_AREA = 0x04
B_IN_FSPACE = 0x10
B_SPEC_DELTA = 0x20

_SCALARS = ("vtype", "obj_id", "emit_id", "bits", "pdf_fwd", "pdf_bwd",
            "time")
_VECTORS = ("n_s", "n_g", "pos", "ray_in", "beta")


def _remap(x):
    """remap_pdf (reference path_utils.py:13-15)."""
    return torch.where(x > 0.0, x, 1.0)


def _vertex_buffers(N, D, device, has_tex=False):
    """Depth-major vertex storage: scalars (D, N), vectors (D, N, 3); row
    d holds every lane's vertex d. has_tex: the scene has albedo
    textures; without them there is no `tex` plane at all (None), as in
    the JAX package."""
    def ints(fill):
        return torch.full((D, N), fill, dtype=torch.int32, device=device)
    buf = dict(vtype=ints(-1), obj_id=ints(-1), emit_id=ints(-1),
               bits=ints(0))
    for k in ("pdf_fwd", "pdf_bwd", "time"):
        buf[k] = torch.zeros((D, N), device=device)
    for k in _VECTORS:
        buf[k] = torch.zeros((D, N, 3), device=device)
    buf["tex"] = torch.full((D, N, 3), -1.0, device=device) \
        if has_tex else None
    return buf


def _masked(mask, v, old):
    if mask is None:
        return v.expand_as(old)
    return torch.where(mask if v.ndim == 1 else mask[:, None], v, old)


def _write_vertex(buf, slot, mask, **vals):
    """Masked write of each lane's values into its own slot (slot (N,)
    int), in place. Lanes whose mask is False keep their rows."""
    D, N = buf["vtype"].shape
    lanes = torch.arange(N, device=slot.device)
    s = slot.clamp(0, D - 1).long()
    for k, v in vals.items():
        if buf[k] is None:
            continue
        buf[k][s, lanes] = _masked(mask, v, buf[k][s, lanes])
    return buf


def _write_vertex_at(buf, idx, mask, **vals):
    """Masked write into ONE depth row (a Python int), in place; mask None
    writes every lane. Valid for the walk whenever every lane that places
    at walk iteration i places into slot i + 1: true without null BSDFs
    (null crossings are the only events that advance a ray without
    placing)."""
    for k, v in vals.items():
        if buf[k] is None:
            continue
        buf[k][idx] = _masked(mask, v, buf[k][idx])
    return buf


def _static_vertex(buf, idx):
    """Vertex slot idx (a Python int) -> dict of (N,) / (N, 3) rows."""
    return {k: (None if v is None else v[idx]) for k, v in buf.items()}


def _vertex_at(buf, idx):
    """Vertex slot read for a strategy's (Python int) index, clamped at 0
    as the JAX package's is."""
    return _static_vertex(buf, max(idx, 0))


def _strategy_case(s, t):
    """Connection-case tag of a (s, t) strategy (the reference's four
    connect_path branches, bdpt.py:306-410)."""
    return "s0" if s == 0 else ("t1" if t == 1 else
                                ("s1" if s == 1 else "gen"))


# ------------------------------ vertex helpers ------------------------------

def _is_connectible(v):
    surf_or_emit = (v["vtype"] == VERTEX_SURFACE) \
        | (v["vtype"] == VERTEX_EMITTER)
    return torch.where(surf_or_emit, (v["bits"] & B_DIR_DELTA) == 0, True)


def _not_delta(v):
    return (v["bits"] & B_SPEC_DELTA) == 0


def _not_delta_source(v):
    return (v["bits"] & (B_POS_DELTA | B_DIR_DELTA)) == 0


def _has_normal(v):
    return (v["n_s"] != 0.0).any(dim=-1)


def _is_light_v(v):
    return (v["vtype"] == VERTEX_EMITTER) | ((v["bits"] & B_IS_AREA) > 0)


def _in_fspace(v):
    return (v["bits"] & B_IN_FSPACE) > 0


def _is_mi_v(v):
    return v["vtype"] == VERTEX_MEDIUM


def _interaction_of(v):
    N = v["vtype"].shape[0]
    dev = v["vtype"].device
    return Interaction(obj_id=v["obj_id"], prim_id=torch.zeros_like(
        v["obj_id"]), t=torch.zeros(N, device=dev), n_g=v["n_g"],
        n_s=v["n_s"], uv=torch.zeros((N, 2), device=dev), tex=v["tex"])


def _get_pdf_bwd(v_pos, v_ns, v_has_n, pdf_sa, next_point):
    """Solid-angle -> area measure at vertex v (path_utils.py:52-63)."""
    diff = v_pos - next_point
    n2 = torch.clamp(dot(diff, diff), min=1e-12)
    pdf = pdf_sa / n2
    cosine = torch.abs(dot(v_ns, diff / torch.sqrt(n2)[:, None]))
    pdf = torch.where(v_has_n, pdf * cosine, pdf)
    return torch.where(pdf_sa > 0.0, pdf, 0.0)


def _convert_density(pdf_sa, diff, next_ns, next_mi):
    """Solid-angle -> area density at the NEXT vertex (bdpt.py:593-604)."""
    n2 = torch.clamp(dot(diff, diff), min=1e-12)
    pdf = pdf_sa / n2
    cosine = torch.abs(dot(next_ns, diff / torch.sqrt(n2)[:, None]))
    pdf = torch.where(next_mi, pdf, pdf * cosine)
    return torch.where(pdf_sa > 0.0, pdf, 0.0)


def _correct_shading_normal(n_s, n_g, incid, outd, is_mi, mode):
    """Importance-transport shading-normal factor (bdpt.py:584-591); mode
    is a Python int."""
    if mode != TRANSPORT_IMP:
        return torch.ones(incid.shape[:-1], device=incid.device)
    num = dot(n_s, outd) * dot(n_g, incid)
    den = dot(n_g, outd) * dot(n_s, incid)
    val = torch.abs(num / torch.where(torch.abs(den) < 1e-9, 1e-9, den))
    return torch.where(is_mi, 1.0, val)


# ------------------------------- camera model -------------------------------

def _cam_normal(scene):
    """cam_r @ (0, 0, 1), each row written out as an ordered f32 sum (as
    camera_rays rotates), so it rounds the same on every device."""
    r = scene.cam_r
    e = torch.zeros(3, device=r.device)
    e[2] = 1.0
    return torch.stack([(r[k, 0] * e[0] + r[k, 1] * e[1]) + r[k, 2] * e[2]
                        for k in range(3)])


def _film_area(cfg):
    inv_f = 1.0 / cfg.focal
    return float(cfg.w * cfg.h) * inv_f * inv_f


def _rasterize_pinhole(cfg, lx, ly):
    """Film-plane coords -> pixel indices (bdpt.py:493-506)."""
    pi = torch.floor(cfg.w * 0.5 + 1.0 - lx * cfg.focal).to(torch.int32)
    pj = torch.floor(cfg.h * 0.5 + 1.0 + ly * cfg.focal).to(torch.int32)
    ok = (pi >= cfg.start_x) & (pj >= cfg.start_y) \
        & (pi < cfg.end_x) & (pj < cfg.end_y)
    return pi, pj, ok


def sample_camera(scene, cfg, ray_d, depth):
    """Camera importance We + sa-pdf + raster pos (bdpt.py:508-528).

    ray_d points TOWARD the camera. The inverse rotation (-ray_d) @ cam_r
    is written out as ordered f32 sums: a differently rounded product
    could move a splat across a pixel boundary."""
    cam_n = _cam_normal(scene)
    dot_n = -dot(ray_d, cam_n)
    x = -ray_d
    r = scene.cam_r
    local = [(x[:, 0] * r[0, k] + x[:, 1] * r[1, k]) + x[:, 2] * r[2, k]
             for k in range(3)]
    z = local[2]
    safe_z = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    pi, pj, ok_r = _rasterize_pinhole(cfg, local[0] / safe_z,
                                      local[1] / safe_z)
    valid = (dot_n > 0.0) & (z > 0.0) & ok_r
    A = _film_area(cfg)
    c = torch.clamp(dot_n, min=1e-9)
    c2 = c * c
    pdf = torch.where(valid, depth * depth / c, 0.0)
    we = torch.where(valid, 1.0 / (A * (c2 * c2)), 0.0)
    pi = torch.where(valid, pi, -1)
    pj = torch.where(valid, pj, -1)
    return we, pdf, pi, pj


def pdf_camera(cfg, dot_normal):
    """Reference bdpt.py:530-539: returns 0 (latent bug kept for output
    parity; the correct value would be 1/(A cos^3))."""
    return torch.zeros_like(dot_normal)


# ----------------------------- vertex-space eval ----------------------------

def eval_vertex(scene, cfg, v, out_dir, mode):
    """fr at vertex v toward out_dir (PathTracer.eval semantics:
    path_tracer.py:459-479): phase value at medium vertices, BxDF
    (cosine-weighted) at surface vertices."""
    is_mi = _is_mi_v(v)
    rows, _ = effective_medium(scene, cfg, v["obj_id"], _in_fspace(v))
    ph = medium_ops.phase_eval(rows["kind"], rows["ph_par"], rows["ph_pdf"],
                               v["ray_in"], out_dir, volume_phase_kinds(cfg))
    mat = bxdf_ops.gather_mat(scene, v["obj_id"])
    fr = bxdf_ops.surface_eval(cfg, mat, _interaction_of(v), v["ray_in"],
                               out_dir, scene.world_medium.ior[0], mode=mode,
                               scene=scene)
    return torch.where(is_mi[:, None], ph[:, None], fr)


def pdf_vertex(scene, cfg, v, ray_in, out_dir):
    """Solid-angle pdf at v for ray_in -> out_dir (path_tracer.py:496-506)."""
    is_mi = _is_mi_v(v)
    rows, _ = effective_medium(scene, cfg, v["obj_id"], _in_fspace(v))
    ph = medium_ops.phase_eval(rows["kind"], rows["ph_par"], rows["ph_pdf"],
                               ray_in, out_dir, volume_phase_kinds(cfg))
    mat = bxdf_ops.gather_mat(scene, v["obj_id"])
    sp = bxdf_ops.surface_pdf(cfg, mat, _interaction_of(v), out_dir, ray_in,
                              scene.world_medium.ior[0], scene=scene)
    return torch.where(is_mi, ph, sp)


def _pdf_light(scene, cur, prev_pos, prev_ns, prev_has_n):
    """Emission direction pdf of emitter vertex cur toward prev, in area
    measure at prev (bdpt.py:572-582)."""
    diff = prev_pos - cur["pos"]
    inv_len = 1.0 / torch.clamp(norm(diff), min=1e-9)
    d = diff * inv_len[:, None]
    eid = cur["emit_id"].clamp(min=0)
    kind = scene.emit_kind[eid]
    pdf = torch.zeros_like(inv_len)
    pdf = torch.where(kind == EmitterTag.POINT, INV_PI * 0.25, pdf)
    pdf = torch.where(kind == EmitterTag.SPOT,
                      INV_2PI / torch.clamp(1.0 - scene.emit_r[eid],
                                            min=1e-9), pdf)
    pdf = torch.where(kind == EmitterTag.AREA,
                      torch.clamp(dot(d, cur["n_g"]), min=0.0) * INV_PI, pdf)
    pdf = torch.where(prev_has_n, pdf * torch.abs(dot(d, prev_ns)), pdf)
    return pdf * inv_len * inv_len


def _area_pdf(scene, cfg, emit_id):
    eid = emit_id.clamp(min=0)
    return torch.where(scene.emit_kind[eid] == EmitterTag.AREA,
                       scene.emit_inv_area[eid], 0.0)


# ------------------------------- random walk --------------------------------

def bdpt_random_walk(scene, cfg, key, buffers, ray_o, ray_d, init_pdf, beta,
                     mode, init_time, max_bnc):
    """Shared subpath walk (reference bdpt.py:204-304). Slot 0 is filled by
    the caller; returns (buffers, vertex count including slot 0)."""
    N = ray_o.shape[0]
    dev = ray_o.device
    world_ior = scene.world_medium.ior[0]
    media_everywhere = cfg.world_scattering or bool(cfg.volume_kind)
    max_time = cfg.t_min + cfg.t_interval * max(cfg.t_bins, 1)
    # media-free scenes skip mean-free-path sampling (the key split stays,
    # so the stream is the JAX package's)
    no_media = not (cfg.medium_kinds or cfg.world_scattering
                    or cfg.volume_kind)
    phase_kinds = volume_phase_kinds(cfg)
    zero3 = torch.zeros((N, 3), device=dev)
    # extra iterations absorb null-surface crossings, which advance a ray
    # without placing a vertex
    iters = max_bnc + (NULL_BUDGET if cfg.has_null_bsdf else 0)

    buf = buffers
    thp = beta
    ray_pdf = init_pdf
    acc_time = torch.full((N,), float(init_time), device=dev) \
        if not isinstance(init_time, torch.Tensor) else init_time
    last_pos = ray_o
    # shading normal of the last PLACED vertex (slot 0 at entry)
    prev_ns = buf["n_s"][0]
    vnum = torch.zeros(N, dtype=torch.int32, device=dev)
    active = torch.ones(N, dtype=torch.bool, device=dev)
    it = ray_intersect(scene, cfg, ray_o, ray_d)

    for i in range(iters):
        miss = ~it.is_hit
        if media_everywhere:
            wb = world_bound_time(scene, ray_o, ray_d)
            depth = torch.where(miss, torch.clamp(wb, min=0.0), it.t)
        else:
            depth = it.t
            active = active & it.is_hit
        in_free = miss | (dot(it.n_g, ray_d) < 0.0)
        obj_id = it.obj_id

        rows, scat = effective_medium(scene, cfg, obj_id, in_free)
        key, k_mfp = rng.split(key)
        if no_media:
            is_mi = torch.zeros(N, dtype=torch.bool, device=dev)
            mfp = depth
        else:
            u_mfp = rng.uniform(k_mfp, (N, 2), device=dev)
            is_mi, mfp, path_beta = medium_ops.sample_mfp(
                rows["u_e"], rows["u_s"], scat, depth, u_mfp)
        rows_v = rows
        if cfg.volume_kind:
            key, k_vol = rng.split(key)
            v_t, v_beta = volume_ops.sample_distance_delta_tracking(
                scene.volume, cfg.volume_kind, k_vol, ray_o, ray_d, thp,
                depth, active=active)
            is_vol = v_t > 0.0
            mfp = torch.where(is_vol, v_t, mfp)
            path_beta = torch.where(is_vol[:, None], v_beta, path_beta)
            is_mi = is_mi | is_vol
            rows_v = volume_phase_rows(scene, cfg, rows, is_vol)
        active = active & ~(miss & ~is_mi)
        if not no_media:
            thp = thp * torch.where(active[:, None], path_beta, 1.0)
        active = active & (thp.amax(dim=-1) >= 5e-5)
        obs.lanes(active)

        hit_point = ray_o + ray_d * mfp[:, None]
        mat = bxdf_ops.gather_mat(scene, obj_id)
        hit_light = torch.where(is_mi | miss, -1, mat.emit)
        ior = torch.where(in_free, world_ior, rows["ior"])
        acc_time = acc_time + torch.where(active, mfp * ior, 0.0)
        if cfg.transient:
            active = active & (acc_time <= max_time)

        is_null = (~is_mi & _is_null_surface(scene, obj_id)
                   if cfg.has_null_bsdf else torch.zeros_like(active))
        place = active & ~is_null

        pdf_fwd = _convert_density(ray_pdf, hit_point - last_pos, it.n_s,
                                   is_mi)
        is_delta = ~is_mi & mat.is_delta & (obj_id >= 0)
        bits = (torch.where(is_delta, B_DIR_DELTA | B_SPEC_DELTA, 0)
                | torch.where(hit_light >= 0, B_IS_AREA, 0)
                | torch.where(in_free, B_IN_FSPACE, 0)).to(torch.int32)

        it = process_ns(scene, cfg, it)
        tex = None
        it_tex = it
        if scene.tex["albedo"].present:
            tex, _ = get_uv_item(scene, scene.tex["albedo"], it)
            it_tex = dataclasses.replace(it, tex=tex)
        vnum = vnum + place.to(torch.int32)

        # continuation sampling before the vertex write, so the specular
        # flag folds into the written bits. The JAX package passes no
        # scene here (bdpt.py:553), so a mixture lane samples with its own
        # placeholder row, not its components: kept for parity
        key, k_new = rng.split(key)
        u_new = rng.uniform(k_new, (N, 6), device=dev)
        s_dir, s_spec, s_pdf, is_specular = bxdf_ops.surface_sample(
            cfg, mat, it_tex, ray_d, u_new, world_ior, mode=mode)
        if no_media:
            new_dir, ray_pdf = s_dir, s_pdf
        else:
            p_dir, p_val = medium_ops.phase_sample(
                rows_v["kind"], rows_v["ph_par"], rows_v["ph_pdf"], ray_d,
                u_new[:, :3], phase_kinds)
            new_dir = torch.where(is_mi[:, None], p_dir, s_dir)
            ray_pdf = torch.where(is_mi, p_val, s_pdf)
            is_specular = ~is_mi & is_specular

        bits = bits | torch.where(is_specular, B_DIR_DELTA | B_SPEC_DELTA,
                                  0).to(torch.int32)
        vtype_v = torch.where(is_mi, VERTEX_MEDIUM, VERTEX_SURFACE) \
            .to(torch.int32)
        n_s_v = torch.where(is_mi[:, None], zero3, it.n_s)
        n_g_v = torch.where(is_mi[:, None], zero3, it.n_g)
        vals = dict(vtype=vtype_v, obj_id=obj_id, emit_id=hit_light,
                    bits=bits, pdf_fwd=pdf_fwd, time=acc_time, pos=hit_point,
                    n_s=n_s_v, n_g=n_g_v, ray_in=ray_d, beta=thp)
        if tex is not None:
            vals["tex"] = tex
        if cfg.has_null_bsdf:
            _write_vertex(buf, vnum, place, **vals)
        else:
            _write_vertex_at(buf, i + 1, place, **vals)

        walk_on = active & (vnum < max_bnc)
        dead_surface = ~is_mi & ((s_spec.amax(dim=-1) <= 0.0)
                                 | (s_pdf <= 0.0))
        cont = torch.where(is_mi[:, None], 1.0,
                           s_spec / torch.clamp(s_pdf, min=1e-9)[:, None])
        thp_next = thp * torch.where(walk_on[:, None], cont, 1.0)
        csn = _correct_shading_normal(it.n_s, it.n_g, ray_d, new_dir, is_mi,
                                      mode)
        thp_next = thp_next * torch.where(walk_on, csn, 1.0)[:, None]

        # backward pdf of the PREVIOUS placed vertex (bdpt.py:293-303);
        # lanes that do not place never read these values
        cur_v = dict(vtype=vtype_v, obj_id=obj_id, emit_id=hit_light,
                     bits=bits, pos=hit_point, n_s=n_s_v, n_g=n_g_v,
                     ray_in=ray_d, tex=tex)
        pdf_bwd_sa = torch.where(
            is_mi, ray_pdf,
            torch.where(is_delta, 0.0,
                        pdf_vertex(scene, cfg, cur_v, -new_dir, -ray_d)))
        ray_pdf = torch.where(is_delta & ~is_mi, 0.0, ray_pdf)
        bwd = _get_pdf_bwd(last_pos, prev_ns, (prev_ns != 0.0).any(dim=-1),
                           pdf_bwd_sa, hit_point)
        if cfg.has_null_bsdf:
            _write_vertex(buf, vnum - 1, place & walk_on, pdf_bwd=bwd)
        else:                         # the previous slot is row i
            _write_vertex_at(buf, i, place & walk_on, pdf_bwd=bwd)

        active = walk_on & ~(~is_mi & dead_surface)
        # null lanes continue in the same direction without placing
        out_dir = torch.where(is_null[:, None], ray_d, new_dir)
        last_pos = torch.where(place[:, None], hit_point, last_pos)
        prev_ns = torch.where(place[:, None], n_s_v, prev_ns)
        ray_o, ray_d, thp = hit_point, out_dir, thp_next
        # the last iteration's next segment would feed nothing
        if i < iters - 1:
            it = ray_intersect(scene, cfg, hit_point, out_dir, alive=active)
    return buf, vnum + 1


@obs.spanned("bdpt.eye_walk",
             lambda scene, cfg, key, cnt, max_bnc, pix_ids=None:
             {"n": cfg.n_pixels if pix_ids is None else pix_ids.shape[0]})
def generate_eye_path(scene, cfg, key, cnt, max_bnc, pix_ids=None):
    N = cfg.n_pixels if pix_ids is None else pix_ids.shape[0]
    dev = scene.device
    key, cam_key = rng.split(key)
    ray_o, ray_d = camera_rays(scene, cfg, cam_key, cnt, pix_ids=pix_ids)
    buf = _vertex_buffers(N, max_bnc + 1, dev, scene.tex["albedo"].present)
    _write_vertex_at(
        buf, 0, None,
        vtype=torch.full((N,), VERTEX_CAMERA, dtype=torch.int32, device=dev),
        obj_id=torch.full((N,), -1, dtype=torch.int32, device=dev),
        emit_id=torch.full((N,), -1, dtype=torch.int32, device=dev),
        bits=torch.full((N,), B_POS_DELTA | B_IN_FSPACE, dtype=torch.int32,
                        device=dev),
        pos=scene.cam_t.expand(N, 3), beta=torch.ones((N, 3), device=dev),
        time=torch.zeros(N, device=dev))
    # pdf_camera is 0 (reference parity), so the walk starts with pdf 0
    pdf_dir = pdf_camera(cfg, dot(ray_d, _cam_normal(scene)))
    return bdpt_random_walk(scene, cfg, key, buf, ray_o, ray_d, pdf_dir,
                            torch.ones((N, 3), device=dev), TRANSPORT_RAD,
                            0.0, max_bnc)


@obs.spanned("bdpt.light_walk",
             lambda scene, cfg, key, max_bnc, n_paths=None:
             {"n": cfg.n_pixels if n_paths is None else n_paths})
def generate_light_path(scene, cfg, key, max_bnc, n_paths=None):
    N = cfg.n_pixels if n_paths is None else n_paths
    dev = scene.device
    key, k_pick, k_le = rng.split(key, 3)
    u_pick = rng.uniform(k_pick, (N,), device=dev)
    eid, emitter_pdf, _valid = emitter_ops.sample_light_index(
        cfg, u_pick, torch.full((N,), -1, dtype=torch.int32, device=dev))
    u_le = rng.uniform(k_le, (N, 5), device=dev)
    ray_o, ray_d, pdf_pos, pdf_dir, normal = emitter_ops.sample_le(
        scene, cfg, eid, u_le)
    intensity = scene.emit_intensity[eid]
    vertex_pdf = pdf_pos * emitter_pdf

    buf = _vertex_buffers(N, max_bnc + 1, dev, scene.tex["albedo"].present)
    _write_vertex_at(
        buf, 0, None,
        vtype=torch.full((N,), VERTEX_EMITTER, dtype=torch.int32, device=dev),
        obj_id=scene.emit_obj[eid], emit_id=eid, bits=scene.emit_bits[eid],
        pdf_fwd=vertex_pdf, time=scene.emit_time[eid], n_s=normal, n_g=normal,
        pos=ray_o, beta=intensity)

    ok = (pdf_dir > 0.0) & (intensity.amax(dim=-1) > 0.0) \
        & (vertex_pdf > 0.0)
    beta = intensity * torch.abs(dot(ray_d, normal))[:, None] \
        / torch.clamp(vertex_pdf * pdf_dir, min=1e-12)[:, None]
    beta = torch.where(ok[:, None], beta, 0.0)
    buf, vnum = bdpt_random_walk(scene, cfg, key, buf, ray_o, ray_d, pdf_dir,
                                 beta, TRANSPORT_IMP, scene.emit_time[eid],
                                 max_bnc)
    return buf, torch.where(ok, vnum, 1)


# ------------------------------- connections --------------------------------

def _null_vertex(N, device, has_tex=False):
    """All-null placeholder vertex (the lit side of s == 0 strategies);
    has_tex as for `_vertex_buffers` (its tex is 0, as the JAX
    package's)."""
    def ints(fill):
        return torch.full((N,), fill, dtype=torch.int32, device=device)
    z3 = torch.zeros((N, 3), device=device)
    zf = torch.zeros(N, device=device)
    return dict(vtype=ints(-1), obj_id=ints(-1), emit_id=ints(-1),
                bits=ints(0), pdf_fwd=zf, pdf_bwd=zf, time=zf, n_s=z3,
                n_g=z3, pos=z3, ray_in=z3, beta=z3,
                tex=z3 if has_tex else None)


def _pdf_ratio(scene, cfg, cur, prev_pos, prev_null, nxt):
    """remap(area-pdf of cur->nxt) / remap(nxt.pdf_fwd)
    (reference bdpt.py:541-570)."""
    ray_out = nxt["pos"] - cur["pos"]
    out_norm = norm(ray_out)
    out_dir = ray_out / torch.clamp(out_norm, min=1e-9)[:, None]
    is_emitter = cur["vtype"] == VERTEX_EMITTER
    is_camera = cur["vtype"] == VERTEX_CAMERA

    # emitter: directional pdf in area measure at nxt
    pdf_emit = _pdf_light(scene, cur, nxt["pos"], nxt["n_s"],
                          _has_normal(nxt))
    # camera: pdf_camera (reference-faithful 0)
    pdf_cam_sa = pdf_camera(cfg, torch.abs(dot(_cam_normal(scene)[None, :]
                                               .expand_as(out_dir),
                                               out_dir)))
    # generic surface / medium vertex
    ray_in = torch.where(prev_null[:, None], torch.zeros_like(out_dir),
                         normalize(cur["pos"] - prev_pos))
    pdf_sa = pdf_vertex(scene, cfg, cur, ray_in, out_dir)
    pdf_sa = torch.where(is_camera, pdf_cam_sa, pdf_sa)
    pdf_sa = torch.where(out_norm > 0.0, pdf_sa, 0.0)

    pdf_area = _get_pdf_bwd(nxt["pos"], nxt["n_s"], _has_normal(nxt),
                            pdf_sa, cur["pos"])
    pdf_area = torch.where(is_emitter, pdf_emit, pdf_area)
    return _remap(pdf_area) / _remap(nxt["pdf_fwd"])


def _mis_planes(cam_buf, lit_buf):
    """Strategy-independent (D, N) planes of the MIS sweeps: per-slot
    ratios remap(pdf_bwd) / remap(pdf_fwd) and not-delta flags, for each
    subpath buffer. Computed once per pass."""
    def per(buf):
        return (_remap(buf["pdf_bwd"]) / _remap(buf["pdf_fwd"]),
                (buf["bits"] & B_SPEC_DELTA) == 0)
    return per(cam_buf) + per(lit_buf)


def _stack_rows(rows_st, build):
    """Concatenate per-row vertex dicts along the lane axis (K*N,)."""
    parts = [build(si, ti) for (si, ti) in rows_st]
    if len(parts) == 1:
        return parts[0]
    return {k: (None if v is None else torch.cat([p[k] for p in parts]))
            for k, v in parts[0].items()}


def _sweep_table(steps, gates):
    """Shared sweep prefix table B (D, N) (bdpt.py:978-1000).

    The per-strategy sweep sum_{k<=hi} g_k prod_{m=k..hi} s'_m (s' = steps
    with the endpoint override at m == hi) factors as r_eff * B[hi] with
    B[h] = A(h - 1) + g_h and A_h = s_h A_{h-1} + s_h g_h. The JAX package
    runs the recurrence as an associative scan (tree order); here it runs
    in order, so the two differ by ~1 ulp per factor."""
    g = gates.to(steps.dtype)
    rows = [steps[0] * g[0]]
    for h in range(1, steps.shape[0]):
        rows.append(rows[-1] * steps[h] + steps[h] * g[h])
    A = torch.stack(rows)
    return torch.cat([torch.zeros_like(A[:1]), A[:-1]]) + g


@obs.spanned("bdpt.mis", lambda *a, case=None, rows=None, **k:
             {"case": case, "strategies": len(rows) if rows else 1})
def _mis_weight(scene, cfg, cam_buf, lit_buf, cam_side, lit_side, s, t,
                case=None, planes=None, rows=None):
    """MIS weight of a strategy, or of a flat batch of them (reference
    bdpt.py:412-491; the JAX package's vectorized ratio sweeps).

    rows=None: the single strategy (s, t) over (N,) sides. rows=[(s, t),
    ...]: K strategies of one case, sides concatenated to (K*N,) lanes;
    the endpoint ratios then run once over K*N lanes. Indices are Python
    ints."""
    rows_st = [(s, t)] if rows is None else [(r[0], r[1]) for r in rows]
    if case is None:
        case = _strategy_case(*rows_st[0])
    if planes is None:
        planes = _mis_planes(cam_buf, lit_buf)
    cam_steps, cam_nd, lit_steps, lit_nd = planes
    NF = cam_side["vtype"].shape[0]
    N = cam_buf["vtype"].shape[1]
    K = len(rows_st)
    D = cam_buf["vtype"].shape[0]
    dev = cam_steps.device
    false_n = torch.zeros(NF, dtype=torch.bool, device=dev)

    cam_prev_f = _stack_rows(rows_st,
                             lambda si, ti: _vertex_at(cam_buf, ti - 2))
    if case not in ("s0", "s1"):
        lit_prev_f = _stack_rows(rows_st,
                                 lambda si, ti: _vertex_at(lit_buf, si - 2))

    # endpoint ratio overrides (update_endpoint, bdpt.py:412-428)
    r_cam_end = torch.ones(NF, device=dev)
    r_cam_prev = torch.full((NF,), -1.0, device=dev)
    r_lit_end = torch.ones(NF, device=dev)
    r_lit_prev = torch.full((NF,), -1.0, device=dev)
    z3 = torch.zeros((NF, 3), device=dev)
    true_n = ~false_n

    if case != "s0":
        if case == "t1":                       # idx_t < 1
            prev_pos, prev_null = z3, true_n
        else:
            prev_pos, prev_null = cam_prev_f["pos"], false_n
        r_lit_end = _pdf_ratio(scene, cfg, cam_side, prev_pos, prev_null,
                               lit_side)
        if case != "t1":                       # idx_t >= 1
            r_cam_prev = _pdf_ratio(scene, cfg, cam_side, lit_side["pos"],
                                    false_n, cam_prev_f)
        if case == "s1":                       # idx_s < 1
            prev_pos, prev_null = z3, true_n
        else:
            prev_pos, prev_null = lit_prev_f["pos"], false_n
        r_cam_end = _pdf_ratio(scene, cfg, lit_side, prev_pos, prev_null,
                               cam_side)
        if case != "s1":                       # idx_s >= 1
            r_lit_prev = _pdf_ratio(scene, cfg, lit_side, cam_side["pos"],
                                    false_n, lit_prev_f)
    else:
        # the camera path hit an emitter (s == 0, bdpt.py:424-428)
        r_cam_end = _remap(_area_pdf(scene, cfg, cam_side["emit_id"])
                           / float(max(cfg.n_emitters, 1))) \
            / _remap(cam_side["pdf_fwd"])
        # s0 strategies have t >= 2, so idx_t >= 1 always
        r_cam_prev = _remap(_pdf_light(scene, cam_side, cam_prev_f["pos"],
                                       cam_prev_f["n_s"],
                                       _has_normal(cam_prev_f))) \
            / _remap(cam_prev_f["pdf_fwd"])

    iota = torch.arange(D, device=dev)[:, None]
    if case != "t1":
        nd_prev_cam = _not_delta(cam_prev_f)
        cam_prev_nd_full = torch.cat([cam_nd[:1], cam_nd[:-1]])
        B_cam = _sweep_table(cam_steps,
                             cam_nd & cam_prev_nd_full & (iota >= 1))
    if case != "s0":
        lit0_nd = _not_delta_source(_static_vertex(lit_buf, 0))   # (N,)
        lit_prev_nd_full = torch.cat([lit0_nd[None], lit_nd[:-1]])
        cur_nd_f = lit0_nd if case == "s1" else _not_delta(lit_prev_f)
        B_lit = _sweep_table(lit_steps, lit_nd & lit_prev_nd_full)

    def seg(x, i):
        # row-shared (N,) arrays (the s1 light-origin flags) pass through;
        # flat (K*N,) arrays are sliced to row i's lanes
        if K == 1 or x.shape[0] == N:
            return x
        return x[i * N:(i + 1) * N]

    sum_terms = []
    for i, (si, ti) in enumerate(rows_st):
        sum_ri = torch.zeros(N, device=dev)
        # camera-side sweep (bdpt.py:452-467)
        if case != "t1":
            rce = seg(r_cam_end, i)
            sum_ri = sum_ri + torch.where(seg(nd_prev_cam, i), rce, 0.0)
            hi = ti - 2
            rp = seg(r_cam_prev, i)
            r_eff = torch.where(rp > 0.0, rp, cam_steps[hi])
            sum_ri = sum_ri + rce * r_eff * B_cam[hi]
        # light-side sweep (bdpt.py:468-489); the k == 0 gate uses the
        # light origin's source-delta flags
        if case != "s0":
            rle = seg(r_lit_end, i)
            sum_ri = sum_ri + torch.where(seg(cur_nd_f, i), rle, 0.0)
            hi = si - 2
            if hi >= 0:                        # s == 1: empty
                rp = seg(r_lit_prev, i)
                r_eff = torch.where(rp > 0.0, rp, lit_steps[hi])
                sum_ri = sum_ri + rle * (r_eff * B_lit[hi])
        sum_terms.append(sum_ri)
    total = sum_terms[0] if K == 1 else torch.cat(sum_terms)
    return 1.0 / (1.0 + total)


@obs.spanned("bdpt.connect",
             lambda scene, cfg, key, cam_buf, cam_vnum, lit_buf, lit_vnum,
             rows, case=None, **_: {"case": case, "strategies": len(rows),
                                    "lanes": len(rows) * cam_vnum.shape[0]})
def connect_strategy(scene, cfg, key, cam_buf, cam_vnum, lit_buf, lit_vnum,
                     rows, case=None, planes=None, scan=False):
    """A flat batch of (t, s) strategies over the whole wavefront
    (reference bdpt.py:306-410, its `rows` form). Returns (radiance
    (K*N, 3), raster flat index (K*N,) or -1, path_time (K*N,), warp_off
    (K*N,)).

    rows=[(s, t, k_idx), ...], one case: the K strategies' endpoints are
    concatenated to (K*N,) lanes and the whole connection runs once over
    them. `key` is the group base key; row sub-keys fold k_idx, so s1's
    sampled endpoints keep their per-strategy streams. scan: the group is
    one the JAX package scans, so each row's transmittance draws from its
    own sub-key as the scan's single-strategy form does."""
    rows_st = [(r[0], r[1]) for r in rows]
    sub_keys = [rng.fold_in(key, r[2]) for r in rows]
    if case is None:
        case = _strategy_case(*rows_st[0])
    N = cam_vnum.shape[0]
    K = len(rows_st)
    NF = K * N
    dev = cam_vnum.device
    zero3 = torch.zeros((NF, 3), device=dev)

    def flat(build):
        """Concatenate per-row (N,) lane arrays to (K*N,)."""
        parts = [build(si, ti) for (si, ti) in rows_st]
        return parts[0] if K == 1 else torch.cat(parts)

    # per-lane strategy bounds (bdpt.py:146-152)
    valid = flat(lambda si, ti: (ti <= cam_vnum) & (si <= lit_vnum))
    cam_side = _stack_rows(rows_st,
                           lambda si, ti: _vertex_at(cam_buf, ti - 1))
    # multi light connection skip (bdpt.py:153-155)
    if case in ("s1", "gen"):
        valid = valid & (cam_side["vtype"] != VERTEX_EMITTER)

    le = zero3
    raster = torch.full((NF,), -1, dtype=torch.int32, device=dev)
    path_time = torch.zeros(NF, device=dev)
    calc_tr = torch.zeros(NF, dtype=torch.bool, device=dev)
    track_pos = conn_dir = zero3
    depth = torch.zeros(NF, device=dev)
    has_tex = scene.tex["albedo"].present
    lit_side = (_null_vertex(NF, dev, has_tex) if case == "s0"
                else _stack_rows(rows_st,
                                 lambda si, ti: _vertex_at(lit_buf, si - 1)))

    if case == "s0":
        v = cam_side
        is_l = _is_light_v(v) & (v["emit_id"] >= 0)
        eid = v["emit_id"].clamp(min=0)
        e_le = emitter_ops.eval_le(scene, eid, v["ray_in"], v["n_g"])
        le = torch.where((valid & is_l)[:, None], e_le * v["beta"], zero3)
        path_time = scene.emit_time[eid] + v["time"]
    elif case == "t1":
        v = lit_side
        ok = valid & _is_connectible(v)
        diff = scene.cam_t - v["pos"]
        depth = norm(diff)
        conn_dir = diff / torch.clamp(depth[:, None], min=1e-9)
        we, cam_pdf, pi, pj = sample_camera(scene, cfg, -conn_dir, depth)
        ok = ok & (cam_pdf > 0.0)
        fr2cam = eval_vertex(scene, cfg, v, conn_dir, TRANSPORT_IMP)
        cam_beta = (we / torch.clamp(cam_pdf, min=1e-9))[:, None]
        le = torch.where(ok[:, None], v["beta"] * fr2cam * cam_beta, zero3)
        calc_tr = ok & (fr2cam.amax(dim=-1) > 0.0)
        track_pos = v["pos"]
        raster = torch.where(ok, pi * cfg.h + pj, -1)
        path_time = v["time"] + depth
        # the sampled camera vertex, for MIS
        cn = _cam_normal(scene).expand(NF, 3)
        cam_side = _null_vertex(NF, dev, has_tex)
        cam_side.update(
            vtype=torch.full((NF,), VERTEX_CAMERA, dtype=torch.int32,
                             device=dev),
            bits=torch.full((NF,), B_POS_DELTA | B_IN_FSPACE,
                            dtype=torch.int32, device=dev),
            pos=scene.cam_t.expand(NF, 3), n_s=cn, n_g=cn,
            time=v["time"] + depth,
            beta=cam_beta * torch.ones((NF, 3), device=dev))
    elif case == "s1":
        v = cam_side
        ok = valid & _is_connectible(v)
        picks = [rng.split(k, 3) for k in sub_keys]
        u_pick = torch.cat([rng.uniform(p[1], (N,), device=dev)
                            for p in picks])
        u_hit = torch.cat([rng.uniform(p[2], (N, 3), device=dev)
                           for p in picks])
        eid, emitter_pdf, _e_valid = emitter_ops.sample_light_index(
            cfg, u_pick, torch.full((NF,), -1, dtype=torch.int32,
                                    device=dev))
        emit_pos, emit_int, _pdf, e_normal = emitter_ops.sample_hit(
            scene, cfg, eid, v["pos"], u_hit)
        diff = emit_pos - v["pos"]
        depth = norm(diff)
        conn_dir = diff / torch.clamp(depth[:, None], min=1e-9)
        ok = ok & (emit_int.amax(dim=-1) > 0.0)
        fr2lit = eval_vertex(scene, cfg, v, conn_dir, TRANSPORT_RAD)
        lit_beta = emit_int / torch.clamp(emitter_pdf, min=1e-9)[:, None]
        le = torch.where(ok[:, None], v["beta"] * fr2lit * lit_beta, zero3)
        calc_tr = ok & (fr2lit.amax(dim=-1) > 0.0)
        track_pos = v["pos"]
        path_time = scene.emit_time[eid] + v["time"]
        # the sampled emitter vertex, for MIS
        lit_side = _null_vertex(NF, dev, has_tex)
        lit_side.update(
            vtype=torch.full((NF,), VERTEX_EMITTER, dtype=torch.int32,
                             device=dev),
            obj_id=scene.emit_obj[eid], emit_id=eid,
            bits=scene.emit_bits[eid], time=scene.emit_time[eid],
            pdf_fwd=_area_pdf(scene, cfg, eid) / float(max(cfg.n_emitters,
                                                           1)),
            n_s=e_normal, n_g=e_normal, pos=emit_pos, beta=lit_beta)
    else:
        cv, lv = cam_side, lit_side
        ok = valid & _is_connectible(cv) & _is_connectible(lv)
        diff = lv["pos"] - cv["pos"]
        depth = norm(diff)
        conn_dir = diff / torch.clamp(depth[:, None], min=1e-9)
        ok = ok & (depth > 0.0)
        fr_cam = eval_vertex(scene, cfg, cv, conn_dir, TRANSPORT_RAD)
        fr_lit = eval_vertex(scene, cfg, lv, -conn_dir, TRANSPORT_IMP)
        inv_d2 = 1.0 / torch.clamp(depth * depth, min=1e-12)
        le = torch.where(ok[:, None],
                         cv["beta"] * fr_cam * fr_lit * lv["beta"]
                         * inv_d2[:, None], zero3)
        calc_tr = ok & (fr_cam.amax(dim=-1) > 0.0) \
            & (fr_lit.amax(dim=-1) > 0.0)
        track_pos = cv["pos"]
        path_time = lv["time"] + cv["time"]

    # transmittance + propagation time (bdpt.py:394-397)
    need_tr = calc_tr & (le.amax(dim=-1) > 0.0)
    if case != "s0":
        # the JAX package's key (it feeds only grid-volume ratio
        # tracking): the flat form's one key for the chunk (bdpt.py:1222),
        # or the scan form's split of each row's sub-key, for s1 after
        # the endpoint's three-way split (:1156, :1216-1217)
        if scan:
            base = [p[0] for p in picks] if case == "s1" else sub_keys
            k_tr = [rng.split(k)[1] for k in base]
        else:
            k_tr = rng.fold_in(key, 1 << 31)
        tr, track_depth = track_ray(scene, cfg, track_pos, conn_dir, depth,
                                    key=k_tr, thp=torch.ones((NF, 3),
                                                             device=dev),
                                    active=need_tr)
        le = torch.where(need_tr[:, None], le * tr, le)
        path_time = path_time + torch.where(need_tr, track_depth, 0.0)

    # MIS weight (bdpt.py:398-404); s + t == 2 (the camera sees the
    # emitter, only in the s0 case) always weights 1
    if cfg.use_mis:
        w = _mis_weight(scene, cfg, cam_buf, lit_buf, cam_side, lit_side,
                        0, 0, case=case, planes=planes, rows=rows_st)
        if case == "s0":
            one = flat(lambda si, ti: torch.full((N,), si + ti == 2,
                                                 dtype=torch.bool,
                                                 device=dev))
            w = torch.where(one, 1.0, w)
    else:
        w = torch.ones(NF, device=dev)
    has_le = le.amax(dim=-1) > 0.0
    result = torch.where(has_le[:, None], le * w[:, None], zero3)
    if cfg.modulated:
        # AMCW sine-squared ToF modulation (reference bdpt.py:407-408)
        m = (0.5 * (torch.sin(6.0 * path_time) + 1.0))[:, None]
        result = result * (m * m)
    result = torch.nan_to_num(result, nan=0.0, posinf=0.0, neginf=0.0)
    path_time = torch.where(result.amax(dim=-1) > 0.0, path_time, 0.0)
    # camera first-leg time, for true unwarped binning (cfg.unwarp): the
    # t=1 camera connection is the leg; every other case has t >= 2, so
    # the eye buffer's slot-1 time is the leg
    if case == "t1":
        warp_off = depth
    else:
        t1v = cam_buf["time"][1]
        warp_off = flat(lambda si, ti: t1v)
    return result, raster, path_time, warp_off


def _strategy_groups(cfg, max_bnc):
    """{case: [(s, t, k_idx), ...]} in the reference's double-loop order
    (bdpt.py:143-167); k_idx numbers the strategies from 1."""
    t_hi = min(cfg.end_t - 1, max_bnc + 1)
    s_hi = min(cfg.end_s - 1, max_bnc + 1)
    groups = {"s0": [], "t1": [], "s1": [], "gen": []}
    k_idx = 0
    for t in range(max(cfg.start_t, 1), t_hi + 1):
        for s in range(max(cfg.start_s, 0), s_hi + 1):
            depth = s + t - 2
            if (s == 1 and t == 1) or depth < 0 or depth > cfg.max_bounce:
                continue
            k_idx += 1
            groups[_strategy_case(s, t)].append((s, t, k_idx))
    return groups


def scan_form(n_rows, N):
    """Whether the JAX package scans a group of n_rows strategies over N
    lanes: more than FLAT_MAX_CHUNKS chunks of FLAT_LANES // N
    (bdpt.py:1418-1421)."""
    Q = max(1, FLAT_LANES // max(N, 1))
    return -(-n_rows // Q) > FLAT_MAX_CHUNKS


@obs.spanned("bdpt.bin", lambda cfg, bins, cnts, case, radiance, *_:
             {"case": case, "lanes": radiance.shape[0]})
def bin_transient(cfg, bins, cnts, case, radiance, raster, p_time, n_rows,
                  warp_off, N, full):
    """Transient binning of a chunk of `n_rows` strategies over N lanes
    into the pass's histograms `bins` (N, t_bins, 3) and `cnts` (N,
    t_bins), in place (a plain accumulating index_put_: on the card its
    float order varies from run to run). A t == 1 chunk bins at its raster
    targets (full: a full-frame pass; else crop-local, as
    `bdpt_pass_core` says), any other chunk at its own lanes. cfg.unwarp
    subtracts the camera first-leg time (bdpt.py:42-46)."""
    obs.count("transient.offered", radiance.shape[0])
    if cfg.unwarp:
        p_time = torch.clamp(p_time - warp_off, min=0.0)
    tid = torch.floor((p_time - cfg.t_min) / cfg.t_interval) \
        .to(torch.int64)
    in_range = (p_time > cfg.t_min) \
        & (p_time < cfg.t_min + cfg.t_interval * cfg.t_bins) \
        & (radiance.amax(dim=-1) > 0.0)
    if case == "t1":
        if full:
            target = raster.long()
        else:
            # full-film raster -> crop-local bin index (raster >= 0
            # implies inside the crop window, _rasterize_pinhole)
            ch_ = cfg.end_y - cfg.start_y
            pi = torch.div(raster, cfg.h, rounding_mode="floor")
            pj = raster % cfg.h
            target = ((pi - cfg.start_x) * ch_
                      + (pj - cfg.start_y)).long()
        keep = in_range & (raster >= 0)
    else:
        target = torch.arange(N, device=radiance.device).repeat(n_rows)
        keep = in_range
    # out-of-range targets (the JAX package's `drop`) are dropped
    keep = keep & (target < N) & (target >= 0)
    obs.tally("transient.binned", keep)
    tid = tid.clamp(0, cfg.t_bins - 1)
    sel = keep.nonzero()[:, 0]
    tg, tb = target[sel], tid[sel]
    bins.index_put_((tg, tb), radiance[sel], accumulate=True)
    cnts.index_put_((tg, tb), torch.ones_like(tg, dtype=torch.int32),
                    accumulate=True)


def bdpt_pass_core(scene, cfg, key, cnt, pix_ids=None, crop_local=False):
    """One BDPT pass, optionally restricted to the crop window's pixels.

    pix_ids None: full frame. Otherwise only the given pixels' camera
    subpaths (and that many light subpaths) are traced, but t == 1 splats
    still target the FULL film. crop_local=True asserts pix_ids is the crop
    window (renderer/base.py crop_pix_ids order): transient histograms are
    then crop-local, with t == 1 raster targets mapped full film -> crop
    index (the reference's crop-aware field layout, bdpt.py:49-78).

    Returns (color_local (N,3), color_splat (n_pixels,3), bins, cnts)."""
    full = pix_ids is None
    N = cfg.n_pixels if full else pix_ids.shape[0]
    dev = scene.device
    assert full or crop_local or not cfg.transient, \
        "transient BDPT shards must be the crop window"
    cap = CAP_CROP if crop_local else CAP
    max_bnc = min(cfg.max_bounce, cap)
    if cfg.max_bounce > cap:
        warnings.warn(
            f"BDPT subpath depth clamped: scene max_bounce={cfg.max_bounce} "
            f"exceeds the cap {cap} (reference N_MAX_BOUNCE=32/"
            f"T_MAX_BOUNCE=400); rendering with {cap} bounces", stacklevel=2)
    key, k_cam, k_lit, k_con = rng.split(key, 4)
    cam_buf, cam_vnum = generate_eye_path(scene, cfg, k_cam, cnt, max_bnc,
                                          pix_ids=pix_ids)
    lit_buf, lit_vnum = generate_light_path(scene, cfg, k_lit, max_bnc,
                                            n_paths=N)

    color_local = torch.zeros((N, 3), device=dev)
    color_splat = torch.zeros((cfg.n_pixels, 3), device=dev)
    drop = cfg.n_pixels
    mis_planes = _mis_planes(cam_buf, lit_buf) if cfg.use_mis else None
    bins = cnts = None
    if cfg.transient:
        bins = torch.zeros((N, cfg.t_bins, 3), device=dev)
        cnts = torch.zeros((N, cfg.t_bins), dtype=torch.int32, device=dev)
    groups = _strategy_groups(cfg, max_bnc)

    def splat_sorted(film, ii, rr):
        """ONE pixel-sorted film splat for all t = 1 strategies: a stable
        sort by pixel, the rgb gathered by its permutation, then kernel B4
        (the plain version on the CPU)."""
        with obs.span("bdpt.splat", n=ii.shape[0]):
            ii, perm = torch.sort(ii, stable=True)
            return splat_sorted_accumulate(film, ii.contiguous(),
                                           rr[perm].contiguous())

    Q = max(1, FLAT_LANES // max(N, 1))
    for case in ("s0", "t1", "s1", "gen"):
        table = groups[case]
        if not table:
            continue
        # the scan form's draws and sums, where the JAX package scans
        scan = scan_form(len(table), N)
        ii_all, rr_all = [], []
        for c0 in range(0, len(table), Q):
            rows = table[c0:c0 + Q]
            radiance, raster, p_time, warp_off = connect_strategy(
                scene, cfg, k_con, cam_buf, cam_vnum, lit_buf, lit_vnum,
                rows, case=case, planes=mis_planes, scan=scan)
            if case == "t1":
                ok = raster >= 0
                ii_all.append(torch.where(ok, raster, drop))
                rr_all.append(torch.where(ok[:, None], radiance, 0.0))
            elif scan:                 # strategy after strategy (:1438)
                for k in range(len(rows)):
                    color_local = color_local + radiance[k * N:(k + 1) * N]
            else:
                r = radiance.reshape(len(rows), N, 3)
                acc = r[0]
                for k in range(1, len(rows)):
                    acc = acc + r[k]
                color_local = color_local + acc
            if cfg.transient and scan:  # one strategy at a time (:1440)
                for k in range(len(rows)):
                    lanes = slice(k * N, (k + 1) * N)
                    bin_transient(cfg, bins, cnts, case, radiance[lanes],
                                  raster[lanes], p_time[lanes], 1,
                                  warp_off[lanes], N, full)
            elif cfg.transient:
                bin_transient(cfg, bins, cnts, case, radiance, raster,
                              p_time, len(rows), warp_off, N, full)
            del radiance, raster, p_time, warp_off
        if case == "t1":
            color_splat = splat_sorted(color_splat, torch.cat(ii_all),
                                       torch.cat(rr_all))
    return color_local, color_splat, bins, cnts


def _check(scene, cfg):
    if cfg.n_emitters < 1:
        raise ValueError("BDPT needs at least one emitter")


def render_pass_bdpt(scene, cfg, key, cnt):
    """One full BDPT pass; returns (color (n_pixels, 3), bins, cnts), where
    bins/cnts are the transient histograms (None, None in steady state;
    crop-local when a crop window is configured).

    With a crop window only crop pixels are traced (reference
    tracer_base.py:39-55); light-tracing splats are crop-clipped by
    _rasterize_pinhole as in the reference."""
    _check(scene, cfg)
    pix = crop_pix_ids(cfg, scene.device)
    if pix is None:
        color_local, color_splat, bins, cnts = bdpt_pass_core(
            scene, cfg, key, cnt)
        return color_local + color_splat, bins, cnts
    color_local, color_splat, bins, cnts = bdpt_pass_core(
        scene, cfg, key, cnt, pix_ids=pix, crop_local=True)
    color = color_splat.clone()
    color[pix] = color[pix] + color_local
    return color, bins, cnts


def render_batch_bdpt(scene, cfg, key, cnt0, spp):
    """SUM of spp steady-state BDPT passes, (n_pixels, 3): the JAX
    package's stream (pass i keyed by fold_in(key, i))."""
    acc = torch.zeros((cfg.n_pixels, 3), device=scene.device)
    for i in range(spp):
        with obs.span(obs.PASS, cnt=cnt0 + i, spp=1):
            color, _b, _c = render_pass_bdpt(scene, cfg,
                                             rng.fold_in(key, i), cnt0 + i)
            acc = acc + torch.nan_to_num(color, nan=0.0)
    return acc


_TRANSIENT_KEYS = ("t_min", "t_interval", "sol", "decomposition", "t_bins")


def transient_check_point(cfg, time_bins, time_cnts) -> dict:
    """Transient additions to a checkpoint dict: the histograms and the
    binning config they were accumulated under."""
    chk = {k: getattr(cfg, k) for k in _TRANSIENT_KEYS}
    chk["time_bins"] = obs.host_read(time_bins, "film.checkpoint").numpy()
    chk["time_cnts"] = obs.host_read(time_cnts, "film.checkpoint").numpy()
    return chk


def validate_transient_check_point(cfg, chk, bins_shape, cnts_shape,
                                   is_transient, device=None):
    """Validate (without mutating anything) that a checkpoint's transient
    payload matches this run; returns (bins, cnts) to adopt, or (None,
    None) for steady-state runs. Raises on a transient run loading a
    steady checkpoint, a steady run loading a transient one, a binning
    config mismatch and shape mismatches."""
    has = "time_bins" in chk
    if not is_transient:
        if has:
            raise ValueError(
                "checkpoint carries transient histograms but this run is "
                "steady-state — resuming would silently discard them")
        return None, None
    if not has:
        raise ValueError(
            "checkpoint has no transient histograms (saved from a "
            "steady-state run?)")
    if "time_cnts" not in chk:
        raise ValueError("checkpoint is missing 'time_cnts'")
    for k in _TRANSIENT_KEYS:
        if k in chk and chk[k] != getattr(cfg, k):
            raise ValueError(f"transient config mismatch on '{k}': "
                             f"{chk[k]} != {getattr(cfg, k)}")
    bins = torch.as_tensor(np.asarray(chk["time_bins"]), device=device)
    cnts = torch.as_tensor(np.asarray(chk["time_cnts"]), device=device)
    if tuple(bins.shape) != tuple(bins_shape) \
            or tuple(cnts.shape) != tuple(cnts_shape):
        raise ValueError(
            f"transient histogram shape mismatch: checkpoint "
            f"{tuple(bins.shape)}/{tuple(cnts.shape)} != configured "
            f"{tuple(bins_shape)}/{tuple(cnts_shape)}")
    return bins, cnts


def transient_copy_average(cfg, time_bins, time_cnts, pix_ids, time_idx):
    """One time bin as a (w, h, 3) frame (reference bdpt.py:123-127);
    crop-local bins scatter into a zero full-film frame."""
    cnt = time_cnts[:, time_idx].clamp(min=1)
    frame = time_bins[:, time_idx] / cnt[:, None]
    if pix_ids is not None:
        full = torch.zeros((cfg.n_pixels, 3), device=frame.device)
        full[pix_ids] = frame
        frame = full
    return frame.reshape(cfg.w, cfg.h, 3)


def transient_frames_np(cfg, time_bins, time_cnts, pix_ids):
    """All time bins as (T, h, w, 3) image-oriented numpy."""
    return np.stack([
        obs.host_read(transient_copy_average(cfg, time_bins, time_cnts,
                                             pix_ids, i).transpose(0, 1),
                      "film.transient").numpy()[::-1]
        for i in range(cfg.t_bins)])


class BDPT(ProgressiveRenderer):
    """Bidirectional path tracer (reference bdpt.py:34)."""

    def __init__(self, scene, cfg, seed: int = 0):
        _check(scene, cfg)
        super().__init__(scene, cfg, seed)
        self.is_transient = cfg.transient
        if self.is_transient:
            self._pix_ids = crop_pix_ids(cfg, scene.device)
            n_traced = cfg.n_pixels if self._pix_ids is None \
                else int(self._pix_ids.shape[0])
            self.time_bins = torch.zeros((n_traced, cfg.t_bins, 3),
                                         device=scene.device)
            self.time_cnts = torch.zeros((n_traced, cfg.t_bins),
                                         dtype=torch.int32,
                                         device=scene.device)

    def render_pass(self, key, cnt):
        color, bins, cnts = render_pass_bdpt(self.scene, self.cfg, key, cnt)
        if self.is_transient:
            self.time_bins = self.time_bins + bins
            self.time_cnts = self.time_cnts + cnts
        return color

    def render_batch(self, spp: int):
        if self.is_transient:
            return super().render_batch(spp)
        self.key, sub = rng.split(self.key)
        acc = render_batch_bdpt(self.scene, self.cfg, sub, self.cnt + 1, spp)
        self.cnt += spp
        self.color = self.color + acc.reshape(self.cfg.w, self.cfg.h, 3)
        return self.color

    # transient runs checkpoint their histograms too: resuming with only
    # color/cnt would export transient frames built from post-resume
    # samples while the steady image includes all of them
    def get_check_point(self) -> dict:
        chk = super().get_check_point()
        if self.is_transient:
            chk.update(transient_check_point(self.cfg, self.time_bins,
                                             self.time_cnts))
        return chk

    def load_check_point(self, chk: dict):
        # validate before any state mutates, so a rejected checkpoint
        # leaves the renderer untouched
        bins, cnts = validate_transient_check_point(
            self.cfg, chk,
            self.time_bins.shape if self.is_transient else None,
            self.time_cnts.shape if self.is_transient else None,
            self.is_transient, device=self.scene.device)
        super().load_check_point(chk)
        if self.is_transient:
            self.time_bins = bins
            self.time_cnts = cnts

    def copy_average(self, time_idx: int):
        return transient_copy_average(self.cfg, self.time_bins,
                                      self.time_cnts, self._pix_ids,
                                      time_idx)

    def transient_frames(self):
        return transient_frames_np(self.cfg, self.time_bins,
                                   self.time_cnts, self._pix_ids)
