"""Texture fetch from the packed atlases (port of
adapt_tpu/ops/texture_ops.py).

Bilinear taps into a tag's atlas with wrap-around (reference
bxdf/texture.py:102-139 `Texture.query`), the local barycentric uv of a
hit turned into the object's global uv (path_tracer.py:276-289
`get_uv_item`), and the normal- and bump-map perturbation of the shading
normal (path_tracer.py:291-307). The JAX package's one-hot table gathers
are index reads here. Every function is free on a scene without the tag:
`TextureTable.present` is a host bool.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import obs
from ..scene.texture import MODE_CHECKER, MODE_INVALID
from .math3d import delocalize_rotate, normalize


def _bilinear(atlas, x, y):
    """Bilinear fetch at float coords (x, y), atlas[y, x] convention."""
    H, W = atlas.shape[0], atlas.shape[1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    rx = (x - x0)[:, None]
    ry = (y - y0)[:, None]
    x0i = x0.to(torch.int32).clamp(0, W - 1).long()
    y0i = y0.to(torch.int32).clamp(0, H - 1).long()
    x1i = (x0i + 1).clamp(0, W - 1)
    y1i = (y0i + 1).clamp(0, H - 1)
    q00 = atlas[y0i, x0i]
    q10 = atlas[y0i, x1i]
    q01 = atlas[y1i, x0i]
    q11 = atlas[y1i, x1i]
    top = q00 * (1.0 - rx) + q10 * rx
    bot = q01 * (1.0 - rx) + q11 * rx
    return top * (1.0 - ry) + bot * ry


def _untextured(n, device):
    return (torch.full((n, 3), -1.0, device=device),
            torch.zeros(n, dtype=torch.bool, device=device))


def query_texture(table, obj_id, u, v):
    """Per-lane texture query; returns ((N,3) color, (N,) valid).

    Invalid (color -1) where the object has no texture of this tag (mode
    -255) or the lane missed (obj_id -1)."""
    if not table.present:
        return _untextured(obj_id.shape[0], obj_id.device)
    idx = obj_id.clamp(min=0).long()
    mode = table.mode[idx]
    valid = (obj_id >= 0) & (mode > MODE_INVALID)

    w = torch.clamp(table.w[idx], min=2.0)
    h = torch.clamp(table.h[idx], min=2.0)
    sc_u, sc_v = table.scale_u[idx], table.scale_v[idx]
    su = u * sc_u * w
    sv = v * sc_v * h
    # wrap to [0, dim - 1) as the reference's float mod does
    # (texture.py:120-121); remainder takes the divisor's sign, as jnp.mod
    su = torch.remainder(su, w - 1.0)
    sv = torch.remainder(sv, h - 1.0)
    x = su + table.off_x[idx].to(torch.float32)
    y = sv + table.off_y[idx].to(torch.float32)
    img_color = _bilinear(table.atlas, x, y)

    # checkerboard (mode 1): two colors on a unit grid
    checker = torch.remainder(torch.floor(u * 2.0 * sc_u)
                              + torch.floor(v * 2.0 * sc_v), 2.0)
    chk_color = torch.where(checker[:, None] > 0.5, table.c2[idx],
                            table.c1[idx])
    color = torch.where((mode == MODE_CHECKER)[:, None], chk_color,
                        img_color)
    return torch.where(valid[:, None], color, -1.0), valid


@obs.spanned("shade.texture",
             lambda scene, table, it: {"n": it.obj_id.shape[0]})
def get_uv_item(scene, table, it):
    """Texture color of `table`'s tag at each hit: ((N,3) color, (N,)
    valid). Triangles interpolate their vertex uvs with the hit's
    barycentric (u, v); spheres use the hit's local uv as it is."""
    if not table.present:
        return _untextured(it.prim_id.shape[0], it.prim_id.device)
    prim = it.prim_id.clamp(min=0).long()
    obj = it.obj_id.clamp(min=0).long()
    is_sphere = scene.obj_is_sphere[obj] > 0
    uvc = scene.prim_uv[prim]                      # (N,3,2)
    lu, lv = it.uv[:, 0], it.uv[:, 1]
    w0 = (1.0 - lu - lv)[:, None]
    tri_uv = uvc[:, 1] * lu[:, None] + uvc[:, 2] * lv[:, None] \
        + uvc[:, 0] * w0
    u = torch.where(is_sphere, lu, tri_uv[:, 0])
    v = torch.where(is_sphere, lv, tri_uv[:, 1])
    return query_texture(table, it.obj_id, u, v)


def process_ns(scene, cfg, it):
    """Normal- and bump-map perturbation of the shading normal
    (reference path_tracer.py:291-307). A normal map replaces n_s by the
    mapped normal rotated into the geometric normal's frame; a bump map
    rotates n_s by the mapped offset. An identity (the same object) when
    the scene has neither."""
    n_s = it.n_s
    if cfg.has_normal_map:
        normal, valid = get_uv_item(scene, scene.tex["normal"], it)
        mapped = delocalize_rotate(it.n_g, normalize(normal))
        n_s = torch.where(valid[:, None], mapped, n_s)
    if cfg.has_bump_map:
        delta, valid = get_uv_item(scene, scene.tex["bump"], it)
        bumped = normalize(delocalize_rotate(n_s, normalize(delta)))
        n_s = torch.where(valid[:, None], bumped, n_s)
    if n_s is it.n_s:
        return it
    return dataclasses.replace(it, n_s=n_s)
