"""Carry state across from the JAX package, as numpy arrays.

The port never imports jax. A caller that holds JAX objects reads them out
with `scene_leaves` (plain `np.asarray` on each leaf) and hands the numpy
dict to `scene_from_numpy` (the BVH packs come across as they are, so the
port walks the JAX package's own tree, and their float4 rows are made from
them as the port's compiler makes them; the cluster tables `cl_*` come
across in the port's prim-major layout, so both packages sweep the same
clusters); a JAX PRNG key's data (`jax.random.key_data`,
the checkpoint `key` field) becomes a port key with `key_from_numpy`.
BDPT vertex buffers cross in the JAX package's layout (scalars (D, N),
vectors (3, D, N)) with `vertex_buffers_from_numpy`, and back with
`vertex_buffers_to_numpy`; the port keeps vectors as (D, N, 3).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .scene.compile import (MediumTable, RenderConfig, SceneData,
                            TextureTable, front_boxes, prim_slots,
                            resolve_device, v4_packs)

_TEX_TAGS = ("albedo", "normal", "bump", "roughness")
_MEDIUM = tuple(f.name for f in dataclasses.fields(MediumTable))
_NESTED = {"medium": _MEDIUM, "world_medium": _MEDIUM}

# dotted names of every SceneData leaf the port reads; each resolves on a
# JAX SceneData and on the port's alike (attributes, and dict keys in tex)
LEAF_NAMES = tuple(
    [f.name for f in dataclasses.fields(SceneData)
     if f.name not in _NESTED and f.name != "tex"]
    + [f"{m}.{a}" for m, attrs in _NESTED.items() for a in attrs]
    + [f"tex.{t}.mode" for t in _TEX_TAGS])


def _resolve(obj, dotted):
    for part in dotted.split("."):
        obj = obj[part] if isinstance(obj, dict) else getattr(obj, part)
    return obj


def _jax_layout_leaves(scene) -> dict:
    """The port's own tables from a JAX SceneData's. The BVH packs' float4
    rows by `v4_packs`. The cluster tables: `cl_aabb` (C,8) loses its two
    padded columns, the prim-major copy `cl_rows_pm` (C*CM,24) its six
    padded fields, `cl_chunk` (C*8,K) becomes (C,K,6); the inflated boxes,
    the live counts and the prim-to-slot map are derived as the port's
    compiler derives them."""
    node_v4, prim_v4 = v4_packs(scene.bvh_node_pack, scene.bvh_prim_pack)
    aabb = np.ascontiguousarray(np.asarray(scene.cl_aabb)[:, :6])
    rows = np.ascontiguousarray(np.asarray(scene.cl_rows_pm)[:, :18])
    ch = np.asarray(scene.cl_chunk)
    chunk = ch.reshape(-1, 8, ch.shape[1])[:, :6].transpose(0, 2, 1)
    count, slot = prim_slots(rows, aabb.shape[0],
                             np.asarray(scene.prim_obj).shape[0])
    return dict(bvh_node_v4=node_v4, bvh_prim_v4=prim_v4, cl_aabb=aabb,
                cl_front=front_boxes(aabb), cl_rows=rows,
                cl_chunk=np.ascontiguousarray(chunk), cl_count=count,
                cl_slot=slot)


def scene_leaves(scene) -> dict:
    """{dotted name: numpy array} for LEAF_NAMES of a JAX or port scene."""
    out = {}
    layout = {} if isinstance(scene, SceneData) \
        else _jax_layout_leaves(scene)
    for name in LEAF_NAMES:
        x = layout[name] if name in layout else _resolve(scene, name)
        out[name] = x.cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)
    return out


def scene_from_numpy(leaves: dict, cfg_fields: dict, device="cuda"):
    """(SceneData, RenderConfig) of the port from numpy leaves
    (`scene_leaves`) and a RenderConfig's fields (`dataclasses.asdict`),
    on `device` (the CUDA device by default; raises when there is none)."""
    device = resolve_device(device)
    def t(name):
        return torch.tensor(np.asarray(leaves[name]))

    kw = {n: t(n) for n in LEAF_NAMES if "." not in n}
    for m, attrs in _NESTED.items():
        kw[m] = MediumTable(**{a: t(f"{m}.{a}") for a in attrs})
    kw["tex"] = {tag: TextureTable(
        mode=t(f"tex.{tag}.mode"),
        present=bool((np.asarray(leaves[f"tex.{tag}.mode"]) > -255).any()))
        for tag in _TEX_TAGS}
    scene = SceneData(**kw).to(device)
    return scene, RenderConfig(**cfg_fields)


def key_from_numpy(data) -> tuple:
    """uint32[2] JAX key data -> the port's key (two Python ints)."""
    data = np.asarray(data, np.uint32).reshape(2)
    return (int(data[0]), int(data[1]))


def key_to_numpy(key) -> np.ndarray:
    """The port's key -> uint32[2], as `jax.random.key_data` gives it."""
    return np.array(key, np.uint32)


def vertex_buffers_from_numpy(bufs: dict, device="cuda") -> dict:
    """BDPT vertex buffers of the JAX package (a dict of arrays: scalars
    (D, N), vectors (3, D, N), `tex` None) -> the port's layout (vectors
    (D, N, 3)) on `device`."""
    device = resolve_device(device)
    out = {}
    for k, v in bufs.items():
        if v is None:
            out[k] = None
            continue
        a = np.asarray(v)
        if a.ndim == 3:
            a = np.moveaxis(a, 0, -1)
        out[k] = torch.tensor(np.ascontiguousarray(a), device=device)
    return out


def vertex_buffers_to_numpy(buf: dict) -> dict:
    """The port's BDPT vertex buffers -> numpy in the JAX package's layout
    (vectors (3, D, N))."""
    out = {}
    for k, v in buf.items():
        if v is None:
            out[k] = None
            continue
        a = v.cpu().numpy()
        out[k] = np.ascontiguousarray(np.moveaxis(a, -1, 0)) \
            if a.ndim == 3 else a
    return out
