"""Carry state across from the JAX package, as numpy arrays.

The port never imports jax. A caller that holds JAX objects reads them out
with `scene_leaves` (plain `np.asarray` on each leaf) and hands the numpy
dict to `scene_from_numpy` (the BVH packs come across as they are, so the
port walks the JAX package's own tree; the TPU's cluster tables `cl_*`
are not read); a JAX PRNG key's data (`jax.random.key_data`,
the checkpoint `key` field) becomes a port key with `key_from_numpy`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .scene.compile import (MediumTable, RenderConfig, SceneData,
                            TextureTable, resolve_device)

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


def scene_leaves(scene) -> dict:
    """{dotted name: numpy array} for LEAF_NAMES of a JAX or port scene."""
    out = {}
    for name in LEAF_NAMES:
        x = _resolve(scene, name)
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
