"""Generated stand-ins for meshes and textures upstream AdaPT does not
ship, written into the checkout (git-ignored) when missing. Frozen copies
of scripts/gen_procedural.py `torus_knot`, `write_obj` and
`ensure_texture`: a configuration names a maker and its arguments, so a
change there cannot change the benchmark's scene.
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np


def torus_knot(n_u, n_v, p=2, q=3, R=1.0, r=0.35, tube=0.18):
    """Closed tube around a (p,q) torus knot; returns (verts, faces),
    windings facing outward."""
    u = np.linspace(0.0, 2.0 * np.pi, n_u, endpoint=False)
    cu = (R + r * np.cos(q * u))
    c = np.stack([cu * np.cos(p * u), cu * np.sin(p * u),
                  -r * np.sin(q * u)], axis=1)
    t = np.roll(c, -1, axis=0) - np.roll(c, 1, axis=0)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    n = np.cross(t, np.array([0.0, 0.0, 1.0]))
    bad = np.linalg.norm(n, axis=1) < 1e-6
    n[bad] = np.cross(t[bad], np.array([1.0, 0.0, 0.0]))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    b = np.cross(t, n)
    v = np.linspace(0.0, 2.0 * np.pi, n_v, endpoint=False)
    cv, sv = np.cos(v), np.sin(v)
    verts = (c[:, None, :] + tube * (cv[None, :, None] * n[:, None, :]
                                     + sv[None, :, None] * b[:, None, :]))
    verts = verts.reshape(-1, 3)
    idx = np.arange(n_u * n_v).reshape(n_u, n_v)
    i10 = np.roll(idx, -1, axis=0)
    i01 = np.roll(idx, -1, axis=1)
    i11 = np.roll(np.roll(idx, -1, axis=0), -1, axis=1)
    faces = np.concatenate([np.stack([idx, i10, i11], -1).reshape(-1, 3),
                            np.stack([idx, i11, i01], -1).reshape(-1, 3)])
    centers = np.repeat(c, n_v, axis=0)
    fv = verts[faces]
    fn = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
    flip = np.einsum("fd,fd->f", fn, fv.mean(1) - centers[faces[:, 0]]) < 0
    faces[flip] = faces[flip][:, [0, 2, 1]]
    return verts, faces


def write_obj(path, verts, faces):
    """Write through a temporary name, so a reader never sees half."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    with open(tmp, "w") as fh:
        fh.write("# procedural torus-knot stand-in mesh\n")
        np.savetxt(fh, verts, fmt="v %.6f %.6f %.6f")
        np.savetxt(fh, faces + 1, fmt="f %d %d %d")
    os.replace(tmp, path)


def marble_jpeg(path, size=256):
    """A deterministic marble-like RGB image, written as a JPEG (frozen
    copy of scripts/gen_procedural.py `ensure_texture`)."""
    from PIL import Image
    y, x = np.mgrid[0:size, 0:size] / size
    v = 0.5 + 0.5 * np.sin(8 * np.pi * x + 4 * np.sin(2 * np.pi * y))
    img = np.stack([0.4 + 0.5 * v, 0.5 + 0.3 * v, 0.8 - 0.3 * v], -1)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{os.getpid()}.{path.name}")
    Image.fromarray((img * 255).astype(np.uint8)).save(tmp)
    os.replace(tmp, path)


def _knot_obj(path, offset=(0.0, 0.0, 0.0), **args):
    """A torus knot moved by `offset` (gen_procedural's knots all sit at
    the origin)."""
    verts, faces = torus_knot(**args)
    write_obj(path, verts + np.asarray(offset, dtype=np.float64), faces)


MAKERS = {"torus_knot": _knot_obj, "marble_jpeg": marble_jpeg}


def ensure(root, assets):
    """Make each {"maker", "path", "args"} of a configuration that is
    missing under root."""
    for a in assets:
        path = Path(root) / a["path"]
        if not path.exists():
            MAKERS[a["maker"]](path, **a["args"])
