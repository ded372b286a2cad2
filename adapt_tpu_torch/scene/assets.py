"""The grid volumes of `scenes/cbox/cbox-volgrid.xml` and `cbox-rgbvol.xml`,
and a loader that refuses to render a volume scene without its volume.

The scenes' `.vol` files are not tracked. `scripts/gen_procedural.py`
`ensure_vol` makes them, but writes through the JAX package's writer;
`vol_assets` evaluates the same grid formula (`vol_grid`) and writes the
same bytes through the port's (`native.write_vol`). Either loader only
warns about a missing `.vol` file and renders without the volume;
`load_volume` fails instead.

    python -m adapt_tpu_torch.scene.assets     # write the missing grids
"""
from __future__ import annotations

import os
import warnings

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the grid volumes, as scripts/gen_procedural.py `ensure_all` names them:
# file, grid kind
VOLUMES = (("janga-smoke-264-136-136.vol", "plume"),
           ("embergen_dust_devil_tornado_a_50-256-256-256.vol", "tornado"))


def vol_grid(kind, n=96):
    """scripts/gen_procedural.py `ensure_vol`'s density grid ((n, n, n)
    float32; "plume" or "tornado")."""
    z, y, x = np.mgrid[0:n, 0:n, 0:n].astype(np.float32) / (n - 1)
    swirl = np.sin(7.0 * y + 11.0 * (x + z)) * 0.04
    if kind == "tornado":
        # swirling funnel: radius grows with height around a wavy axis
        cx = 0.5 + 0.08 * np.sin(6.0 * y) + swirl
        cz = 0.5 + 0.08 * np.cos(6.0 * y) + swirl
        r = np.sqrt((x - cx) ** 2 + (z - cz) ** 2)
        funnel = 0.06 + 0.25 * y
        d = np.exp(-((r / funnel) ** 2) * 4.0) * (0.3 + 0.7 * y)
    else:
        # buoyant plume: dense core rising and spreading
        cx = 0.5 + 0.1 * np.sin(4.0 * y) + swirl
        cz = 0.5 + 0.1 * np.cos(5.0 * y) + swirl
        r = np.sqrt((x - cx) ** 2 + (z - cz) ** 2)
        width = 0.12 + 0.18 * y * y
        d = np.exp(-((r / width) ** 2) * 3.0) * np.exp(-2.5 * y)
    d *= (0.75 + 0.25 * np.sin(13.0 * x) * np.sin(17.0 * z)
          * np.sin(9.0 * y))
    return d.astype(np.float32)


def vol_assets(directory=None):
    """Write the two scenes' `.vol` grids (`vol_grid`) into `directory`
    (the repository's scenes/volume/ by default), each only if it is
    missing; returns their paths."""
    from ..native import write_vol
    directory = directory or os.path.join(_ROOT, "scenes", "volume")
    os.makedirs(directory, exist_ok=True)
    paths = []
    for name, kind in VOLUMES:
        path = os.path.join(directory, name)
        if not os.path.exists(path):
            tmp = f"{path}.{os.getpid()}.tmp"
            write_vol(tmp, vol_grid(kind))
            os.replace(tmp, path)
        paths.append(path)
    return paths


def load_volume(directory, file, device="cuda"):
    """Load a scene with a grid volume; raises RuntimeError unless the
    volume loaded. Returns (scene, cfg, configs)."""
    from .compile import load_scene
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message="volume file")
        try:
            scene, cfg, configs = load_scene(directory, file, device=device)
        except UserWarning as w:
            raise RuntimeError(f"{file}: {w}") from None
    if cfg.volume_kind <= 0:
        raise RuntimeError(f"{file}: no grid volume")
    return scene, cfg, configs


if __name__ == "__main__":
    for p in vol_assets():
        print(p)
