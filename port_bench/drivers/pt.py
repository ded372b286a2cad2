"""Traffic driver: progressive path tracing, one sample a pixel a pass.

A traffic file names its driver (`"driver": "pt"` finds this file); the
harness and the trace call only what a driver exposes:

- `make(scene, cfg, seed, traffic)`: the renderer the window drives;
- `step(r)`: one pass, the call the window times;
- `film(r)`: the accumulated film, (w, h, 3);
- `reference_scene(xml, overrides)`: the reference's own reading of the
  scene, with `w` and `h`;
- `reference(sc, seed, passes, pix, dtype)`: the reference's film of the
  flat pixel ids `pix` after `passes` passes, (S, 3) float32;
- `ranges()`: [(module, attribute, range name)] the traced passes wrap.

The program is imported inside the functions that need it, so the
reference side (control.py) loads nothing of it.
"""
from __future__ import annotations

import torch


def make(scene, cfg, seed, traffic):
    from adapt_tpu_torch.renderer import pt
    if traffic["spp_per_pass"] != 1:
        # render_batch(spp) draws its samples from another key chain
        raise NotImplementedError("the pt driver renders one sample a pass")
    return pt.Renderer(scene, cfg, seed=seed)


def step(r):
    """ProgressiveRenderer.render(): one sample over every pixel."""
    r.render()


def film(r):
    return r.color


def reference_scene(xml, overrides):
    from port_bench.reference import scene as ref_scene
    return ref_scene.load(str(xml), overrides)


def reference(sc, seed, passes, pix, dtype=torch.float32):
    from port_bench.reference import pt as ref_pt
    return ref_pt.film(sc, seed, passes, pix, dtype=dtype)


def ranges():
    """PT's layers (frozen from adapt_tpu_torch/profile_pt.py); ranges may
    nest (the bounce loop holds every other)."""
    from adapt_tpu_torch import rng
    from adapt_tpu_torch.ops import bxdf_ops, intersect_kernels
    from adapt_tpu_torch.renderer import compact, pt
    return ((rng, "lane_uniform", "rng.lane_uniform"),
            (pt, "camera_rays", "camera_rays"),
            (pt, "ray_intersect", "ray_intersect"),
            (pt, "does_intersect", "does_intersect"),
            (pt, "get_uv_item", "texture fetch"),
            (bxdf_ops, "surface_sample", "surface_sample"),
            (bxdf_ops, "surface_eval", "surface_eval"),
            (bxdf_ops, "surface_pdf", "surface_pdf"),
            (compact, "run_compacted", "bounce loop"),
            (intersect_kernels, "tri_closest_hit", "B1 wrapper"),
            (intersect_kernels, "tri_any_hit", "B2 wrapper"))
