"""Traffic driver: progressive bidirectional path tracing, one sample a
pixel a pass (`BDPT.render()`). On a transient scene the film compared is
the time-of-flight histogram, (pixels, bins, 3): its flat entries are
(pixel, bin) pairs, pixel x bins + bin, so the harness's sampled "pixels"
are such entries and the reference scene counts them in `w` x `h`.

The driver contract is drivers/pt.py's: `make`, `step`, `film`,
`reference_scene`, `reference`, `ranges`. The program is imported inside
the functions that need it, so the reference side (control.py) loads
nothing of it.
"""
from __future__ import annotations

import torch


def make(scene, cfg, seed, traffic):
    from adapt_tpu_torch.renderer import bdpt
    if traffic["spp_per_pass"] != 1:
        # render_batch(spp) of a steady scene draws from another key chain
        raise NotImplementedError("the bdpt driver renders one sample a pass")
    return bdpt.BDPT(scene, cfg, seed=seed)


def step(r):
    """ProgressiveRenderer.render(): one sample over every pixel."""
    r.render()


def film(r):
    """The transient histogram `time_bins` (pixels, bins, 3) of a
    transient scene, else the color film (w, h, 3)."""
    return r.time_bins if r.is_transient else r.color


def reference_scene(xml, overrides):
    from port_bench.reference import bdpt as ref_bdpt
    return ref_bdpt.load(str(xml), overrides)


def reference(sc, seed, passes, pix, dtype=torch.float32):
    from port_bench.reference import bdpt as ref_bdpt
    return ref_bdpt.film(sc, seed, passes, pix, dtype=dtype)


def ranges():
    """BDPT's layers. "connect" holds `_mis_weight` and the shadow rays'
    B2 calls; "transient bin" is left out where the program has no
    module-level binning function to wrap."""
    from adapt_tpu_torch import rng
    from adapt_tpu_torch.ops import intersect_kernels
    from adapt_tpu_torch.renderer import bdpt
    out = [(bdpt, "generate_eye_path", "eye walk"),
           (bdpt, "generate_light_path", "light walk"),
           (rng, "uniform", "rng.uniform"),
           (bdpt, "connect_strategy", "connect"),
           (intersect_kernels, "tri_closest_hit", "B1 wrapper"),
           (intersect_kernels, "tri_any_hit", "B2 wrapper"),
           (intersect_kernels, "tri_track_hits", "B3 wrapper"),
           (bdpt, "splat_sorted_accumulate", "B4 wrapper")]
    if hasattr(bdpt, "bin_transient"):
        out.append((bdpt, "bin_transient", "transient bin"))
    return tuple(out)
