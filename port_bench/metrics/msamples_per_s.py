"""Pixel samples completed in the window (pixels x samples a pass x
passes) over the window's seconds, in millions."""


def read(rec):
    n = rec["n_pixels"] * rec["spp_per_pass"] * len(rec["pass_s"])
    return n / rec["window_s"] / 1e6
