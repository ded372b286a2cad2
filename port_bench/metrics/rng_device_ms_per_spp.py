"""Device ms a sample of the kernels launched inside the randomness
ranges (rng.py `lane_uniform`, PT's; `uniform`, named "rng.uniform" where a
driver wraps it), in the traced passes."""

RANGES = ("rng.lane_uniform", "rng.uniform")


def read(rec):
    t = rec["trace"]
    rows = [t["layer"][n] for n in RANGES if t and n in t["layer"]]
    if not rows:
        return None
    return sum(r["device_ms"] for r in rows) \
        / (t["passes"] * rec["spp_per_pass"])
