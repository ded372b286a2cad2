"""Device operations (kernels, copies, fills) the profiler saw a sample
in the traced passes."""


def read(rec):
    t = rec["trace"]
    if not t:
        return None
    return t["launches"] / (t["passes"] * rec["spp_per_pass"])
