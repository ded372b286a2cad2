"""Device ms a sample of the port's hand-written kernels (names starting
tri_, bvh_, splat_, cluster_), in the traced passes."""


def read(rec):
    t = rec["trace"]
    if not t or not t["own_device_s"]:
        return None
    return t["own_device_s"] * 1e3 / (t["passes"] * rec["spp_per_pass"])
