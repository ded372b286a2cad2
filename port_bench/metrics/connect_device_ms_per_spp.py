"""Device ms a sample of the kernels launched inside BDPT's connections
(the driver's "connect" range around renderer/bdpt.py `connect_strategy`:
every strategy's arithmetic, `_mis_weight` and the shadow rays' any hits),
in the traced passes."""


def read(rec):
    t = rec["trace"]
    if not t or "connect" not in t["layer"]:
        return None
    return t["layer"]["connect"]["device_ms"] \
        / (t["passes"] * rec["spp_per_pass"])
