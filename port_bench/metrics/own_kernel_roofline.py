"""Percent: the byte bounds of the hand-written kernels' launches in the
traced passes (bounds.py: each input and output once at 3.35 TB/s) over
their device time. None where a launch could not be matched to its
kernel or has no bound."""


def read(rec):
    t = rec["trace"]
    if not t or not t["own_bound_ms"] or not t["own_matched_ms"]:
        return None
    return 100.0 * t["own_bound_ms"] / t["own_matched_ms"]
