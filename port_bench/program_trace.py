"""The program's own record of a traced run (adapt_tpu_torch/obs.py), for
the readers of its spans and counters.

Under torch.profiler the program records a span at each layer boundary
and its counters; `export(rec)` returns that record with the samples the
traced passes rendered, or None where the program has no such module,
recorded no pass, or recorded another number of passes than the trace
(a tree without the module then gives no line, not a failed run).
"""
from __future__ import annotations

PASS = "render.pass"


def export(rec):
    """obs.export() of a traced run, with "samples": the recorded
    `render.pass` spans x the traffic's samples a pass; or None."""
    t = rec.get("trace")
    if not t:
        return None
    try:
        from adapt_tpu_torch import obs
    except ImportError:
        return None
    out = obs.export()
    passes = sum(1 for s in out["spans"] if s["name"] == PASS)
    if passes == 0 or passes != t["passes"]:
        return None
    out["samples"] = passes * rec["spp_per_pass"]
    return out


def _covered(intervals, lo, hi):
    """ns of [lo, hi] inside the union of (start, end) intervals."""
    total, cur = 0, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur is None or s > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        total += cur[1] - cur[0]
    return total


def self_ns(spans, names):
    """ns in the spans named `names` less what their child spans cover."""
    kids = {}
    for s in spans:
        kids.setdefault(s["parent"], []).append((s["start_ns"], s["end_ns"]))
    return sum(s["end_ns"] - s["start_ns"]
               - _covered(kids.get(s["id"], ()), s["start_ns"], s["end_ns"])
               for s in spans if s["name"] in names)


def outermost_ns(spans, prefixes):
    """ns in the spans whose names start with `prefixes` and that no such
    span encloses."""
    by_id = {s["id"]: s for s in spans}

    def inside(s):
        p = by_id.get(s["parent"])
        while p is not None:
            if p["name"].startswith(prefixes):
                return True
            p = by_id.get(p["parent"])
        return False
    return sum(s["end_ns"] - s["start_ns"] for s in spans
               if s["name"].startswith(prefixes) and not inside(s))
