"""Percent of the lanes issued that were live, from the program's
counters (adapt_tpu_torch/obs.py): 100 x `lanes.live` (each bounce's
live lanes, summed on the device) over `lanes.issued` (each bounce's
wavefront width, on the host), in the traced passes. Below 100 the
draws, intersections and shading of the dead lanes are wasted work."""
from port_bench import program_trace


def read(rec):
    ex = program_trace.export(rec)
    if ex is None or not ex["counters"]["lanes.issued"]:
        return None
    c = ex["counters"]
    return 100.0 * c["lanes.live"] / c["lanes.issued"]
