"""Seconds in the program's outermost set-up spans
(adapt_tpu_torch/obs.py, recorded always): `setup.lib` (a library's
build or load, ops/_build.py), `setup.scene` (parse, tables, BVH build,
cluster cut) and `setup.probe` (PT's auto-compaction probe). `setup_s`
less this is imports, the CUDA context, the renderer and the warm-up
pass. Reported in traced runs."""
from port_bench import program_trace


def read(rec):
    ex = program_trace.export(rec)
    if ex is None:
        return None
    return program_trace.outermost_ns(ex["spans"], ("setup.",)) / 1e9
