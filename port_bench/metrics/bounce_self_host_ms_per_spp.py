"""Host ms a sample of the walks' own glue, from the program's spans
(adapt_tpu_torch/obs.py): time in `pt.bounce` (renderer/pt.py
`trace_pt`'s bounces), `vpt.iter`, `bdpt.eye_walk` and `bdpt.light_walk`
less what their child spans cover (draws, intersection, kernels,
shading, lights), in the traced passes: Russian roulette, MIS arithmetic,
the selects and the state. The profiler's cost of opening the walk's own
range is in it; its children's is not."""
from port_bench import program_trace

WALKS = ("pt.bounce", "vpt.iter", "bdpt.eye_walk", "bdpt.light_walk")


def read(rec):
    ex = program_trace.export(rec)
    if ex is None:
        return None
    return program_trace.self_ns(ex["spans"], WALKS) / 1e6 / ex["samples"]
