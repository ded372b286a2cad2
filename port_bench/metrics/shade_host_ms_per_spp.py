"""Host ms a sample in shading, from the program's spans
(adapt_tpu_torch/obs.py): the outermost `shade.*` spans (ops/bxdf_ops.py
`surface_sample`, `surface_eval`, `surface_pdf`; ops/texture_ops.py
`get_uv_item`) and `light.*` spans (ops/emitter_ops.py
`sample_light_index`, `sample_hit`), in the traced passes: the dispatch
over materials and lights, issued from the host."""
from port_bench import program_trace

PREFIXES = ("shade.", "light.")


def read(rec):
    ex = program_trace.export(rec)
    if ex is None:
        return None
    return program_trace.outermost_ns(ex["spans"], PREFIXES) / 1e6 \
        / ex["samples"]
