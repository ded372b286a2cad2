"""Host ms a sample in the transient film's binning, from the program's
spans (adapt_tpu_torch/obs.py): the outermost `bdpt.bin` spans
(renderer/bdpt.py `bin_transient`: the bin of each lane, the keep mask,
the read of its count that `nonzero` waits for, two accumulating
index_put_), in the traced passes. None where the program records no such
span."""
from port_bench import program_trace

SPAN = "bdpt.bin"


def read(rec):
    ex = program_trace.export(rec)
    if ex is None or not any(s["name"] == SPAN for s in ex["spans"]):
        return None
    return program_trace.outermost_ns(ex["spans"], (SPAN,)) / 1e6 \
        / ex["samples"]
