"""Seconds from the start of run.py to the first timed pass: imports,
CUDA context, builds or cached libraries, scene load, the renderer, the
warm-up pass (and, in a traced run, nothing of the trace)."""


def read(rec):
    return rec["setup_s"]
