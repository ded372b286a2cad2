"""Host ms a sample inside the walks' ranges: PT's bounce loop
(renderer/compact.py `run_compacted`, which runs renderer/pt.py
`trace_pt`'s bounces) and, where a driver wraps them, BDPT's "eye walk"
and "light walk" (renderer/bdpt.py `generate_eye_path`,
`generate_light_path`), in the traced passes. The ranges do not nest in
one another."""

RANGES = ("bounce loop", "eye walk", "light walk")


def read(rec):
    t = rec["trace"]
    rows = [t["layer"][n] for n in RANGES if t and n in t["layer"]]
    if not rows:
        return None
    return sum(r["host_ms"] for r in rows) \
        / (t["passes"] * rec["spp_per_pass"])
