"""Percent of a pass's wall time in which no kernel ran: one less the
union of the kernel intervals of a traced pass (the mean over the traced
passes) over the mean pass of the untraced window that follows them. The
traced passes' own wall time carries the profiler's host cost (about
twice an untraced pass on cbox), so it is not the base."""


def read(rec):
    t = rec["trace"]
    if not t:
        return None
    pass_s = rec["window_s"] / len(rec["pass_s"])
    return 100.0 * (1.0 - t["busy_s"] / t["passes"] / pass_s)
