"""Device: the share of the profiled segment in which no kernel, copy or
memset ran."""

HOOKS = ()


def read(r):
    seg = r.profile
    if seg is None or seg.trace is None or seg.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - seg.trace.busy_s / seg.trace.window_s)
