"""Kernels: device ms a move of K1 (``descend_backprop``) in the profiled
segment."""

HOOKS = ()


def read(r):
    seg = r.profile
    if seg is None or seg.trace is None or not seg.units:
        return None
    k1 = seg.trace.kernels_matching("descend_backprop")
    return 1e3 * k1 / seg.units if k1 > 0 else None
