"""Nets: ms a move in the joint net's forwards (``inference.policy_value``),
spanned with device syncs."""

HOOKS = ("bokego_tpu_torch.models.inference:policy_value",)


def read(r):
    seg = r.spans
    if not seg.units or not seg.calls[HOOKS[0]]:
        return None
    return 1e3 * seg.span_s[HOOKS[0]] / seg.units
