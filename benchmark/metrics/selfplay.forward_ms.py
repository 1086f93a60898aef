"""Nets: ms a move in the evaluator's forwards (``inference.policy_probs``
and ``inference.value_fn``), spanned with device syncs."""

HOOKS = ("bokego_tpu_torch.models.inference:policy_probs", "bokego_tpu_torch.models.inference:value_fn")


def read(r):
    seg = r.spans
    if not seg.units or not seg.calls[HOOKS[0]]:
        return None
    return 1e3 * sum(seg.span_s[h] for h in HOOKS) / seg.units
