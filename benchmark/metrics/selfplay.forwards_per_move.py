"""Eval phase: the policy forwards a move ran in the measured window (the
roots' forward of ``init_trees`` and one per eval phase with work), counted
at ``inference.policy_probs`` without a sync."""

HOOKS = ("bokego_tpu_torch.models.inference:policy_probs",)


def read(r):
    seg = r.window
    if not seg.units or not seg.calls[HOOKS[0]]:
        return None
    return seg.calls[HOOKS[0]] / seg.units
