"""Whole step: the valid-tap FLOPs of every policy and value forward of the
measured window (rows counted at ``inference.policy_probs`` without a sync)
over the window's seconds and the fp32 peak."""

HOOKS = ("bokego_tpu_torch.models.inference:policy_probs",)


def read(r):
    seg = r.window
    rows = seg.rows[HOOKS[0]]
    if seg.seconds <= 0 or rows <= 0:
        return None
    return 100.0 * rows * r.flops_per_row / seg.seconds / r.peak_fp32
