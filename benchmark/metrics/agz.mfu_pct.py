"""Whole step: the valid-tap FLOPs of every forward of the joint net in the
measured window (rows counted at ``inference.policy_value`` without a sync)
over the window's seconds and the bf16 tensor-core peak."""

from benchmark.harness import flops_agz

HOOKS = ("bokego_tpu_torch.models.inference:policy_value",)


def read(r):
    seg = r.window
    rows = seg.rows[HOOKS[0]]
    if seg.seconds <= 0 or rows <= 0:
        return None
    return 100.0 * rows * flops_agz.forward_flops(flops_agz.config_nets()) / seg.seconds / flops_agz.PEAK_BF16_FLOPS
