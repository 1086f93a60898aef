"""Kernels: the convolutions' share of the fp32 peak in the profiled
segment: the valid-tap FLOPs of the convolutions of every policy and value
forward that ran (rows counted at ``inference.policy_probs``) over the
device time of the kernels that the convolution operators launched."""

HOOKS = ("bokego_tpu_torch.models.inference:policy_probs",)


def read(r):
    seg = r.profile
    if seg is None or seg.trace is None:
        return None
    conv_s = seg.trace.ops_matching("conv")
    rows = seg.rows[HOOKS[0]]
    if conv_s <= 0 or rows <= 0:
        return None
    return 100.0 * rows * r.conv_flops_per_row / conv_s / r.peak_fp32
