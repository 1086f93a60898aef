"""Kernels: the convolutions' share of the bf16 tensor-core peak in the
profiled segment: the valid-tap FLOPs of every convolution of the net (stem,
residual blocks and the heads' 1x1 convolutions) for the rows counted at
``inference.policy_value``, over the device time of the kernels that the
convolution operators launched (the trace ties each kernel to its innermost
host operator).  That is cuDNN's GEMM alone: the folded bias's add, the
ReLUs and the residual adds are operators of their own and are not counted.
The FLOPs are those of ``flops_agz.CONFIG``'s net, whatever the cell."""

from benchmark.harness import flops_agz

HOOKS = ("bokego_tpu_torch.models.inference:policy_value",)


def read(r):
    seg = r.profile
    if seg is None or seg.trace is None:
        return None
    conv_s = seg.trace.ops_matching("conv")
    rows = seg.rows[HOOKS[0]]
    if conv_s <= 0 or rows <= 0:
        return None
    return 100.0 * rows * flops_agz.conv_flops(flops_agz.config_nets()) / conv_s / flops_agz.PEAK_BF16_FLOPS
