"""Operations of the nets' forward, and the H100's peaks.

FLOPs follow the valid-tap convention of XLA's ``cost_analysis`` (the
program's ``mfu_report.net_flops``, copied here): a convolution counts only
the taps of its "same"-padded input that land on the board, so a 3x3 layer
on 9x9 does 2 * 625 * C_in * C_out FLOPs a position and the 5x5 stem
2 * 1521 * 27 * C.  A dense layer counts 2 * in * out.
"""

from __future__ import annotations

BOARD = 9
# NVIDIA H100 SXM data sheet, dense rates at the 700 W power limit.
PEAK_FP32_FLOPS = 67e12  # float32 outside the tensor cores


def taps(k: int, pad: int, size: int = BOARD) -> int:
    """(output, tap) pairs along one axis of a stride-1 convolution whose
    input index lands on the board."""
    out = size + 2 * pad - k + 1
    return sum(1 for o in range(out) for t in range(k) if 0 <= o - pad + t < size)


def _conv_macs(c_in: int, c_out: int, k: int) -> int:
    return taps(k, k // 2) ** 2 * c_in * c_out


def trunk_macs(nets: dict) -> int:
    """MACs a position of the trunk and the 1x1 head of one net."""
    c, planes = nets["channels"], nets["planes"]
    macs = _conv_macs(planes, c, nets["stem_kernel"])
    macs += nets["trunk_layers"] * _conv_macs(c, c, nets["trunk_kernel"])
    return macs + BOARD * BOARD * c  # the 1x1 head to one plane


def forward_flops(nets: dict, convs_only: bool = False) -> int:
    """FLOPs a position of one policy and one value forward."""
    macs = 2 * trunk_macs(nets)
    if not convs_only:
        macs += BOARD * BOARD * nets["value_hidden"] + nets["value_hidden"]
    return 2 * macs
