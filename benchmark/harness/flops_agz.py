"""Operations of AlphaGo Zero's dual residual network a position, and the
H100's bf16 tensor-core peak.

FLOPs follow the valid-tap convention of ``flops.py``: a convolution counts
only the taps of its "same"-padded input that land on the board, so a 3x3
layer on 9x9 does 2 * 625 * C_in * C_out FLOPs a position, and a 1x1 layer
2 * 81 * C_in * C_out; a dense layer counts 2 * in * out.  At the published
sizes (``nets`` of ``configs/selfplay-agz40-b1024.json``) the convolutions
are 6,398,524,416 FLOPs a position and the whole forward 6,398,592,968.
"""

from __future__ import annotations

import json

from benchmark.harness.cell import BENCH_DIR
from benchmark.harness.flops import taps

CONFIG = "selfplay-agz40-b1024"
# NVIDIA H100 SXM data sheet: dense bf16 on the tensor cores at the 700 W power limit.
PEAK_BF16_FLOPS = 989e12


def config_nets(name: str = CONFIG) -> dict:
    """The ``nets`` of configuration ``name``."""
    return json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text())["nets"]


def conv_flops(nets: dict) -> int:
    """FLOPs a position of every convolution: the stem, the residual
    blocks' two each, and the heads' 1x1 convolutions."""
    board, c = nets["board"], nets["channels"]
    k_stem, k = nets["stem_kernel"], nets["trunk_kernel"]
    macs = taps(k_stem, k_stem // 2, board) ** 2 * nets["planes"] * c
    macs += 2 * nets["residual_blocks"] * taps(k, k // 2, board) ** 2 * c * c
    macs += board * board * c * (nets["policy_filters"] + nets["value_filters"])
    return 2 * macs


def forward_flops(nets: dict) -> int:
    """FLOPs a position of the whole forward: the convolutions and the
    heads' dense layers."""
    area = nets["board"] ** 2
    dense = nets["policy_filters"] * area * nets["policy_outputs"]
    dense += nets["value_filters"] * area * nets["value_hidden"] + nets["value_hidden"]
    return conv_flops(nets) + 2 * dense
