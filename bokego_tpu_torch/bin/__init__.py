"""Training entry points of the port, with the flags of the JAX package's
``bin/*.py`` scripts plus ``--device`` (default ``cuda``; they raise without
a GPU unless ``--device cpu`` is given):

    python -m bokego_tpu_torch.bin.train            # SL of the policy or value net
    python -m bokego_tpu_torch.bin.process_data     # csv -> npz features or packed shards
    python -m bokego_tpu_torch.bin.gen_policy_data  # self-play -> policy SL data
    python -m bokego_tpu_torch.bin.genvals          # value-net data
    python -m bokego_tpu_torch.bin.selfplay         # REINFORCE against the pool
    python -m bokego_tpu_torch.bin.alphazero        # the AlphaZero loop

Checkpoints are torch ``.pt`` files in the reference layout
(``train/checkpoints.py``).
"""

import argparse

import torch


def add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda", help="torch device (default: cuda; 'cpu' to run on the CPU)")


def device_from(args) -> torch.device:
    """The device the flags ask for (raising for ``cuda`` without a GPU),
    with TF32 off so the nets compute in full fp32."""
    from bokego_tpu_torch.device import fp32_only, resolve_device

    dev = resolve_device(args.device)
    fp32_only()
    return dev
