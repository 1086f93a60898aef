"""Batched inference over the nets (counterpart of
``bokego_tpu/models/inference.py``): every function takes ``(B, 9, 9, 27)``
NHWC feature stacks and runs without autograd."""

from __future__ import annotations

import torch

from bokego_tpu_torch.models.nets import PolicyNet, ValueNet


@torch.inference_mode()
def policy_probs(net: PolicyNet, fts: torch.Tensor) -> torch.Tensor:
    """(B, 9, 9, 27) -> (B, 81) softmax over the points."""
    return torch.softmax(net(fts), dim=-1)


@torch.inference_mode()
def value_fn(net: ValueNet, fts: torch.Tensor) -> torch.Tensor:
    """(B, 9, 9, 27) -> (B,) value in (-1, 1) for the side to move."""
    return net(fts)[..., 0]
