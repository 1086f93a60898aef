"""Batched inference over the nets (counterpart of
``bokego_tpu/models/inference.py``): every function takes ``(B, 9, 9, 27)``
NHWC feature stacks and runs without autograd."""

from __future__ import annotations

import torch

from bokego_tpu_torch.models.nets import PolicyNet, PolicyNetV2, ValueNet


@torch.inference_mode()
def policy_probs(net: PolicyNet, fts: torch.Tensor) -> torch.Tensor:
    """(B, 9, 9, 27) -> (B, 81) softmax over the points."""
    return torch.softmax(net(fts), dim=-1)


@torch.inference_mode()
def policy_logits_v2(net: PolicyNetV2, fts: torch.Tensor) -> torch.Tensor:
    """(B, 9, 9, 27) -> (B, 81) logits of the legacy v0.2 policy."""
    return net(fts)


@torch.inference_mode()
def value_fn(net: ValueNet, fts: torch.Tensor) -> torch.Tensor:
    """(B, 9, 9, 27) -> (B,) value in (-1, 1) for the side to move."""
    return net(fts)[..., 0]


def sample_moves(gen: torch.Generator, probs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """One move per row sampled from ``probs (B, 81)`` restricted to ``mask``
    and renormalised; uniform over the mask where no mass is left; 81 (PASS)
    where the mask is empty.  ``gen`` lives on the tensors' device."""
    n = probs.shape[-1]
    mask = mask[..., :n]
    p = torch.where(mask, probs, 0.0)
    p = torch.where(p.sum(-1, keepdim=True) > 0, p, mask.to(probs.dtype))
    any_legal = mask.any(-1)
    # multinomial needs some mass in every row; empty rows are overridden
    p = torch.where(any_legal[..., None], p, 1.0)
    mv = torch.multinomial(p, 1, generator=gen)[..., 0]
    return torch.where(any_legal, mv, n)
