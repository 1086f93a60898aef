"""Batched inference over the nets (counterpart of
``bokego_tpu/models/inference.py``): every function takes ``(B, 9, 9, 27)``
NHWC feature stacks and runs without autograd.  ``dtype=torch.bfloat16``
takes the nets' bf16 route (``models/nets.py``) and returns float32.
:func:`policy_value` runs the joint net of ``models/resnet.py``, which has
no counterpart in the JAX package."""

from __future__ import annotations

import torch

from bokego_tpu_torch.coords import NN
from bokego_tpu_torch.features import features_batch
from bokego_tpu_torch.models.nets import PolicyNet, PolicyNetV2, ValueNet
from bokego_tpu_torch.models.resnet import ResNetPV
from bokego_tpu_torch.utils import metrics


def _forward(net, fts: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
    """``net(fts)``; with a ``dtype``, the nets' route in that dtype (any
    module with a one-argument forward serves the float32 default)."""
    return net(fts) if dtype is None else net(fts, dtype)


@torch.inference_mode()
def policy_logits(net: PolicyNet, fts: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """(B, 9, 9, 27) -> (B, 81) logits (eval mode, running BatchNorm statistics)."""
    return _forward(net, fts, dtype)


@torch.inference_mode()
def policy_probs(net: PolicyNet, fts: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """(B, 9, 9, 27) -> (B, 81) softmax over the points."""
    with metrics.span("nets.policy"):
        return torch.softmax(_forward(net, fts, dtype), dim=-1)


@torch.inference_mode()
def policy_logits_v2(net: PolicyNetV2, fts: torch.Tensor) -> torch.Tensor:
    """(B, 9, 9, 27) -> (B, 81) logits of the legacy v0.2 policy."""
    return net(fts)


@torch.inference_mode()
def value_fn(net: ValueNet, fts: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """(B, 9, 9, 27) -> (B,) value in (-1, 1) for the side to move."""
    with metrics.span("nets.value"):
        return _forward(net, fts, dtype)[..., 0]


@torch.inference_mode()
def policy_value(net: ResNetPV, fts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, 9, 9, 27) -> (probs (B, 81), values (B,)) of a joint
    policy-value net in one forward, both float32.  ``probs`` is the softmax
    over the 81 board logits, the 82-way softmax renormalised without pass:
    the search gives pass no prior."""
    with metrics.span("nets.pv"):
        metrics.count("nets.pv_rows", fts.shape[0])
        logits, values = net(fts)
        return torch.softmax(logits[:, :NN], dim=-1), values


def policy_value_states(policy: PolicyNet, value: ValueNet, states) -> tuple[torch.Tensor, torch.Tensor]:
    """A batch of GoStates -> (probs (B, 81), values (B,)), the features
    computed on the states' device."""
    fts = features_batch(states)
    return policy_probs(policy, fts), value_fn(value, fts)


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
