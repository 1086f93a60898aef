"""Policy and value convnets as ``nn.Module``s (counterpart of
``bokego_tpu/models/nets.py``).

The modules use the reference torch key layout (``conv.0 … conv.21``,
``bn``, ``lin_bn``, ``lin1``, ``lin2``) so the repo's reference-format
checkpoints (``data/weights/value_r2.pt``) load with ``load_state_dict`` and
no conversion.  ``conv`` is a Sequential of seven (conv, BatchNorm, ReLU)
triples at indices 0..20 and the untied-bias 1x1 head at 21.

Inputs are NHWC ``(B, 9, 9, 27)`` like the JAX nets; the modules permute to
NCHW inside.  Convolutions go to ``torch.nn.functional.conv2d`` (the JAX
package leaves them to XLA, outside any Pallas kernel).
"""

from __future__ import annotations

import torch
from torch import nn

from bokego_tpu_torch.coords import NN
from bokego_tpu_torch.device import resolve_device


class UntiedBiasConv(nn.Module):
    """Conv with a shared kernel and a per-position bias ``(out, 9, 9)``."""

    def __init__(self, in_channels: int, out_channels: int = 1, size: int = 9):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 1, 1))
        self.bias = nn.Parameter(torch.zeros(out_channels, size, size))
        nn.init.kaiming_uniform_(self.weight, a=5**0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn.functional.conv2d(x, self.weight) + self.bias


def _trunk(channels: int) -> nn.Sequential:
    """5x5 conv then six 3x3 convs, each with BN+ReLU; untied 1x1 head."""
    layers: list[nn.Module] = []
    in_ch = 27
    for k in [5] + [3] * 6:
        layers += [
            nn.Conv2d(in_ch, channels, k, padding=k // 2),
            nn.BatchNorm2d(channels, eps=1e-5, momentum=0.1),
            nn.ReLU(),
        ]
        in_ch = channels
    layers.append(UntiedBiasConv(channels, 1))
    return nn.Sequential(*layers)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class PolicyNet(nn.Module):
    """(B, 9, 9, 27) -> (B, 81) move logits."""

    def __init__(self, channels: int = 128):
        super().__init__()
        self.conv = _trunk(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(_nchw(x)).reshape(x.shape[0], NN)


class ValueNet(nn.Module):
    """(B, 9, 9, 27) -> (B, 1) value in (-1, 1) for the side to move."""

    def __init__(self, channels: int = 128):
        super().__init__()
        self.conv = _trunk(channels)
        self.bn = nn.BatchNorm2d(1, eps=1e-5, momentum=0.1)
        self.lin1 = nn.Linear(NN, 64)
        self.lin_bn = nn.BatchNorm1d(64, eps=1e-5, momentum=0.1)
        self.lin2 = nn.Linear(64, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn(self.conv(_nchw(x))))
        x = torch.relu(self.lin_bn(self.lin1(x.reshape(x.shape[0], NN))))
        return torch.tanh(self.lin2(x))


def init_policy(channels: int = 128, seed: int = 0, device=None) -> PolicyNet:
    """A seeded random-init PolicyNet in eval mode on ``device``."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = PolicyNet(channels)
    return net.to(dev).eval()


def init_value(channels: int = 128, seed: int = 1, device=None) -> ValueNet:
    """A seeded random-init ValueNet in eval mode on ``device``."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = ValueNet(channels)
    return net.to(dev).eval()


def load_value(path: str, device=None) -> ValueNet:
    """A reference-format value checkpoint (``{"model_state_dict": …}``)."""
    dev = resolve_device(device)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model_state_dict", ckpt)
    channels = sd["conv.0.weight"].shape[0]
    net = ValueNet(channels)
    net.load_state_dict(sd)
    return net.to(dev).eval()
