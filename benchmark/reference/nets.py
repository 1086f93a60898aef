"""BokeGo v0.3's policy and value nets as a plain float32 forward on the CPU.

Published architecture (``bokego/nnet.py`` of BokeGo v0.3): the 27-plane
input, a 5x5 stem convolution and six 3x3 convolutions at ``channels``,
each followed by BatchNorm (inference statistics, eps 1e-5) and ReLU, then
a 1x1 convolution to one plane plus a bias per point (the untied-bias
head).  The policy is the softmax of that plane over the 81 points.  The
value net runs the same trunk and head, then BatchNorm and ReLU, a dense
layer 81 -> 64, BatchNorm and ReLU, a dense layer 64 -> 1 and tanh.

The weights are read from the reference-format ``.pt`` state dicts
(``conv.0 ... conv.21``, ``bn``, ``lin1``, ``lin_bn``, ``lin2``) by this
module's own loader.  Every operation is a plain torch call in float32;
TF32 is switched off, though it has no effect on the CPU.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

EPS = 1e-5
STEM_KERNEL, TRUNK_KERNEL, TRUNK_LAYERS = 5, 3, 6


def load(path: str) -> dict[str, torch.Tensor]:
    """The float tensors of a reference-format checkpoint, as float32 on the CPU."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = sd.get("model_state_dict", sd)
    return {k: v.float() for k, v in sd.items() if v.is_floating_point()}


def _bn(x: torch.Tensor, sd: dict, name: str) -> torch.Tensor:
    shape = (1, -1) + (1,) * (x.dim() - 2)
    mean, var = sd[f"{name}.running_mean"].view(shape), sd[f"{name}.running_var"].view(shape)
    w, b = sd[f"{name}.weight"].view(shape), sd[f"{name}.bias"].view(shape)
    return (x - mean) / torch.sqrt(var + EPS) * w + b


def _head(sd: dict, x: torch.Tensor) -> torch.Tensor:
    """Trunk and untied-bias head: ``(B, 27, 9, 9)`` -> ``(B, 1, 9, 9)``."""
    kernels = [STEM_KERNEL] + [TRUNK_KERNEL] * TRUNK_LAYERS
    for i, k in enumerate(kernels):
        x = F.conv2d(x, sd[f"conv.{3 * i}.weight"], sd[f"conv.{3 * i}.bias"], padding=k // 2)
        x = torch.relu(_bn(x, sd, f"conv.{3 * i + 1}"))
    last = 3 * len(kernels)
    return F.conv2d(x, sd[f"conv.{last}.weight"]) + sd[f"conv.{last}.bias"]


@torch.no_grad()
def policy_probs(sd: dict, planes: torch.Tensor) -> torch.Tensor:
    """``(B, 27, 9, 9)`` planes -> ``(B, 81)`` move probabilities."""
    return torch.softmax(_head(sd, planes).reshape(planes.shape[0], -1), dim=-1)


@torch.no_grad()
def value(sd: dict, planes: torch.Tensor) -> torch.Tensor:
    """``(B, 27, 9, 9)`` planes -> ``(B,)`` value for the side to move."""
    x = torch.relu(_bn(_head(sd, planes), sd, "bn")).reshape(planes.shape[0], -1)
    x = torch.relu(_bn(x @ sd["lin1.weight"].T + sd["lin1.bias"], sd, "lin_bn"))
    return torch.tanh(x @ sd["lin2.weight"].T + sd["lin2.bias"])[:, 0]


def forward(policy_sd: dict, value_sd: dict, planes, block: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """Probabilities and values of ``planes`` (NumPy or torch, ``(B, 27, 9,
    9)``), in blocks of ``block`` rows, on the CPU in float32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    x = torch.as_tensor(planes, dtype=torch.float32)
    probs, vals = [], []
    for i in range(0, x.shape[0], block):
        probs.append(policy_probs(policy_sd, x[i : i + block]))
        vals.append(value(value_sd, x[i : i + block]))
    if not probs:
        return torch.zeros((0, 81)), torch.zeros((0,))
    return torch.cat(probs), torch.cat(vals)
