"""Policy and value convnets as ``nn.Module``s (counterpart of
``bokego_tpu/models/nets.py``).

The modules use the reference torch key layout (``conv.0 … conv.21``,
``bn``, ``lin_bn``, ``lin1``, ``lin2``) so the repo's reference-format
checkpoints (``data/weights/value_r2.pt``, ``data/weights/policy_17.pt``) load with ``load_state_dict`` and
no conversion.  ``conv`` is a Sequential of seven (conv, BatchNorm, ReLU)
triples at indices 0..20 and the untied-bias 1x1 head at 21.

Inputs are NHWC ``(B, 9, 9, 27)`` like the JAX nets; the modules permute to
NCHW inside.  Convolutions go to ``torch.nn.functional.conv2d`` (the JAX
package leaves them to XLA, outside any Pallas kernel).

A fresh module draws from Flax's default initialisers, as the JAX nets'
``init`` does: every convolution and dense kernel from ``lecun_normal``
(a normal of variance ``1 / fan_in`` cut at two of its pre-cut standard
deviations), every bias and untied bias zero, BatchNorm scale 1, bias 0,
mean 0, variance 1.  The draws come from torch's generator, so they are not
the JAX draws; their distributions are the same.

BatchNorm in ``train()`` mode follows Flax's ``nn.BatchNorm``, not torch's:
it normalises by the biased batch variance and folds that same biased
variance into ``running_var`` (torch folds in the unbiased one, a factor
``n / (n - 1)``: 3 % for ``lin_bn`` at a batch of 32).  In ``eval()`` mode
it is the stock layer while input, statistics and parameters are float32.

**bf16** (``forward(x, dtype=torch.bfloat16)``, the JAX package's
``net_evaluator(dtype=jnp.bfloat16)``): every float32 parameter and
statistic is rounded to bf16 for the call and the features are cast to
bf16, as the JAX evaluator's ``_cast`` does; a module stored in bf16
(``net.to(torch.bfloat16)``, ``bench.py``'s variant) takes the same route
and gives the same bits.  Each layer then computes as its Flax counterpart
does, in its input's dtype: the Flax convolutions and dense layers take
``dtype=x.dtype`` and every BatchNorm returns float32, so only the 5x5 stem
convolution and its BatchNorm run in bf16, and every later layer computes
in float32 on weights rounded to bf16 (a "bf16 trunk" that is 91 % fp32 by
FLOPs).  The rounding points are those of the JAX graph as XLA runs it: a
bf16 result is rounded to bf16 unless its only use is a cast to float32,
which XLA's default excess precision keeps in float32 (the BatchNorm
scale ``rsqrt(var + eps) * scale`` of the float32 layers, the stem
BatchNorm's last ``+ bias``).
"""

from __future__ import annotations

import torch
from torch import nn

from bokego_tpu_torch.coords import NN
from bokego_tpu_torch.device import resolve_device


class _FlaxStatsBatchNorm:
    """Train-mode forward with Flax's statistics (``momentum=0.1`` here is
    Flax's ``momentum=0.9``): ``y = (x - mean) * (weight * rsqrt(var + eps))
    + bias`` over the biased batch variance, and the running averages
    ``0.9 * running + 0.1 * batch`` of the mean and that variance."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            if x.dtype == self.running_var.dtype == torch.float32:
                return super().forward(x)
            return self._eval_rounded(x)
        dims = [0, *range(2, x.dim())]
        shape = [1, -1] + [1] * (x.dim() - 2)
        mean = x.mean(dims)
        var = x.var(dims, correction=0)
        with torch.no_grad():
            decay = 1.0 - self.momentum
            self.running_mean.copy_(decay * self.running_mean + (1.0 - decay) * mean)
            self.running_var.copy_(decay * self.running_var + (1.0 - decay) * var)
            self.num_batches_tracked += 1
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)

    def _eval_rounded(self, x: torch.Tensor) -> torch.Tensor:
        """Flax's eval-mode normalisation on bf16 statistics and parameters
        (``flax.linen.normalization._normalize``), float32 out: ``rsqrt(var
        + eps)`` in bf16 (eps rounded to bf16, as JAX's weak-typed constant
        is); the scale times it in bf16 for a bf16 input, else in float32;
        ``x - mean`` and the product in the input's dtype; the bias added in
        float32."""
        shape = [1, -1] + [1] * (x.dim() - 2)
        mean, var, scale, bias = (
            t.view(shape) for t in (self.running_mean, self.running_var, self.weight, self.bias)
        )
        inv = torch.rsqrt(var + torch.tensor(self.eps, dtype=var.dtype))
        mul = inv * scale if x.dtype == inv.dtype else inv.float() * scale.float()
        return ((x - mean) * mul).float() + bias.float()


class BatchNorm2d(_FlaxStatsBatchNorm, nn.BatchNorm2d):
    pass


class BatchNorm1d(_FlaxStatsBatchNorm, nn.BatchNorm1d):
    pass


_TRUNC_STD = 0.87962566103423978  # std of a unit normal cut at +-2


def lecun_normal_(weight: torch.Tensor) -> torch.Tensor:
    """Flax's ``lecun_normal()`` in place: ``variance_scaling(1.0, "fan_in",
    "truncated_normal")``, fan_in the product of every dimension but the
    output one (``in_channels * kh * kw`` for a convolution)."""
    std = (1.0 / weight[0].numel()) ** 0.5 / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, std=std, a=-2.0 * std, b=2.0 * std)


class _FlaxInit:
    """``reset_parameters`` with Flax's defaults: a ``lecun_normal`` kernel
    and a zero bias."""

    def reset_parameters(self) -> None:
        lecun_normal_(self.weight)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


class Conv2d(_FlaxInit, nn.Conv2d):
    """``nn.Conv2d`` in its input's dtype (Flax's ``nn.Conv(dtype=x.dtype)``):
    float32 in, the stock layer (on bf16-rounded weights when the module is
    stored in bf16); bf16 in, the convolution in bf16, its output rounded,
    then the bias added in bf16, as the JAX graph adds it."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight.to(x.dtype), self.bias.to(x.dtype)
        if x.dtype == torch.float32:
            return self._conv_forward(x, w, b)
        return self._conv_forward(x, w, None) + b.view(-1, 1, 1)


class Linear(_FlaxInit, nn.Linear):
    """``nn.Linear`` in its input's dtype (Flax's ``nn.Dense(dtype=x.dtype)``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn.functional.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class UntiedBiasConv(nn.Module):
    """Conv with a shared kernel and a per-position bias ``(out, 9, 9)``, in
    its input's dtype."""

    def __init__(self, in_channels: int, out_channels: int = 1, size: int = 9):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 1, 1))
        self.bias = nn.Parameter(torch.zeros(out_channels, size, size))
        lecun_normal_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn.functional.conv2d(x, self.weight.to(x.dtype)) + self.bias.to(x.dtype)


def _trunk(channels: int) -> nn.Sequential:
    """5x5 conv then six 3x3 convs, each with BN+ReLU; untied 1x1 head."""
    layers: list[nn.Module] = []
    in_ch = 27
    for k in [5] + [3] * 6:
        layers += [
            Conv2d(in_ch, channels, k, padding=k // 2),
            BatchNorm2d(channels, eps=1e-5, momentum=0.1),
            nn.ReLU(),
        ]
        in_ch = channels
    layers.append(UntiedBiasConv(channels, 1))
    return nn.Sequential(*layers)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def cast_call(net: nn.Module, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``net(x)`` with every float32 parameter and buffer rounded to
    ``dtype`` for this call and ``x`` cast to ``dtype`` (the JAX evaluator's
    ``_cast``); a module already stored in ``dtype`` runs as it is.  The
    output as float32."""
    rounded = {
        name: t.to(dtype)
        for name, t in [*net.named_parameters(), *net.named_buffers()]
        if t.dtype == torch.float32
    }
    return torch.func.functional_call(net, rounded, (x.to(dtype),)).float()


class PolicyNet(nn.Module):
    """(B, 9, 9, 27) -> (B, 81) move logits."""

    def __init__(self, channels: int = 128):
        super().__init__()
        self.conv = _trunk(channels)

    def forward(self, x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
        if dtype is not None:
            return cast_call(self, x, dtype)
        return self.conv(_nchw(x)).reshape(x.shape[0], NN)


class ValueNet(nn.Module):
    """(B, 9, 9, 27) -> (B, 1) value in (-1, 1) for the side to move."""

    def __init__(self, channels: int = 128):
        super().__init__()
        self.conv = _trunk(channels)
        self.bn = BatchNorm2d(1, eps=1e-5, momentum=0.1)
        self.lin1 = Linear(NN, 64)
        self.lin_bn = BatchNorm1d(64, eps=1e-5, momentum=0.1)
        self.lin2 = Linear(64, 1)

    def forward(self, x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
        if dtype is not None:
            return cast_call(self, x, dtype)
        x = torch.relu(self.bn(self.conv(_nchw(x))))
        x = torch.relu(self.lin_bn(self.lin1(x.reshape(x.shape[0], NN))))
        return torch.tanh(self.lin2(x))


class PolicyNetV2(nn.Module):
    """The legacy v0.2 policy, kept for loading old checkpoints: no
    BatchNorm, a 5x5 conv 27 -> 64 and five 3x3 convs to 128 with ReLU
    between (``conv.0 … conv.10``), the untied-bias 1x1 head at ``conv.12``."""

    def __init__(self):
        super().__init__()
        layers: list[nn.Module] = []
        in_ch = 27
        for width, k in zip([64] + [128] * 5, [5] + [3] * 5):
            layers += [Conv2d(in_ch, width, k, padding=k // 2), nn.ReLU()]
            in_ch = width
        layers.append(UntiedBiasConv(in_ch, 1))
        self.conv = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(_nchw(x)).reshape(x.shape[0], NN)


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


def value_from_policy(value: ValueNet, policy: PolicyNet) -> ValueNet:
    """Copy a policy's trunk (weights and BatchNorm statistics) into
    ``value`` in place and return it (``bokego_tpu.models.value_from_policy``;
    the reference's ``ValueNet.load_policy_dict``)."""
    value.conv.load_state_dict(policy.conv.state_dict())
    return value


def from_state_dict(kind: str, sd: dict, device=None) -> PolicyNet | ValueNet:
    """A ``"policy"`` or ``"value"`` net of the state dict's width, loaded
    from ``sd`` (or from a checkpoint payload's ``model_state_dict``), in
    eval mode on ``device``."""
    dev = resolve_device(device)
    sd = sd.get("model_state_dict", sd)
    net = (PolicyNet if kind == "policy" else ValueNet)(sd["conv.0.weight"].shape[0])
    net.load_state_dict(sd)
    return net.to(dev).eval()


def _load(kind: str, path: str, device):
    return from_state_dict(kind, torch.load(path, map_location="cpu", weights_only=True), device)


def load_policy(path: str, device=None) -> PolicyNet:
    """A reference-format policy checkpoint (``{"model_state_dict": …}``)."""
    return _load("policy", path, device)


def load_value(path: str, device=None) -> ValueNet:
    """A reference-format value checkpoint (``{"model_state_dict": …}``)."""
    return _load("value", path, device)
