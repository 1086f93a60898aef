"""AlphaGo Zero's dual residual network as a plain float32 forward.

Silver et al. 2017, "Mastering the game of Go without human knowledge",
Nature 550:354-359, Methods, "Neural network architecture":

- the convolutional block: a 3x3 convolution of 256 filters (stride 1),
  BatchNorm, ReLU;
- 39 residual blocks: a 3x3 convolution of 256 filters, BatchNorm, ReLU, a
  3x3 convolution of 256 filters, BatchNorm, the block's input added, ReLU;
- the policy head: a 1x1 convolution of 2 filters, BatchNorm, ReLU, a dense
  layer to one logit per point and one for pass;
- the value head: a 1x1 convolution of 1 filter, BatchNorm, ReLU, a dense
  layer to 256, ReLU, a dense layer to 1, tanh.

Convolutions have no bias; dense layers do.  BatchNorm uses its running
statistics with eps 1e-5 (the paper gives none).  The depth and widths are
read from the state dict.

Departures from the paper:

- the board is 9x9, not 19x19: the policy's dense layer maps 2 * 81 inputs
  to 82 logits (logit 81 is pass), the value's first dense layer 81 inputs
  to 256;
- the input is 27 feature planes of the position (stones, liberties,
  captures, legality, the colour to move, the last move), not the paper's
  17 planes of eight positions of history;
- the search that uses these outputs gives pass no prior: the move
  probabilities are the softmax over the 81 board logits
  (:func:`board_log_probs`).

The weights are a state dict of the float32 module, keys ``stem``,
``stem_bn``, ``blocks.<i>.{conv1,bn1,conv2,bn2}``, ``policy_conv``,
``policy_bn``, ``policy_fc``, ``value_conv``, ``value_bn``, ``value_fc1``,
``value_fc2``.  Every operation is a plain torch call in float32 with TF32
off; the dense layers flatten their maps in (channel, row, col) order.

:func:`init_state` draws such a state dict from a seed, and
:func:`calibrate` sets its BatchNorm statistics from a batch of positions:
at the published depth the plain draws (``lecun_normal`` kernels, identity
BatchNorm) give a one-hot policy and a saturated value, so the last
BatchNorm scale of every residual branch is ``1 / sqrt(blocks)`` and each
BatchNorm normalises its input over the calibration batch.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

EPS = 1e-5
# the standard deviation of a unit normal truncated to [-2, 2], which Flax's
# truncated-normal initialisers divide out
TRUNC_STD = 0.87962566103423978


def _bn(x: torch.Tensor, sd: dict, name: str) -> torch.Tensor:
    shape = (1, -1) + (1,) * (x.dim() - 2)
    mean, var = sd[f"{name}.running_mean"].view(shape), sd[f"{name}.running_var"].view(shape)
    w, b = sd[f"{name}.weight"].view(shape), sd[f"{name}.bias"].view(shape)
    return (x - mean) / torch.sqrt(var + EPS) * w + b


def _calibrating_bn(x: torch.Tensor, sd: dict, name: str) -> torch.Tensor:
    dims = [0, *range(2, x.dim())]
    sd[f"{name}.running_mean"] = x.mean(dims)
    sd[f"{name}.running_var"] = x.var(dims, unbiased=False)
    return _bn(x, sd, name)


def _conv_bn(x: torch.Tensor, sd: dict, conv: str, bn: str, bn_fn=_bn) -> torch.Tensor:
    w = sd[f"{conv}.weight"]
    return bn_fn(F.conv2d(x, w, padding=w.shape[-1] // 2), sd, bn)


def _blocks(sd: dict) -> int:
    return len({k.split(".")[1] for k in sd if k.startswith("blocks.")})


@torch.no_grad()
def logits_value(sd: dict, planes: torch.Tensor, bn_fn=_bn) -> tuple[torch.Tensor, torch.Tensor]:
    """``(B, planes, 9, 9)`` -> ``(logits (B, 82), value (B,))``; ``bn_fn``
    applies each BatchNorm."""
    x = torch.relu(_conv_bn(planes, sd, "stem", "stem_bn", bn_fn))
    for i in range(_blocks(sd)):
        y = torch.relu(_conv_bn(x, sd, f"blocks.{i}.conv1", f"blocks.{i}.bn1", bn_fn))
        x = torch.relu(x + _conv_bn(y, sd, f"blocks.{i}.conv2", f"blocks.{i}.bn2", bn_fn))
    b = x.shape[0]
    p = torch.relu(_conv_bn(x, sd, "policy_conv", "policy_bn", bn_fn)).reshape(b, -1)
    logits = F.linear(p, sd["policy_fc.weight"], sd["policy_fc.bias"])
    v = torch.relu(_conv_bn(x, sd, "value_conv", "value_bn", bn_fn)).reshape(b, -1)
    v = torch.relu(F.linear(v, sd["value_fc1.weight"], sd["value_fc1.bias"]))
    value = torch.tanh(F.linear(v, sd["value_fc2.weight"], sd["value_fc2.bias"]))[:, 0]
    return logits, value


def board_log_probs(logits: torch.Tensor) -> torch.Tensor:
    """``(B, 82)`` logits -> ``(B, 81)`` log-probabilities of the board
    points, pass left out."""
    return torch.log_softmax(logits[:, :81], dim=-1)


def float32_state(sd: dict, device="cpu") -> dict[str, torch.Tensor]:
    """The floating tensors of a state dict as float32 on ``device``."""
    return {k: v.detach().to(device=device, dtype=torch.float32) for k, v in sd.items() if v.is_floating_point()}


def _no_tf32() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def forward(sd: dict, planes, block: int = 64, device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """Logits and values of ``planes`` (NumPy or torch, ``(B, planes, 9,
    9)``) in blocks of ``block`` rows on ``device``, in float32 with TF32
    off; returned on the CPU."""
    _no_tf32()
    sd = float32_state(sd, device)
    x = torch.as_tensor(planes, dtype=torch.float32)
    logits, values = [], []
    for i in range(0, x.shape[0], block):
        lg, v = logits_value(sd, x[i : i + block].to(device))
        logits.append(lg.cpu())
        values.append(v.cpu())
    if not logits:
        return torch.zeros((0, 82)), torch.zeros((0,))
    return torch.cat(logits), torch.cat(values)


def _lecun_normal(shape: tuple, gen: torch.Generator) -> torch.Tensor:
    """Flax's ``lecun_normal()``: a normal truncated to two standard
    deviations, scaled to variance ``1 / fan_in`` (fan_in: every dimension
    but the first), drawn by inverting the normal's distribution function."""
    std = math.prod(shape[1:]) ** -0.5 / TRUNC_STD
    lo, hi = (0.5 * (1.0 + math.erf(z / math.sqrt(2.0))) for z in (-2.0, 2.0))
    u = lo + (hi - lo) * torch.rand(shape, generator=gen)
    return math.sqrt(2.0) * std * torch.erfinv(2.0 * u - 1.0)


def init_state(
    seed: int,
    planes: int = 27,
    filters: int = 256,
    blocks: int = 39,
    policy_filters: int = 2,
    value_filters: int = 1,
    value_hidden: int = 256,
    board: int = 9,
) -> dict[str, torch.Tensor]:
    """A seeded state dict of the float32 module on the CPU, before
    :func:`calibrate`: ``lecun_normal`` kernels and zero biases, BatchNorm
    scale 1 and shift 0 but ``1 / sqrt(blocks)`` for the last of each
    residual branch, running mean 0 and variance 1."""
    gen = torch.Generator().manual_seed(seed)
    area = board * board
    sd: dict[str, torch.Tensor] = {}

    def conv_bn(conv: str, bn: str, c_in: int, c_out: int, k: int, scale: float = 1.0):
        sd[f"{conv}.weight"] = _lecun_normal((c_out, c_in, k, k), gen)
        sd[f"{bn}.weight"] = torch.full((c_out,), scale)
        sd[f"{bn}.bias"] = torch.zeros(c_out)
        sd[f"{bn}.running_mean"] = torch.zeros(c_out)
        sd[f"{bn}.running_var"] = torch.ones(c_out)
        sd[f"{bn}.num_batches_tracked"] = torch.tensor(0)

    def dense(name: str, n_in: int, n_out: int):
        sd[f"{name}.weight"] = _lecun_normal((n_out, n_in), gen)
        sd[f"{name}.bias"] = torch.zeros(n_out)

    conv_bn("stem", "stem_bn", planes, filters, 3)
    for i in range(blocks):
        conv_bn(f"blocks.{i}.conv1", f"blocks.{i}.bn1", filters, filters, 3)
        conv_bn(f"blocks.{i}.conv2", f"blocks.{i}.bn2", filters, filters, 3, blocks**-0.5)
    conv_bn("policy_conv", "policy_bn", filters, policy_filters, 1)
    dense("policy_fc", policy_filters * area, area + 1)
    conv_bn("value_conv", "value_bn", filters, value_filters, 1)
    dense("value_fc1", value_filters * area, value_hidden)
    dense("value_fc2", value_hidden, 1)
    return sd


def calibrate(sd: dict, planes, device="cpu") -> dict:
    """Set, in ``sd``, every BatchNorm's running statistics to the mean and
    the (biased) variance of its input over ``planes`` (NumPy or torch,
    ``(B, planes, 9, 9)``), layer after layer, in one float32 forward on
    ``device`` with TF32 off: each later layer sees the earlier ones
    normalised by their new statistics.  Returns ``sd``."""
    _no_tf32()
    work = float32_state(sd, device)
    logits_value(work, torch.as_tensor(planes, dtype=torch.float32).to(device), bn_fn=_calibrating_bn)
    for k, v in work.items():
        if k.endswith((".running_mean", ".running_var")):
            sd[k] = v.cpu()
    return sd
