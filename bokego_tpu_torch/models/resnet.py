"""AlphaGo Zero's dual residual network on the 9x9 board.

Silver et al. 2017, *Mastering the game of Go without human knowledge*,
Nature 550:354-359, Methods, "Neural network architecture": a convolutional
block (3x3 convolution of ``filters``, BatchNorm, ReLU), ``blocks`` residual
blocks (3x3 convolution, BatchNorm, ReLU, 3x3 convolution, BatchNorm, the
block's input added, ReLU), and two heads over that one trunk.  The policy
head: a 1x1 convolution of ``policy_filters``, BatchNorm, ReLU, a dense layer
to the 81 points and pass (logit 81).  The value head: a 1x1 convolution of
``value_filters``, BatchNorm, ReLU, a dense layer to ``value_hidden``, ReLU,
a dense layer to one scalar, tanh.  Convolutions have no bias (BatchNorm
follows each); dense layers do.  The defaults are the 40-block version
(1 + 39 blocks of 256 filters, 46,144,317 parameters).

Departures from the paper: the board is 9x9, so the dense layers take
``policy_filters * 81`` and ``value_filters * 81`` inputs; the input is the
port's 27 feature planes (``features.py``) in place of the paper's 17 planes
of history, since the port's rules keep no history.

Inputs are NHWC ``(B, 9, 9, 27)`` like the other nets; outputs are
``(logits (B, 82), value (B,))``, the value for the side to move.  The
float32 module in eval mode (running BatchNorm statistics) is the source of
truth; :meth:`ResNetPV.inference` gives the serving copy
(:class:`FoldedResNetPV`): each BatchNorm folded into the convolution before
it, the weights cast once (bf16 by default), channels-last activations, the
dense layers in that dtype, and tanh (and the caller's softmax) in float32.
Its trunk runs each 3x3 convolution through cuDNN without the bias and then
one in-place pass of ``ops/epilogue.bias_add_relu``: the bias, the block's
input after the second convolution of a block, and the ReLU, rounded once.

:func:`init_resnet` draws a seeded net whose policy is neither one-hot nor
flat and whose value is neither saturated nor dead at these depths:
Flax-default ``lecun_normal`` kernels and zero biases (``nets.lecun_normal_``),
the last BatchNorm scale of every residual branch ``1 / sqrt(blocks)``, and
every BatchNorm's statistics calibrated on a seeded batch of positions from
random legal play (:func:`calibrate`).
"""

from __future__ import annotations

import copy

import torch
import torch.nn.functional as F
from torch import nn

from bokego_tpu_torch.coords import NN
from bokego_tpu_torch.device import resolve_device
from bokego_tpu_torch.env import rules, state as st
from bokego_tpu_torch.features import features_batch
from bokego_tpu_torch.models.nets import lecun_normal_
from bokego_tpu_torch.ops import epilogue
from bokego_tpu_torch.utils import metrics

EPS = 1e-5  # BatchNorm epsilon; the paper gives none


def _conv(c_in: int, c_out: int, k: int) -> nn.Conv2d:
    conv = nn.Conv2d(c_in, c_out, k, padding=k // 2, bias=False)
    lecun_normal_(conv.weight)
    return conv


def _dense(n_in: int, n_out: int) -> nn.Linear:
    lin = nn.Linear(n_in, n_out)
    lecun_normal_(lin.weight)
    nn.init.zeros_(lin.bias)
    return lin


class ResidualBlock(nn.Module):
    """conv 3x3 -> BN -> ReLU -> conv 3x3 -> BN -> + input -> ReLU."""

    def __init__(self, filters: int):
        super().__init__()
        self.conv1, self.bn1 = _conv(filters, filters, 3), nn.BatchNorm2d(filters, eps=EPS)
        self.conv2, self.bn2 = _conv(filters, filters, 3), nn.BatchNorm2d(filters, eps=EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(x + self.bn2(self.conv2(y)))


class ResNetPV(nn.Module):
    """(B, 9, 9, planes) -> (logits (B, 82), value (B,))."""

    def __init__(
        self,
        planes: int = 27,
        filters: int = 256,
        blocks: int = 39,
        policy_filters: int = 2,
        value_filters: int = 1,
        value_hidden: int = 256,
        board: int = 9,
    ):
        super().__init__()
        area = board * board
        self.stem, self.stem_bn = _conv(planes, filters, 3), nn.BatchNorm2d(filters, eps=EPS)
        self.blocks = nn.ModuleList(ResidualBlock(filters) for _ in range(blocks))
        self.policy_conv = _conv(filters, policy_filters, 1)
        self.policy_bn = nn.BatchNorm2d(policy_filters, eps=EPS)
        self.policy_fc = _dense(policy_filters * area, area + 1)
        self.value_conv = _conv(filters, value_filters, 1)
        self.value_bn = nn.BatchNorm2d(value_filters, eps=EPS)
        self.value_fc1 = _dense(value_filters * area, value_hidden)
        self.value_fc2 = _dense(value_hidden, 1)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        with metrics.span("nets.tower"):
            h = self.tower(x)
        with metrics.span("nets.heads"):
            return self.heads(h)

    def tower(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC features -> the trunk's ``(B, filters, 9, 9)``, in the
        weights' dtype (an NHWC tensor seen as NCHW is channels-last)."""
        x = x.permute(0, 3, 1, 2).to(self.stem.weight.dtype)
        h = torch.relu(self.stem_bn(self.stem(x)))
        for block in self.blocks:
            h = block(h)
        return h

    def heads(self, h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The trunk -> float32 ``(logits (B, 82), value (B,))``.  The dense
        layers flatten their maps in (channel, row, col) order."""
        b = h.shape[0]
        p = torch.relu(self.policy_bn(self.policy_conv(h)))
        logits = self.policy_fc(p.reshape(b, -1))
        v = torch.relu(self.value_bn(self.value_conv(h)))
        v = torch.relu(self.value_fc1(v.reshape(b, -1)))
        return logits.float(), torch.tanh(self.value_fc2(v).float())[:, 0]

    def _conv_bn_pairs(self):
        yield self, "stem", "stem_bn"
        for block in self.blocks:
            yield block, "conv1", "bn1"
            yield block, "conv2", "bn2"
        yield self, "policy_conv", "policy_bn"
        yield self, "value_conv", "value_bn"

    @torch.no_grad()
    def inference(self, dtype: torch.dtype = torch.bfloat16) -> "FoldedResNetPV":
        """A serving copy in eval mode: every BatchNorm folded into the
        convolution before it (its scale into the weights, its shift into a
        bias), the parameters cast to ``dtype`` once, the convolution
        weights channels-last.  This module is left as it is."""
        net = copy.deepcopy(self).float().eval()
        for owner, conv_name, bn_name in net._conv_bn_pairs():
            conv, bn = getattr(owner, conv_name), getattr(owner, bn_name)
            scale = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
            conv.weight.mul_(scale.view(-1, 1, 1, 1))
            conv.bias = nn.Parameter(bn.bias - bn.running_mean * scale)
            setattr(owner, bn_name, nn.Identity())
        net.__class__ = FoldedResNetPV
        return net.to(dtype=dtype, memory_format=torch.channels_last).requires_grad_(False)


class FoldedResNetPV(ResNetPV):
    """The serving copy :meth:`ResNetPV.inference` returns: every BatchNorm
    an ``Identity``, every convolution with the folded bias.  Its trunk runs
    each convolution through cuDNN without the bias, then one in-place
    epilogue pass (``ops/epilogue.bias_add_relu``): bias and ReLU after the
    stem and each block's first convolution, bias, the block's input and
    ReLU after its second.  The heads are :class:`ResNetPV`'s."""

    def tower(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.stem.weight.dtype)
        h = _trunk_layer(self.stem, x)
        for block in self.blocks:
            h = _trunk_layer(block.conv2, _trunk_layer(block.conv1, h), h)
        return h


def _trunk_layer(conv: nn.Conv2d, x: torch.Tensor, residual: torch.Tensor | None = None) -> torch.Tensor:
    """cuDNN's convolution without the bias, then the epilogue in place."""
    y = F.conv2d(x, conv.weight, None, conv.stride, conv.padding)
    return epilogue.bias_add_relu(y, conv.bias, residual)


def random_positions(n_games: int, plies, seed: int, device=None):
    """Positions of ``n_games`` seeded games of uniformly random legal
    moves (a pass only where no point is legal), taken after each ply in
    ``plies``: a ``GoState`` of ``n_games * len(plies)`` rows.  The moves
    are drawn on the CPU, so a seed gives the same positions on any
    device."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    states = st.new_game_batch(n_games, device=dev)
    taken = []
    for ply in range(max(plies) + 1):
        if ply in plies:
            taken.append(states)
        if ply == max(plies):
            break
        legal = rules.legal_mask(states)[:, :NN].cpu()
        weights = torch.where(legal.any(1, keepdim=True), legal.float(), 1.0)
        moves = torch.multinomial(weights, 1, generator=gen)[:, 0]
        states = rules.step(states, torch.where(legal.any(1), moves, NN).to(dev))
    return st.GoState(*(torch.cat(x) for x in zip(*(s.tensors() for s in taken))))


CALIBRATION_GAMES, CALIBRATION_PLIES = 8, (4, 20, 36, 52)


@torch.no_grad()
def calibrate(net: ResNetPV, fts: torch.Tensor) -> ResNetPV:
    """Set every BatchNorm's running statistics to those of its input over
    ``fts`` in one forward, layer after layer (each later layer sees the
    earlier ones normalised), and return ``net`` in eval mode."""
    bns = [m for m in net.modules() if isinstance(m, nn.BatchNorm2d)]
    saved = [m.momentum for m in bns]
    for m in bns:
        m.momentum = 1.0  # running statistics := this batch's
    net.train()
    try:
        net(fts)
    finally:
        for m, momentum in zip(bns, saved):
            m.momentum = momentum
    return net.eval()


def init_resnet(seed: int = 0, device=None, **sizes) -> ResNetPV:
    """A seeded float32 :class:`ResNetPV` in eval mode on ``device``: the
    module's draws under ``torch.manual_seed(seed)``, each residual branch's
    last BatchNorm scale set to ``1 / sqrt(blocks)``, and the statistics
    calibrated (:func:`calibrate`) on :func:`random_positions` of
    ``CALIBRATION_GAMES`` games at ``CALIBRATION_PLIES``, drawn from
    ``seed``."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = ResNetPV(**sizes)
    with torch.no_grad():
        for block in net.blocks:
            block.bn2.weight.fill_(len(net.blocks) ** -0.5)
    net = net.to(dev)
    positions = random_positions(CALIBRATION_GAMES, CALIBRATION_PLIES, seed, dev)
    return calibrate(net, features_batch(positions))


def from_state_dict(sd: dict, device=None) -> ResNetPV:
    """A float32 :class:`ResNetPV` of the state dict's sizes, loaded from
    ``sd`` (copied: ``sd`` is left as it is), in eval mode on ``device``.
    The module is built on ``device``, where its own draws are cheap; the
    global random streams are left as they were."""
    blocks = len({k.split(".")[1] for k in sd if k.startswith("blocks.")})
    policy_filters, value_filters = sd["policy_conv.weight"].shape[0], sd["value_conv.weight"].shape[0]
    area = sd["policy_fc.weight"].shape[1] // policy_filters
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []), dev:
        net = ResNetPV(
            planes=sd["stem.weight"].shape[1],
            filters=sd["stem.weight"].shape[0],
            blocks=blocks,
            policy_filters=policy_filters,
            value_filters=value_filters,
            value_hidden=sd["value_fc1.weight"].shape[0],
            board=round(area**0.5),
        )
    net.load_state_dict(sd)
    return net.eval()


def load(path: str, device=None) -> ResNetPV:
    """A :class:`ResNetPV` saved as ``torch.save(net.state_dict(), path)``."""
    return from_state_dict(torch.load(path, map_location="cpu", weights_only=True), device)
