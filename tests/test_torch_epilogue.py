"""The residual tower's trunk epilogue (``ops/epilogue.py``) and the serving
copy that runs it (``resnet.FoldedResNetPV``), on the CPU: the plain version
against ``relu(y + b (+ r))`` computed in float32 and rounded once, the
wrapper's checks, and the copy's forward (one epilogue pass after each
trunk convolution and no other op between two of them).

This file imports no JAX; the kernel itself is held against the plain
version in ``tests/test_torch_cuda.py``."""

from __future__ import annotations

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from bokego_tpu_torch.coords import NN
from bokego_tpu_torch.features import features_batch
from bokego_tpu_torch.models import resnet
from bokego_tpu_torch.ops import epilogue
from bokego_tpu_torch.utils import metrics

from tests.test_torch_agz import BF16_LOGP_LIMIT, BF16_VALUE_LIMIT, _small


def _activation(shape, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    return (2.0 * torch.randn(shape, generator=gen)).to(dtype).contiguous(memory_format=torch.channels_last)


def _inputs(dtype, residual: bool, shape=(3, 16, 9, 9)):
    y = _activation(shape, dtype, 0)
    bias = torch.randn(shape[1], generator=torch.Generator().manual_seed(1)).to(dtype)
    return y, bias, _activation(shape, dtype, 2) if residual else None


@pytest.mark.parametrize("residual", [False, True], ids=["bias_relu", "bias_residual_relu"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_plain_epilogue_is_float32_arithmetic_rounded_once(dtype, residual):
    y, bias, r = _inputs(dtype, residual)
    acc = y.float() + bias.float().view(1, -1, 1, 1)
    if residual:
        acc = acc + r.float()
    got = epilogue.bias_add_relu_plain(y.clone(), bias, r)
    assert got.dtype == dtype and got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, acc.relu().to(dtype))
    if dtype == torch.bfloat16 and residual:  # the unfused route rounds after the bias too
        assert not torch.equal(got, ((y + bias.view(1, -1, 1, 1)).float() + r.float()).relu().to(dtype))


@pytest.mark.parametrize("residual", [False, True], ids=["bias_relu", "bias_residual_relu"])
def test_wrapper_runs_the_plain_version_in_place_on_the_cpu(residual):
    y, bias, r = _inputs(torch.bfloat16, residual)
    want = epilogue.bias_add_relu_plain(y.clone(), bias, r)
    with metrics.recording() as rec:
        got = epilogue.bias_add_relu(y, bias, r)
    assert got is y and torch.equal(y, want)
    assert rec.counters == {}  # the plain version launches nothing


def _bad_inputs(case: str):
    y, bias, r = _inputs(torch.bfloat16, True)
    if case == "dtype":
        return y.half(), bias.half(), None
    if case == "channels":
        return _inputs(torch.bfloat16, True, shape=(3, 12, 9, 9))
    if case == "layout":
        return y.contiguous(), bias, None
    if case == "residual_shape":
        return y, bias, r[:2]
    if case == "residual_layout":
        return y, bias, r.contiguous()
    if case == "bias_shape":
        return y, bias[:8], None
    raise AssertionError(case)


@pytest.mark.parametrize(
    "case,error",
    [("dtype", TypeError), ("channels", ValueError), ("layout", ValueError), ("residual_shape", ValueError),
     ("residual_layout", ValueError), ("bias_shape", ValueError)],
)
def test_wrapper_refuses_what_the_kernel_does_not_take(case, error):
    y, bias, r = _bad_inputs(case)
    kept = y.clone()
    with pytest.raises(error):
        epilogue.bias_add_relu(y, bias, r)
    assert torch.equal(y, kept)


def test_serving_copy_is_the_folded_class_and_the_module_is_not(monkeypatch):
    net = _small(2, 8)
    folded = net.inference()
    assert type(folded) is resnet.FoldedResNetPV and type(net) is resnet.ResNetPV
    convs = [m for m in folded.modules() if isinstance(m, torch.nn.Conv2d)]
    assert len(convs) == 1 + 2 * 2 + 2 and all(c.bias is not None for c in convs)
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in folded.modules())
    fts = features_batch(resnet.random_positions(2, (4, 30), 9, "cpu"))
    passes = []
    wrapper = epilogue.bias_add_relu
    monkeypatch.setattr(epilogue, "bias_add_relu", lambda *a: passes.append(1) or wrapper(*a))
    with torch.inference_mode():
        net(fts)
        assert not passes  # the float32 module keeps its own forward
        folded(fts)
    assert len(passes) == 1 + 2 * 2


class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


def test_nothing_but_one_epilogue_between_two_trunk_convolutions(monkeypatch):
    blocks = 3
    folded = _small(blocks, 16).inference()
    fts = features_batch(resnet.random_positions(2, (6,), 4, "cpu"))
    log = _OpLog()
    plain = epilogue.bias_add_relu

    def logged(y, bias, residual=None):
        log.ops.append("epilogue" if residual is None else "epilogue+residual")
        with torch.utils._python_dispatch._disable_current_modes():
            return plain(y, bias, residual)

    monkeypatch.setattr(epilogue, "bias_add_relu", logged)
    with torch.inference_mode(), log:
        folded.tower(fts)
    trunk = ["conv" if op.startswith("conv") else op for op in log.ops]  # conv2d, or convolution
    trunk = trunk[trunk.index("conv"):]
    assert trunk == ["conv", "epilogue"] + ["conv", "epilogue", "conv", "epilogue+residual"] * blocks, log.ops


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_fused_forward_against_the_unfused_one(dtype):
    """The serving copy against :class:`ResNetPV`'s own forward of the same
    folded weights (the unfused route: bias in the convolution, then ReLU
    and the residual add as ops of their own, each rounded)."""
    folded = _small(3, 16).inference(dtype)
    fts = features_batch(resnet.random_positions(4, (3, 25), 17, "cpu"))
    with torch.inference_mode():
        fused = folded(fts)
        unfused = resnet.ResNetPV.heads(folded, resnet.ResNetPV.tower(folded, fts))
    if dtype == torch.float32:
        for a, b in zip(fused, unfused):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    else:
        logp = [torch.log_softmax(x[0][:, :NN], -1) for x in (fused, unfused)]
        assert float((logp[0] - logp[1]).abs().max()) <= BF16_LOGP_LIMIT
        assert float((fused[1] - unfused[1]).abs().max()) <= BF16_VALUE_LIMIT
        assert not torch.equal(fused[0], unfused[0])  # the roundings removed do show
