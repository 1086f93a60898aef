"""AlphaGo Zero's residual tower (``models/resnet.py``): the module against
the plain float32 reference (``benchmark/reference/agz.py``), the folded and
bf16 inference forms, the seeded initialisation at the published sizes, and
the joint evaluator in the search and in self-play.

This file imports no JAX; its ``cuda`` tests run on a card with
``python -m pytest --noconftest -m cuda tests/test_torch_agz.py``."""

from __future__ import annotations

import ast
import json
from pathlib import Path

import pytest
import torch

from bokego_tpu_torch.config import SearchConfig
from bokego_tpu_torch.coords import NN
from bokego_tpu_torch.env import rules
from bokego_tpu_torch.features import features_batch
from bokego_tpu_torch.models import inference, resnet
from bokego_tpu_torch.parallel.selfplay import selfplay
from bokego_tpu_torch.search import mcts
from bokego_tpu_torch.utils import metrics
from benchmark.reference import agz as ref

ROOT = Path(__file__).resolve().parents[1]

# bf16 keeps 8 bits of mantissa (a relative rounding of 2**-9 a value):
# over the 9 layers of the (3, 16) net, rounded activations and weights give
# log-probability gaps near 0.03 and value gaps under 0.01 against float32;
# the limits leave 3x of room above them.  Convolution weights rounded to
# float8_e4m3fn (3 bits of mantissa, each tensor scaled to the format's
# largest value 448 first) give log-probability gaps near 0.2.
BF16_LOGP_LIMIT, BF16_VALUE_LIMIT = 0.1, 0.05


def _positions(n_games: int, plies=(0, 9, 25, 41), seed: int = 11):
    return features_batch(resnet.random_positions(n_games, plies, seed, "cpu"))


def _scrambled_bn(net: resnet.ResNetPV, seed: int) -> resnet.ResNetPV:
    """Every BatchNorm's scale, shift and statistics drawn away from the
    identity (seeded), so that a folding or ordering fault shows."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(0.5 + torch.rand(n, generator=gen))
                m.bias.copy_(0.2 * torch.randn(n, generator=gen))
                m.running_mean.copy_(0.5 * torch.randn(n, generator=gen))
                m.running_var.copy_(0.5 + 1.5 * torch.rand(n, generator=gen))
    return net


def _small(blocks: int, filters: int, seed: int = 3) -> resnet.ResNetPV:
    return _scrambled_bn(resnet.init_resnet(seed, "cpu", blocks=blocks, filters=filters), seed + 100)


def _reference(net, fts):
    return ref.forward(net.state_dict(), fts.permute(0, 3, 1, 2))


def _gaps(logits, values, ref_logits, ref_values) -> tuple[float, float]:
    logp = torch.log_softmax(logits[:, :NN].float(), -1)
    return float((logp - ref.board_log_probs(ref_logits)).abs().max()), float((values - ref_values).abs().max())


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("blocks,filters", [(1, 8), (3, 16)])
def test_resnet_matches_the_plain_reference(blocks, filters, batch):
    net = _small(blocks, filters)
    fts = _positions(8)[torch.arange(batch) * 3]
    want_logits, want_values = _reference(net, fts)
    with torch.inference_mode():
        logits, values = net(fts)
    assert logits.shape == (batch, NN + 1) and values.shape == (batch,)
    assert logits.dtype == values.dtype == torch.float32
    torch.testing.assert_close(logits, want_logits, atol=1e-5, rtol=0)
    torch.testing.assert_close(values, want_values, atol=1e-5, rtol=0)


def test_folded_float32_form_equals_the_module():
    net = _small(3, 16)
    folded = net.inference(torch.float32)
    fts = _positions(8)
    with torch.inference_mode():
        want, got = net(fts), folded(fts)
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in folded.modules())
    assert folded.stem.weight.is_contiguous(memory_format=torch.channels_last)
    assert all(isinstance(m, torch.nn.BatchNorm2d) for m in (net.stem_bn, net.blocks[0].bn2))  # left as it was
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def _fp8_weights(net: resnet.ResNetPV) -> resnet.ResNetPV:
    """Every convolution weight rounded through float8_e4m3fn with a scale
    per tensor, as fp8 inference stores them."""
    with torch.no_grad():
        for p in net.parameters():
            if p.dim() == 4:
                scale = p.abs().amax().float() / 448.0
                p.copy_(((p.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(p.dtype))
    return net


def test_bf16_form_is_within_its_limits_and_fp8_weights_are_not():
    net = _small(3, 16)
    fts = _positions(8)
    want = _reference(net, fts)
    bf16 = net.inference()
    assert {p.dtype for p in bf16.parameters()} == {torch.bfloat16}
    with torch.inference_mode():
        logp_gap, value_gap = _gaps(*bf16(fts), *want)
        fp8_gaps = _gaps(*_fp8_weights(net.inference())(fts), *want)
    assert 0 < logp_gap <= BF16_LOGP_LIMIT and value_gap <= BF16_VALUE_LIMIT
    assert fp8_gaps[0] > BF16_LOGP_LIMIT or fp8_gaps[1] > BF16_VALUE_LIMIT


def test_seeded_init_at_the_published_sizes():
    net = resnet.init_resnet(0, "cpu")
    assert sum(p.numel() for p in net.parameters()) == 46_144_317
    assert len(net.blocks) == 39 and net.stem.weight.shape == (256, 27, 3, 3)
    assert net.policy_fc.weight.shape == (NN + 1, 2 * NN) and net.value_fc1.weight.shape == (256, NN)
    fts = _positions(2, plies=(5, 25, 45, 65), seed=101)
    with torch.inference_mode():
        probs, values = inference.policy_value(net, fts)
    top = probs.max(1).values.median()
    assert 0.03 <= top <= 0.9, top
    assert 0.02 <= values.abs().median() <= 0.9, values
    assert ((values.abs() > 0.999) | (values == 0)).float().mean() <= 0.1, values


def test_seeded_init_is_deterministic():
    a, b, c = (resnet.init_resnet(s, "cpu", blocks=3, filters=16) for s in (0, 0, 1))
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    assert not torch.equal(a.stem.weight, c.stem.weight)
    assert not torch.equal(a.stem_bn.running_mean, torch.zeros(16))  # calibrated


def test_state_dict_round_trip(tmp_path):
    net = _small(1, 8)
    path = tmp_path / "pv.pt"
    torch.save(net.state_dict(), path)
    back = resnet.load(str(path), "cpu")
    assert len(back.blocks) == 1 and back.stem.weight.shape == (8, 27, 3, 3)
    fts = _positions(2)
    with torch.inference_mode():
        assert all(torch.equal(a, b) for a, b in zip(net(fts), back(fts)))


def _search_cfg(use_kernel: bool) -> SearchConfig:
    return SearchConfig(
        expand_thresh=2, no_sim=True, max_turns=80, max_nodes=128, n_rollouts=16,
        use_kernel=use_kernel, kernel_levels=8, eval_every=2, noise_weight=0.25,
    )


@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel", "plain"])
def test_pv_evaluator_in_the_search(use_kernel):
    params = {"pv": _small(1, 8).inference()}
    states = resnet.random_positions(2, (3, 30), 5, "cpu")
    with metrics.recording() as rec:
        actions, trees = mcts.search(states, mcts.pv_evaluator(), params, _search_cfg(use_kernel), gen=torch.Generator().manual_seed(1))
    assert rules.legal_mask(states).gather(1, actions[:, None]).all()
    assert torch.equal(trees.root_stats[:, 0], torch.full((4,), 16.0))
    forwards = rec.phases["nets.pv"].count
    assert forwards >= 2 and rec.phases["nets.tower"].count == rec.phases["nets.heads"].count == forwards
    assert rec.counters["nets.pv_rows"] == 4 * forwards


def test_pv_evaluator_callbacks_are_one_forward():
    net = _small(1, 8)
    ev, params = mcts.pv_evaluator(), {"pv": net}
    states = resnet.random_positions(3, (10,), 8, "cpu")
    probs, values = ev.evaluate(params, states)
    with torch.inference_mode():
        logits, want_values = net(features_batch(states))
    torch.testing.assert_close(probs, torch.softmax(logits[:, :NN], -1))
    torch.testing.assert_close(probs.sum(1), torch.ones(3))
    assert torch.equal(values, want_values) and ev.has_value
    assert torch.equal(ev.policy_probs(params, states), probs)
    assert all(torch.equal(a, b) for a, b in zip(ev.evaluate_fts(params, features_batch(states)), (probs, values)))


def test_selfplay_with_the_tower():
    cfg = SearchConfig(expand_thresh=2, no_sim=True, max_turns=80, max_nodes=128, use_kernel=True, eval_every=2)
    result = selfplay({"pv": _small(1, 8).inference()}, mcts.pv_evaluator(), cfg, 4, 3, 16, device="cpu")
    assert result.actions.shape == (3, 4)
    assert (result.actions < NN).all()  # three plies from the empty board: no pass
    assert torch.equal(result.final.turn, torch.full((4,), 3))
    assert not result.final.invalid.any()


def test_reference_copies_are_identical_and_import_nothing_of_the_program():
    """The tower's float32 reference is one file, ``benchmark/reference/agz.py``,
    which these tests and the benchmark's check share; it imports only
    ``math`` and ``torch``."""
    assert not (ROOT / "tests/reference_agz.py").exists()
    for node in ast.walk(ast.parse(Path(ref.__file__).read_text())):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else [node.module or ""]
            assert all(n.split(".")[0] in {"__future__", "math", "torch"} for n in names), names


def test_reference_init_runs_in_the_program_through_its_state_dict():
    planes = _positions(4).permute(0, 3, 1, 2)
    sd = ref.calibrate(ref.init_state(5, blocks=3, filters=16), planes)
    kept = {k: v.clone() for k, v in sd.items()}
    torch.manual_seed(7)
    stream = torch.rand(4)
    torch.manual_seed(7)
    net = resnet.from_state_dict(sd, "cpu")
    assert torch.equal(torch.rand(4), stream)  # the global stream is left as it was
    assert set(sd) == set(resnet.ResNetPV(blocks=3, filters=16).state_dict())
    assert not net.training and len(net.blocks) == 3 and net.stem.weight.shape == (16, 27, 3, 3)
    fts = _positions(8, seed=13)
    want_logits, want_values = ref.forward(sd, fts.permute(0, 3, 1, 2))
    with torch.inference_mode():
        logits, values = net(fts)
        net.stem.weight.add_(1.0)  # the program's copy, not the caller's
    torch.testing.assert_close(logits, want_logits, atol=1e-5, rtol=0)
    torch.testing.assert_close(values, want_values, atol=1e-5, rtol=0)
    assert all(torch.equal(kept[k], sd[k]) for k in sd)


def test_reference_init_is_seeded_and_calibrated_on_its_batch():
    a, b, c = (ref.init_state(s, blocks=2, filters=8) for s in (4, 4, 5))
    assert all(torch.equal(a[k], b[k]) for k in a) and not torch.equal(a["stem.weight"], c["stem.weight"])
    assert torch.equal(a["blocks.1.bn2.weight"], torch.full((8,), 2**-0.5)) and torch.equal(a["blocks.1.bn1.weight"], torch.ones(8))
    w = a["blocks.0.conv1.weight"]
    assert w.abs().max() <= 2 * (1 / 72) ** 0.5 / ref.TRUNC_STD
    planes = _positions(4).permute(0, 3, 1, 2)
    ref.calibrate(a, planes)
    stem = torch.nn.functional.conv2d(planes, a["stem.weight"], padding=1)
    torch.testing.assert_close(a["stem_bn.running_mean"], stem.mean((0, 2, 3)), atol=1e-5, rtol=0)
    torch.testing.assert_close(a["stem_bn.running_var"], stem.var((0, 2, 3), unbiased=False), atol=1e-5, rtol=1e-5)
    assert not torch.equal(a["value_bn.running_var"], torch.ones(1))  # every layer, the heads' too


@pytest.mark.cuda
def test_bf16_tower_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    net = resnet.init_resnet(0, dev)
    fts = _positions(16, plies=(0, 20, 40, 60), seed=12).to(dev)
    want = ref.forward(net.state_dict(), fts.permute(0, 3, 1, 2), device=dev)
    with torch.inference_mode():
        got = net.inference()(fts)
    logp_gap, value_gap = _gaps(*(t.cpu() for t in got), *want)
    limits = json.loads((ROOT / "benchmark/configs/selfplay-agz40-b1024.json").read_text())["check"]
    assert logp_gap <= limits["logp_gap"] and value_gap <= limits["value_gap"], (logp_gap, value_gap)
    cfg = SearchConfig(expand_thresh=2, no_sim=True, max_turns=80, max_nodes=128, use_kernel=True, eval_every=2)
    result = selfplay({"pv": net.inference()}, mcts.pv_evaluator(), cfg, 8, 2, 16, device=dev)
    assert (result.actions < NN).all()
