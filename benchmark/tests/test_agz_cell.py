"""The AlphaGo Zero tower's cell on the CPU at the harness's tiny size (B=4,
8 rollouts, 2 s; the net at its published sizes): the result line traced
and untraced, a perturbed logit that the check must refuse, and weights
whose value head is dead, which the check must refuse though program and
reference agree."""

from __future__ import annotations

import json

import pytest

from benchmark.tests.conftest import ROOT, SEED, TINY, last_line, run_cli, run_here

CELL = "selfplay-agz40-b1024.newgames-pv"


def _expected_metrics(trace: int) -> set[str]:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    if trace == 0:
        return {m["name"] for m in bench["end_to_end"] if CELL in m.get("workloads", [CELL])}
    # a CPU run has no device trace: those metrics read nothing and are left out
    return {m["name"] for m in bench["per_layer"] if CELL in m["workloads"] and m["source"] != "device_trace"}


@pytest.mark.parametrize("trace", [0, 1])
def test_the_tower_cell_prints_a_valid_last_line(trace):
    rc, out, err = run_cli(["--workload", CELL, "--seed", str(SEED), "--trace", str(trace), *TINY])
    assert rc == 0, err[-3000:]
    line = last_line(out)
    assert list(line)[-1] == "check"
    assert line["correct"] is True, line["check"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == _expected_metrics(trace)
    assert trace or set(line["metrics"]) == {"setup_s", "selfplay_moves_per_s"}
    for m in line["metrics"].values():
        assert isinstance(m["value"], float) and m["value"] > 0 and m["unit"]
    if trace:
        assert set(line["missing"]) == {"agz.conv_roofline", "agz.device_idle_pct"}
    for name in ("logp_gap", "value_gap"):
        assert 0 < line["check"][name]["value"] <= line["check"][name]["limit"]
    assert line["check"]["forward_rows"]["value"] > 0 and line["check"]["leaf_successors"]["value"] > 0


def test_a_perturbed_logit_turns_correct_false(monkeypatch, capsys):
    from bokego_tpu_torch.models.resnet import ResNetPV

    plain = ResNetPV.heads

    def heads(self, h):
        logits, values = plain(self, h)
        logits = logits.clone()
        logits[:, 40] += 1.0
        return logits, values

    monkeypatch.setattr(ResNetPV, "heads", heads)
    rc, line = run_here(capsys, ["--workload", CELL, "--seed", str(SEED), *TINY])
    assert rc == 0 and line is not None
    assert line["correct"] is False, line["check"]
    assert line["check"]["logp_gap"]["value"] > line["check"]["logp_gap"]["limit"]


def test_a_dead_value_head_turns_correct_false(monkeypatch, capsys):
    from benchmark.reference import agz

    plain = agz.init_state

    def init_state(seed, **sizes):
        sd = plain(seed, **sizes)
        sd["value_fc2.weight"].zero_()
        return sd

    monkeypatch.setattr(agz, "init_state", init_state)
    rc, line = run_here(capsys, ["--workload", CELL, "--seed", str(SEED), *TINY])
    assert rc == 0 and line is not None
    check = line["check"]
    assert line["correct"] is False, check
    assert check["value_gap"]["value"] == 0.0  # the gap alone cannot see it
    assert check["value_dead_or_saturated_share"]["value"] == 1.0
    assert check["abs_value_median_above"]["value"] == 0.0
