"""The port's small host-side modules: the ``gnugo`` bridge (a copy, held
to the original's behaviour; no ``gnugo`` binary is expected here, so the
absent-binary branch is what runs) and ``utils/metrics`` (the cases of
``tests/test_misc.py::test_metrics`` plus what differs in the port:
blocking on tensors, the profiler trace with a span of the program's
recorder in it; the recorder itself is ``tests/test_torch_trace.py``'s)."""

import json
import os

import pytest
import torch

from bokego_tpu import gnugo as jgnugo
from bokego_tpu.utils.metrics import Counter as JCounter, Metrics as JMetrics
from bokego_tpu_torch import gnugo, sgf
from bokego_tpu_torch.utils import metrics
from bokego_tpu_torch.utils.metrics import Counter, Metrics
from tests.torch_port_util import to_port  # noqa: F401  (sets torch threads)


def test_gnugo_absent_fallback(tmp_path):
    """Without gnugo installed every call returns None and touches no file,
    as in the JAX package; with it, a score comes back."""
    assert gnugo.available() == jgnugo.available()
    path = os.path.join(tmp_path, "game.sgf")
    text = sgf.write_sgf([40, 30, -1, -1], path, komi=5.5)
    if gnugo.available():
        assert gnugo.gnu_score_moves([40, 30]) in (1, -1)
        assert gnugo.gnu_final_score_sgf(path)
    else:
        assert gnugo.gnu_score_moves([40, 30]) is jgnugo.gnu_score_moves([40, 30]) is None
        assert gnugo.gnu_final_score_sgf(path) is jgnugo.gnu_final_score_sgf(path) is None
        assert gnugo.annotate_results([path]) == jgnugo.annotate_results([path]) == {}
        with open(path) as f:
            assert f.read() == text  # left as it was


def test_gnugo_annotate_skips_scored_games(tmp_path):
    """A game that carries ``RE[]`` already is never sent to gnugo."""
    path = os.path.join(tmp_path, "scored.sgf")
    sgf.write_sgf([40, 30], path, result="B+2.5")
    assert gnugo.annotate_results([path]) == {}
    assert sgf.read_result(path) == "B+2.5"


def test_metrics():
    m, jm = Metrics(), JMetrics()
    for x in (m, jm):
        with x.phase("rollout", n=100):
            pass
        x.count("expansions", 3)
        x.count("expansions")
    assert m.phases["rollout"].count == jm.phases["rollout"].count == 100
    assert m.counters == jm.counters == {"expansions": 4.0}
    assert "rollout" in m.report() and "expansions: 4" in m.report()
    assert [line.split(":")[0] for line in m.report().splitlines()] == [
        line.split(":")[0] for line in jm.report().splitlines()
    ]
    assert m.rollouts_per_sec() > 0 and m.games_per_min() == 0.0


def test_counter_copy_equals_original():
    c, jc = Counter(), JCounter()
    assert (c.rate, c.mean) == (jc.rate, jc.mean) == (0.0, 0.0)
    for x in (c, jc):
        x.add(0.5, 10)
        x.add(1.5)
    assert (c.total, c.count, c.rate, c.mean) == (jc.total, jc.count, jc.rate, jc.mean) == (2.0, 11, 5.5, 2.0 / 11)


def test_phase_blocks_on_nested_tensors(monkeypatch):
    """``block_on`` takes a tensor or a nest (a ``Tree``, a dict of nets'
    outputs): CPU tensors need no wait, every CUDA device among them is
    synchronised once."""
    from bokego_tpu_torch.config import SearchConfig
    from bokego_tpu_torch.env import state as st
    from bokego_tpu_torch.search import mcts
    from tests.torch_fake_eval import fake_evaluator

    trees = mcts.init_trees(st.new_game_batch(2, device="cpu"), fake_evaluator(), None, SearchConfig(max_nodes=128))
    assert len(list(metrics._tensors({"a": [trees, torch.zeros(1)], "b": (None, 3)}))) == 17  # 7 + 9 + 1
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    m = Metrics()
    with m.phase("step", n=2, block_on=trees):
        pass
    assert synced == [] and m.phases["step"].count == 2

    class OnCard:  # a stand-in for a CUDA tensor: only these two attributes are read
        is_cuda, device = True, torch.device("cuda", 0)

    monkeypatch.setattr(metrics, "_tensors", lambda tree: [OnCard(), OnCard(), torch.zeros(1)])
    with m.phase("step", block_on=object()):
        pass
    assert synced == [torch.device("cuda", 0)] and m.phases["step"].count == 3


def test_device_trace_and_annotate_without_a_gpu(tmp_path):
    """On a machine without a GPU the trace holds host events only, and a
    span of the program's recorder is a ``user_annotation`` event in it."""
    if torch.cuda.is_available():
        pytest.skip("the CPU-only branches; the card-side ones run in tests/test_torch_cuda.py")
    log_dir = os.path.join(tmp_path, "trace")
    with metrics.recording() as rec, metrics.device_trace(log_dir):
        with metrics.span("add"):
            torch.ones(8) + 1
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "add" and e.get("cat") == "user_annotation" for e in events)
    assert not any(e.get("cat") == "kernel" for e in events)
    assert rec.phases["add"].count == 1
