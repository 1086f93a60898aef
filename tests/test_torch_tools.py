"""The port's measurement tools, ``bokego_tpu_torch/mfu_report.py`` and
``bokego_tpu_torch/sim_throughput.py``, against the JAX package and the JAX
tools under ``tools/`` on the CPU.

* FLOP counts: ``net_flops``'s valid-tap count equals the hand count
  exactly and lies within 0.5 % below XLA's ``cost_analysis`` of the JAX
  ``net_evaluator(True).evaluate_fts`` (XLA adds the elementwise ops); its
  nominal count equals ``torch.utils.flop_counter``'s over the port's nets
  exactly; the parameter bytes equal the Flax variables' ``params``.
* The forwards and K1 calls counted around a small ``run_search`` (the
  kernels' plain versions) equal the JAX tool's ``ceil(rollouts/E) + 1``
  model and ``len(rollout_groups(...))``.
* Both entry points at CPU sizes print "not measured" for every device
  time, share and rate, and raise without a GPU unless ``--device cpu``.
* ``sim_throughput``'s runs with a 16-channel net pair carried across with
  ``from_flax`` and the one-hot playout policy: midgame states exact, root
  visits and Wq exact, Wv within 1e-5 of the JAX package's ``run_search``
  on the same states; its ``SearchConfig`` is the JAX tool's field for field.
"""

import ast
import dataclasses
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from bokego_tpu.config import SearchConfig as JConfig
from bokego_tpu.env import state as jst
from bokego_tpu.models import init_policy as jinit_policy, init_value as jinit_value
from bokego_tpu.search import mcts as jmcts
from bokego_tpu.search import playout as jpo
from bokego_tpu_torch import mfu_report, sim_throughput
from bokego_tpu_torch.config import SearchConfig as TConfig
from bokego_tpu_torch.models import nets
from bokego_tpu_torch.search import mcts
from bokego_tpu_torch.utils import metrics
from tests.test_mcts import fake_evaluator as jax_fake_evaluator
from tests.test_torch_models import ATOL, _flax_vars, _jax_evaluator, _port_net
from tests.test_torch_playout import jax_onehot_policy
from tests.torch_fake_eval import fake_evaluator, onehot_policy
from tests.torch_port_util import assert_states_equal, random_positions, to_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VALID_TAPS_B8 = 2_134_706_176  # 8 x 266,838,272: the convolutions' on-board taps and the linears, 128 channels
XLA_B8 = 2_140_525_568  # XLA's cost_analysis of evaluate_fts at B=8, 128 channels (CPU)


@pytest.mark.parametrize("k", [1, 3, 5, 7])
def test_valid_taps_match_a_convolution_of_ones(k):
    """The on-board (output, tap) pairs of a "same" k x k convolution on 9x9,
    counted by convolving a board of ones with a kernel of ones."""
    ones = torch.nn.functional.conv2d(torch.ones(1, 1, 9, 9), torch.ones(1, 1, k, k), padding=k // 2)
    assert mfu_report._taps(k, k // 2) ** 2 == int(ones.sum())


def test_net_flops_valid_taps_exact_and_below_xla():
    valid, nominal = mfu_report.net_flops(128, 8)
    assert valid == VALID_TAPS_B8
    # by hand: a 5x5 layer 27 -> C, six 3x3 layers C -> C, the 1x1 head, per net; the value net's linears
    per_net = 1521 * 27 * 128 + 6 * 625 * 128 * 128 + 81 * 128
    assert valid == 8 * 2 * (2 * per_net + 81 * 64 + 64)
    assert nominal == 8 * 2 * (2 * (2025 * 27 * 128 + 6 * 729 * 128 * 128 + 81 * 128) + 81 * 64 + 64)

    ev = jmcts.net_evaluator(True)
    params = {"policy": jinit_policy(jax.random.PRNGKey(0)), "value": jinit_value(jax.random.PRNGKey(1))}
    fts = np.zeros((8, 9, 9, 27), np.float32)
    cost = jax.jit(ev.evaluate_fts).lower(params, fts).compile().cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    xla = float(cost["flops"])
    assert xla == XLA_B8
    assert 0.0 <= (xla - valid) / xla <= 0.005


@pytest.mark.parametrize("channels", [128, 16])
def test_nominal_flops_equal_flop_counter(channels):
    from torch.utils.flop_counter import FlopCounterMode

    pol, val = nets.init_policy(channels, device="cpu"), nets.init_value(channels, device="cpu")
    fts = torch.zeros(8, 9, 9, 27)
    with FlopCounterMode(display=False) as fc, torch.inference_mode():
        pol(fts)
        val(fts)
    assert mfu_report.net_flops(channels, 8)[1] == fc.get_total_flops()
    conv_valid, conv_nominal = mfu_report.net_flops(channels, 8, convs_only=True)
    assert conv_nominal == fc.get_total_flops() - 8 * 2 * (81 * 64 + 64)
    assert conv_valid < conv_nominal


def test_forward_bytes_count_the_flax_parameters():
    flax = sum(
        np.asarray(x).size
        for init, seed in ((jinit_policy, 0), (jinit_value, 1))
        for x in jax.tree.leaves(init(jax.random.PRNGKey(seed))["params"])
    )
    assert mfu_report.param_bytes(128) == 4 * flax == 7_814_036
    assert mfu_report.forward_bytes(128, 8) == 7_814_036 + 4 * 8 * (81 * 27 + 82)


def test_bound_ms_takes_the_larger_time():
    assert mfu_report.bound_ms(3.35e9, 0) == pytest.approx((1.0, "bytes"))
    assert mfu_report.bound_ms(0, 67e9) == pytest.approx((1.0, "operations"))
    assert mfu_report.bound_ms(0, 495e9, peak_ops=mfu_report.TF32_FLOPS) == pytest.approx((1.0, "operations"))


@pytest.mark.parametrize("batch,rollouts,eval_every", [(8, 16, 4), (8, 16, 8), (4, 13, 3)])
def test_move_counts_match_the_jax_tool_model(batch, rollouts, eval_every):
    """Forwards and K1 calls of a move on the kernel path (plain versions on
    the CPU: no launch is counted).  At these sizes every eval step has
    work, so the forwards run are the JAX tool's model."""
    cfg = dataclasses.replace(mfu_report.BENCH_CONFIG, n_rollouts=rollouts, eval_every=eval_every)
    params = {"policy": nets.init_policy(16, seed=0, device="cpu"), "value": nets.init_value(16, seed=1, device="cpu")}
    states = sim_throughput.midgame(torch.Generator().manual_seed(0), lambda s: onehot_policy(None, s), batch, 6, "cpu")
    with metrics.recording() as outer:
        with mfu_report.counting(mcts.net_evaluator()) as (ev, counts):
            mfu_report.search_move(states, ev, params, cfg)
        metrics.count("after")  # counting gave the outer recorder back, with its counts
    assert outer.counters == {**counts.counters, "after": 1} and counts.counters["search.rollouts"] == rollouts
    assert len(counts.forwards) == math.ceil(rollouts / eval_every) + 1 == mfu_report.eval_model(rollouts, eval_every)
    assert counts.forwards == [batch] * len(counts.forwards)
    assert not [k for k in counts.counters if k.startswith("ops.")]
    # counting records no span: the outer recorder's spans are the move's, one
    # K1 call a rollout group, one expansion a forward, no K3/K4 descent
    assert outer.phases["search.k1"].count == len(mcts.rollout_groups(rollouts, eval_every))
    assert outer.phases["search.expand"].count == len(counts.forwards) and "search.descend" not in outer.phases
    # the replay rollout by rollout gives the trees of the grouped search, and counts K1's bytes
    n_bytes, n_ops, replayed = mfu_report.k1_move_work(states, mcts.net_evaluator(), params, cfg)
    grouped = mcts.run_search(mcts.init_trees(states, mcts.net_evaluator(), params, cfg), mcts.net_evaluator(),
                              params, cfg, rollouts)
    for f in ("pstats", "root_stats", "n_nodes", "parent", "value"):
        torch.testing.assert_close(getattr(replayed, f), getattr(grouped, f), rtol=0, atol=0, equal_nan=True)
    assert n_bytes > batch * (8 + 12 + 12 + 4 + 512) and n_ops > 0


def _jax_counting(ev, calls: list):
    """A JAX evaluator that appends each executed forward's batch to
    ``calls`` (``jax.debug.callback`` runs only where the forward runs, so an
    eval step that ``lax.cond`` skips adds nothing)."""

    def counted(fn):
        def call(params, x):
            jax.debug.callback(lambda b: calls.append(int(b)), x.board.shape[0] if hasattr(x, "board") else x.shape[0])
            return fn(params, x)

        return call

    return ev._replace(
        evaluate=counted(ev.evaluate), evaluate_fts=counted(ev.evaluate_fts) if ev.evaluate_fts else None
    )


@pytest.mark.parametrize("batch,rollouts,eval_every", [(2, 64, 4), (1, 96, 8)])
def test_executed_forwards_match_the_jax_package(batch, rollouts, eval_every):
    """An eval step on which no tree has work skips its forward, here as in
    the JAX package (``lax.cond``): the forwards executed equal the JAX
    search's, and fall below the JAX tool's ``ceil(rollouts/E) + 1`` model."""
    cfg = dict(
        expand_thresh=100, no_sim=True, max_turns=80, max_nodes=128, n_rollouts=rollouts, use_kernel=True,
        kernel_block=4, kernel_levels=6, eval_every=eval_every,
    )
    js = random_positions(31, batch, 10, pass_prob=0.05)
    calls = []
    jev = _jax_counting(jax_fake_evaluator(), calls)
    jt = jmcts.init_trees(jax.random.PRNGKey(0), js, jev, None, JConfig(**cfg))
    jt = jax.jit(lambda t: jmcts.run_search(jax.random.PRNGKey(0), t, jev, None, JConfig(**cfg), rollouts))(jt)
    jax.block_until_ready(jt)
    jax.effects_barrier()

    with metrics.recording() as rec, mfu_report.counting(fake_evaluator()) as (tev, counts):
        trees = mcts.run_search(mcts.init_trees(to_port(js), tev, None, TConfig(**cfg)), tev, None, TConfig(**cfg),
                                rollouts)
    np.testing.assert_array_equal(trees.root_stats.numpy(), np.asarray(jt.root_stats))
    assert counts.forwards == calls == [batch] * len(calls)
    assert len(calls) < mfu_report.eval_model(rollouts, eval_every)
    assert rec.phases["search.k1"].count == len(mcts.rollout_groups(rollouts, eval_every))


def _run(module: str, *args: str) -> str:
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-m", module, *args], cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )
    assert r.returncode == 0, r.stderr
    return r.stdout


def test_mfu_report_on_the_cpu_prints_counts_only():
    out = _run("bokego_tpu_torch.mfu_report", "--device", "cpu")
    rows = [line for line in out.splitlines() if line.startswith("| ") and not line.startswith("| phase")]
    assert len(rows) == 7
    assert "| eval phases (4; 4 ran a forward) |" in out
    for line in rows:
        cells = [c.strip() for c in line.strip("|").split("|")]
        assert cells[3:7] == ["not measured"] * 4, line
    assert "batch=8 rollouts=16 eval_every=4" in out
    net = rows[0].split("|")[2].strip()
    assert net == f"{VALID_TAPS_B8 / 1e9:.2f} / {mfu_report.net_flops(128, 8)[1] / 1e9:.2f}"
    assert "forwards 5 at batches [8] (the JAX tool's model ceil(16/4)+1 = 5); K1 calls 5 running 16" in out
    assert "rollouts/s (batched): not measured; move latency not measured; games/min/chip not measured" in out
    assert "TFLOP/s," not in out.split("\n", 2)[2]  # no measured rate past the peaks line


@pytest.mark.parametrize("module", [mfu_report, sim_throughput])
def test_entry_points_need_a_gpu(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main([])


def test_sim_throughput_on_the_cpu_prints_not_measured(capsys):
    sim_throughput.main(["--device", "cpu", "--batch", "2", "--rollouts", "2", "--midgame-plies", "60"])
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == (
        "sim-mode: not measured rollouts/s/chip at B=2 (each rollout = full policy playout to terminal; "
        "midgame start ply 60)"
    )
    assert out[-2].startswith("playouts: ") and out[-2].endswith("not measured ms a ply")


def _jax_tool_config() -> dict:
    """The keywords of the ``SearchConfig(...)`` call in the JAX tool."""
    with open(os.path.join(REPO, "tools", "measure_sim_throughput.py")) as f:
        tree = ast.parse(f.read())
    calls = [
        n for n in ast.walk(tree)
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Name) and n.func.id == "SearchConfig"
    ]
    assert len(calls) == 1
    return {k.arg: ast.literal_eval(k.value) for k in calls[0].keywords}


def test_sim_config_is_the_jax_tools():
    want = dataclasses.asdict(JConfig(**_jax_tool_config()))
    assert dataclasses.asdict(sim_throughput.CONFIG) == want


def test_sim_runs_match_jax():
    """B=2, 2 rollouts a run, 4 midgame plies, one warm and one timed run:
    the JAX tool's sequence of ``init_trees`` and ``run_search`` calls."""
    batch, rollouts, plies = 2, 2, 4
    pv, vv = _flax_vars("policy", 6), _flax_vars("value", 7)
    jparams = {"policy": pv, "value": vv}
    tparams = {"policy": _port_net("policy", pv), "value": _port_net("value", vv)}
    jcfg = JConfig(**_jax_tool_config())

    jprobs = lambda s: jax_onehot_policy(None, s)  # noqa: E731
    js = jpo.playout(jax.random.PRNGKey(0), jprobs, jprobs, jst.new_game_batch(batch), num_steps=plies,
                     max_turns=80).final
    jev = _jax_evaluator()._replace(policy_probs=jax_onehot_policy)
    run = jax.jit(lambda r, t: jmcts.run_search(r, t, jev, jparams, jcfg, rollouts))
    jt = jmcts.init_trees(jax.random.PRNGKey(0), js, jev, jparams, jcfg)
    for i in range(2):
        jt = run(jax.random.PRNGKey(i), jt)

    ts = sim_throughput.midgame(torch.Generator().manual_seed(0), lambda s: onehot_policy(None, s), batch, plies, "cpu")
    assert_states_equal(js, ts)
    tev = mcts.net_evaluator()._replace(policy_probs=onehot_policy)
    res = sim_throughput.sim_runs(ts, tev, tparams, sim_throughput.CONFIG, rollouts, 1, "cpu")
    tt = res.trees
    rs, jrs = tt.root_stats.numpy(), np.asarray(jt.root_stats)
    np.testing.assert_array_equal(rs[:, 0], jrs[:, 0])  # N
    np.testing.assert_array_equal(rs[:, 1], jrs[:, 1])  # Wq: playout rewards
    np.testing.assert_allclose(rs[:, 2], jrs[:, 2], rtol=0, atol=ATOL)  # Wv: the value net
    assert rs[:, 0].tolist() == [2.0 * rollouts] * batch
    assert float(np.abs(rs[:, 1]).sum()) > 0
    for f in ("n_nodes", "parent", "action", "expanded"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(), np.asarray(getattr(jt, f)), err_msg=f)
    assert len(res.seconds) == 1 and res.forwards[0] >= rollouts
