"""The port's headline bench and its bf16 route, the serving-latency and
scaling tools, against the JAX package and the JAX ``bench.py`` on the CPU.

Weights come across from the JAX package with ``convert.from_flax``: the
bench's random-init nets (``init_policy(PRNGKey(0))``,
``init_value(PRNGKey(1))``) and the shipped ``policy_17_flax`` and
``value_r2``, at the full width of 128 channels.

* The bf16 evaluator (``net_evaluator(dtype=torch.bfloat16)``: all three
  members) against the JAX ``net_evaluator(True, dtype=jnp.bfloat16)`` on
  the same numpy-seeded positions (B=32): within ``ATOL_BF16`` = 1e-4 on
  probabilities and values.  Measured here: random-init nets 1.7e-7 and
  2.1e-8, shipped nets 8.9e-7 and 1.9e-6; the JAX package's own bf16 and
  fp32 results differ by 1.7e-2 and 2.1e-2 on the shipped nets, and the
  port's by more than 100 times the tolerance.
* The per-layer compute dtypes of the port's forward (forward hooks on the
  convolutions and linears) equal those of the JAX forward's jaxpr: bf16
  for the stem convolution only, float32 for the rest (and every layer in
  float32 without ``dtype``).
* The two routes of bf16, parameters rounded on each call and nets stored
  in bf16 once, give the same bits; ``dtype=None`` gives the bits of the
  stock layers' forward, the evaluator before the bf16 route.
* The bench's nets: ``data/weights/jax_init_policy_key0.pt`` and
  ``jax_init_value_key1.pt`` hold ``convert.from_flax`` of the JAX bench's
  random-init nets bit for bit, and ``bench.bench_nets``, ``mfu_report``
  and ``parallel.scaling`` load exactly those tensors; a missing or
  unreadable file raises.
* The bench's ``one_move`` with those nets equals the JAX bench's move
  (rebuilt here from ``bench.py``'s body, which nests it) state for state
  and ``done`` for ``done``, in fp32: on the non-kernel path
  (``use_kernel=False, eval_every=1``) over the bench's whole game, 81
  moves at B=8 and 8 rollouts; on the kernel path (the port's plain
  versions against Pallas in interpret mode) over 4 moves at B=8 and 8
  rollouts, and over 3 moves at B=2 and the bench's 400 rollouts.
* ``bench_game``'s buckets and per-move forwards at the CPU's size.
* ``python -m bokego_tpu_torch.bench``: its JSON line's keys, the CPU smoke
  configuration with ``"smoke": true``, the environment variables, and a
  non-zero exit without a GPU and without ``--device cpu``.
* ``serving_latency`` at ``--time 0.2 --trials 1 --device cpu`` and
  ``parallel.scaling 2 2 --device cpu`` print their lines; root visits
  grew on both paths; the sharded actions and scores are IDENTICAL.
"""

import copy
import dataclasses
import functools
import json
import os
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bokego_tpu import features as jfeatures
from bokego_tpu.config import SearchConfig as JConfig
from bokego_tpu.coords import PASS_ACTION as JPASS
from bokego_tpu.env import rules as jrules, state as jst
from bokego_tpu.models import inference as jinference
from bokego_tpu.models import init_policy as jinit_policy, init_value as jinit_value
from bokego_tpu.search import mcts as jmcts
from bokego_tpu.train import checkpoints as jcheckpoints
from bokego_tpu_torch import bench, bench_game, mfu_report, serving_latency
from bokego_tpu_torch.config import BENCH_BATCH, BENCH_CONFIG, BENCH_POLICY_WEIGHTS, BENCH_VALUE_WEIGHTS
from bokego_tpu_torch.models import convert, inference, nets
from bokego_tpu_torch.parallel import scaling
from bokego_tpu_torch.search import mcts
from bokego_tpu_torch.utils import metrics
from tests.torch_port_util import assert_states_equal, random_positions, to_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL_BF16 = 1e-4  # bf16 evaluator against the JAX one, probabilities and values
ATOL = 1e-5  # float32 nets against the JAX package (tests/test_torch_models.py)
BATCH = 32
WEIGHTS = ("random-init", "shipped")


@functools.lru_cache(maxsize=None)
def _jax_vars(which: str) -> dict:
    """The JAX variables as numpy arrays (read-only: shared by the tests)."""
    if which == "random-init":
        params = {"policy": jinit_policy(jax.random.PRNGKey(0)), "value": jinit_value(jax.random.PRNGKey(1))}
    else:
        weights = os.path.join(REPO, "data", "weights")
        params = {kind: jcheckpoints.load_variables(os.path.join(weights, name))
                  for kind, name in (("policy", "policy_17_flax"), ("value", "value_r2"))}
    return jax.tree.map(np.asarray, params)


def _port_nets(params: dict) -> dict:
    out = {}
    for kind, cls in (("policy", nets.PolicyNet), ("value", nets.ValueNet)):
        net = cls()
        net.load_state_dict(convert.from_flax(params[kind]))
        out[kind] = net.eval()
    return out


@pytest.fixture(scope="module", params=WEIGHTS)
def weights(request):
    params = _jax_vars(request.param)
    return request.param, params, _port_nets(params)


@pytest.fixture(scope="module")
def positions():
    js = random_positions(5, BATCH, 30, pass_prob=0.05)
    return js, to_port(js), np.asarray(jax.jit(jfeatures.features_batch)(js))


def test_bf16_evaluator_matches_jax(weights, positions):
    name, params, port = weights
    js, ts, fts = positions
    jev = jmcts.net_evaluator(True, dtype=jnp.bfloat16)
    tev = mcts.net_evaluator(True, dtype=torch.bfloat16)
    want_p, want_v = (np.asarray(a) for a in jax.jit(jev.evaluate_fts)(params, fts))
    got_p, got_v = tev.evaluate_fts(port, torch.from_numpy(fts.copy()))
    assert got_p.dtype == got_v.dtype == torch.float32
    np.testing.assert_allclose(got_p.numpy(), want_p, rtol=0, atol=ATOL_BF16)
    np.testing.assert_allclose(got_v.numpy(), want_v, rtol=0, atol=ATOL_BF16)
    # the members over states take the same route
    ev_p, ev_v = tev.evaluate(port, ts)
    assert torch.equal(ev_p, got_p) and torch.equal(ev_v, got_v)
    jp = np.asarray(jax.jit(jev.policy_probs)(params, js))
    np.testing.assert_allclose(tev.policy_probs(port, ts).numpy(), jp, rtol=0, atol=ATOL_BF16)
    if name == "shipped":
        # the route is not float32 in disguise
        f32_p, f32_v = mcts.net_evaluator(True).evaluate_fts(port, torch.from_numpy(fts.copy()))
        assert float((f32_p - got_p).abs().max()) > 100 * ATOL_BF16
        assert float((f32_v - got_v).abs().max()) > 100 * ATOL_BF16


def _jax_layer_dtypes(params, fts, dtype) -> list[tuple[str, str]]:
    """(input, output) dtype of every convolution and dot product in the
    jaxpr of the JAX evaluator's ``evaluate_fts``, in order."""
    jaxpr = jax.make_jaxpr(jmcts.net_evaluator(True, dtype=dtype).evaluate_fts)(params, fts)
    found = []

    def walk(jp):
        for eqn in jp.eqns:
            if eqn.primitive.name in ("conv_general_dilated", "dot_general"):
                found.append((str(eqn.invars[0].aval.dtype), str(eqn.outvars[0].aval.dtype)))
            for p in eqn.params.values():
                sub = getattr(p, "jaxpr", p)
                if hasattr(sub, "eqns"):
                    walk(sub)

    walk(jaxpr.jaxpr)
    return found


def _port_layer_dtypes(port, fts, dtype, stored: bool) -> list[tuple[str, str]]:
    """The same list from forward hooks on the port's convolutions and
    linears, per-call or stored route."""
    if stored:
        port = {k: copy.deepcopy(net).to(dtype) for k, net in port.items()}
    found, handles = [], []
    names = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
    for net in port.values():
        for m in net.modules():
            if isinstance(m, (nets.Conv2d, nets.UntiedBiasConv, nets.Linear)):
                handles.append(m.register_forward_hook(
                    lambda m, args, out: found.append((names[args[0].dtype], names[out.dtype]))))
    try:
        mcts.net_evaluator(True, dtype=dtype).evaluate_fts(port, torch.from_numpy(fts.copy()))
    finally:
        for h in handles:
            h.remove()
    return found


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_layer_compute_dtypes_match_jax_graph(dtype, positions):
    params = _jax_vars("random-init")
    port = _port_nets(params)
    fts = positions[2][:4]
    want = _jax_layer_dtypes(params, fts, jnp.bfloat16 if dtype == "bf16" else None)
    # policy: 5x5 stem, six 3x3, the 1x1 head; value: the same and two dense layers
    assert len(want) == 8 + 10
    stem = ("bfloat16", "bfloat16") if dtype == "bf16" else ("float32", "float32")
    assert want == [stem] + [("float32", "float32")] * 7 + [stem] + [("float32", "float32")] * 9
    tdtype = torch.bfloat16 if dtype == "bf16" else None
    for stored in ((False, True) if tdtype else (False,)):
        assert _port_layer_dtypes(port, fts, tdtype, stored) == want


def test_bf16_routes_give_the_same_bits(weights, positions):
    _, _, port = weights
    _, ts, fts = positions
    stored = {k: copy.deepcopy(net).to(torch.bfloat16) for k, net in port.items()}
    assert all(t.dtype == torch.bfloat16 for net in stored.values() for t in net.parameters())
    ev = mcts.net_evaluator(True, dtype=torch.bfloat16)
    x = torch.from_numpy(fts.copy())
    per_call, once = ev.evaluate_fts(port, x), ev.evaluate_fts(stored, x)
    assert torch.equal(per_call[0], once[0]) and torch.equal(per_call[1], once[1])
    assert torch.equal(ev.policy_probs(port, ts), ev.policy_probs(stored, ts))
    # the per-call route leaves the float32 modules as they were
    assert all(t.dtype == torch.float32 for net in port.values() for t in net.parameters())


def _stock(net, x: torch.Tensor) -> torch.Tensor:
    """A net's forward through the stock torch layers (the code before the
    bf16 route)."""

    def layer(m, h):
        for stock in (torch.nn.Conv2d, torch.nn.BatchNorm2d, torch.nn.BatchNorm1d, torch.nn.Linear):
            if isinstance(m, stock):
                return stock.forward(m, h)
        if isinstance(m, nets.UntiedBiasConv):
            return torch.nn.functional.conv2d(h, m.weight) + m.bias
        return m(h)

    h = x.permute(0, 3, 1, 2)
    for m in net.conv:
        h = layer(m, h)
    if isinstance(net, nets.PolicyNet):
        return h.reshape(x.shape[0], 81)
    h = torch.relu(layer(net.bn, h)).reshape(x.shape[0], 81)
    h = torch.relu(layer(net.lin_bn, layer(net.lin1, h)))
    return torch.tanh(layer(net.lin2, h))


def test_fp32_evaluator_unchanged(weights, positions):
    _, _, port = weights
    _, _, fts = positions
    x = torch.from_numpy(fts.copy())
    probs, vals = mcts.net_evaluator(True).evaluate_fts(port, x)
    with torch.inference_mode():
        assert torch.equal(probs, torch.softmax(_stock(port["policy"], x), -1))
        assert torch.equal(vals, _stock(port["value"], x)[:, 0])


def test_policy_logits_and_policy_value_states_match_jax(weights, positions):
    _, params, port = weights
    js, ts, fts = positions
    want = np.asarray(jax.jit(jinference.policy_logits)(params["policy"], fts))
    got = inference.policy_logits(port["policy"], torch.from_numpy(fts.copy())).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=ATOL)
    want_p, want_v = jax.jit(jinference.policy_value_states)(params["policy"], params["value"], js)
    got_p, got_v = inference.policy_value_states(port["policy"], port["value"], ts)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=0, atol=ATOL)


def _same_tensors(got: dict, want: dict) -> None:
    """Every tensor of ``want`` is in ``got`` with its dtype and its bits,
    and ``got`` has no other."""
    assert set(got) == set(want)
    for k, t in want.items():
        assert got[k].dtype == t.dtype and torch.equal(got[k].cpu(), t), k


class _Searched(Exception):
    """Raised with the nets of the first search a tool runs."""


def test_bench_nets_are_the_jax_bench_nets(monkeypatch):
    """The shipped files hold ``convert.from_flax`` of the JAX bench's
    ``init_policy(PRNGKey(0))`` and ``init_value(PRNGKey(1))`` bit for bit,
    BatchNorm statistics included; the bench, ``mfu_report`` and
    ``parallel.scaling`` play exactly those tensors."""
    want = {kind: convert.from_flax(v) for kind, v in _jax_vars("random-init").items()}
    for kind, path in (("policy", BENCH_POLICY_WEIGHTS), ("value", BENCH_VALUE_WEIGHTS)):
        _same_tensors(torch.load(path, map_location="cpu", weights_only=True)["model_state_dict"], want[kind])
    assert any("running_var" in k for k in want["policy"]) and any("lin_bn.running_mean" in k for k in want["value"])

    def same_nets(params):
        for kind in ("policy", "value"):
            _same_tensors(params[kind].state_dict(), want[kind])
            assert not params[kind].training

    same_nets(bench.bench_nets("cpu", "fp32")[0])
    same_nets(scaling._setup(torch.device("cpu"))[0])

    def searched(states, ev, params, cfg):
        raise _Searched(params)

    monkeypatch.setattr(mfu_report, "search_move", searched)
    with pytest.raises(_Searched) as seen:
        mfu_report.report(torch.device("cpu"), 8, 16, 4)
    same_nets(seen.value.args[0])


def test_bench_without_its_weights_raises(monkeypatch, tmp_path):
    """A missing or unreadable weight file raises: no seeded draw stands in."""
    monkeypatch.setattr(bench, "BENCH_POLICY_WEIGHTS", str(tmp_path / "missing.pt"))
    with pytest.raises(FileNotFoundError):
        bench.bench_nets("cpu", "fp32")
    bad = tmp_path / "bad.pt"
    bad.write_bytes(b"not a checkpoint")
    monkeypatch.setattr(bench, "BENCH_POLICY_WEIGHTS", str(bad))
    with pytest.raises(pickle.UnpicklingError):
        bench.bench_nets("cpu", "fp32")


@pytest.mark.parametrize(
    "kernel,moves,batch,n_rollouts", [(False, 81, 8, 8), (True, 4, 8, 8), (True, 3, 2, 400)],
    ids=["plain", "kernel", "kernel400"],
)
def test_one_move_matches_jax_bench(kernel, moves, batch, n_rollouts):
    """``bench.py``'s move, rebuilt from its body: the CPU configuration
    over the bench's whole game and one move past it (81 moves: every game
    is done at ``max_turns=80`` and then passes), the card's kernel
    configuration at the CPU's sizes, and at its 400 rollouts on two
    boards, where leaves reach ``expand_thresh=100`` and expand.  The port
    side plays ``bench.bench_nets``."""
    jcfg = JConfig(
        expand_thresh=100, no_sim=True, max_turns=80, max_nodes=512, n_rollouts=n_rollouts,
        use_kernel=kernel, kernel_block=64, kernel_levels=6, eval_every=8 if kernel else 1,
    )
    params = _jax_vars("random-init")  # init_policy(PRNGKey(0)), init_value(PRNGKey(1))
    jev = jmcts.net_evaluator(has_value=True)

    @jax.jit
    def jax_move(rng, states, done):
        actions, _ = jmcts.search(rng, states, jev, params, jcfg, n_rollouts)
        actions = jnp.where(done, JPASS, actions)
        nxt = jrules.step_batch(states, actions)
        done = done | jrules.is_terminal_batch(nxt, jcfg.max_turns)
        return nxt, done

    cfg = dataclasses.replace(BENCH_CONFIG, n_rollouts=n_rollouts)
    if not kernel:
        cfg = dataclasses.replace(cfg, use_kernel=False, eval_every=1)
        assert bench.settings(torch.device("cpu"), {}).cfg == cfg
    port, ev = bench.bench_nets("cpu", "fp32")
    rng = jax.random.PRNGKey(42)
    js, jdone = jst.new_game_batch(batch), jnp.zeros((batch,), bool)
    ts, tdone = to_port(js), torch.zeros(batch, dtype=torch.bool)
    forwards = []
    for _ in range(moves):
        rng, r = jax.random.split(rng)
        js, jdone = jax_move(r, js, jdone)
        with metrics.recording() as rec, mfu_report.counting(ev) as (cev, counts):
            ts, tdone = bench.one_move(ts, tdone, cev, port, cfg, n_rollouts)
        forwards.append(len(counts.forwards))
        assert_states_equal(js, ts)
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        # CPU tensors take the plain versions: no kernel launch.  The search's
        # spans: one expansion a forward; the kernel path one K1 call a rollout
        # group and no descent, the plain path one descent and one backprop a
        # rollout
        assert not [k for k in counts.counters if k.startswith("ops.")]
        assert counts.counters["search.rollouts"] == rec.counters["search.rollouts"] == n_rollouts
        k1 = len(mcts.rollout_groups(n_rollouts, cfg.eval_every)) if kernel else 0
        spans = {k: rec.phases[k].count for k in ("search.k1", "search.descend", "search.backprop", "search.expand")}
        assert spans == {"search.k1": k1, "search.descend": 0 if kernel else n_rollouts,
                         "search.backprop": 0 if kernel else n_rollouts, "search.expand": len(counts.forwards)}
    assert int(ts.turn.min()) == moves
    if moves > jcfg.max_turns:
        assert bool(tdone.all())
    if n_rollouts > jcfg.expand_thresh:
        assert min(forwards) > 1  # past init_trees' forward: leaves expanded on every move


def test_bench_json_line_and_smoke_configuration(capsys, monkeypatch):
    monkeypatch.delenv("BOKEGO_BENCH_DTYPE", raising=False)
    monkeypatch.setenv("BOKEGO_BENCH_BATCH", "64")  # read on the card only, as bench.py does
    bench.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "smoke"}
    assert out["smoke"] is True and out["vs_baseline"] is None and out["unit"] == "games/min/chip"
    assert out["value"] > 0
    assert out["metric"] == (
        "selfplay games/min/chip (9x9, 8 rollouts/move, 4 moves, batch 8, fp32, device cpu)"
    )
    monkeypatch.setenv("BOKEGO_BENCH_DTYPE", "bf16")
    bench.main(["--device", "cpu"])
    assert ", bf16, device cpu)" in json.loads(capsys.readouterr().out)["metric"]


def test_bench_settings_read_the_environment():
    card = torch.device("cuda")
    s = bench.settings(card, {})
    assert (s.batch, s.moves, s.rollouts, s.cfg, s.dtype) == (BENCH_BATCH, 80, 400, BENCH_CONFIG, "fp32")
    assert BENCH_BATCH == 1024 and BENCH_CONFIG.use_kernel and BENCH_CONFIG.eval_every == 8
    s = bench.settings(card, {"BOKEGO_BENCH_BATCH": "4096", "BOKEGO_BENCH_DTYPE": "bf16"})
    assert (s.batch, s.dtype) == (4096, "bf16")
    cpu = bench.settings(torch.device("cpu"), {"BOKEGO_BENCH_BATCH": "4096", "BOKEGO_BENCH_DTYPE": "bf16"})
    assert (cpu.batch, cpu.moves, cpu.rollouts, cpu.dtype) == (8, 4, 8, "bf16")
    assert not cpu.cfg.use_kernel and cpu.cfg.eval_every == 1 and cpu.cfg.n_rollouts == 8
    with pytest.raises(ValueError, match="BOKEGO_BENCH_DTYPE"):
        bench.settings(card, {"BOKEGO_BENCH_DTYPE": "fp16"})
    params, ev = bench.bench_nets("cpu", "bf16")
    assert all(t.dtype == torch.bfloat16 for net in params.values() for t in net.parameters())


def test_bench_without_a_gpu_exits_non_zero():
    proc = subprocess.run(
        [sys.executable, "-m", "bokego_tpu_torch.bench"], capture_output=True, text=True, timeout=120, cwd=REPO,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert proc.returncode != 0
    assert proc.stdout == ""  # no line: nothing ran on the CPU instead
    assert "no CUDA device" in proc.stderr


def test_serving_latency_on_the_cpu(capsys, monkeypatch):
    runs = []
    measure = serving_latency.measure

    def recorded(*args, **kwargs):
        runs.append(measure(*args, **kwargs))
        return runs[-1]

    monkeypatch.setattr(serving_latency, "measure", recorded)
    serving_latency.main(["--time", "0.2", "--trials", "1", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "config: default, forest 1, leaf_batch 1, 0.2s/trial, device cpu"
    assert [line.split(":")[0] for line in lines[1:]] == list(serving_latency.PATHS)
    for line in lines[1:]:
        assert float(re.search(r": ([\d,]+) rollouts/s", line).group(1).replace(",", "")) > 0
    (result,) = runs
    for path in serving_latency.PATHS:
        (grown, seconds), = result[path]
        assert grown >= 8 and seconds > 0  # at least one chunk of 8 rollouts
    assert result[serving_latency.PATHS[1]][0][0] == 400  # the count path: rollout(0.2 * 2000)


def test_scaling_on_the_cpu(capsys):
    scaling.main(["2", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    rows = re.findall(r"^\| (\d+) \| (\d+) \| [\d.]+ \| [\d.]+ \| [\d.]+ \|$", out, flags=re.M)
    assert rows == [("1", "2"), ("2", "4")]
    assert "sharded(n=2) vs single-device at equal batch+seed: actions IDENTICAL, scores IDENTICAL" in out


def test_bench_game_on_the_cpu(capsys, monkeypatch):
    """``bench_game``'s buckets sum its moves; each move's forwards are
    those ``mfu_report.counting`` counts around ``bench.one_move`` (every
    eval step of the CPU configuration runs one, and ``init_trees`` one);
    ``--nets seeded`` plays the port's seeded draws."""
    bench_game.main(["--device", "cpu", "--bucket", "3"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == (
        "nets bench (jax_init_policy_key0.pt, jax_init_value_key1.pt); batch 8, 8 rollouts a move, "
        "4 moves after a warm-up; device cpu"
    )
    rows = [line.split(" | ") for line in lines[3:-1]]
    assert [r[0] for r in rows] == ["| 1-3", "| 4-4", "| all"]
    assert [int(r[1]) for r in rows] == [27, 9, 36]  # 8 eval steps and init_trees a move
    last = json.loads(lines[-1])
    assert last["nets"] == "bench" and last["forwards"] == [9] * 4 and len(last["ms"]) == 4
    params, _, source = bench_game.game_nets("seeded", "cpu")
    assert source == "init_policy(seed=0), init_value(seed=1)"
    for kind, init in (("policy", nets.init_policy), ("value", nets.init_value)):
        _same_tensors(params[kind].state_dict(), init(device="cpu").state_dict())
    with pytest.raises(ValueError, match="nets"):
        bench_game.game_nets("random", "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_game.main([])  # no GPU and no --device cpu: nothing runs on the CPU instead
