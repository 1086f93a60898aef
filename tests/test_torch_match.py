"""The port's match harness (``bokego_tpu_torch/match/``) against the JAX
package's match tools under ``tools/`` on the CPU.

Where no draw is made the games are held exactly (tolerance 0): every
move's actions, the final boards, the Tromp-Taylor scores and the win
vector of ``weights_match.play`` (two different 16-channel net pairs
carried across with ``from_flax``, no opening) and of ``config_match.play``
with ``(FAST, EXACT)`` (the kernels' plain versions against Pallas in
interpret mode); ``serving_match.play_game`` move for move, result string
and winner, with count-mode engines on the deterministic evaluator; and
the openings and ``policy_curve.play_side``'s final boards through one-hot
policies, whose draws are the same whatever the generator.  Where the
``torch.Generator`` streams differ from ``jax.random`` (real-net openings,
resolved scoring) the invariants are checked.  The JAX tools' move caps
are patched small with ``monkeypatch``; no file under ``tools/`` changes.
"""

import dataclasses
import os
import importlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

import tools.config_match as jcm
import tools.measure_fastmode_fidelity as jfid
import tools.policy_curve as jpc
import tools.serving_match as jsm
import tools.weights_match as jwm
from bokego_tpu.config import EngineConfig as JEngineConfig, SearchConfig as JConfig
from bokego_tpu.env import rules as jrules
from bokego_tpu.gtp.engine import GTPEngine as JEngine
from bokego_tpu.models import inference as jinference
from bokego_tpu.search import playout as jpo
from bokego_tpu_torch.config import EngineConfig, SearchConfig
from bokego_tpu_torch.coords import NN, PASS_ACTION
from bokego_tpu_torch.env import rules, state as st
from bokego_tpu_torch.gtp.engine import GTPEngine
from bokego_tpu_torch.match import common, config_match, fastmode_fidelity, policy_curve, serving_match
from bokego_tpu_torch.match import weights_match
from bokego_tpu_torch.models import nets
from bokego_tpu_torch.search import mcts
from tests.test_mcts import fake_evaluator as jax_fake_evaluator
from tests.test_torch_models import _flax_vars, _jax_evaluator, _port_net
from tests.test_torch_playout import jax_onehot_evaluator
from tests.test_torch_train_rl import jax_onehot_probs
from tests.torch_fake_eval import OneHotPolicyNet, fake_evaluator, onehot_evaluator
from tests.torch_port_util import assert_states_equal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOVES = 8  # the move cap of the batched games here
BATCH = 3
ROLLOUTS = 16


class _SharedJit:
    """Stands in for the ``jax`` module inside a JAX tool, whose ``play``
    jits a fresh lambda on every call: a function of the same code over
    the same closed-over values gets the function compiled the first time,
    so the cases of this file share one compile of each search."""

    def __init__(self):
        self._cache = {}

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, **kw):
        cells = tuple(c.cell_contents for c in fn.__closure__ or ())
        key = (fn.__code__, cells, tuple(sorted(kw.items())))
        if key not in self._cache:
            self._cache[key] = jax.jit(fn, **kw)
        return self._cache[key]


SHARED_JIT = _SharedJit()


_jstep = jax.jit(jrules.step_batch)
_jterminal = jax.jit(jrules.is_terminal_batch, static_argnums=1)
_jscore = jax.jit(jrules.score_batch)


class _Recorder:
    """Stands in for ``bokego_tpu.env.rules`` inside a JAX tool: records the
    actions of every move, the last states and the Tromp-Taylor scores (the
    same functions, jitted: the tool calls them op by op)."""

    def __init__(self):
        self.actions, self.final, self.scores = [], None, None

    def step_batch(self, states, actions):
        self.actions.append(np.asarray(actions))
        self.final = _jstep(states, actions)
        return self.final

    def is_terminal_batch(self, states, max_turns):
        return _jterminal(states, max_turns)

    def score_batch(self, states):
        self.scores = np.asarray(_jscore(states))
        return self.scores


@pytest.fixture
def jax_tool(monkeypatch):
    """Patch a JAX tool module for a run here: the small move cap, the
    shared jit and a recorder; returns the recorder."""

    def patch(module):
        monkeypatch.setattr(module, "N_MOVES", MOVES)
        monkeypatch.setattr(module, "jax", SHARED_JIT)
        rec = _Recorder()
        monkeypatch.setattr(module, "rules", rec)
        return rec

    for mod in (weights_match, config_match):
        monkeypatch.setattr(mod, "N_MOVES", MOVES)
    return patch


@pytest.fixture(scope="module")
def net_pairs():
    """Two different pairs of small nets: Flax variables and their port
    copies, and the matching evaluators."""
    jpairs, tpairs = [], []
    for seed in (1, 3):
        pv, vv = _flax_vars("policy", seed), _flax_vars("value", seed + 1)
        jpairs.append({"policy": pv, "value": vv})
        tpairs.append({"policy": _port_net("policy", pv), "value": _port_net("value", vv)})
    return jpairs, tpairs, _jax_evaluator(), mcts.net_evaluator()


@pytest.fixture(autouse=True)
def small_resolver(monkeypatch):
    """The dead-group resolver cut to 5 random games of up to 16 plies a
    board (63 of 96 on the card): on the CPU its full size takes seconds a
    board, and ``tests/test_torch_scoring.py`` holds it."""
    monkeypatch.setattr(common, "RESOLVE_PLAYOUTS", 5)
    monkeypatch.setattr(common, "RESOLVE_STEPS", 16)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _assert_games_equal(rec: _Recorder, games: common.Games, jwon) -> None:
    np.testing.assert_array_equal(games.actions.numpy(), np.stack(rec.actions).astype(np.int64))
    assert_states_equal(rec.final, games.final)
    np.testing.assert_array_equal(games.scores.numpy(), rec.scores)
    np.testing.assert_array_equal(games.won.numpy(), np.asarray(jwon))


@pytest.mark.parametrize("a_is_black", [True, False])
def test_weights_match_play_matches_jax(jax_tool, net_pairs, a_is_black):
    """Two weight sets at one config, no opening: move for move."""
    rec = jax_tool(jwm)
    (ja, jb), (ta, tb), jev, tev = net_pairs
    cfg = dict(expand_thresh=2, max_nodes=128, no_sim=True)
    jwon = jwm.play(jax.random.PRNGKey(0), ja, jb, jev, BATCH, JConfig(**cfg), ROLLOUTS, a_is_black, open_plies=0)
    games = weights_match.play(_gen(), ta, tb, tev, BATCH, SearchConfig(**cfg), ROLLOUTS, a_is_black,
                               open_plies=0, device="cpu")
    _assert_games_equal(rec, games, jwon)
    assert len({tuple(a) for a in games.actions.T.tolist()}) == 1  # no opening: the games are replicas
    assert len(set(games.actions[:, 0].tolist())) == MOVES  # and no pass before the cap


@pytest.mark.parametrize("a_is_black", [True, False])
def test_config_match_fast_vs_exact_matches_jax(jax_tool, net_pairs, a_is_black):
    """``(FAST, EXACT)`` of the fidelity tool, expansion threshold lowered so
    that the trees grow below the root: the kernel path's plain versions
    against Pallas interpret, move for move."""
    rec = jax_tool(jcm)
    for name in ("FAST", "EXACT"):
        assert dataclasses.asdict(getattr(fastmode_fidelity, name)) == dataclasses.asdict(getattr(jfid, name))
    (ja, _), (ta, _), jev, tev = net_pairs
    jfast, jexact = (dataclasses.replace(c, expand_thresh=2) for c in (jfid.FAST, jfid.EXACT))
    tfast, texact = (dataclasses.replace(c, expand_thresh=2) for c in (fastmode_fidelity.FAST, fastmode_fidelity.EXACT))
    jwon = jcm.play(jax.random.PRNGKey(0), ja, jev, BATCH, jfast, jexact, ROLLOUTS, ROLLOUTS, a_is_black, open_plies=0)
    games = config_match.play(_gen(), ta, tev, BATCH, tfast, texact, ROLLOUTS, ROLLOUTS, a_is_black,
                              open_plies=0, device="cpu")
    _assert_games_equal(rec, games, jwon)


@pytest.mark.parametrize("tool", ["weights_match", "config_match", "serving_match"])
def test_onehot_openings_match_jax(jax_tool, monkeypatch, tool):
    """With a one-hot policy the sampled openings are the JAX tools' exactly:
    the batched games played as openings to the move cap, and the serving
    match's opening list."""
    if tool == "serving_match":
        # the JAX tool samples op by op: jitted steps spare the compile of each op
        monkeypatch.setattr(jrules, "step", jax.jit(jrules.step))
        monkeypatch.setattr(jpo, "select_moves", jax.jit(jpo.select_moves, static_argnames="avoid_eyes"))
        jev = jax_onehot_evaluator()._replace(policy_probs=jax.jit(jax_onehot_evaluator().policy_probs))
        ecfg = dict(time_lim=None, n_rollouts=8, pondering=False)
        jeng = JEngine(jev, None, JConfig(), JEngineConfig(**ecfg))
        teng = GTPEngine(onehot_evaluator(), None, SearchConfig(), EngineConfig(**ecfg), device="cpu")
        want = jsm.sample_opening(jax.random.PRNGKey(0), jeng, 4)
        assert serving_match.sample_opening(_gen(), teng, 4) == want
        assert len(set(want)) == 4 and min(want) >= 0
        return
    jmod, tmod = (jwm, weights_match) if tool == "weights_match" else (jcm, config_match)
    rec = jax_tool(jmod)
    cfg = dict(expand_thresh=2, max_nodes=128, no_sim=True)
    if tool == "weights_match":
        jwon = jmod.play(jax.random.PRNGKey(0), None, None, jax_onehot_evaluator(), BATCH, JConfig(**cfg), 4, True,
                         open_plies=MOVES)
        games = tmod.play(_gen(), None, None, onehot_evaluator(), BATCH, SearchConfig(**cfg), 4, True,
                          open_plies=MOVES, device="cpu")
    else:
        jwon = jmod.play(jax.random.PRNGKey(0), None, jax_onehot_evaluator(), BATCH, JConfig(**cfg),
                         JConfig(**cfg), 4, 4, False, open_plies=MOVES)
        games = tmod.play(_gen(), None, onehot_evaluator(), BATCH, SearchConfig(**cfg), SearchConfig(**cfg), 4, 4,
                          False, open_plies=MOVES, device="cpu")
    _assert_games_equal(rec, games, jwon)


def _check_opening(actions: torch.Tensor, plies: int) -> None:
    """Replay the first ``plies`` moves of a batch: each one legal, none on
    the mover's own eye, and every game that finished passes."""
    s = st.new_game_batch(actions.shape[1], device="cpu")
    done = torch.zeros(actions.shape[1], dtype=torch.bool)
    for a in actions[:plies]:
        own_eye = rules.eye_colors(s.board) == s.to_play[:, None]
        legal = rules.legal_mask(s)
        assert bool(torch.where(done, a == PASS_ACTION, legal.gather(1, a[:, None])[:, 0]).all())
        assert not bool(own_eye.gather(1, a.clamp(max=NN - 1)[:, None])[:, 0][a < NN].any())
        s = rules.step(s, a)
        assert not bool(s.invalid.any())
        done = done | rules.is_terminal(s, 80)


def test_real_net_openings_invariants(monkeypatch, net_pairs):
    """Real-net openings come from the ``torch.Generator`` stream (not
    ``jax.random``): legal, no own-eye fills, the same in both colour
    halves of a config match seeded alike, different across the batch,
    and ``sample_opening`` passes for finished games."""
    _, (ta, _), _, tev = net_pairs
    monkeypatch.setattr(config_match, "N_MOVES", 6)
    cfg = SearchConfig(expand_thresh=2, max_nodes=128)
    halves = [
        config_match.play(_gen(5), ta, tev, 8, cfg, cfg, 4, 4, a_is_black, open_plies=6, device="cpu")
        for a_is_black in (True, False)
    ]
    torch.testing.assert_close(halves[0].actions, halves[1].actions, rtol=0, atol=0)
    _check_opening(halves[0].actions, 6)
    assert len({tuple(a) for a in halves[0].actions.T.tolist()}) > 1
    s = halves[0].final
    done = torch.arange(8) % 2 == 0
    probs = tev.policy_probs(ta, s)
    mv = common.sample_opening(_gen(1), probs, s, done)
    assert bool((mv[done] == PASS_ACTION).all()) and bool((mv[~done] < NN).all())
    legal = rules.legal_mask(s).gather(1, mv[:, None])[:, 0]
    own_eye = (rules.eye_colors(s.board) == s.to_play[:, None]).gather(1, mv.clamp(max=NN - 1)[:, None])[:, 0]
    assert bool(legal.all()) and not bool(own_eye[~done].any())


def _engines(cfg: dict, forest: int):
    """Two count-mode engines of one configuration on the deterministic
    evaluator, JAX and port.  The second JAX engine takes the first one's
    jitted functions (they read only the shared evaluator and the equal
    configuration), so the pair compiles once."""
    ecfg = dict(time_lim=None, n_rollouts=ROLLOUTS, pondering=False, forest_size=forest)
    cfg = dict(dict(expand_thresh=2, no_sim=True, max_nodes=512), **cfg)
    jev = jax_fake_evaluator()
    jengs = [JEngine(jev, None, JConfig(**cfg), JEngineConfig(**ecfg)) for _ in range(2)]
    for name, fn in vars(jengs[0]).items():
        if name.startswith("_jit_"):
            setattr(jengs[1], name, fn)
    tengs = [GTPEngine(fake_evaluator(), None, SearchConfig(**cfg), EngineConfig(**ecfg), device="cpu")
             for _ in range(2)]
    return jengs, tengs


@pytest.mark.parametrize("cfg,forest", [({}, 1), ({"use_kernel": True, "eval_every": 8}, 2)],
                         ids=["default", "kernel-forest2"])
def test_serving_match_play_game_matches_jax(monkeypatch, cfg, forest):
    """Two games in a row on the same engines (so the second starts from
    the engines' reset): the moves, the referee's result string and the
    winner equal the JAX tool's."""
    monkeypatch.setattr(jsm, "MAX_MOVES", 16)
    monkeypatch.setattr(serving_match, "MAX_MOVES", 16)
    monkeypatch.setattr(jrules, "step", jax.jit(jrules.step))  # the JAX engine steps op by op
    (ja, jb), (ta, tb) = _engines(cfg, forest)
    jlog, tlog = [], []
    for a_is_black, opening in ((True, [40, 41, 30, 31]), (False, [20, 60, 22])):
        won, how = jsm.play_game(ja, jb, a_is_black, opening, jlog.append)
        res = serving_match.play_game(ta, tb, a_is_black, opening, tlog.append)
        assert (res.a_won, res.how) == (won, how)
        assert res.moves == ja._move_history == jb._move_history
        assert ta._move_history == tb._move_history == res.moves
        assert len(res.moves) == 16 and len(res.seconds) == 16 - len(opening)
        assert re.fullmatch(r"[+-]\d+\.\d", how)
    assert [re.sub(r"\(\d+\.\d\ds\)", "", x) for x in tlog] == [re.sub(r"\(\d+\.\d\ds\)", "", x) for x in jlog]


def test_serving_match_new_game_resets_engine():
    """``GTPEngine.new_game`` (``clear_board``) drops the last game's
    trees, history and undo state, and a resigned engine plays again."""
    eng = GTPEngine(fake_evaluator(), None, SearchConfig(expand_thresh=2, max_nodes=256),
                    EngineConfig(time_lim=None, n_rollouts=8, pondering=False), device="cpu")
    eng.input_move(40)
    eng.genmove()
    old = eng.trees
    assert eng.genmove(resign=True) == -2 and not eng.running
    eng.new_game()
    assert eng.running and eng._move_history == [] and eng._last_state is None
    assert eng.trees is not old and int(eng.trees.root_stats[0, 0]) == 0
    assert int(eng.state.turn[0]) == 0 and not bool(eng.state.board.any())


@pytest.fixture
def onehot_curve(monkeypatch):
    monkeypatch.setattr(jpc, "MAX_TURNS", 24)
    monkeypatch.setattr(policy_curve, "MAX_TURNS", 24)
    monkeypatch.setattr(jinference, "policy_probs", jax_onehot_probs)
    finals = []

    def playout_final(*args, **kw):
        finals.append(jpo.playout_final(*args, **kw))
        return finals[-1]

    monkeypatch.setattr(jpc, "po", type("po", (), {"playout_final": staticmethod(playout_final)}))
    # the JAX tool's resolution draws from jax.random: nothing here compares
    # it, so Tromp-Taylor stands in for it (the finals are compared)
    monkeypatch.setattr(jpc, "scoring", type("scoring", (), {"resolved_score": staticmethod(
        lambda rng, s, **kw: jrules.score(s))}))
    return finals


@pytest.mark.parametrize("i_am_black", [True, False])
def test_policy_curve_play_side_onehot_matches_jax(onehot_curve, i_am_black):
    """Two one-hot policies (offsets 0 and 5): the final boards equal the JAX
    tool's; the port's resolved scores are finite and ``won`` follows their
    sign from the side's colour (black minus white plus komi)."""
    jwon = np.asarray(jpc.play_side(jax.random.PRNGKey(0), 0, 5, 4, i_am_black))
    side = policy_curve.play_side(_gen(), OneHotPolicyNet(0), OneHotPolicyNet(5), 4, i_am_black, "cpu")
    assert_states_equal(onehot_curve[0], side.final)
    assert jwon.shape == side.won.shape
    assert bool(torch.isfinite(side.scores).all())
    torch.testing.assert_close(side.won, side.scores > 0 if i_am_black else side.scores <= 0, rtol=0, atol=0)
    assert bool(rules.is_terminal(side.final, 24).all())


def test_policy_curve_play_side_real_nets(net_pairs, monkeypatch):
    """Real small nets, the port's streams: every game finishes by the turn
    cap or a pass, no illegal move, finite resolved scores whose sign
    decides ``won``, and one generation counts both colours."""
    monkeypatch.setattr(policy_curve, "MAX_TURNS", 20)
    pa, pb = (p["policy"] for p in net_pairs[1])
    side = policy_curve.play_side(_gen(3), pa, pb, 3, False, "cpu")
    assert len({tuple(b) for b in side.final.board.tolist()}) > 1
    assert bool(rules.is_terminal(side.final, 20).all()) and not bool(side.final.invalid.any())
    assert bool(torch.isfinite(side.scores).all())
    torch.testing.assert_close(side.won, side.scores <= 0, rtol=0, atol=0)
    sides = policy_curve.generation(pa, pb, 1, seed=4, device="cpu")
    wins, total = policy_curve.wins_of(sides)
    assert total == 2 and wins == int(sides[0].won[0]) + int(sides[1].won[0])


def _run_main(name: str, argv: list[str], capsys) -> str:
    """``bokego_tpu_torch.match.<name>.main(argv)``, as ``python -m`` runs
    it; returns its standard output."""
    importlib.import_module(f"bokego_tpu_torch.match.{name}").main(argv)
    return capsys.readouterr().out


@pytest.fixture
def tiny_pool(tmp_path):
    """A pool of one tiny generation and a tiny opponent, as .pt files."""
    from bokego_tpu_torch.train import checkpoints

    pool = tmp_path / "pool"
    pool.mkdir()
    checkpoints.save_variables(str(pool / "policy_3.pt"), nets.init_policy(8, seed=3, device="cpu"))
    checkpoints.save_variables(str(tmp_path / "opp.pt"), nets.init_policy(8, seed=4, device="cpu"))
    return tmp_path


CLI_CASES = {
    "weights_match": (["random:1", "random:2", "random:3", "random:4", "--games", "1", "--rollouts", "2"],
                      r"A won \d+/2 = \d\.\d{3} \+- \d\.\d{3} \(2 rollouts/move, \d+s\)"),
    "config_match": (["{'expand_thresh': 4}", "{}", "--games", "1", "--rollouts", "2", "--rollouts-b", "3",
                      "--policy", "random", "--value", "random"],
                     r"A winrate \d\.\d{3} \+/- \d\.\d{3} over 2 games \(A: 2 rollouts, B: 3\)"),
    "fastmode_fidelity": (["1", "2"], r"fast winrate \d\.\d{3} \+/- \d\.\d{3} \(95% CI\)"),
    "policy_curve": (["--games", "2", "--pool", "{pool}/pool", "--opponent", "{pool}/opp.pt", "--out", "{pool}/c.txt"],
                     r"gen 3: \d+/4 = \d\.\d{3} \+- \d\.\d{3} \(\d+s\)"),
    "serving_match": (["{}", "{'use_kernel': True, 'eval_every': 8, 'max_nodes': 512}", "--forest-b", "2",
                       "--games", "1", "--time", "0.01", "--open-plies", "2", "--policy", "random",
                       "--value", "random"],
                      r"A winrate \d\.\d{3} \+/- \d\.\d{3} over 1 games at 0\.01s/move"),
}


def _argv(argv: list[str], pool) -> list[str]:
    return [a.replace("{pool}", str(pool)) for a in argv]


@pytest.mark.parametrize("name", sorted(CLI_CASES))
def test_entry_point_on_cpu(name, monkeypatch, capsys, tiny_pool):
    """Each entry point at a tiny size with ``--device cpu`` prints its
    result line in the JAX tool's format; the move caps are cut so that a
    run takes seconds (two searched moves after the 6-ply opening)."""
    for mod, attr, cap in ((weights_match, "N_MOVES", 8), (config_match, "N_MOVES", 8),
                           (policy_curve, "MAX_TURNS", 6), (serving_match, "MAX_MOVES", 6)):
        monkeypatch.setattr(mod, attr, cap)
    argv, pattern = CLI_CASES[name]
    out = _run_main(name, _argv(argv, tiny_pool) + ["--device", "cpu"], capsys)
    assert re.search(rf"^{pattern}$", out, re.M), out
    if name == "policy_curve":
        assert (tiny_pool / "c.txt").read_text().splitlines()[1:] == re.findall(rf"^{pattern}$", out, re.M)


@pytest.mark.parametrize("name", sorted(CLI_CASES))
def test_entry_point_needs_a_gpu(name, monkeypatch, capsys, tiny_pool):
    """Without ``--device cpu`` every entry point asks for CUDA and raises
    here, before it plays."""
    argv, _ = CLI_CASES[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run_main(name, _argv(argv, tiny_pool), capsys)


def test_entry_points_run_as_modules(tiny_pool):
    """``python -m bokego_tpu_torch.match.<name>`` reaches ``main`` for
    every entry point: without ``--device cpu`` each exits non-zero here,
    saying that there is no CUDA device (the processes run side by side)."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = {
        name: subprocess.Popen([sys.executable, "-m", f"bokego_tpu_torch.match.{name}", *_argv(argv, tiny_pool)],
                               cwd=tiny_pool, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, (argv, _) in CLI_CASES.items()
    }
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=120)
        assert proc.returncode != 0 and "no CUDA device" in err, (name, out, err[-2000:])


def test_policy_curve_default_out_is_not_a_record(monkeypatch, capsys, tiny_pool):
    """Without ``--out`` the curve goes to ``data/match_logs/`` (ignored by
    git), never over the TPU record in ``data/training_logs/``."""
    logs = os.path.join(REPO, "data", "training_logs")
    before = {f: os.stat(os.path.join(logs, f)).st_mtime_ns for f in os.listdir(logs)}
    monkeypatch.setattr(policy_curve, "REPO", str(tiny_pool))
    monkeypatch.setattr(policy_curve, "MAX_TURNS", 4)
    _run_main("policy_curve", ["--games", "1", "--single", f"{tiny_pool}/pool/policy_3.pt",
                               "--opponent", f"{tiny_pool}/opp.pt", "--device", "cpu"], capsys)
    assert (tiny_pool / "data" / "match_logs" / "policy_curve.txt").read_text().splitlines()[1].startswith("gen 3: ")
    assert {f: os.stat(os.path.join(logs, f)).st_mtime_ns for f in os.listdir(logs)} == before
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "data/match_logs/" in f.read().split()


def test_common_interval_and_loading():
    """The interval as the tools print it, and ``random[:SEED]`` nets."""
    assert f"{common.interval(27 / 32, 32):.3f}" == "0.126"
    assert f"{common.interval(359 / 512, 512):.3f}" == "0.040"
    assert common.interval(1.0, 4) == 0.0 and common.interval(1.0, 4, 1e-9) > 0.0
    a, b = common.load_net("random:3", "policy", "cpu"), common.load_net("random:3", "policy", "cpu")
    assert torch.equal(a.conv[0].weight, b.conv[0].weight)
    assert not torch.equal(a.conv[0].weight, common.load_net("random", "policy", "cpu").conv[0].weight)
    assert isinstance(common.load_net("random", "value", "cpu"), nets.ValueNet)
