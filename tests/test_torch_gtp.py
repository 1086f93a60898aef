"""The port's GTP engine: protocol conformance (the cases of
``tests/test_gtp.py`` that are about protocol and engine behaviour),
scripted sessions answered letter for letter like the JAX engine (default,
kernel, leaf-parallel and simulation-mode configurations), the ``analyze``
stream and its top-k stats equal to the JAX engine's, the CLI's flags
against the JAX CLI's ``SearchConfig``, the deadline logic on a fake
clock, and the host-side copies (``coords``, ``sgf``, ``EngineConfig``)
held equal to the originals.

Everything runs on the CPU with the deterministic evaluator; comparisons
with the JAX engine are exact (tolerance 0: equal response strings)."""

import dataclasses
import os
import warnings

import numpy as np
import pytest
import torch

from bokego_tpu import coords as jcoords
from bokego_tpu import sgf as jsgf
from bokego_tpu.config import EngineConfig as JEngineConfig, SearchConfig as JSearchConfig
from bokego_tpu.gtp.engine import COMMANDS as JCOMMANDS, GTPEngine as JEngine
from bokego_tpu_torch import coords as tcoords
from bokego_tpu_torch import sgf as tsgf
from bokego_tpu_torch.config import EngineConfig, SearchConfig
from bokego_tpu_torch.coords import NN
from bokego_tpu_torch.gtp import engine as tengine
from bokego_tpu_torch.gtp.engine import COMMANDS, GTPEngine
from bokego_tpu_torch.search import tree as tr
from tests.test_mcts import fake_evaluator as jax_fake_evaluator
from tests.test_torch_playout import jax_onehot_evaluator
from tests.torch_fake_eval import fake_evaluator, onehot_evaluator
from tests.torch_port_util import to_port  # noqa: F401  (sets torch threads)


def make_engine(scfg=None, **ecfg):
    scfg = scfg or SearchConfig(expand_thresh=4, no_sim=True, max_nodes=512, n_rollouts=8)
    ecfg = dict(dict(time_lim=None, n_rollouts=8, pondering=False), **ecfg)
    eng = GTPEngine(fake_evaluator(), None, scfg, EngineConfig(**ecfg), device="cpu")
    eng.running = True
    return eng


@pytest.fixture(scope="module")
def engine():
    return make_engine()


def ok(engine, cmd):
    out = engine.send(cmd)
    assert out.startswith("="), f"{cmd!r} -> {out!r}"
    return out[1:].strip()


def fail(engine, cmd):
    out = engine.send(cmd)
    assert out.startswith("?"), f"{cmd!r} -> {out!r}"
    return out[1:].strip()


def test_basic_commands(engine):
    assert ok(engine, "protocol_version") == "2"
    assert ok(engine, "name")
    assert ok(engine, "version")
    assert ok(engine, "known_command play") == "true"
    assert ok(engine, "known_command frobnicate") == "false"
    assert set(ok(engine, "list_commands").split("\n")) == set(COMMANDS)
    assert COMMANDS == JCOMMANDS
    fail(engine, "notacommand")


def test_command_id_framing(engine):
    out = engine.send("7 protocol_version")
    assert out == "=7 2\n\n"
    assert engine.send("12 notacommand").startswith("?12 ")


def test_boardsize(engine):
    ok(engine, "boardsize 9")
    fail(engine, "boardsize 19")


def test_play_and_board(engine):
    ok(engine, "clear_board")
    ok(engine, "play black E5")
    assert "X" in ok(engine, "showboard")
    assert ok(engine, "last_move") == "black E5"
    ok(engine, "play white C3")
    assert ok(engine, "move_history").split("\n") == ["E5", "C3"]
    assert fail(engine, "play black E5") == "illegal move"  # occupied
    assert fail(engine, "play black Z9") == "invalid coordinate"


def test_out_of_turn_play(engine):
    """Consecutive same-colour plays insert a PASS."""
    ok(engine, "clear_board")
    ok(engine, "play black E5")
    ok(engine, "play black C3")
    assert engine._turn() == 3


def test_undo(engine):
    ok(engine, "clear_board")
    ok(engine, "play black E5")
    ok(engine, "undo")
    assert engine._turn() == 0
    fail(engine, "undo")  # only one undo allowed


def test_komi_and_final_score(engine):
    ok(engine, "clear_board")
    ok(engine, "komi 7")
    assert ok(engine, "final_score") == "W+7.0"
    fail(engine, "komi abc")
    ok(engine, "komi 5.5")


def test_handicap(engine):
    ok(engine, "clear_board")
    assert len(ok(engine, "set_fixed_handicap 3").split()) == 3
    assert engine._turn() == 1
    fail(engine, "set_fixed_handicap 3")  # board not empty
    ok(engine, "clear_board")
    fail(engine, "set_fixed_handicap 9")


def test_genmove_legal(engine):
    ok(engine, "clear_board")
    mv = ok(engine, "genmove black")
    assert mv and mv != "resign"
    assert ok(engine, "reg_genmove white")
    assert len(engine._move_history) == 2
    assert not bool(engine.state.invalid[0])


def test_genmove_out_of_turn(engine):
    ok(engine, "clear_board")
    ok(engine, "genmove white")  # black to play -> pass inserted
    assert engine._turn() == 2


def test_printsgf_loadsgf(engine, tmp_path):
    ok(engine, "clear_board")
    ok(engine, "play black E5")
    ok(engine, "play white C3")
    path = os.path.join(tmp_path, "out.sgf")
    ok(engine, f"printsgf {path}")
    assert os.path.exists(path)
    ok(engine, "clear_board")
    assert ok(engine, f"loadsgf {path} 3") in ("black", "white")
    assert engine._turn() == 2
    fail(engine, "loadsgf /nonexistent.sgf 1")


def test_pondering_toggle(engine):
    ok(engine, "pondering off")
    assert engine.pondering is False
    ok(engine, "pondering on")
    assert engine.pondering is True
    fail(engine, "pondering maybe")
    ok(engine, "pondering off")


def test_clear_cache(engine):
    ok(engine, "clear_cache")


def test_analyze_stream(engine):
    ok(engine, "clear_board")
    gen = engine.send("analyze black 1")
    assert hasattr(gen, "__next__")
    assert next(gen).startswith("=")
    line = next(gen)
    assert "info move" in line and "visits" in line and "pv" in line
    engine._input[0] = "quit"  # stop streaming
    assert next(gen) == "\n"
    engine._input[0] = None
    assert fail(engine, "analyze white 1") == "it is not white's turn"


def _forest_engine(turn: int, root_stats):
    eng = make_engine(SearchConfig(expand_thresh=2, no_sim=True, max_nodes=256), forest_size=len(root_stats))
    ok(eng, "clear_board")
    eng.state = dataclasses.replace(eng.state, turn=torch.tensor([turn]))
    eng._rebuild()
    eng.trees.root_stats = torch.tensor(root_stats, dtype=torch.float32)
    return eng


def test_forest_winrate_aggregates_all_trees():
    """winrate()/surrender pool the root stats across the forest: tree 0
    alone looks healthy (1.0); pooled N=210, Wv=-186 gives 0.057 < 0.1."""
    eng = _forest_engine(52, [[10.0, 0.0, 10.0], [100.0, 0.0, -98.0], [100.0, 0.0, -98.0]])
    assert eng.winrate() == pytest.approx((1 - 186 / 210) / 2)
    assert "resign" in eng.send("genmove black")


def test_surrender_rule():
    """Resign when the winrate is under 0.1 after turn 50; a forest with no
    visits has no winrate and does not resign."""
    eng = _forest_engine(52, [[100.0, 0.0, -95.0]])
    assert eng.winrate() < 0.1
    assert "resign" in eng.send("genmove black")
    fresh = _forest_engine(52, [[0.0, 0.0, 0.0]])
    assert fresh.winrate() is None and not fresh.surrender
    early = _forest_engine(40, [[100.0, 0.0, -95.0]])
    assert not early.surrender


def test_case_insensitive_verbs_case_preserving_args(tmp_path):
    eng = make_engine()
    ok(eng, "clear_board")
    ok(eng, "play BLACK E5")
    ok(eng, "PLAY White C3")
    assert ok(eng, "KNOWN_COMMAND PLAY") == "true"
    path = os.path.join(tmp_path, "MixedCase.SGF")
    ok(eng, f"printsgf {path}")
    assert os.path.exists(path)
    ok(eng, "clear_board")
    assert ok(eng, f"LOADSGF {path} 3") in ("black", "white")
    assert eng._turn() == 2
    ok(eng, "PONDERING OFF")
    assert eng.pondering is False


def test_zero_rollout_genmove_policy_fallback():
    """A pool too small to expand the root leaves no children: genmove
    samples a legal move from the policy, reproducibly for a seed."""
    moves = []
    for _ in range(2):
        eng = make_engine(SearchConfig(expand_thresh=4, no_sim=True, max_nodes=16), n_rollouts=4)
        mv = ok(eng, "genmove black")
        assert mv and mv not in ("resign", "PASS")
        assert not bool(eng.state.invalid[0])
        moves.append(mv)
    assert moves[0] == moves[1]


def test_out_of_turn_illegal_play_is_atomic():
    """When the inserted out-of-turn PASS succeeds but the move itself is
    rejected, state, trees and undo bookkeeping all roll back together."""
    eng = make_engine()
    assert eng.send("play b E5").startswith("=")
    eng.rollout(8)  # a forest rooted at the post-E5 position
    board_before = eng.state.board.clone()
    last_before, undid_before = eng._last_state, eng._undid
    hist_before = list(eng._move_history)
    assert eng.send("play b E5").startswith("?")  # PASS inserted, move rejected
    assert torch.equal(eng.state.board, board_before)
    assert eng._turn() == 1
    assert eng._move_history == hist_before
    assert eng._undid == undid_before
    assert eng._last_state is last_before
    assert eng.trees is None  # the forest past the PASS was dropped
    assert eng.send("genmove w").startswith("=")


def test_analyze_stats_match_host():
    """The device-side top-k of the analyze stream against a host
    recomputation over the root rows: visits summed over the forest, the
    mixed value from pooled (N, Wq, Wv), priors from tree 0, children that
    exist nowhere padded with -1, and the actions in the host's stable
    order (equal visits: the lower action first)."""
    eng = make_engine(SearchConfig(expand_thresh=2, no_sim=True, max_nodes=256), n_rollouts=24, forest_size=3)
    eng.rollout(24)
    k = 5
    top_a, top_n, mixed, prior = eng._analyze_stats(k)
    rows = eng._root_rows().numpy()
    has = rows[:, tr.C_CHILD, :81] >= 0
    n = np.where(has, rows[:, tr.C_N, :81], 0.0).sum(0)
    wq = np.where(has, rows[:, tr.C_WQ, :81], 0.0).sum(0)
    wv = np.where(has, rows[:, tr.C_WV, :81], 0.0).sum(0)
    mixed_host = ((1 - eng._w) * wq + eng._w * wv) / np.maximum(n, 1.0)
    x = np.where(has.any(0), n, -1.0)
    order = np.argsort(-x, kind="stable")[:k]
    assert top_a == order.tolist()
    assert top_n == [int(v) for v in x[order]]
    for a, nn_, m, p in zip(top_a, top_n, mixed, prior):
        if nn_ < 0:
            continue
        assert has.any(0)[a] and int(n[a]) == nn_
        np.testing.assert_allclose(m, mixed_host[a], rtol=1e-6, atol=1e-7)
        assert p == rows[0, tr.C_PRIOR, a]
    assert eng._root_child_visits() == {a: int(n[a]) for a in np.flatnonzero(has.any(0))}


def test_reroot_keeps_the_subtree():
    """A generated move re-roots into its child (no rebuild), the kept
    subtree is compacted to the pool head, and the visits carry over."""
    eng = make_engine(SearchConfig(expand_thresh=2, no_sim=True, max_nodes=512), n_rollouts=32)
    ok(eng, "clear_board")
    rebuilds = eng.rebuilds
    ok(eng, "genmove black")
    assert eng.rebuilds == rebuilds
    assert int(eng.trees.root[0]) == 0
    assert float(eng.trees.root_stats[0, 0]) > 0
    ok(eng, "play white A1")  # a move outside the tree's visited part still has a child
    ok(eng, "undo")
    assert eng.rebuilds == rebuilds + 1


class FakeConnection:
    """A pipe-like connection that hands out one command after every few
    polls of the reader thread, so the engine idles in between."""

    def __init__(self, commands, polls_between=3):
        self.commands, self.sent = list(commands), []
        self.polls_between, self.polls = polls_between, 0

    def poll(self):
        self.polls += 1
        return self.polls % self.polls_between == 0

    def recv(self):
        return self.commands.pop(0) if self.commands else "quit"

    def send(self, text):
        self.sent.append(text)


@pytest.mark.parametrize("pondering", [True, False])
def test_start_loop_ponders_between_inputs(pondering):
    """``start()`` warms up, answers the commands of a connection in order
    and, while it waits for the next one, rolls out on the current root in
    chunks of 8 (only with pondering on); the analyze stream ends on input."""
    conn = FakeConnection(["clear_board", "play black E5", "analyze white 10", "genmove white", "quit"])
    scfg = SearchConfig(expand_thresh=4, no_sim=True, max_nodes=4096)
    ecfg = EngineConfig(time_lim=None, n_rollouts=24, pondering=pondering)
    eng = GTPEngine(fake_evaluator(), None, scfg, ecfg, connection=conn, device="cpu")
    calls, rollout = [], eng.rollout
    eng.rollout = lambda n: calls.append(n) or rollout(n)
    eng.start()
    assert eng.running is False and eng._chunk_s is not None  # warmed up, then quit
    replies = [t for t in conn.sent if t.strip()]
    assert replies[:3] == ["= \n\n", "= \n\n", "= \n"]
    assert any(t.startswith("info move") for t in replies[3:-2])  # analyze streamed
    assert replies[-2].startswith("= ") and replies[-1] == "= \n\n"  # genmove, quit
    assert len(eng._move_history) == 2
    assert (tengine.PONDER_CHUNK in calls) == pondering
    assert calls.count(24) == 1  # the genmove's own search


# ---------------------------------------------------------------------------
# One scripted session, the JAX engine and the port's, letter for letter.

SESSION = [
    "protocol_version", "boardsize 9", "komi 5.5", "clear_board",
    "play black E5", "genmove white", "play white C3", "undo", "undo",
    "play black E5", "3 play black Z9", "genmove black", "genmove white",
    "genmove black", "reg_genmove white", "last_move", "move_history",
    "showboard", "final_score", "play black pass", "play white pass",
    "final_score", "printsgf {sgf}", "clear_board", "loadsgf {sgf}",
    "showboard", "known_command analyze", "clear_board",
    "set_fixed_handicap 2", "genmove white", "quit", "protocol_version",
]


KERNEL_CFG = dict(use_kernel=True, eval_every=8, kernel_levels=8)


def engine_pair(cfg, forest):
    """The JAX engine and the port's on the deterministic evaluator, with
    the same search config (``expand_thresh=2``, no simulations, 512 nodes
    unless ``cfg`` says otherwise), 16 rollouts a move, no pondering."""
    cfg = dict(dict(expand_thresh=2, no_sim=True, max_nodes=512), **cfg)
    ecfg = dict(time_lim=None, n_rollouts=16, pondering=False, forest_size=forest)
    jeng = JEngine(jax_fake_evaluator(), None, JSearchConfig(**cfg), JEngineConfig(**ecfg))
    teng = GTPEngine(fake_evaluator(), None, SearchConfig(**cfg), EngineConfig(**ecfg), device="cpu")
    jeng.running = teng.running = True
    return jeng, teng


@pytest.mark.parametrize(
    "kernel,forest", [(False, 1), (True, 2)], ids=["default", "kernel_forest2"]
)
def test_session_matches_jax_engine(kernel, forest, tmp_path):
    """Every response of the scripted session is equal, in the default
    configuration (non-kernel search, eval_every=1, one tree) and in the
    kernel configuration (the rollout kernels' CPU stand-ins on both sides:
    Pallas in interpret mode, the plain torch versions) with a forest of 2."""
    jeng, teng = engine_pair(KERNEL_CFG if kernel else {}, forest)
    for cmd in SESSION:
        jout = jeng.send(cmd.format(sgf=os.path.join(tmp_path, "j.sgf")))
        tout = teng.send(cmd.format(sgf=os.path.join(tmp_path, "t.sgf")))
        assert tout == jout, cmd
    assert teng.running is False and tout is None
    assert teng._move_history == jeng._move_history
    assert teng.rebuilds < len(SESSION)  # generated moves re-rooted instead


def _same_analyze_stats(jeng, teng, ks, what):
    """``_analyze_stats(k)`` equal to ``JEngine._jit_analyze_stats``:
    actions, visits, mixed values and priors, exactly and in order."""
    for k in ks:
        want = [np.asarray(x).tolist() for x in jeng._jit_analyze_stats(jeng.trees, k)]
        assert list(teng._analyze_stats(k)) == want, (what, k)


def test_analyze_stats_match_jax_engine():
    """The analyze stream's top k against the JAX engine's on the same
    session, with a forest of 2: on a fresh root, where every child has 0
    visits; with k above the number of children (80 after a stone), so
    that the -1 padding compares too; and after rollouts and re-rooting,
    where many children tie at 1 or 2 visits."""
    jeng, teng = engine_pair({}, forest=2)
    ks = (1, 3, 8, NN)
    for eng in (jeng, teng):
        eng.send("clear_board")
        eng._ensure_tree()
    _same_analyze_stats(jeng, teng, ks, "empty board, fresh root")
    assert set(teng._analyze_stats(NN)[1]) == {0}  # every child ties
    for cmd in ("play black E5", "genmove white", "play black C3"):
        assert teng.send(cmd) == jeng.send(cmd), cmd
        _same_analyze_stats(jeng, teng, ks, cmd)
    top_n = teng._analyze_stats(NN)[1]
    assert top_n[-1] == -1 and len(set(top_n)) < len(top_n)  # padded, with ties
    for eng in (jeng, teng):
        eng._rebuild()
    _same_analyze_stats(jeng, teng, ks, "rebuilt root")
    assert set(teng._analyze_stats(NN)[1]) == {0, -1}  # every child ties, padded
    for n in (8, 8, 16):
        jeng.rollout(n)
        teng.rollout(n)
        _same_analyze_stats(jeng, teng, ks, f"after {n} more rollouts")


@pytest.mark.parametrize(
    "cfg,forest", [({}, 1), (KERNEL_CFG, 2), (dict(leaf_batch=4), 1)],
    ids=["default", "kernel_forest2", "leaf_batch4"],
)
def test_analyze_stream_matches_jax_engine(cfg, forest):
    """The ``analyze`` stream, letter for letter, after a few moves: each
    engine's ``timed_rollout`` is replaced on the instance by a fixed
    ``rollout(8)``, so that every tick grows both forests alike whatever
    the clock.  Each tick lists the top 3 children in ascending visit
    order; equal visits (common at 1 or 2 visits a child) must be ordered
    as ``lax.top_k`` orders them."""
    jeng, teng = engine_pair(cfg, forest)
    for eng in (jeng, teng):
        eng.timed_rollout = lambda seconds, eng=eng: eng.rollout(8)
    for cmd in ("clear_board", "play black E5", "genmove white", "play black C3"):
        assert teng.send(cmd) == jeng.send(cmd), cmd
    jstream, tstream = jeng.send("analyze white 10"), teng.send("analyze white 10")
    assert next(tstream) == next(jstream) == "= \n"
    for tick in range(6):
        tline = next(tstream)
        assert tline.startswith("info move ")
        assert tline == next(jstream), tick
    jeng._input[0] = teng._input[0] = "showboard"
    assert next(tstream) == next(jstream) == "\n"


SHORT_SESSION = [
    "clear_board", "play black E5", "genmove white", "play black C3", "genmove white",
    "genmove black", "undo", "genmove black", "move_history", "showboard", "final_score", "quit",
]


@pytest.mark.parametrize(
    "cfg,rollouts,forest,session",
    [
        (dict(leaf_batch=4), 16, 1, SESSION),
        (dict(leaf_batch=3), 16, 2, SHORT_SESSION),
        (dict(no_sim=False, max_turns=30), 8, 1, SHORT_SESSION),
        (dict(no_sim=False, max_turns=30, leaf_batch=4), 8, 1, SHORT_SESSION),
    ],
    ids=["leaf_batch4", "leaf_batch3_forest2", "simulate", "simulate_leaf_batch4"],
)
def test_leaf_parallel_and_simulation_sessions_match_jax_engine(cfg, rollouts, forest, session, tmp_path):
    """Leaf-parallel search and simulation mode through the engine, every
    response equal to the JAX engine's.  Without simulations no random
    number is drawn; with them the one-hot playout policy makes the draws
    immaterial (the two engines' generators differ).  ``leaf_batch=3`` does
    not divide the chunk of 8: both engines run 3 steps (9 rollouts) a
    chunk."""
    cfg = dict(dict(expand_thresh=2, no_sim=True, max_nodes=512), **cfg)
    sim = not cfg["no_sim"]
    ecfg = dict(time_lim=None, n_rollouts=rollouts, pondering=False, forest_size=forest)
    jev, tev = (jax_onehot_evaluator(), onehot_evaluator()) if sim else (jax_fake_evaluator(), fake_evaluator())
    jeng = JEngine(jev, None, JSearchConfig(**cfg), JEngineConfig(**ecfg))
    teng = GTPEngine(tev, None, SearchConfig(**cfg), EngineConfig(**ecfg), device="cpu")
    jeng.running = teng.running = True
    grown, rollout = [], teng.rollout

    def counted_rollout(n):  # genmove's own search: the roots' visit growth
        before = teng.trees.root_stats[:, 0].clone()
        out = rollout(n)
        grown.append((teng.trees.root_stats[:, 0] - before).tolist())
        return out

    teng.rollout = counted_rollout
    for cmd in session:
        jout = jeng.send(cmd.format(sgf=os.path.join(tmp_path, "j.sgf")))
        tout = teng.send(cmd.format(sgf=os.path.join(tmp_path, "t.sgf")))
        assert tout == jout, cmd
    assert teng._move_history == jeng._move_history
    # every chunk of 8 runs ceil(8 / K) steps of K rollouts
    k = cfg.get("leaf_batch", 1)
    per_chunk = -(-tengine.ROLLOUT_CHUNK // k) * k
    want = [float(per_chunk * (rollouts // tengine.ROLLOUT_CHUNK))] * forest
    assert len(grown) == sum(c.startswith(("genmove", "reg_genmove")) for c in session)
    assert all(g == want for g in grown), (grown, want)


# ---------------------------------------------------------------------------
# The deadline logic of timed_rollout, on a fake clock.


class FakeClock:
    """A clock that advances ``per_chunk`` seconds whenever a chunk runs."""

    def __init__(self, eng, per_chunk):
        self.now, self.per_chunk, self.chunks = 0.0, per_chunk, 0
        run = eng._run_chunk

        def run_chunk(n):
            assert n == tengine.ROLLOUT_CHUNK
            run(n)
            self.chunks += 1
            self.now += self.per_chunk(self.chunks) if callable(self.per_chunk) else self.per_chunk

        eng._run_chunk = run_chunk
        eng._clock = lambda: self.now


def _timed_engine(per_chunk, max_nodes=4096):
    eng = make_engine(SearchConfig(expand_thresh=4, no_sim=True, max_nodes=max_nodes), time_lim=1.0)
    return eng, FakeClock(eng, per_chunk)


def test_timed_rollout_stops_one_chunk_before_the_deadline():
    eng, clock = _timed_engine(0.125)
    assert eng.timed_rollout(1.0) == 7  # the eighth chunk would end on the deadline
    assert clock.now == 0.875
    assert eng._chunk_s == 0.125
    assert float(eng.trees.root_stats[0, 0]) == 7 * tengine.ROLLOUT_CHUNK


def test_timed_rollout_always_runs_a_first_chunk():
    """A budget under one chunk still searches once: no move on zero visits."""
    eng, clock = _timed_engine(0.5)
    eng._chunk_s = 0.5
    assert eng.timed_rollout(0.2) == 1
    assert clock.chunks == 1


def test_timed_rollout_overrun_is_bounded_by_one_chunk():
    """A chunk that takes longer than the running value overruns by its
    excess at most; the running value follows (mean of old and new)."""
    eng, clock = _timed_engine(lambda i: 0.125 if i < 5 else 0.5)
    eng.timed_rollout(0.6875)
    assert clock.chunks == 5  # 0.5 s in, 0.1875 left > 0.125: a fifth chunk starts
    assert clock.now == 1.0  # 0.3125 past the deadline: less than that 0.5 s chunk
    assert eng._chunk_s == 0.3125
    assert eng.timed_rollout(0.375) == 1  # only the first chunk, which always runs


def test_timed_rollout_stops_when_the_pool_is_full():
    eng, clock = _timed_engine(0.0, max_nodes=90)  # the root's expansion fills the pool
    assert eng.timed_rollout(1.0) == 0
    assert clock.chunks == 0


def test_warm_up_times_a_chunk_and_leaves_the_forest_alone():
    eng, clock = _timed_engine(0.125)
    eng._ensure_tree()
    trees, rebuilds = eng.trees, eng.rebuilds
    before = trees.pstats.clone()
    eng.warm_up()
    assert eng.trees is trees and eng.rebuilds == rebuilds
    assert torch.equal(trees.pstats, before)
    assert eng._chunk_s == pytest.approx(0.125) and clock.chunks == 2


def _jax_cli_search_config(monkeypatch, flags):
    """The ``SearchConfig`` that ``bokego_tpu.cli.main`` hands its engine for
    ``flags`` (the engine and the weights are replaced by stand-ins)."""
    from bokego_tpu import cli as jcli
    from bokego_tpu.gtp import engine as jengine

    seen = {}

    class Capture:
        def __init__(self, ev, params, scfg, ecfg):
            seen.update(scfg=scfg, ecfg=ecfg)

        def start(self):
            pass

    monkeypatch.setattr(jengine, "GTPEngine", Capture)
    monkeypatch.setattr(jcli, "load_variables", lambda path, kind: None)
    jcli.main(flags)
    return seen["scfg"], seen["ecfg"]


@pytest.mark.parametrize(
    "flags",
    [
        ["--simulate"],
        ["--leaf-batch", "4"],
        ["--leaf-batch", "1"],
        ["--fast", "--simulate", "-r", "64"],
        ["--fast", "--leaf-batch", "16", "--forest", "8", "--strong"],
        ["--simulate", "--leaf-batch", "8", "--noise", "0.25", "--expand-thresh", "7", "--max-nodes", "2048"],
    ],
    ids=lambda f: "".join(f).replace("--", "_"),
)
def test_unported_configurations_raise(flags, monkeypatch):
    """``--simulate`` and ``--leaf-batch`` no longer raise: the CLI maps them
    (and every other flag) to the ``SearchConfig`` and ``EngineConfig`` that
    the JAX CLI gives its engine on a CPU backend, and an engine is built
    for that configuration."""
    from bokego_tpu_torch import cli

    cpu = torch.device("cpu")
    args = cli.build_parser().parse_args(flags)
    jscfg, jecfg = _jax_cli_search_config(monkeypatch, flags)
    scfg = cli.search_config(args, cpu)
    assert dataclasses.asdict(scfg) == dataclasses.asdict(jscfg)
    assert args.forest == jecfg.forest_size and args.r == jecfg.n_rollouts
    eng = GTPEngine(fake_evaluator(), None, scfg, EngineConfig(), device="cpu")
    assert eng._w == (1.0 if scfg.no_sim else 0.5)


@pytest.mark.parametrize("flags", [["--simulate", "-r", "4"], ["--leaf-batch", "4", "-r", "16"]])
def test_cli_raises_without_gpu(flags, monkeypatch):
    """Like every entry point of the port, the CLI wants the GPU for these
    flags too and raises when there is none, unless asked for the CPU."""
    from bokego_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(flags + ["--no-ponder"])


def test_cli_serves_in_fp32(monkeypatch):
    """``main`` turns TF32 off for cuDNN convolutions and matmuls before the
    engine starts (torch's default lets cuDNN use TF32), so the GTP engine
    serves the nets in the fp32 that every parity check assumes."""
    from bokego_tpu_torch import cli

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    seen = []
    monkeypatch.setattr(GTPEngine, "start", lambda self: seen.append(
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32, self.device.type)))
    cli.main(["-r", "4", "--no-ponder", "--device", "cpu"])
    assert seen == [(False, False, "cpu")]


def test_cli_presets_on_a_cuda_device():
    """``--fast`` selects the kernels only on a CUDA device, and never with
    ``--simulate`` or ``--leaf-batch`` (the kernels are no_sim, K=1)."""
    from bokego_tpu_torch import cli

    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    args = cli.build_parser().parse_args(["--fast", "--strong", "--noise", "0.25"])
    assert cli.search_config(args, cpu) == SearchConfig(
        expand_thresh=16, max_nodes=65536, noise_weight=0.25
    )
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fast = cli.search_config(args, cuda)
        sim = cli.search_config(cli.build_parser().parse_args(["--fast", "--simulate"]), cuda)
        leaf = cli.search_config(cli.build_parser().parse_args(["--fast", "--leaf-batch", "8"]), cuda)
    assert fast.use_kernel and fast.eval_every == 8 and fast.kernel_levels == 8
    assert fast.max_nodes == 65536 and fast.expand_thresh == 16
    assert sim == SearchConfig(no_sim=False, use_kernel=False, eval_every=8, max_nodes=512)
    assert leaf == SearchConfig(leaf_batch=8, use_kernel=False, eval_every=1, max_nodes=512)


# ---------------------------------------------------------------------------
# Host-side copies.


def test_coords_copy_equals_original():
    for name in ("N", "NN", "PASS", "RESIGN", "PASS_ACTION", "NUM_ACTIONS", "FLOWERS9", "EMPTY", "BLACK", "WHITE"):
        assert getattr(tcoords, name) == getattr(jcoords, name), name
    vertices = [c + str(r) for c in "ABCDEFGHJ" for r in range(1, 10)] + ["pass", "e5"]
    assert tcoords.squash(vertices) == jcoords.squash(vertices)
    assert tcoords.squash([(0, 0), (8, 8), (3, 5)]) == jcoords.squash([(0, 0), (8, 8), (3, 5)])
    sqs = list(range(-1, 81))
    assert tcoords.unsquash(sqs) == jcoords.unsquash(sqs)
    assert tcoords.unsquash(sqs[1:], alph=False) == jcoords.unsquash(sqs[1:], alph=False)
    for sq in sqs:
        assert tcoords.to_action(sq) == jcoords.to_action(sq)
        assert tcoords.from_action(tcoords.to_action(sq)) == sq
    with pytest.raises(ValueError):
        tcoords.squash("Z9")
    assert tcoords.is_on_board((0, 8)) and not tcoords.is_on_board((9, 0))


def test_sgf_copy_equals_original(tmp_path):
    moves = [40, 30, -1, 21, 0, 80, -1, -1]
    kw = dict(komi=6.5, black="a", white="b", result="B+2.5", comment="c")
    jp, tp = os.path.join(tmp_path, "j.sgf"), os.path.join(tmp_path, "t.sgf")
    assert tsgf.write_sgf(moves, tp, **kw) == jsgf.write_sgf(moves, jp, **kw)
    assert tsgf.read_moves(jp) == jsgf.read_moves(tp) == moves
    assert tsgf.read_result(jp) == jsgf.read_result(tp) == "B+2.5"
    board = ("XO." * 27)[:81]
    assert tsgf.board_to_sgf(board, 3) == jsgf.board_to_sgf(board, 3)
    with pytest.raises(IOError):
        tsgf.read_moves(os.path.join(tmp_path, "none.sgf"))


def test_engine_config_copy_equals_original():
    assert dataclasses.asdict(EngineConfig()) == dataclasses.asdict(JEngineConfig())
    assert dataclasses.asdict(SearchConfig()) == dataclasses.asdict(JSearchConfig())
