"""The port's policy playouts and simulation mode.

The cases of ``tests/test_playout.py`` on the port (legality on the oracle,
eye avoidance, reward sign, done boards passing, the early exit), a
frequency test of one non-degenerate ply, and parity with the JAX package
where the draws cannot matter: with the one-hot playout policy
(``tests/torch_fake_eval.onehot_policy`` and its JAX twin below) the masked
distribution has a single point of mass, so ``jax.random.categorical`` and
``torch.multinomial`` pick the same move whatever their streams.  Those
comparisons are exact (tolerance 0): final boards, rewards, and every tree
array of a ``no_sim=False`` search in both orderings."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bokego_tpu.config import SearchConfig as JConfig
from bokego_tpu.coords import NN as JNN
from bokego_tpu.env import rules as jrules
from bokego_tpu.search import mcts as jmcts
from bokego_tpu.search import playout as jpo
from bokego_tpu_torch.config import SearchConfig as TConfig
from bokego_tpu_torch.coords import NN, PASS_ACTION
from bokego_tpu_torch.env import rules, state as st
from bokego_tpu_torch.search import mcts as tmcts
from bokego_tpu_torch.search import playout as po
from tests.oracle import OracleGame
from tests.test_mcts import fake_evaluator as jax_fake_evaluator
from tests.torch_fake_eval import fake_evaluator, onehot_evaluator, onehot_policy
from tests.torch_port_util import assert_states_equal, random_positions, to_port

TREE_FIELDS = ("pstats", "root_stats", "n_nodes", "parent", "action", "value", "expanded", "terminal", "root")


def uniform_probs(states):
    return torch.full((states.turn.shape[0], NN), 1.0 / NN)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _new_games(batch):
    return st.new_game_batch(batch, device="cpu")


def test_playout_legal_and_lockstep():
    B, T = 8, 30
    traj = po.playout(_gen(0), uniform_probs, uniform_probs, _new_games(B), num_steps=T, max_turns=80)
    assert traj.actions.shape == (T, B) and traj.states.board.shape == (T, B, NN)
    games = [OracleGame() for _ in range(B)]
    acts = traj.actions.numpy()
    for t in range(T):
        for b in range(B):
            a = int(acts[t, b])
            if a == PASS_ACTION:
                games[b].play(-1)
            else:
                assert games[b].is_legal(a), f"t={t} b={b} a={a}"
                games[b].play(a)
    for b in range(B):
        np.testing.assert_array_equal(traj.final.board[b].numpy(), np.array(games[b].board))
    assert len(set(traj.final.turn.tolist())) == 1  # lockstep turn parity
    assert not bool(traj.final.invalid.any())


def test_playout_eye_avoidance():
    """With avoid_eyes, a policy playout never fills its own one-point eye."""
    B, T = 16, 40
    traj = po.playout(
        _gen(1), uniform_probs, uniform_probs, _new_games(B), num_steps=T, max_turns=80, avoid_eyes=True
    )
    acts, boards = traj.actions.numpy(), traj.states.board.numpy()
    kos, turns = traj.states.ko.numpy(), traj.states.turn.numpy()
    for t in range(T):
        for b in range(B):
            a = int(acts[t, b])
            if a == PASS_ACTION:
                continue
            g = OracleGame(board=list(boards[t, b]), ko=None if kos[t, b] < 0 else int(kos[t, b]), turn=int(turns[t, b]))
            assert g.eye_color(a) != g.to_play, f"filled own eye t={t} b={b}"


def test_rewards_sign():
    black = st.from_board_string("X" * 80 + ".", device="cpu")
    white = st.from_board_string("O" * 80 + ".", device="cpu")
    assert po.rewards(black).tolist() == [1.0] and po.rewards(white).tolist() == [-1.0]


def test_done_games_keep_passing():
    """A terminal board stays unchanged while the others go on."""
    states = rules.step(_new_games(2), torch.tensor([PASS_ACTION, 40]))
    traj = po.playout(_gen(2), uniform_probs, uniform_probs, states, num_steps=10, max_turns=80)
    assert bool((traj.actions[:, 0] == PASS_ACTION).all())
    assert torch.equal(traj.final.board[0], states.board[0])
    assert not bool((traj.actions[:, 1] == PASS_ACTION).all())


def test_playout_final_terminates_and_matches_scan_semantics():
    """playout_final ends with every board terminal, from a midgame start
    well before the full ply budget, and its rewards follow the score."""
    traj = po.playout(_gen(2), uniform_probs, uniform_probs, _new_games(8), num_steps=60, max_turns=80)
    calls = []

    def counted(states):
        calls.append(1)
        return uniform_probs(states)

    final = po.playout_final(_gen(3), counted, counted, traj.final, max_turns=80)
    assert bool(rules.is_terminal(final, 80).all())
    assert 0 < len(calls) <= 22  # turn 60 -> past 80 at most; the budget is 82 plies
    r, s = po.rewards(final).numpy(), rules.score(final).numpy()
    np.testing.assert_array_equal(r, np.where(s > 0, 1.0, -1.0))
    # a batch that is terminal already costs no policy forward
    assert po.playout_final(_gen(3), None, None, final, max_turns=80) is final


def test_playout_alternates_two_policies():
    """Even steps draw from the first policy, odd steps from the second."""

    def all_on(point):
        return lambda states: torch.nn.functional.one_hot(torch.full((states.turn.shape[0],), point), NN).float()

    traj = po.playout(_gen(0), all_on(40), all_on(20), _new_games(3), num_steps=2, max_turns=80)
    assert traj.actions.tolist() == [[40] * 3, [20] * 3]


def test_playout_step_follows_masked_distribution():
    """One ply of 4000 equal boards with a non-degenerate policy: the move
    frequencies follow the masked, renormalised distribution.  Fixed seed;
    each frequency within 4 standard errors + 1e-3 of its probability
    (a 4-sigma bound on 79 cells fails by chance about once in 200 seeds),
    and no mass on the occupied or masked-out points."""
    n = 4000
    one = rules.play_moves(_new_games(1), torch.tensor([[40], [41]]))
    states = one.map(lambda x: x.expand((n,) + x.shape[1:]).clone())
    probs = torch.arange(1.0, NN + 1).pow(1.5)
    probs = (probs / probs.sum()).expand(n, NN)
    done = torch.zeros(n, dtype=torch.bool)
    moves = po.select_moves(_gen(5), probs, states, avoid_eyes=False, done=done)
    legal = rules.legal_mask(one)[0, :NN]
    want = torch.where(legal, probs[0], 0.0)
    want = (want / want.sum()).numpy()
    freq = np.bincount(moves.numpy(), minlength=NN + 1)[:NN] / n
    assert freq[40] == 0 and freq[41] == 0 and int((moves == PASS_ACTION).sum()) == 0
    bound = 4 * np.sqrt(want * (1 - want) / n) + 1e-3
    assert np.all(np.abs(freq - want) <= bound), np.abs(freq - want).max()


# ---------------------------------------------------------------------------
# Against the JAX package, with the one-hot playout policy.


def jax_onehot_policy(params, states):
    """The JAX twin of ``tests/torch_fake_eval.onehot_policy``."""
    del params
    eyes = jrules.eye_colors_batch(states.board)
    playable = jrules.legal_mask_batch(states)[:, :JNN] & (eyes != states.to_play[:, None].astype(eyes.dtype))
    count = playable.sum(-1)
    chk = jnp.sum(states.board.astype(jnp.int32) * jnp.arange(1, 82)[None, :], axis=-1) + states.turn
    pick = chk % jnp.maximum(count, 1)
    return (playable & (jnp.cumsum(playable, axis=-1) == pick[:, None] + 1)).astype(jnp.float32)


def jax_onehot_evaluator():
    return jmcts.Evaluator(evaluate=jax_fake_evaluator().evaluate, policy_probs=jax_onehot_policy, has_value=True)


def _positions(seed, batch, n_moves, komi):
    """Random midgame positions with one komi per board, so that the
    playouts' rewards differ between the boards."""
    js = random_positions(seed, batch, n_moves, pass_prob=0.05)
    return js.replace(komi=jnp.asarray(komi, jnp.float32))


def test_onehot_policy_matches_jax_twin():
    js = random_positions(41, 16, 50, pass_prob=0.05)
    jp = np.asarray(jax_onehot_policy(None, js))
    tp = onehot_policy(None, to_port(js)).numpy()
    np.testing.assert_array_equal(tp, jp)
    assert set(tp.sum(-1).tolist()) <= {0.0, 1.0} and tp.sum() >= 12


@pytest.mark.parametrize("seed,n_moves,max_turns", [(42, 20, 60), (43, 55, 80)])
def test_playout_final_and_rewards_match_jax(seed, n_moves, max_turns):
    js = _positions(seed, 6, n_moves, [-30.0, -3.5, 0.5, 5.5, 9.5, 40.0])
    jprobs = lambda s: jax_onehot_policy(None, s)  # noqa: E731
    jfinal = jax.jit(
        lambda s: jpo.playout_final(jax.random.PRNGKey(0), jprobs, jprobs, s, max_turns=max_turns, avoid_eyes=True)
    )(js)
    tprobs = lambda s: onehot_policy(None, s)  # noqa: E731
    tfinal = po.playout_final(_gen(9), tprobs, tprobs, to_port(js), max_turns=max_turns, avoid_eyes=True)
    assert_states_equal(jfinal, tfinal)
    jr, tr_ = np.asarray(jpo.rewards(jfinal)), po.rewards(tfinal).numpy()
    np.testing.assert_array_equal(tr_, jr)
    assert set(tr_.tolist()) == {1.0, -1.0}  # the komi spread gives both winners
    # a fixed-length playout records the same trajectory
    jtraj = jax.jit(
        lambda s: jpo.playout(jax.random.PRNGKey(1), jprobs, jprobs, s, num_steps=12, max_turns=max_turns, avoid_eyes=True)
    )(js)
    ttraj = po.playout(_gen(1), tprobs, tprobs, to_port(js), num_steps=12, max_turns=max_turns, avoid_eyes=True)
    np.testing.assert_array_equal(ttraj.actions.numpy(), np.asarray(jtraj.actions))
    assert_states_equal(jtraj.final, ttraj.final)
    assert_states_equal(
        jax.tree.map(lambda x: x[7], jtraj.states), ttraj.states.map(lambda x: x[7])
    )


def test_simulate_matches_jax():
    """``mcts._simulate``: the reward from the side of the leaf's mover."""
    cfg = dict(no_sim=False, max_turns=50)
    js = _positions(44, 6, 15, [-30.0, -3.5, 0.5, 5.5, 9.5, 40.0])
    odd = jrules.step_batch(js, jnp.full((6,), 81, jnp.int32))  # white to move, and terminal after the pass
    for states in (js, odd):
        jr = np.asarray(jmcts._simulate(jax.random.PRNGKey(0), states, jax_onehot_evaluator(), None, JConfig(**cfg)))
        tr_ = tmcts._simulate(_gen(0), to_port(states), onehot_evaluator(), None, TConfig(**cfg)).numpy()
        np.testing.assert_array_equal(tr_, jr)
    assert set(tr_.tolist()) == {1.0, -1.0}


@pytest.mark.parametrize(
    "eval_every,value_net_weight,use_kernel",
    [(1, 0.5, False), (2, 0.5, False), (1, 0.25, False), (2, 0.5, True)],
)
def test_simulation_mode_search_matches_jax(eval_every, value_net_weight, use_kernel):
    """A ``no_sim=False`` search in both orderings, array for array; with
    ``use_kernel=True`` both packages take their non-kernel path."""
    cfg = dict(
        no_sim=False, max_turns=40, max_nodes=256, expand_thresh=2, eval_every=eval_every,
        value_net_weight=value_net_weight, use_kernel=use_kernel,
    )
    n = 16
    js = _positions(45, 3, 14, [-20.0, 2.5, 30.0])
    jev = jax_onehot_evaluator()
    jt = jmcts.init_trees(jax.random.PRNGKey(0), js, jev, None, JConfig(**cfg))
    jt = jax.jit(lambda t: jmcts.run_search(jax.random.PRNGKey(1), t, jev, None, JConfig(**cfg), n))(jt)

    tev = onehot_evaluator()
    ta, tt = tmcts.search(to_port(js), tev, None, TConfig(**cfg), n, gen=_gen(0))
    for f in TREE_FIELDS:
        np.testing.assert_array_equal(getattr(tt, f).numpy(), np.asarray(getattr(jt, f)), err_msg=f)
    assert_states_equal(jt.nodes, tt.nodes, fields=("board", "ko", "turn", "last_move"))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(jax.vmap(jmcts.choose_action)(jt)))
    # every rollout played its leaf out: the roots' Wq moved, not all one way
    wq = tt.root_stats[:, 1]
    assert bool((wq != 0).all()) and len(set(wq.tolist())) > 1
    assert float(tt.pstats[:, :, 1].abs().sum()) > 0
    # step by step gives the same trees
    stepped = tmcts.init_trees(to_port(js), tev, None, TConfig(**cfg))
    gen = _gen(3)
    for i in range(n):
        stepped = tmcts.search_step(stepped, tev, None, TConfig(**cfg), i, gen=gen)
    for f in TREE_FIELDS:
        np.testing.assert_array_equal(getattr(stepped, f).numpy(), getattr(tt, f).numpy(), err_msg=f)


def test_simulation_mode_needs_policy_and_generator():
    """What simulation mode needs is asked for by name; nothing falls back."""
    ts = to_port(random_positions(46, 2, 6))
    cfg = TConfig(no_sim=False, max_turns=20, max_nodes=128)
    ev = fake_evaluator()
    trees = tmcts.init_trees(ts, ev, None, cfg)
    with pytest.raises(ValueError, match="policy_probs"):
        tmcts.search_step(trees, ev._replace(policy_probs=None), None, cfg, gen=_gen(0))
    with pytest.raises(ValueError, match="Generator"):
        tmcts.search_step(trees, ev, None, cfg)
    # a real (non-degenerate) playout policy runs and counts its rollouts
    trees = tmcts.run_search(trees, ev, None, cfg, 3, gen=_gen(0))
    assert trees.root_stats[:, 0].tolist() == [3.0, 3.0]
    assert bool((trees.root_stats[:, 1].abs() <= 3.0).all())
