"""Port parity of the dead-group scoring and its helpers against the JAX
package: ``eye_colors``, ``play_moves`` and ``render`` exact;
``select_moves`` / ``sample_moves`` by their contract (the draws are
torch's own); ``ownership`` / ``resolved_score`` by outcome (a vote over
random playouts: equal owners and score on settled positions, not equal
bits); the port's ``native`` binding equal to ``bokego_tpu.native`` call for
call (the same C++ with the same seed)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bokego_tpu import native as jnative
from bokego_tpu.env import rules as jrules
from bokego_tpu.env import scoring as jscoring
from bokego_tpu.env import state as jst
from bokego_tpu_torch import native as tnative
from bokego_tpu_torch.env import rules as trules
from bokego_tpu_torch.env import scoring as tscoring
from bokego_tpu_torch.env import state as tst
from bokego_tpu_torch.models.inference import sample_moves
from bokego_tpu_torch.search.playout import select_moves
from tests.torch_port_util import _jlegal, _jstep, assert_states_equal, random_actions, random_positions, to_port

# A settled final position: a black wall and a white wall with one dead
# white stone at (3, 0) inside black's side (tests/test_scoring.py).
SETTLED = (
    ".X.X.O.O."
    "XXXX.O.O."
    ".XXX.OOO."
    "O.XX.O..."
    ".XXX.O.O."
    "XXXX.OOO."
    ".X.X.O.O."
    "XXXX.O..."
    ".X.X.OOO."
)
# The same with black stones on the open middle column: nothing is left to
# contest, so two votes cannot differ anywhere.
FILLED = "".join("X" if i % 9 == 4 else c for i, c in enumerate(SETTLED))


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("n_moves", [20, 60])
def test_eye_colors_match_jax(n_moves):
    js = random_positions(41 + n_moves, 32, n_moves, pass_prob=0.02)
    want = np.asarray(jrules.eye_colors_batch(js.board))
    got = trules.eye_colors(to_port(js).board)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    if n_moves == 60:
        assert (want == 1).any() and (want == 2).any()  # eyes of both colours occur


def test_play_moves_and_render_match_jax():
    rng = np.random.default_rng(7)
    s = jst.new_game_batch(3)
    seq = []
    for _ in range(30):
        a = random_actions(rng, np.asarray(_jlegal(s)), pass_prob=0.05)
        s = _jstep(s, jnp.asarray(a))
        seq.append(a)
    ts = trules.play_moves(tst.new_game_batch(3, device="cpu"), torch.from_numpy(np.stack(seq)).long())
    assert_states_equal(s, ts)
    for i in range(3):
        assert tst.render(ts, i) == jst.render(jax.tree.map(lambda x: x[i], s))
    one = tst.new_game(6.5, device="cpu")
    assert one.board.shape == (1, 81) and float(one.komi[0]) == 6.5
    assert tst.render(one) == jst.render(jst.new_game(6.5))


def test_sample_moves_contract():
    """Masked and renormalised; uniform over the mask when no mass is left;
    81 when the mask is empty; reproducible for a seed."""
    probs = torch.tensor([[0.5, 0.5, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0], [0.25] * 4, [0.25] * 4])
    mask = torch.tensor(
        [[False, True, True, False], [True, True, False, False], [False] * 4, [True, False, False, True]]
    )
    draws = torch.stack([sample_moves(_gen(i), probs, mask) for i in range(200)])
    assert set(draws[:, 0].tolist()) == {1}  # the only masked point with mass
    assert set(draws[:, 1].tolist()) == {0, 1}  # no mass left: uniform over the mask
    assert abs(float((draws[:, 1] == 0).float().mean()) - 0.5) < 0.15
    assert set(draws[:, 2].tolist()) == {4}  # empty mask: PASS for a 4-point board
    assert set(draws[:, 3].tolist()) == {0, 3}
    wide = torch.rand(8, 81, generator=_gen(1))
    legal = torch.rand(8, 82, generator=_gen(2)) < 0.5  # a (B, 82) mask is cut to 81
    assert torch.equal(sample_moves(_gen(3), wide, legal), sample_moves(_gen(3), wide, legal))


def test_select_moves_are_legal_and_avoid_own_eyes():
    js = random_positions(43, 64, 60, pass_prob=0.02)
    ts = to_port(js)
    legal = np.asarray(jrules.legal_mask_batch(js))[:, :81]
    eyes = np.asarray(jrules.eye_colors_batch(js.board))
    own_eye = eyes == np.asarray(js.to_play)[:, None]
    assert (legal & own_eye).any()  # the filter has something to remove
    done = torch.zeros(64, dtype=torch.bool)
    done[:4] = True
    uniform = torch.full((64, 81), 1.0 / 81)
    for seed in range(5):
        mv = select_moves(_gen(seed), uniform, ts, avoid_eyes=True, done=done).numpy()
        assert (mv[:4] == 81).all()
        for b in range(4, 64):
            playable = legal[b] & ~own_eye[b]
            assert (mv[b] == 81 and not playable.any()) or playable[mv[b]]


def test_ownership_and_score_match_jax_on_settled_positions():
    """Both packages' votes (63 playouts each, each with its own random
    draws) give the same owners and, where nothing is contested, the same
    score; the dead stone is judged dead by both and by the native library.
    On the board with the open middle column only that column may differ."""
    for board_str in (SETTLED, FILLED):
        js = jst.from_board_string(board_str, turn=0, komi=5.5)
        ts = tst.from_board_string(board_str, turn=0, komi=5.5, device="cpu")
        jown = np.asarray(jscoring.ownership(jax.random.PRNGKey(0), js, n_playouts=63))
        town = tscoring.ownership(_gen(0), ts, n_playouts=63)
        assert town.dtype == torch.int8 and town.shape == (81,)
        settled = np.arange(81) % 9 != 4 if board_str is SETTLED else np.ones(81, bool)
        np.testing.assert_array_equal(town.numpy()[settled], jown[settled])
        assert (town.numpy()[settled] != 0).all()
        jscore = float(jscoring.resolved_score(jax.random.PRNGKey(1), js, n_playouts=63))
        tscore = float(tscoring.resolved_score(_gen(1), ts, n_playouts=63))
        if board_str is FILLED:
            assert tscore == jscore == 45 - 36 - 5.5
        else:
            assert abs(tscore - jscore) <= 9 and tscore - (36 - 36 - 5.5) in range(-9, 10)
        dead = tscoring.dead_stones(town, ts.board[0])
        np.testing.assert_array_equal(dead.numpy(), np.asarray(jscoring.dead_stones(jnp.asarray(jown), js.board)))
        assert dead.nonzero()[:, 0].tolist() == [27]  # the lone white stone, and nothing else
        assert float(trules.score(ts)[0]) != tscore  # raw Tromp-Taylor counts it alive
        nb = tnative.NativeBoard(5.5)
        nb.board[:] = ts.board[0].numpy()
        assert nb.ownership(n_playouts=63)[27] == 1


@pytest.mark.parametrize("seed", range(3))
def test_native_copy_equals_original_call_for_call(seed):
    assert tnative.available() and jnative.available()
    rng = np.random.default_rng(seed)
    tb, jb = tnative.NativeBoard(6.5), jnative.NativeBoard(6.5)
    moves = []
    for i in range(60):
        legal = tb.legal_moves()
        np.testing.assert_array_equal(legal, jb.legal_moves())
        np.testing.assert_array_equal(tb.liberties(), jb.liberties())
        assert tb.score() == jb.score()
        choices = np.flatnonzero(legal)
        mv = int(rng.choice(choices)) if len(choices) and rng.random() > 0.05 else -1
        assert tb.play(mv) == jb.play(mv)
        moves.append(mv)
        assert (tb.ko, tb.turn) == (jb.ko, jb.turn)
        np.testing.assert_array_equal(tb.board, jb.board)
    np.testing.assert_array_equal(tb.ownership(n_playouts=31, seed=3), jb.ownership(n_playouts=31, seed=3))
    assert tb.resolved_score() == jb.resolved_score()
    args = (tb.board.copy(), tb.ko, tb.turn, 6.5)
    assert tnative.resolved_score_raw(*args) == jnative.resolved_score_raw(*args) == tb.resolved_score()
    tr, jr = tnative.replay(moves, 6.5), jnative.replay(moves, 6.5)
    np.testing.assert_array_equal(tr.board, jr.board)
    np.testing.assert_array_equal(tr.board, tb.board)
    assert (tr.turn, tr.ko) == (jr.turn, jr.ko)


def test_native_illegal_moves_raise():
    nb = tnative.NativeBoard()
    nb.play(40)
    with pytest.raises(ValueError):
        nb.play(40)  # occupied
    with pytest.raises(ValueError):
        tnative.replay([40, 40])
    assert issubclass(tnative.NativeUnavailable, RuntimeError)
