"""The eval phase's board analysis on the CPU: ``rules.leaf_analysis``'s
planes against ``features_batch`` and ``features_from_tables``, the crafted
positions of ``tests/torch_leaf_boards.py`` (which the card's tests of K5
``leaf_tables`` also take) doing what they claim, the search handing the
net those planes, and the wrapper's checks.  The kernel itself runs only on
the card (``tests/test_torch_cuda.py -k leaf_tables``); a plain run counts
no launch.  Jax-free."""

import pytest
import torch

from bokego_tpu_torch import features
from bokego_tpu_torch.config import SearchConfig
from bokego_tpu_torch.coords import NN
from bokego_tpu_torch.env import rules
from bokego_tpu_torch.ops import leaf
from bokego_tpu_torch.search import mcts
from bokego_tpu_torch.utils import metrics
from tests.torch_fake_eval import stones_evaluator
from tests.torch_leaf_boards import CRAFTED, crafted_positions, random_positions


def _positions(which: str):
    if which == "crafted":
        return crafted_positions("cpu")
    n_moves, seed = map(int, which.split("-"))
    return random_positions(16, n_moves, seed, "cpu")


@pytest.mark.parametrize("which", ["0-1", "12-2", "40-3", "75-4", "crafted"])
def test_leaf_analysis_planes_equal_the_feature_encoder(which):
    """The planes that ``rules.leaf_analysis`` returns are
    ``features_batch``'s and ``features_from_tables``' of its own tables."""
    s = _positions(which)
    la = rules.leaf_analysis(s)
    assert la.planes.shape == (s.board.shape[0], 9, 9, 27) and la.planes.dtype == torch.float32
    assert torch.equal(la.planes, features.features_batch(s))
    assert torch.equal(la.planes, features.features_from_tables(s, la.mt))
    plain, _ = rules._leaf_analysis(s)
    assert plain.planes is None
    for x, y in zip(plain.children.tensors(), la.children.tensors()):
        assert torch.equal(x, y)


def _crafted(name: str):
    i = list(CRAFTED).index(name)
    return rules.leaf_analysis(crafted_positions("cpu").map(lambda x: x[i : i + 1]))


def _pt(r, c):
    return r * 9 + c


def test_crafted_positions_reach_what_they_name():
    """Each crafted position shows its case in the plain version's tables."""
    snake = _crafted("snake_black_to_play").mt.info
    assert int(snake.sizes.max()) == 49 and set(snake.labels[0].tolist()) == {0, NN}
    two = _crafted("captures_two_groups")
    assert int(two.mt.caps[0, 0]) == 2 and int(two.mt.libs_after[0, 0]) == 2
    assert int(two.children.board[0, 0, 1]) == int(two.children.board[0, 0, 9]) == 0
    eight = _crafted("captures_eight")
    assert int(eight.mt.caps[0, 8]) == 8 and int(eight.planes[0, 0, 8, 26]) == 7
    assert int(eight.mt.info.libs.max()) == 10 and int(eight.planes[0, 1, 0, 12]) == 7
    ko_take = _crafted("ko_to_take")
    assert int(ko_take.children.ko[0, _pt(1, 2)]) == _pt(1, 1) and int(ko_take.mt.caps[0, _pt(1, 2)]) == 1
    assert not bool(_crafted("ko_just_taken").mt.legal[0, _pt(1, 1)])
    assert not bool(_crafted("suicide_point").mt.legal[0, 0])
    for side, caps in (("black", 36), ("white", 44)):
        full = _crafted(f"full_but_one_{side}")
        assert int(full.mt.legal.sum()) == 1 and int(full.mt.caps[0, _pt(4, 4)]) == caps
    assert int(_crafted("empty").mt.legal.sum()) == NN


def test_snake_takes_the_most_label_passes():
    """The winding chain needs more label passes than any seeded position."""
    def passes(s):
        with metrics.recording() as rec:
            rules.group_info(s.board)
        return rec.phases["sync.group_pass"].count

    snake = crafted_positions("cpu").map(lambda x: x[1:2])
    assert passes(snake) > max(passes(random_positions(64, n, 5, "cpu")) for n in (20, 60))


def test_search_evaluates_the_leaf_analysis_planes_and_counts_no_launch(monkeypatch):
    """An eval step hands the net the planes of ``rules.leaf_analysis`` of
    the leaves; on the CPU that is the plain version, which counts no
    ``ops.leaf_tables`` launch."""
    seen, analysed = [], []
    base = stones_evaluator()

    def evaluate_fts(params, fts):
        seen.append(fts)
        return base.evaluate_fts(params, fts)

    plain_la = rules.leaf_analysis

    def leaf_analysis(state):
        la = plain_la(state)
        analysed.append((state, la))
        return la

    ev = base._replace(evaluate_fts=evaluate_fts)
    cfg = SearchConfig(expand_thresh=1, no_sim=True, max_turns=80, max_nodes=128, n_rollouts=16,
                       eval_every=2, kernel_levels=6, use_kernel=True)
    roots = random_positions(4, 10, 6, "cpu")
    monkeypatch.setattr(rules, "leaf_analysis", leaf_analysis)
    with metrics.recording() as rec:
        mcts.search(roots, ev, None, cfg)
    assert analysed and len(seen) == len(analysed)  # the roots go through ev.evaluate
    for (state, la), fts in zip(analysed, seen):
        assert fts is la.planes and torch.equal(fts, features.features_batch(state))
    assert rec.phases["rules.leaf_analysis"].count == rec.phases["search.eval_and_expand"].count
    assert "ops.leaf_tables" not in rec.counters


@pytest.mark.parametrize(
    "case",
    ["cpu_board", "board_dtype", "board_shape", "ko_dtype", "turn_shape", "last_move_strided"],
)
def test_leaf_tables_wrapper_refuses_what_it_cannot_take(case):
    """The kernel's wrapper raises on inputs it cannot take and on a CPU
    tensor (the plain version is ``rules`` and ``features``); it never
    falls back, and counts nothing when it raises."""
    s = random_positions(4, 6, 1, "cpu")
    args = dict(board=s.board, ko=s.ko, turn=s.turn, last_move=s.last_move)
    if case == "board_dtype":
        args["board"] = s.board.long()
    elif case == "board_shape":
        args["board"] = s.board[:, :80]
    elif case == "ko_dtype":
        args["ko"] = s.ko.int()
    elif case == "turn_shape":
        args["turn"] = s.turn[:3]
    elif case == "last_move_strided":
        args["last_move"] = torch.stack([s.last_move, s.last_move], 1)[:, 0]
    with metrics.recording() as rec, pytest.raises((TypeError, ValueError)):
        leaf.leaf_tables(**args)
    assert "ops.leaf_tables" not in rec.counters


def test_on_card_picks_by_device():
    """CPU tensors take the plain version; a device that is neither raises."""
    assert leaf.on_card(torch.zeros(1, NN, dtype=torch.int8)) is False
    with pytest.raises(ValueError):
        leaf.on_card(torch.zeros(1, NN, dtype=torch.int8, device="meta"))
