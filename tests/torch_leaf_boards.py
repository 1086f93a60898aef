"""Positions for the board-analysis tests (jax-free, so the GPU tests can use
them where JAX is not installed): seeded random games, and crafted boards
that reach the corners of ``rules.leaf_analysis`` (K5 ``leaf_tables`` on the
card): the label loop's worst case, multiple and large captures, a ko, a
suicide point, a full board."""

from __future__ import annotations

import torch

from bokego_tpu_torch.coords import NN
from bokego_tpu_torch.env import rules
from bokego_tpu_torch.env.state import NO_KO, NO_MOVE, GoState, new_game_batch

_B, _W = 1, 2


def random_positions(batch: int, n_moves: int, seed: int, device) -> GoState:
    """``batch`` games of ``n_moves`` uniformly drawn legal moves (a pass
    weighs a fiftieth of a point) from the empty board."""
    gen = torch.Generator(device=device).manual_seed(seed)
    s = new_game_batch(batch, device=device)
    for _ in range(n_moves):
        w = rules.legal_mask(s).float()
        w[:, NN] = 0.02
        s = rules.step(s, torch.multinomial(w, 1, generator=gen)[:, 0])
    return s


def _pt(r: int, c: int) -> int:
    return r * 9 + c


def _board(stones: dict[int, list[tuple[int, int]]]) -> list[int]:
    b = [0] * NN
    for color, pts in stones.items():
        for r, c in pts:
            b[_pt(r, c)] = color
    return b


def _snake() -> list[int]:
    """One black chain of 49 stones winding across the board: rows 0, 2, 4,
    6, 8 full, joined at alternate ends."""
    pts = [(r, c) for r in (0, 2, 4, 6, 8) for c in range(9)] + [(1, 8), (3, 0), (5, 8), (7, 0)]
    return _board({_B: pts})


def _two_groups() -> list[int]:
    """Black at A9 (0, 0) captures two single white stones at once."""
    return _board({_B: [(0, 2), (1, 1), (2, 0)], _W: [(0, 1), (1, 0)]})


def _eight_stones() -> list[int]:
    """Black at (0, 8) captures a white row of 8 (the captures' last plane);
    the black row below has 10 liberties (the liberties' last plane)."""
    return _board({_W: [(0, c) for c in range(8)], _B: [(1, c) for c in range(9)]})


def _ko_shape(taken: bool) -> list[int]:
    """The ko at (1, 1): before black takes at (1, 2), and after."""
    black = [(0, 1), (1, 0), (2, 1)] + ([(1, 2)] if taken else [])
    white = [(0, 2), (2, 2), (1, 3)] + ([] if taken else [(1, 1)])
    return _board({_B: black, _W: white})


def _suicide() -> list[int]:
    """(0, 0) is suicide for black: its neighbours are white stones with
    other liberties, none in atari."""
    return _board({_W: [(0, 1), (1, 0)], _B: [(4, 4)]})


def _full_board() -> list[int]:
    """Black fills columns 0-4, white 5-8, all but (4, 4): each side's group
    has that one liberty, and playing there takes the other's."""
    b = [_B if c <= 4 else _W for r in range(9) for c in range(9)]
    b[_pt(4, 4)] = 0
    return b


# name: (board, turn, ko, last move)
CRAFTED = {
    "empty": ([0] * NN, 0, NO_KO, NO_MOVE),
    "snake_black_to_play": (_snake(), 0, NO_KO, _pt(8, 8)),
    "snake_white_to_play": (_snake(), 1, NO_KO, _pt(7, 0)),
    "captures_two_groups": (_two_groups(), 6, NO_KO, _pt(1, 0)),
    "captures_eight": (_eight_stones(), 18, NO_KO, _pt(0, 7)),
    "ko_to_take": (_ko_shape(False), 8, NO_KO, _pt(1, 1)),
    "ko_just_taken": (_ko_shape(True), 9, _pt(1, 1), _pt(1, 2)),
    "suicide_point": (_suicide(), 4, NO_KO, _pt(4, 4)),
    "full_but_one_black": (_full_board(), 80, NO_KO, 81),
    "full_but_one_white": (_full_board(), 79, NO_KO, _pt(0, 8)),
}


def crafted_positions(device) -> GoState:
    """The :data:`CRAFTED` positions as one batch, in their order."""
    rows = list(CRAFTED.values())
    i64 = dict(dtype=torch.int64, device=device)
    n = len(rows)
    return GoState(
        board=torch.tensor([r[0] for r in rows], dtype=torch.int8, device=device),
        ko=torch.tensor([r[2] for r in rows], **i64),
        turn=torch.tensor([r[1] for r in rows], **i64),
        last_move=torch.tensor([r[3] for r in rows], **i64),
        hash=torch.zeros((n, 2), **i64),
        komi=torch.full((n,), 5.5, dtype=torch.float32, device=device),
        invalid=torch.zeros((n,), dtype=torch.bool, device=device),
    )
