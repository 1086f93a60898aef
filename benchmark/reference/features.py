"""The 27 input planes of BokeGo v0.3's nets, computed from a position of
the reference rules.

Planes: 0 the mover's stones, 1 the opponent's, 2 empty points, 3 all ones
when black is to move, 4 the last move's point, 5 legal moves, 6-12 the
liberties of the group at each stone, 13-19 the liberties of the mover's
group after playing at each legal point, 20-26 the stones that playing
there captures.  Each count n is bucketed over seven planes: plane k+n-1
holds n for 1 <= n <= 6, plane k+6 holds 7 for n > 6.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.rules import BLACK, EMPTY, NN, PASS, WHITE, OracleGame, group_of

NUM_PLANES = 27


def _bucket(out: np.ndarray, first: int, n: int, p: int) -> None:
    if 1 <= n <= 6:
        out[first + n - 1, p] = n
    elif n > 6:
        out[first + 6, p] = 7


def planes(game: OracleGame) -> np.ndarray:
    """float32 ``(27, 9, 9)``: the planes of ``game`` for the side to move."""
    out = np.zeros((NUM_PLANES, NN), dtype=np.float32)
    me = game.to_play
    them = WHITE if me == BLACK else BLACK
    libs = game.liberties()
    for p in range(NN):
        v = game.board[p]
        out[0, p] = v == me
        out[1, p] = v == them
        out[2, p] = v == EMPTY
        _bucket(out, 6, libs[p], p)
        if v != EMPTY:
            continue
        try:
            board, _, captured = game._try_play(p)
        except ValueError:
            continue
        out[5, p] = 1.0
        _bucket(out, 13, len(group_of(board, p)[1]), p)
        _bucket(out, 20, len(captured), p)
    out[3, :] = float(me == BLACK)
    if game.last_move is not None and game.last_move != PASS:
        out[4, game.last_move] = 1.0
    return out.reshape(NUM_PLANES, 9, 9)


def batch(games) -> np.ndarray:
    """float32 ``(B, 27, 9, 9)`` planes of a list of games."""
    return np.stack([planes(g) for g in games]) if games else np.zeros((0, NUM_PLANES, 9, 9), np.float32)
