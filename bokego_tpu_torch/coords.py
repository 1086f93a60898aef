"""Board coordinates, adjacency tables and coordinate conversions (copy of
``bokego_tpu.coords``).

Coordinate systems: a *pair* ``(x, y)`` with ``x`` the row and ``y`` the
column; *squashed* ``sq = N*x + y``; *alphanumeric* ``"A1".."J9"`` (column
letter, skipping ``I``, then 1-based row).  Device code uses an *action*
encoding in which the extra index 81 is PASS; host-side APIs use ``PASS =
-1`` / ``RESIGN = -2``, and :func:`to_action` / :func:`from_action` convert.
The tables are rebuilt here by the same construction;
``tests/test_torch_env.py`` checks the copy equal to the original.
"""

from __future__ import annotations

import re

import numpy as np

N = 9
NN = N * N

PASS = -1
RESIGN = -2

# Device-side action ids.
PASS_ACTION = NN  # 81
NUM_ACTIONS = NN + 1  # 82

EMPTY, BLACK, WHITE = 0, 1, 2

# Star points in squashed coords.
FLOWERS9 = (20, 60, 24, 56, 40)


def squash(c):
    """Pair/alphanumeric/list -> squashed coordinate."""
    if isinstance(c, (list, tuple)) and c and isinstance(c[0], (list, tuple, str)):
        return [squash(x) for x in c]
    if isinstance(c, str):
        s = c.upper()
        if s == "PASS":
            return PASS
        m = re.match(r"([A-T])(\d+)", s)
        if m is None:
            raise ValueError(f"bad coordinate {c!r}")
        let, num = m[1], m[2]
        if let < "J":
            y = ord(let) - 65
        elif let == "J":
            y = 8
        else:
            y = ord(let) - 66
        return N * (int(num) - 1) + y
    return N * c[0] + c[1]


def unsquash(sq, alph: bool = True):
    """Squashed coordinate -> alphanumeric (or pair)."""
    if isinstance(sq, (list, tuple)):
        return [unsquash(x, alph) for x in sq]
    if sq == PASS:
        return "PASS"
    x, y = divmod(int(sq), N)
    if not alph:
        return (x, y)
    if y < 8:
        letr = chr(y + 65)
    elif y == 8:
        letr = "J"
    else:
        letr = chr(y + 66)
    return letr + str(x + 1)


def to_action(sq: int) -> int:
    """Host move id (PASS=-1) -> device action id (PASS=81)."""
    return PASS_ACTION if sq == PASS else sq


def from_action(a: int) -> int:
    """Device action id -> host move id."""
    return PASS if a == PASS_ACTION else int(a)


def is_on_board(c) -> bool:
    return 0 <= c[0] < N and 0 <= c[1] < N


def _build_table(offsets) -> np.ndarray:
    """(81, 4) int32 table of the points at ``offsets``, padded with NN."""
    out = np.full((NN, 4), NN, dtype=np.int32)
    for x in range(N):
        for y in range(N):
            for k, (dx, dy) in enumerate(offsets):
                if is_on_board((x + dx, y + dy)):
                    out[N * x + y, k] = N * (x + dx) + (y + dy)
    return out


NEIGHBORS = _build_table(((1, 0), (-1, 0), (0, 1), (0, -1)))
DIAGONALS = _build_table(((1, 1), (1, -1), (-1, -1), (-1, 1)))
