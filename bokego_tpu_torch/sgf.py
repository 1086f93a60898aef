"""SGF reading and writing (copy of ``bokego_tpu.sgf``; host only).

Moves are host-encoded squashed coords with PASS = -1; SGF letter pairs map
as ``column = chr(sq // 9 + 'a')``, ``row = chr(sq % 9 + 'a')``.
"""

from __future__ import annotations

import os
import re

from bokego_tpu_torch.coords import N, NN, PASS

_MOVE_RE = re.compile(r";([BW])\[(\w*)\]")


def read_moves(path: str) -> list[int]:
    """Extract the move sequence from an SGF file."""
    if not os.path.exists(path):
        raise IOError(f"Can't open sgf '{path}'")
    with open(path) as f:
        text = f.read()
    moves = []
    for _color, mv in _MOVE_RE.findall(text):
        if not mv:
            moves.append(PASS)
        else:
            moves.append(N * (ord(mv[0]) - 97) + (ord(mv[1]) - 97))
    return moves


def read_result(path: str) -> str | None:
    """The RE[...] property, if present."""
    with open(path) as f:
        m = re.search(r"RE\[([^\]]*)\]", f.read())
    return m.group(1) if m else None


def moves_to_sgf(
    moves: list[int],
    komi: float = 5.5,
    black: str = "",
    white: str = "",
    result: str = "",
    handicap: int = 0,
    comment: str = "",
) -> str:
    """Serialize a move sequence."""
    out = f"(;GM[1]HA[{handicap}]RU[Chinese]"
    if black and white:
        out += f"PB[{black}]PW[{white}]"
    if result:
        out += f"RE[{result}]"
    if comment:
        out += f"C[{comment}]"
    out += f"SZ[{N}]KM[{komi}]\n"
    color = "B"
    for mv in moves:
        if mv == PASS:
            out += f";{color}[]\n"
        else:
            out += f";{color}[{chr(mv // N + 97)}{chr(mv % N + 97)}]\n"
        color = "W" if color == "B" else "B"
    return out + ")"


def write_sgf(moves: list[int], path: str, **kwargs) -> str:
    text = moves_to_sgf(moves, **kwargs)
    with open(path, "w") as f:
        f.write(text)
    return text


def board_to_sgf(board_str: str, turn: int, komi: float = 5.5) -> str:
    """Serialize a position without move history via AB/AW setup properties
   ."""
    out = f"(;GM[1]RU[Chinese]HA[0]SZ[{N}]KM[{komi}]\n"
    ab, aw = "AB", "AW"
    for i in range(NN):
        c = board_str[i]
        pt = f"[{chr(i // N + 97)}{chr(i % N + 97)}]"
        if c == "X":
            ab += pt
        elif c == "O":
            aw += pt
    color = "B" if turn % 2 == 0 else "W"
    return out + ab + "\n" + aw + f"PL[{color}])"


def write_board_sgf(board_str: str, turn: int, path: str, komi: float = 5.5) -> str:
    text = board_to_sgf(board_str, turn, komi)
    with open(path, "w") as f:
        f.write(text)
    return text
