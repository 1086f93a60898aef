"""The Go game state as a dataclass of batched tensors.

Counterpart of ``bokego_tpu/env/state.py``.  Every field carries leading
batch dimensions (``(B,)`` for a batch of games, ``(B, Nmax)`` for a tree's
node pool, ``(B, 82)`` for successors); there is no unbatched form.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from bokego_tpu_torch.coords import BLACK, EMPTY, FLOWERS9, N, NN, PASS_ACTION, WHITE
from bokego_tpu_torch.device import resolve_device
from bokego_tpu_torch.env import zobrist

# last_move / ko sentinels (device encoding)
NO_MOVE = -1
NO_KO = -1

DEFAULT_KOMI = 5.5


@dataclasses.dataclass
class GoState:
    """Batched 9x9 Go positions.

    Attributes (``...`` = batch dims):
      board: int8[..., 81] — 0 empty, 1 black, 2 white.
      ko: int64[...] — ko point, -1 if none.
      turn: int64[...] — move number from 0; black plays on even turns.
      last_move: int64[...] — 0..80 point, 81 pass, -1 none.
      hash: int64[..., 2] — Zobrist (hi, lo) 32-bit words.
      komi: float32[...].
      invalid: bool[...] — latches True once an illegal action is stepped.
    """

    board: torch.Tensor
    ko: torch.Tensor
    turn: torch.Tensor
    last_move: torch.Tensor
    hash: torch.Tensor
    komi: torch.Tensor
    invalid: torch.Tensor

    @property
    def to_play(self) -> torch.Tensor:
        """1 (BLACK) on even turns, 2 (WHITE) on odd turns, as int8."""
        return (self.turn % 2 + 1).to(torch.int8)

    def tensors(self) -> list[torch.Tensor]:
        """The fields in declaration order."""
        return [getattr(self, f.name) for f in dataclasses.fields(self)]

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "GoState":
        """Apply ``fn`` to every field."""
        return GoState(*(fn(x) for x in self.tensors()))


def new_game_batch(
    batch_size: int, komi: float = DEFAULT_KOMI, device=None
) -> GoState:
    """``batch_size`` empty boards, black to play."""
    dev = resolve_device(device)
    b = batch_size
    return GoState(
        board=torch.zeros((b, NN), dtype=torch.int8, device=dev),
        ko=torch.full((b,), NO_KO, dtype=torch.int64, device=dev),
        turn=torch.zeros((b,), dtype=torch.int64, device=dev),
        last_move=torch.full((b,), NO_MOVE, dtype=torch.int64, device=dev),
        hash=torch.zeros((b, 2), dtype=torch.int64, device=dev),
        komi=torch.full((b,), komi, dtype=torch.float32, device=dev),
        invalid=torch.zeros((b,), dtype=torch.bool, device=dev),
    )


def new_game(komi: float = DEFAULT_KOMI, device=None) -> GoState:
    """One empty board, black to play, as a batch of one."""
    return new_game_batch(1, komi, device)


def from_board_string(
    board_str: str,
    ko: int | None = None,
    turn: int = 0,
    last_move: int | None = None,
    komi: float = DEFAULT_KOMI,
    device=None,
) -> GoState:
    """A batch of one from the reference's 81-char ``'.XO'`` board string.

    ``last_move=-1`` is the host PASS; the hash is recomputed from scratch.
    """
    dev = resolve_device(device)
    enc = {".": EMPTY, "X": BLACK, "O": WHITE}
    board = np.array([enc[c] for c in board_str], dtype=np.int8)
    ko_i = NO_KO if ko is None else int(ko)
    if last_move is None:
        lm = NO_MOVE
    elif last_move == -1:
        lm = PASS_ACTION
    else:
        lm = int(last_move)
    h = zobrist.full_hash_np(board, ko_i, turn).astype(np.int64)

    def vec(v, dtype):
        return torch.tensor([v], dtype=dtype, device=dev)

    return GoState(
        board=torch.from_numpy(board)[None].to(dev),
        ko=vec(ko_i, torch.int64),
        turn=vec(turn, torch.int64),
        last_move=vec(lm, torch.int64),
        hash=torch.from_numpy(h)[None].to(dev),
        komi=vec(komi, torch.float32),
        invalid=vec(False, torch.bool),
    )


def to_board_string(state: GoState, index: int = 0) -> str:
    """Board ``index`` of a batch -> reference-style 81-char string."""
    dec = {EMPTY: ".", BLACK: "X", WHITE: "O"}
    return "".join(dec[int(c)] for c in state.board[index].cpu().numpy())


def render(state: GoState, index: int = 0) -> str:
    """Pretty-print board ``index`` of a batch, with star points."""
    cells = list(to_board_string(state, index))
    for f in FLOWERS9:
        if cells[f] == ".":
            cells[f] = "+"
    header = "\t   " + " ".join("ABCDEFGHJ"[i] for i in range(N))
    rows = [
        "\t" + str(i + 1) + "  " + " ".join(cells[N * i : N * (i + 1)])
        for i in range(N)
    ]
    return header + "\n" + "\n".join(rows)
