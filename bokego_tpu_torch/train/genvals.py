"""Value-net training data (counterpart of ``bokego_tpu/train/genvals.py``).

The recipe: play the SL policy for ``r ~ U[min_r, max_r)`` plies (one r per
board), play one uniformly random legal move at ply r (the labelled
position is recorded right after it), finish the game with the RL policy,
and label with whether the random move's player won.  Labels use the
dead-group-aware resolved score by default (``env/scoring.py``) and raw
Tromp-Taylor with ``resolved_labels=False``.  Rows are ``(board, ko, move,
val)`` with val in {0, 1}, x8 D4 in the csv.

The JAX package runs the plies in one ``lax.scan``; here they are a host
loop over ``max_turns + 1`` plies, every board of the batch stepping in
lockstep.  All draws come from one ``torch.Generator``: the same recipe, a
different stream from the JAX package's.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from bokego_tpu_torch.coords import NN
from bokego_tpu_torch.env import rules, scoring, state as st
from bokego_tpu_torch.features import features_batch
from bokego_tpu_torch.models import inference
from bokego_tpu_torch.models.nets import PolicyNet
from bokego_tpu_torch.search.playout import select_moves
from bokego_tpu_torch.train.data import board_strings, d4_apply_moves, d4_board_string


class ValueSamples(NamedTuple):
    board: torch.Tensor  # (B, 81) int8: the position after the random move
    ko: torch.Tensor  # (B,)
    move: torch.Tensor  # (B,) the random move
    val: torch.Tensor  # (B,) 1 iff the random move's player won
    ok: torch.Tensor  # (B,) the game reached its ply r with a real move


def generate(
    gen: torch.Generator,
    sl_net: PolicyNet,
    rl_net: PolicyNet,
    batch: int,
    *,
    max_turns: int = 90,
    min_r: int = 70,
    max_r: int = 90,
    resolved_labels: bool = True,
    resolve_playouts: int = 17,  # odd: no exact ties in the ownership vote
) -> ValueSamples:
    """One batch of labelled positions on the nets' device."""
    dev = next(sl_net.parameters()).device
    r = torch.randint(min_r, max_r, (batch,), generator=gen, device=dev)
    s = st.new_game_batch(batch, device=dev)
    done = torch.zeros(batch, dtype=torch.bool, device=dev)
    board, ko = s.board.clone(), s.ko.clone()
    move = torch.zeros(batch, dtype=torch.int64, device=dev)
    ok = torch.zeros(batch, dtype=torch.bool, device=dev)
    for step_i in range(max_turns + 1):
        fts = features_batch(s)
        before = step_i < r
        probs = inference.policy_probs(sl_net, fts)
        if rl_net is not sl_net:
            probs = torch.where(before[:, None], probs, inference.policy_probs(rl_net, fts))
        # at each board's ply r, a uniformly random legal move
        is_r = step_i == r
        uniform = rules.legal_mask(s)[:, :NN].float()
        probs = torch.where(is_r[:, None], uniform, probs)
        actions = select_moves(gen, probs, s, avoid_eyes=False, done=done)
        s = rules.step(s, actions)
        take = is_r & ~done & (actions < NN)
        board = torch.where(take[:, None], s.board, board)
        ko = torch.where(take, s.ko, ko)
        move = torch.where(take, actions, move)
        ok = ok | take
        done = done | rules.is_terminal(s, max_turns)

    if resolved_labels:
        score = scoring.resolved_scores(gen, s, n_playouts=resolve_playouts, num_steps=96)
    else:
        score = rules.score(s)
    black_won = score > 0
    rand_is_black = r % 2 == 0
    val = (black_won == rand_is_black).to(torch.int64)
    return ValueSamples(board=board, ko=ko, move=move, val=val, ok=ok)


def samples_to_rows(samples: ValueSamples) -> list[tuple[str, int | None, int, int]]:
    """Host rows (board, ko, move, val) of the valid samples."""
    ok = samples.ok.cpu().numpy()
    boards = board_strings(samples.board.cpu().numpy()[ok])
    kos = samples.ko.cpu().numpy()[ok]
    moves = samples.move.cpu().numpy()[ok]
    vals = samples.val.cpu().numpy()[ok]
    return [
        (b, None if k < 0 else int(k), int(m), int(v)) for b, k, m, v in zip(boards, kos, moves, vals)
    ]


def write_csv(path: str, rows, augment: bool = True, header: bool = True):
    """Append rows (board, ko, move, val), optionally x8 D4."""
    new = not os.path.exists(path)
    with open(path, "a+") as f:
        if new and header:
            f.write("board,ko,last,val\n")
        for board, ko, move, val in rows:
            for k in range(8) if augment else (0,):
                b = d4_board_string(board, k)
                m = int(d4_apply_moves(move, k))
                kk = "" if ko is None else int(d4_apply_moves(ko, k))
                f.write(f"{b},{kk},{m},{val}\n")
