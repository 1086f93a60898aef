"""Policy-SL training data from self-play games (counterpart of
``bokego_tpu/train/gendata.py``): (position, move) pairs recorded from
batched policy self-play, as csv rows for ``train/data.py`` or straight
into packed datasets, optionally under all 8 D4 symmetries."""

from __future__ import annotations

import os

import numpy as np
import torch

from bokego_tpu_torch.coords import NN
from bokego_tpu_torch.env import state as st
from bokego_tpu_torch.features import features_batch
from bokego_tpu_torch.models import inference
from bokego_tpu_torch.models.nets import PolicyNet
from bokego_tpu_torch.search import playout as po
from bokego_tpu_torch.train.data import (
    PackedDataset, board_strings, d4_apply_boards, d4_apply_moves, d4_board_string,
)


def probs_fn(net: PolicyNet):
    """States -> the net's move probabilities (a playout policy)."""

    def fn(states):
        return inference.policy_probs(net, features_batch(states))

    return fn


def generate(
    gen: torch.Generator,
    policy: PolicyNet,
    batch: int,
    *,
    max_turns: int = 70,
    opponent: PolicyNet | None = None,
) -> po.Trajectory:
    """``batch`` self-play games on the policy's device (the policy against
    itself, or against ``opponent`` on the odd plies)."""
    dev = next(policy.parameters()).device
    opp = opponent if opponent is not None else policy
    return po.playout(
        gen, probs_fn(policy), probs_fn(opp), st.new_game_batch(batch, device=dev),
        num_steps=max_turns + 1, max_turns=max_turns,
    )


def trajectory_to_rows(traj: po.Trajectory) -> list[tuple[str, int | None, int, int]]:
    """(board, ko, last, move) rows for every real (non-pass) move, in
    (t, b) order.  A position right after a pass is skipped: the csv schema
    derives the side to move from the colour at ``last``."""
    boards = traj.states.board.cpu().numpy()  # (T, B, 81)
    kos = traj.states.ko.cpu().numpy()
    lasts = traj.states.last_move.cpu().numpy()
    actions = traj.actions.cpu().numpy()
    keep = (actions < NN) & (lasts != NN)
    ts, bs = np.nonzero(keep)
    strs = board_strings(boards[ts, bs])
    rows = []
    for s, t, b in zip(strs, ts, bs):
        ko = None if kos[t, b] < 0 else int(kos[t, b])
        last = int(lasts[t, b])
        rows.append((s, ko, last if 0 <= last < NN else -1, int(actions[t, b])))
    return rows


def trajectory_to_packed(traj: po.Trajectory, augment: bool = True) -> PackedDataset:
    """Trajectory -> :class:`PackedDataset`, vectorised, optionally under
    all 8 symmetries.  The packed form stores the turn parity, so positions
    after a pass are kept."""
    boards = traj.states.board.cpu().numpy().reshape(-1, NN)
    kos = traj.states.ko.cpu().numpy().reshape(-1)
    lasts = traj.states.last_move.cpu().numpy().reshape(-1)
    turns = traj.states.turn.cpu().numpy().reshape(-1)
    actions = traj.actions.cpu().numpy().reshape(-1)

    keep = actions < NN  # real moves only
    boards = boards[keep].astype(np.uint8)
    kos = kos[keep].astype(np.int16)
    lasts = lasts[keep].astype(np.int16)
    turns = (turns[keep] % 2).astype(np.int8)
    actions = actions[keep].astype(np.int32)
    if not augment:
        return PackedDataset(boards, kos, lasts, turns, actions, False)

    ks = range(8)
    return PackedDataset(
        np.concatenate([d4_apply_boards(boards, k) for k in ks]),
        np.concatenate([d4_apply_moves(kos, k).astype(np.int16) for k in ks]),
        # -1 (none) and 81 (pass) are fixed points of the action map
        np.concatenate([np.where(lasts >= NN, lasts, d4_apply_moves(lasts, k)).astype(np.int16) for k in ks]),
        np.concatenate([turns] * 8),
        np.concatenate([d4_apply_moves(actions, k).astype(np.int32) for k in ks]),
        False,
    )


def write_csv(path: str, rows, augment: bool = True, header: bool = True):
    """Append policy rows (board, ko, last, move), optionally x8 D4."""
    new = not os.path.exists(path)
    with open(path, "a+") as f:
        if new and header:
            f.write("board,ko,last,move\n")
        for board, ko, last, move in rows:
            for k in range(8) if augment else (0,):
                b = d4_board_string(board, k)
                m = int(d4_apply_moves(move, k))
                la = last if last < 0 else int(d4_apply_moves(last, k))
                kk = "" if ko is None else int(d4_apply_moves(ko, k))
                f.write(f"{b},{kk},{la},{m}\n")
