"""Batched MCTS self-play (counterpart of ``bokego_tpu/parallel/selfplay.py``).

A batch of B games advances in lockstep: per move, a fresh-tree search on
every game, then one batched rules step.  The JAX package scans this loop
under ``jit``; here it is a Python loop over moves.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bokego_tpu_torch.config import SearchConfig
from bokego_tpu_torch.coords import PASS_ACTION
from bokego_tpu_torch.env import rules, state as st
from bokego_tpu_torch.env.state import GoState
from bokego_tpu_torch.search import mcts


class SelfplayResult(NamedTuple):
    final: GoState  # (B,)
    actions: torch.Tensor  # (n_moves, B) — PASS once a game is done
    scores: torch.Tensor  # (B,) Tromp-Taylor


def selfplay(
    params,
    ev: mcts.Evaluator,
    cfg: SearchConfig,
    batch: int,
    n_moves: int,
    n_rollouts: int,
    device=None,
) -> SelfplayResult:
    """Play ``batch`` games for ``n_moves`` plies of MCTS each on ``device``
    (the GPU unless ``device="cpu"``)."""
    states = st.new_game_batch(batch, device=device)
    done = torch.zeros(batch, dtype=torch.bool, device=states.board.device)
    moves = []
    for _ in range(n_moves):
        actions, _ = mcts.search(states, ev, params, cfg, n_rollouts)
        actions = torch.where(done, PASS_ACTION, actions)
        states = rules.step(states, actions)
        done = done | rules.is_terminal(states, cfg.max_turns)
        moves.append(actions)
    actions = torch.stack(moves) if moves else torch.zeros((0, batch), dtype=torch.int64)
    return SelfplayResult(final=states, actions=actions, scores=rules.score(states))
