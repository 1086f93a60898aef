"""Pieces the match entry points share: loading nets, the 95 % interval as
the tools print it, and the policy-sampled opening."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from bokego_tpu_torch.config import SearchConfig
from bokego_tpu_torch.coords import PASS_ACTION
from bokego_tpu_torch.env import rules, scoring, state as st
from bokego_tpu_torch.env.state import GoState
from bokego_tpu_torch.search import mcts
from bokego_tpu_torch.search.playout import select_moves

OPEN_PLIES = 6  # policy-sampled opening plies: PUCT with zero noise is
# deterministic, so without them every game of a batch is a replica
RESOLVE_PLAYOUTS, RESOLVE_STEPS = 63, 96  # the resolver's random games a board, and their plies


def load_net(path: str, kind: str, device) -> torch.nn.Module:
    """The ``"policy"`` or ``"value"`` net of ``path`` on ``device``: a torch
    ``.pt`` checkpoint, or ``random`` / ``random:SEED`` for a seeded random
    init (seed 0 without one)."""
    from bokego_tpu_torch.cli import load_variables
    from bokego_tpu_torch.models import nets

    if path.startswith("random"):
        seed = int(path.split(":", 1)[1]) if ":" in path else 0
        init = nets.init_policy if kind == "policy" else nets.init_value
        return init(seed=seed, device=device)
    return load_variables(path, kind, device)


def load_params(policy: str, value: str, device) -> dict:
    """``{"policy": …, "value": …}`` for ``mcts.net_evaluator``."""
    return {"policy": load_net(policy, "policy", device), "value": load_net(value, "value", device)}


def interval(p: float, n: int, floor: float = 0.0) -> float:
    """Half-width of the normal 95 % interval of a winrate ``p`` over ``n``
    games, ``1.96 * sqrt(max(p (1 - p), floor) / n)``; the tools that print
    ``+/-`` pass ``floor=1e-9``, so that a sweep shows a non-zero width."""
    return 1.96 * math.sqrt(max(p * (1.0 - p), floor) / n)


def resolved_scores(gen: torch.Generator, states: GoState) -> torch.Tensor:
    """(B,) dead-group-aware scores of finished games, black minus (white +
    komi): ``RESOLVE_PLAYOUTS`` random resolutions of up to ``RESOLVE_STEPS``
    plies a board, as the JAX tools judge their finals."""
    return scoring.resolved_scores(gen, states, n_playouts=RESOLVE_PLAYOUTS, num_steps=RESOLVE_STEPS)


def sample_opening(gen: torch.Generator, probs: torch.Tensor, states: GoState, done: torch.Tensor) -> torch.Tensor:
    """One opening move per board, sampled from ``probs (B, 81)`` over the
    legal points that are not the mover's own eyes; finished boards pass."""
    return select_moves(gen, probs, states, avoid_eyes=True, done=done)


class Side(NamedTuple):
    """What one side of a batched match searches with."""

    params: dict
    cfg: SearchConfig
    n_rollouts: int


class Games(NamedTuple):
    """A batch of finished games."""

    won: torch.Tensor  # (B,) bool: side A won
    scores: torch.Tensor  # (B,) f32 black minus (white + komi)
    final: GoState  # (B, ...) final states
    actions: torch.Tensor  # (n_moves, B) int64 device actions, 81 = pass
    done: torch.Tensor  # (B,) bool: the game ended before the move cap


def play_batch(
    gen: torch.Generator,
    side_a: Side,
    side_b: Side,
    ev: mcts.Evaluator,
    batch: int,
    a_is_black: bool,
    n_moves: int,
    open_plies: int,
    resolved: bool,
    device,
) -> Games:
    """``batch`` games in lockstep, A as black iff ``a_is_black``: the first
    ``open_plies`` plies sampled from the mover's policy, then each move
    searched by the mover's side from a fresh tree; finished games pass.
    Scored by Tromp-Taylor, or with ``resolved`` by :func:`resolved_scores`.
    ``gen`` draws the openings and the resolutions (a search without root
    noise draws nothing)."""
    states = st.new_game_batch(batch, device=device)
    done = torch.zeros(batch, dtype=torch.bool, device=states.board.device)
    taken = []
    for move in range(n_moves):
        side = side_a if (move % 2 == 0) == a_is_black else side_b
        if move < open_plies:
            actions = sample_opening(gen, ev.policy_probs(side.params, states), states, done)
        else:
            actions, _ = mcts.search(states, ev, side.params, side.cfg, side.n_rollouts, gen=gen)
        actions = torch.where(done, PASS_ACTION, actions)
        states = rules.step(states, actions)
        done = done | rules.is_terminal(states, n_moves)
        taken.append(actions)
    if resolved:
        scores = resolved_scores(gen, states)
    else:
        scores = rules.score(states)
    won = scores > 0 if a_is_black else scores < 0
    return Games(won=won, scores=scores, final=states, actions=torch.stack(taken), done=done)
