"""Policy playouts on a batch of boards stepping in lockstep (counterpart
of ``bokego_tpu/search/playout.py``).

One policy evaluation per ply covers the whole batch.  Moves are sampled
from the policy's distribution masked to the legal points (optionally
without the mover's own one-point eyes) and renormalised; a board with no
playable point passes, and finished boards keep passing so that the whole
batch stays aligned in turn parity.

The random numbers come from the ``torch.Generator`` the caller passes (on
the boards' device): one ``multinomial`` draw per ply.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from bokego_tpu_torch.coords import NN, PASS_ACTION
from bokego_tpu_torch.env import rules
from bokego_tpu_torch.env.state import GoState
from bokego_tpu_torch.models.inference import sample_moves

ProbsFn = Callable[[GoState], torch.Tensor]  # batch of states -> probs (B, 81)


class Trajectory(NamedTuple):
    """Stacked playout record (time-major)."""

    states: GoState  # (T, B, ...): the state before each action
    actions: torch.Tensor  # (T, B) int64 device actions
    final: GoState  # (B, ...): the state after the last step


def select_moves(
    gen: torch.Generator,
    probs: torch.Tensor,
    states: GoState,
    avoid_eyes: bool,
    done: torch.Tensor,
) -> torch.Tensor:
    """One action per board sampled from ``probs (B, 81)`` over the legal
    points (without the mover's own one-point eyes when ``avoid_eyes``); a
    board with no playable point, or one that is ``done``, passes."""
    legal = rules.legal_mask(states)[:, :NN]
    if avoid_eyes:
        legal = legal & (rules.eye_colors(states.board) != states.to_play[:, None])
    return torch.where(done, PASS_ACTION, sample_moves(gen, probs, legal))


def _ply(gen, probs_fn_even, probs_fn_odd, step_i, states, done, max_turns, avoid_eyes):
    """One ply of every board: ``(actions, next states, next done)``."""
    probs = (probs_fn_even if step_i % 2 == 0 else probs_fn_odd)(states)
    actions = select_moves(gen, probs, states, avoid_eyes, done)
    nxt = rules.step(states, actions)
    return actions, nxt, done | rules.is_terminal(nxt, max_turns)


def playout(
    gen: torch.Generator,
    probs_fn_even: ProbsFn,
    probs_fn_odd: ProbsFn,
    states: GoState,
    num_steps: int,
    max_turns: int,
    avoid_eyes: bool = False,
) -> Trajectory:
    """``num_steps`` plies with two policies alternating by step parity.

    ``probs_fn_even`` plays the side to move on even steps (the caller lines
    this up with black and white: all boards of the batch must share turn
    parity); the two may be different nets."""
    done = rules.is_terminal(states, max_turns)
    before, taken = [], []
    for step_i in range(num_steps):
        actions, nxt, done = _ply(
            gen, probs_fn_even, probs_fn_odd, step_i, states, done, max_turns, avoid_eyes
        )
        before.append(states)
        taken.append(actions)
        states = nxt
    stacked = GoState(*(torch.stack(xs) for xs in zip(*(s.tensors() for s in before))))
    return Trajectory(states=stacked, actions=torch.stack(taken), final=states)


def playout_final(
    gen: torch.Generator,
    probs_fn_even: ProbsFn,
    probs_fn_odd: ProbsFn,
    states: GoState,
    max_turns: int,
    avoid_eyes: bool = False,
) -> GoState:
    """Like :func:`playout`, but only the final state comes back and the
    loop ends once every board is terminal, after at most ``max_turns + 2``
    plies.  This is simulation mode's hot path (``mcts._simulate``): leaves
    sit deep in the game, so most of a fixed ply budget would be spent on
    finished boards.

    The JAX package's ``lax.while_loop`` is a host loop here, with one
    ``bool(done.all())`` read per ply: on a GPU every ply synchronises, which
    makes this loop host-bound."""
    done = rules.is_terminal(states, max_turns)
    step_i = 0
    while step_i < max_turns + 2 and not bool(done.all()):
        _, states, done = _ply(
            gen, probs_fn_even, probs_fn_odd, step_i, states, done, max_turns, avoid_eyes
        )
        step_i += 1
    return states


def rewards(final: GoState) -> torch.Tensor:
    """(B,) of +1 where black wins by Tromp-Taylor, else -1."""
    return torch.where(rules.score(final) > 0, 1.0, -1.0)
