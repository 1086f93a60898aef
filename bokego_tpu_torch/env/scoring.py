"""Dead-group-aware final scoring: ownership by batched random playouts
(counterpart of ``bokego_tpu/env/scoring.py``).

Raw Tromp-Taylor on a real final position counts dead stones as alive.
``ownership`` continues K random (eye-preserving) playouts from the position
until each board double-passes, Tromp-Taylor-colours every finished board
(:func:`bokego_tpu_torch.env.rules.area_colors`) and takes each point's
majority colour across the K resolutions: stones on points the opponent
ends up owning dissolve in the vote.  ``resolved_score`` turns the vote into
a score; ``ownership_batch`` / ``resolved_scores`` do the same for a batch
of boards in one batch of playouts.

Uniform random resolution (not policy-guided) by default: it needs no nets
and cannot inherit a net's blind spots; ``probs_fn`` upgrades it to policy
playouts.  The draws come from an explicit ``torch.Generator`` on the
states' device, so the outcome is a vote to compare with the JAX package's,
not a bit pattern.
"""

from __future__ import annotations

import torch

from bokego_tpu_torch.coords import BLACK, EMPTY, NN, PASS_ACTION, WHITE
from bokego_tpu_torch.env import rules
from bokego_tpu_torch.env.state import GoState
from bokego_tpu_torch.search.playout import select_moves


def _resolve(gen: torch.Generator, states: GoState, num_steps: int, probs_fn=None) -> GoState:
    """Play each board out with random legal non-eye moves until it
    double-passes or ``num_steps`` plies ran.  Termination ignores
    ``max_turns`` and single passes: the input is already a finished
    position, and the continuation only lets dead groups be captured.  The
    loop stops early (one host sync per ply) once every board has
    double-passed; such boards would only pass on."""
    batch = states.board.shape[0]
    dev = states.board.device
    passes = torch.zeros(batch, dtype=torch.int64, device=dev)
    uniform = torch.full((batch, NN), 1.0 / NN, dtype=torch.float32, device=dev)
    for _ in range(num_steps):
        done = passes >= 2
        if bool(done.all()):
            break
        probs = uniform if probs_fn is None else probs_fn(states)
        actions = select_moves(gen, probs, states, avoid_eyes=True, done=done)
        states = rules.step(states, actions)
        passes = torch.where(done, passes, torch.where(actions == PASS_ACTION, passes + 1, 0))
    return states


def ownership_batch(
    gen: torch.Generator,
    states: GoState,
    n_playouts: int = 127,
    num_steps: int = 128,
    probs_fn=None,
) -> torch.Tensor:
    """int8[B, 81] majority owner of every point of every board: BLACK,
    WHITE, or EMPTY (no majority, or neutral throughout).  The K playouts of
    all boards run as one batch (board b's copies are rows ``b*K .. b*K +
    K - 1``).  An odd ``n_playouts`` avoids exact ties on settled points."""
    batch = states.board.shape[0]
    copies = states.map(lambda x: x.repeat_interleave(n_playouts, 0))
    final = _resolve(gen, copies, num_steps, probs_fn)
    colors = rules.area_colors(final.board).reshape(batch, n_playouts, NN)
    b_votes = (colors == BLACK).sum(1)
    w_votes = (colors == WHITE).sum(1)
    neutral = n_playouts - b_votes - w_votes
    return torch.where(
        b_votes > w_votes + neutral, BLACK, torch.where(w_votes > b_votes + neutral, WHITE, EMPTY)
    ).to(torch.int8)


def resolved_scores(
    gen: torch.Generator,
    states: GoState,
    n_playouts: int = 127,
    num_steps: int = 128,
    probs_fn=None,
) -> torch.Tensor:
    """(B,) dead-group-aware area scores, black minus (white + komi): each
    point goes to its majority owner; contested points go to neither side."""
    own = ownership_batch(gen, states, n_playouts, num_steps, probs_fn)
    b = (own == BLACK).sum(-1, dtype=torch.float32)
    w = (own == WHITE).sum(-1, dtype=torch.float32)
    return b - w - states.komi


def ownership(
    gen: torch.Generator,
    state: GoState,
    n_playouts: int = 127,
    num_steps: int = 128,
    probs_fn=None,
) -> torch.Tensor:
    """int8[81] majority owner of every point of ``state`` (a batch of one)."""
    return ownership_batch(gen, state.map(lambda x: x[:1]), n_playouts, num_steps, probs_fn)[0]


def resolved_score(
    gen: torch.Generator,
    state: GoState,
    n_playouts: int = 127,
    num_steps: int = 128,
    probs_fn=None,
) -> torch.Tensor:
    """The resolved score of ``state`` (a batch of one), as a scalar."""
    return resolved_scores(gen, state.map(lambda x: x[:1]), n_playouts, num_steps, probs_fn)[0]


def dead_stones(owner: torch.Tensor, board: torch.Tensor) -> torch.Tensor:
    """bool[81]: stones standing on points the opponent owns."""
    return ((board == BLACK) & (owner == WHITE)) | ((board == WHITE) & (owner == BLACK))
