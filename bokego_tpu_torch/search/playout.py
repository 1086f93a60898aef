"""Move selection for playouts (counterpart of
``bokego_tpu/search/playout.py``).

Only :func:`select_moves` is here: the engine's policy fallback and the
scoring playouts need it.  The simulation playouts (``playout``,
``playout_final``, ``rewards``) are not ported yet.
"""

from __future__ import annotations

import torch

from bokego_tpu_torch.coords import NN, PASS_ACTION
from bokego_tpu_torch.env import rules
from bokego_tpu_torch.env.state import GoState
from bokego_tpu_torch.models.inference import sample_moves


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
