"""Deterministic evaluators for the port's tests (jax-free, so the GPU tests
and ``chip_smoke.py`` can use them where JAX is not installed):
``fake_evaluator`` is the port's copy of ``tests/test_mcts.py::fake_evaluator``
and ``stones_evaluator`` of ``tests/test_leafpar.py::_stones_eval``;
``onehot_evaluator`` makes simulation mode deterministic, and
``OneHotPolicyNet`` is a policy-net stand-in with the same property for
the trainers' playouts."""

from __future__ import annotations

import torch

from bokego_tpu_torch.coords import NN
from bokego_tpu_torch.env import rules
from bokego_tpu_torch.search import mcts


def _checksum(states) -> torch.Tensor:
    weights = torch.arange(1, NN + 1, device=states.board.device)[None, :]
    return (states.board.long() * weights).sum(-1) + states.turn


def _evaluate(params, states):
    del params
    dev = states.board.device
    stones = (states.board != 0).sum(-1)
    z = 1.0 + (torch.arange(NN, device=dev)[None, :] * 7 + stones[:, None]) % 13
    probs = z / z.sum(-1, keepdim=True)
    vals = ((_checksum(states) % 17) - 8) / 10.0
    return probs.float(), vals.float()


def fake_evaluator() -> mcts.Evaluator:
    """Deterministic nets: probs ∝ 1 + ((a * 7 + #stones) % 13), value from
    a board checksum; the playout policy is the same distribution."""
    return mcts.Evaluator(
        evaluate=_evaluate, has_value=True, policy_probs=lambda params, states: _evaluate(params, states)[0]
    )


def onehot_policy(params, states) -> torch.Tensor:
    """All mass on one playable point (legal, not the mover's own eye), the
    ``checksum % count``-th of them.  A masked distribution with a single
    point of mass makes a playout's draws the same whatever the generator,
    so simulation mode compares exactly between packages and devices.  Rows
    without a playable point are all zero (such a board passes)."""
    del params
    playable = rules.legal_mask(states)[:, :NN] & (rules.eye_colors(states.board) != states.to_play[:, None])
    count = playable.sum(-1)
    pick = _checksum(states) % count.clamp(min=1)
    return (playable & (playable.cumsum(-1) == pick[:, None] + 1)).float()


def onehot_evaluator() -> mcts.Evaluator:
    """``fake_evaluator`` with the one-hot playout policy."""
    return mcts.Evaluator(evaluate=_evaluate, has_value=True, policy_probs=onehot_policy)


class OneHotPolicyNet(torch.nn.Module):
    """A policy net stand-in: from the feature planes alone, logits of 0 on
    one legal point (the ``(checksum + offset) % count``-th, the checksum
    taken over the board read back from planes 0, 1 and 3) and -1e9
    elsewhere, so ``softmax`` puts all mass on it and a playout's draws are
    the same whatever the generator.  ``offset`` tells two nets apart.  The
    one parameter only carries the device (and a zero gradient)."""

    def __init__(self, offset: int = 0):
        super().__init__()
        self.offset = offset
        self.anchor = torch.nn.Parameter(torch.zeros(()))

    def forward(self, fts: torch.Tensor) -> torch.Tensor:
        flat = fts.reshape(fts.shape[0], NN, fts.shape[-1])
        black_to_move = flat[:, :1, 3] > 0
        mine = torch.where(black_to_move, 1, 2)
        board = torch.where(flat[..., 0] > 0, mine, torch.where(flat[..., 1] > 0, 3 - mine, 0))
        weights = torch.arange(1, NN + 1, device=fts.device)
        legal = flat[..., 5] > 0
        pick = ((board * weights).sum(-1) + self.offset) % legal.sum(-1).clamp(min=1)
        hot = legal & (legal.cumsum(-1) == pick[:, None] + 1)
        return torch.where(hot, 0.0, -1e9) + 0.0 * self.anchor


def stones_evaluator() -> mcts.Evaluator:
    """An evaluator with the fused ``evaluate_fts`` path, computable from the
    states and from the feature planes alike (planes 0 and 1 are the
    player's and the opponent's stones)."""

    def from_stones(stones):
        z = 1.0 + (torch.arange(NN, device=stones.device)[None, :] * 7 + stones[:, None]) % 13
        return (z / z.sum(-1, keepdim=True)).float(), (((stones * 3) % 17 - 8) / 10.0).float()

    def evaluate(params, states):
        del params
        return from_stones((states.board != 0).sum(-1))

    def evaluate_fts(params, fts):
        del params
        return from_stones((fts[..., 0] + fts[..., 1]).sum((-1, -2)).long())

    return mcts.Evaluator(
        evaluate=evaluate, has_value=True, evaluate_fts=evaluate_fts,
        policy_probs=lambda params, states: evaluate(params, states)[0],
    )
