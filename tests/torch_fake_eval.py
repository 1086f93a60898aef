"""The port's copy of ``tests/test_mcts.py::fake_evaluator`` (jax-free, so
the GPU tests and ``chip_smoke.py`` can use it where JAX is not installed)."""

from __future__ import annotations

import torch

from bokego_tpu_torch.coords import NN
from bokego_tpu_torch.search import mcts


def fake_evaluator() -> mcts.Evaluator:
    """Deterministic nets: probs ∝ 1 + ((a * 7 + #stones) % 13), value from
    a board checksum."""

    def evaluate(params, states):
        del params
        dev = states.board.device
        stones = (states.board != 0).sum(-1)
        z = 1.0 + (torch.arange(NN, device=dev)[None, :] * 7 + stones[:, None]) % 13
        probs = z / z.sum(-1, keepdim=True)
        chk = (states.board.long() * torch.arange(1, NN + 1, device=dev)[None, :]).sum(-1)
        chk = chk + states.turn
        vals = ((chk % 17) - 8) / 10.0
        return probs.float(), vals.float()

    return mcts.Evaluator(evaluate=evaluate, has_value=True)
