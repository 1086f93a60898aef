"""27-plane feature encoder (counterpart of ``bokego_tpu/features.py``).

Planes: 0 player stones, 1 opponent stones, 2 empty, 3 black-to-move, 4 last
move, 5 legal moves, 6-12 liberties, 13-19 liberties after playing, 20-26
stones captured by playing (each bucketed: plane k+i holds i+1 where the
count is i+1, the last plane holds 7 where it is above 6).

Output layout is NHWC ``(B, 9, 9, 27)``, as in the JAX package; the nets
permute to NCHW inside.
"""

from __future__ import annotations

import torch

from bokego_tpu_torch.coords import BLACK, EMPTY, NN
from bokego_tpu_torch.env.rules import MoveTables, move_tables
from bokego_tpu_torch.env.state import GoState

NUM_PLANES = 27


def _bucketize(arr: torch.Tensor) -> torch.Tensor:
    """(B, 81) counts -> (B, 81, 7) float planes."""
    cols = [torch.where(arr == i + 1, float(i + 1), 0.0) for i in range(6)]
    cols.append(torch.where(arr > 6, 7.0, 0.0))
    return torch.stack(cols, dim=-1)


def features_from_tables(state: GoState, mt: MoveTables) -> torch.Tensor:
    """Feature planes from a precomputed move analysis (shared with
    successor generation by ``rules.leaf_analysis`` on eval steps)."""
    board = state.board
    color = state.to_play[:, None]
    f32 = torch.float32
    player = (board == color).to(f32)
    oppt = ((board != EMPTY) & (board != color)).to(f32)
    empty = (board == EMPTY).to(f32)
    turn = (color == BLACK).to(f32).expand(-1, NN)
    iota = torch.arange(NN, device=board.device)
    last = state.last_move[:, None]
    last_mv = ((iota == last) & (last >= 0)).to(f32)
    legal = mt.legal.to(f32)
    planes = torch.cat(
        [
            torch.stack([player, oppt, empty, turn, last_mv, legal], dim=-1),
            _bucketize(mt.info.libs),
            _bucketize(mt.libs_after),
            _bucketize(mt.caps),
        ],
        dim=-1,
    )  # (B, 81, 27)
    return planes.reshape(-1, 9, 9, NUM_PLANES)


def features_batch(state: GoState) -> torch.Tensor:
    """Batched GoState -> float32 (B, 9, 9, 27) NHWC planes."""
    return features_from_tables(state, move_tables(state.board, state.ko, state.to_play))


features = features_batch  # the port has only the batched form
