"""Board coordinates and adjacency tables (copy of ``bokego_tpu.coords``).

Only what the port uses is copied: the sizes, the device action encoding
(81 = PASS), the colour constants and the neighbour tables.  The tables are
rebuilt here by the same construction; ``tests/test_torch_env.py`` checks
them equal to the originals.
"""

from __future__ import annotations

import numpy as np

N = 9
NN = N * N

# Device-side action ids.
PASS_ACTION = NN  # 81
NUM_ACTIONS = NN + 1  # 82

EMPTY, BLACK, WHITE = 0, 1, 2


def _build_table(offsets) -> np.ndarray:
    """(81, 4) int32 table of the points at ``offsets``, padded with NN."""
    out = np.full((NN, 4), NN, dtype=np.int32)
    for x in range(N):
        for y in range(N):
            for k, (dx, dy) in enumerate(offsets):
                if 0 <= x + dx < N and 0 <= y + dy < N:
                    out[N * x + y, k] = N * (x + dx) + (y + dy)
    return out


NEIGHBORS = _build_table(((1, 0), (-1, 0), (0, 1), (0, -1)))
DIAGONALS = _build_table(((1, 1), (1, -1), (-1, -1), (-1, 1)))
