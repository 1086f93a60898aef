"""Zobrist tables (copy of ``bokego_tpu.env.zobrist``).

The same PCG64 stream with seed 20210815 gives the same ``TABLE`` (3 planes x
81 points x 2 words) and ``FLIP`` as the JAX package.  Torch has little
uint32 support, so the port keeps each 32-bit word in an int64; XOR keeps
the values below 2**32, and tests compare the bit patterns.
"""

from __future__ import annotations

import numpy as np

from bokego_tpu_torch.coords import NN

_SEED = 20210815

_rng = np.random.Generator(np.random.PCG64(_SEED))
TABLE = _rng.integers(0, 2**32, size=(3, NN, 2), dtype=np.uint32)
FLIP = _rng.integers(0, 2**32, size=(2,), dtype=np.uint32)


def full_hash_np(board: np.ndarray, ko: int, turn: int) -> np.ndarray:
    """Hash of one position from scratch: uint32[2] (hi, lo)."""
    h = np.zeros(2, dtype=np.uint32)
    for p in range(NN):
        if board[p] == 1:
            h ^= TABLE[0, p]
        elif board[p] == 2:
            h ^= TABLE[1, p]
    if ko >= 0:
        h ^= TABLE[2, ko]
    if turn % 2 == 1:
        h ^= FLIP
    return h
