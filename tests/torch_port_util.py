"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``):
moving states between the JAX package and the port, and seeded random
positions."""

from __future__ import annotations

import numpy as np
import torch

import jax
import jax.numpy as jnp

from bokego_tpu.env import rules as jrules
from bokego_tpu.env import state as jst
from bokego_tpu_torch.coords import NN
from bokego_tpu_torch.env.state import GoState

# The port's tests run on tiny tensors under several pytest workers: one
# intra-op thread each avoids oversubscribing the cores.
torch.set_num_threads(1)

FIELDS = ("board", "ko", "turn", "last_move", "hash", "komi", "invalid")

_jstep = jax.jit(jrules.step_batch)
_jlegal = jax.jit(jrules.legal_mask_batch)


def to_port(js) -> GoState:
    """A batched JAX GoState -> the port's GoState on the CPU."""

    def conv(name):
        x = np.asarray(getattr(js, name))
        if x.dtype in (np.int32, np.uint32):
            x = x.astype(np.int64)
        return torch.from_numpy(np.array(x))  # a writable copy

    return GoState(*(conv(f) for f in FIELDS))


def assert_states_equal(js, ts: GoState, fields=FIELDS) -> None:
    """Field-by-field equality; hashes compare as 32-bit patterns."""
    for f in fields:
        a = np.asarray(getattr(js, f))
        b = getattr(ts, f).cpu().numpy()
        if a.dtype == np.uint32:
            b = b.astype(np.uint32)
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=f)


def random_actions(rng: np.random.Generator, legal: np.ndarray, pass_prob=0.03, wild_prob=0.0):
    """One action per row: a random legal point, sometimes a pass, and with
    ``wild_prob`` any action 0..81 (possibly illegal)."""
    out = []
    for row in legal[:, :NN]:
        u = rng.random()
        if u < wild_prob:
            out.append(int(rng.integers(0, NN + 1)))
        elif u < wild_prob + pass_prob or not row.any():
            out.append(NN)
        else:
            out.append(int(rng.choice(np.flatnonzero(row))))
    return np.asarray(out, np.int32)


def random_positions(seed: int, batch: int, n_moves: int, pass_prob=0.0):
    """JAX GoStates after ``n_moves`` random legal moves from empty boards."""
    rng = np.random.default_rng(seed)
    s = jst.new_game_batch(batch)
    for _ in range(n_moves):
        a = random_actions(rng, np.asarray(_jlegal(s)), pass_prob=pass_prob)
        s = _jstep(s, jnp.asarray(a))
    return s
