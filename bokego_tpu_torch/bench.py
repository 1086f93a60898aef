"""The headline benchmark of the port: MCTS self-play games/min/chip at
400 rollouts a move (the counterpart of the repo's ``bench.py``).

    python -m bokego_tpu_torch.bench                           # B=1024, fp32, on the GPU
    BOKEGO_BENCH_BATCH=4096 python -m bokego_tpu_torch.bench   # BASELINE.json config 4's 4096 games
    BOKEGO_BENCH_DTYPE=bf16 python -m bokego_tpu_torch.bench   # the bf16 variant
    python -m bokego_tpu_torch.bench --device cpu              # the CPU smoke configuration

``bench.py``'s protocol: ``config.BENCH_CONFIG`` (``expand_thresh=100``,
``no_sim``, ``max_nodes=512``, the rollout kernels K1 and K2 with
``eval_every=8``, ``kernel_levels=6``) at ``BENCH_BATCH`` games, or
``BOKEGO_BENCH_BATCH`` when set; the JAX bench's random-init nets,
``init_policy(PRNGKey(0))`` and ``init_value(PRNGKey(1))``, read from
``data/weights/jax_init_policy_key0.pt`` and ``jax_init_value_key1.pt``
(``config.BENCH_POLICY_WEIGHTS``, ``BENCH_VALUE_WEIGHTS``; a missing file
raises); one move (:func:`one_move`) as warm-up, then ``MOVES`` moves from
the new games, ``torch.cuda.synchronize()`` and the host clock.  ``BOKEGO_BENCH_DTYPE=bf16``
stores both nets in bf16 once and evaluates with
``net_evaluator(dtype=torch.bfloat16)``: only the stem convolution computes
in bf16 (``models/nets.py``), as in the JAX package.

It prints one JSON line with ``bench.py``'s keys: ``metric`` (naming the
card, the batch and the dtype), ``value`` in games/min/chip (divided by the
one card the run used), ``unit`` and ``vs_baseline``, which is ``null``: the
JAX bench's denominator of 625 is the TPU v5e-8 north star, not a figure of
this card.  ``--device cpu`` runs ``bench.py``'s CPU smoke configuration
(B=8, 4 moves of 8 rollouts, the non-kernel search at ``eval_every=1``)
and adds ``"smoke": true``.  Without a GPU and without ``--device cpu`` it
raises; it never runs on the CPU instead, and a failure exits non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from bokego_tpu_torch.bin import add_device_flag, device_from
from bokego_tpu_torch.config import (
    BENCH_BATCH, BENCH_CONFIG, BENCH_POLICY_WEIGHTS, BENCH_VALUE_WEIGHTS, SearchConfig,
)
from bokego_tpu_torch.coords import PASS_ACTION
from bokego_tpu_torch.device import synchronize
from bokego_tpu_torch.env import rules, state as st
from bokego_tpu_torch.env.state import GoState
from bokego_tpu_torch.models import nets
from bokego_tpu_torch.search import mcts

MOVES = 80  # timed moves on the card
SMOKE_BATCH, SMOKE_MOVES, SMOKE_ROLLOUTS = 8, 4, 8  # bench.py's CPU configuration
DTYPES = {"fp32": None, "bf16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class Settings:
    """What one bench run plays: games, timed moves, rollouts a move, the
    search configuration and the nets' dtype name (a key of ``DTYPES``)."""

    batch: int
    moves: int
    rollouts: int
    cfg: SearchConfig
    dtype: str


def settings(device: torch.device, environ=os.environ) -> Settings:
    """The run ``bench.py`` makes on this device: the card's configuration
    (``BOKEGO_BENCH_BATCH`` read) or the CPU smoke one; ``BOKEGO_BENCH_DTYPE``
    read on both."""
    dtype = environ.get("BOKEGO_BENCH_DTYPE", "fp32")
    if dtype not in DTYPES:
        raise ValueError(f"BOKEGO_BENCH_DTYPE={dtype!r}: expected one of {sorted(DTYPES)}")
    if device.type == "cpu":
        cfg = dataclasses.replace(BENCH_CONFIG, n_rollouts=SMOKE_ROLLOUTS, use_kernel=False, eval_every=1)
        return Settings(SMOKE_BATCH, SMOKE_MOVES, SMOKE_ROLLOUTS, cfg, dtype)
    batch = int(environ.get("BOKEGO_BENCH_BATCH", BENCH_BATCH))
    return Settings(batch, MOVES, BENCH_CONFIG.n_rollouts, BENCH_CONFIG, dtype)


def bench_nets(device, dtype: str) -> tuple[dict, mcts.Evaluator]:
    """The JAX bench's random-init nets, read from their files, and their
    evaluator; for bf16 the nets are stored in bf16 once."""
    params = {
        "policy": nets.load_policy(BENCH_POLICY_WEIGHTS, device=device),
        "value": nets.load_value(BENCH_VALUE_WEIGHTS, device=device),
    }
    if DTYPES[dtype] is not None:
        params = {k: net.to(DTYPES[dtype]) for k, net in params.items()}
    return params, mcts.net_evaluator(has_value=True, dtype=DTYPES[dtype])


def one_move(states: GoState, done: torch.Tensor, ev: mcts.Evaluator, params, cfg: SearchConfig, n_rollouts: int):
    """One self-play move of every game: a fresh-tree search, PASS where
    the game is done, the rules step, ``done |= is_terminal``."""
    actions, _ = mcts.search(states, ev, params, cfg, n_rollouts)
    actions = torch.where(done, PASS_ACTION, actions)
    nxt = rules.step(states, actions)
    return nxt, done | rules.is_terminal(nxt, cfg.max_turns)


def run(device: torch.device, s: Settings, nets_ev=None) -> tuple[dict, GoState, torch.Tensor]:
    """One bench run on ``device``: the warm-up move, then ``s.moves`` timed
    moves from the new games, with ``nets_ev`` (nets and evaluator; default
    :func:`bench_nets`).  Returns the JSON record, the final states and the
    done flags."""
    params, ev = nets_ev or bench_nets(device, s.dtype)
    states = st.new_game_batch(s.batch, device=device)
    done = torch.zeros(s.batch, dtype=torch.bool, device=device)
    one_move(states, done, ev, params, s.cfg, s.rollouts)  # warm-up (cuDNN's choice, kernel build)
    synchronize(device)
    t0 = time.monotonic()
    for _ in range(s.moves):
        states, done = one_move(states, done, ev, params, s.cfg, s.rollouts)
    synchronize(device)
    dt = time.monotonic() - t0
    on_card = device.type == "cuda"
    name = torch.cuda.get_device_name(device) if on_card else "cpu"
    out = {
        "metric": f"selfplay games/min/chip (9x9, {s.rollouts} rollouts/move, {s.moves} moves, "
        f"batch {s.batch}, {s.dtype}, device {name})",
        "value": s.batch * 60.0 / dt,  # the run used one card
        "unit": "games/min/chip",
        "vs_baseline": None,
    }
    if not on_card:
        out["smoke"] = True
    return out, states, done


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="self-play games/min/chip at 400 rollouts a move")
    add_device_flag(p)
    dev = device_from(p.parse_args(argv))
    out, _, _ = run(dev, settings(dev))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
