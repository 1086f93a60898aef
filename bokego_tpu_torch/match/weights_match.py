"""In-process match between two WEIGHT sets at one search configuration
(counterpart of ``tools/weights_match.py``): a batch of simultaneous games
on one device, each side searching with its own nets, to measure training
progress (trained weights against a random init, one generation against
another).

    python -m bokego_tpu_torch.match.weights_match A_POLICY A_VALUE B_POLICY B_VALUE \\
        [--games 64] [--rollouts 64] [--expand-thresh 16] [--max-nodes 512] \\
        [--seed 7] [--resolved] [--device cuda]

Nets are torch ``.pt`` checkpoints, or ``random`` / ``random:SEED`` for a
seeded random init.  Prints ``A won W/N = p +- ci (R rollouts/move, Ts)``.
The openings (``OPEN_PLIES`` plies, each side sampling its own policy) and
the resolved scoring draw from a ``torch.Generator`` seeded by ``--seed``,
not from ``jax.random``: the games are the JAX tool's only where no draw is
made (``open_plies=0``, Tromp-Taylor scoring).
"""

from __future__ import annotations

import argparse
import time

import torch

from bokego_tpu_torch.bin import add_device_flag, device_from
from bokego_tpu_torch.config import SearchConfig
from bokego_tpu_torch.match.common import OPEN_PLIES, Games, Side, interval, load_params, play_batch
from bokego_tpu_torch.search import mcts

N_MOVES = 80


def play(
    gen: torch.Generator, params_a, params_b, ev: mcts.Evaluator, batch: int, cfg: SearchConfig,
    n_rollouts: int, a_is_black: bool, open_plies: int = OPEN_PLIES, resolved: bool = False, device=None,
) -> Games:
    """One batch of games, A as black iff ``a_is_black``; ``Games.won`` is
    True where A won."""
    return play_batch(
        gen, Side(params_a, cfg, n_rollouts), Side(params_b, cfg, n_rollouts), ev, batch, a_is_black,
        N_MOVES, open_plies, resolved, device,
    )


def match(
    gen: torch.Generator, params_a, params_b, ev: mcts.Evaluator, games_per_side: int, cfg: SearchConfig,
    n_rollouts: int, resolved: bool = False, device=None,
) -> tuple[int, int]:
    """A as black, then as white, from one generator; returns (A's wins, games)."""
    wins, total = 0, 0
    for a_is_black in (True, False):
        won = play(gen, params_a, params_b, ev, games_per_side, cfg, n_rollouts, a_is_black,
                   resolved=resolved, device=device).won
        wins += int(won.sum())
        total += won.numel()
    return wins, total


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("a_policy")
    p.add_argument("a_value")
    p.add_argument("b_policy")
    p.add_argument("b_value")
    p.add_argument("--games", type=int, default=64, help="games per color")
    p.add_argument("--rollouts", type=int, default=64)
    p.add_argument("--expand-thresh", type=int, default=16)
    p.add_argument("--max-nodes", type=int, default=512)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--resolved", action="store_true", help="dead-group-aware scoring of the finals")
    add_device_flag(p)
    args = p.parse_args(argv)

    dev = device_from(args)
    params_a = load_params(args.a_policy, args.a_value, dev)
    params_b = load_params(args.b_policy, args.b_value, dev)
    cfg = SearchConfig(expand_thresh=args.expand_thresh, max_nodes=args.max_nodes, no_sim=True)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.monotonic()
    wins, total = match(gen, params_a, params_b, mcts.net_evaluator(has_value=True), args.games, cfg,
                        args.rollouts, resolved=args.resolved, device=dev)
    p_hat = wins / total
    print(f"A won {wins}/{total} = {p_hat:.3f} +- {interval(p_hat, total):.3f} "
          f"({args.rollouts} rollouts/move, {time.monotonic() - t0:.0f}s)", flush=True)


if __name__ == "__main__":
    main()
