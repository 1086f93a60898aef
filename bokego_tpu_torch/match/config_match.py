"""In-process match between two search configurations with shared nets
(counterpart of ``tools/config_match.py``): config A moves one colour and
config B the other in a batch of simultaneous games on one device, at equal
rollouts per move unless ``--rollouts-b`` says otherwise.  Used to tune the
serving configuration and to measure fidelity trades.

    python -m bokego_tpu_torch.match.config_match '{"expand_thresh": 16, "max_nodes": 4096}' '{}' \\
        [--games 64] [--rollouts 400] [--rollouts-b N] [--policy data/weights/policy_17.pt] \\
        [--value data/weights/value_r2.pt] [--seed 5] [--resolved] [--device cuda]

The configs are dict literals of ``SearchConfig`` overrides.  Both colour
halves start from a generator seeded alike, so they play the same sampled
openings with the colours swapped (a paired comparison).  Prints ``A as
B: …``, ``A as W: …`` and ``A winrate p +/- ci over N games (A: R rollouts,
B: R)``.
"""

from __future__ import annotations

import argparse
import ast
import time

import torch

from bokego_tpu_torch.bin import add_device_flag, device_from
from bokego_tpu_torch.config import POLICY_WEIGHTS, VALUE_WEIGHTS, SearchConfig
from bokego_tpu_torch.match.common import OPEN_PLIES, Games, Side, interval, load_params, play_batch
from bokego_tpu_torch.search import mcts

N_MOVES = 80


def play(
    gen: torch.Generator, params, ev: mcts.Evaluator, batch: int, cfg_a: SearchConfig, cfg_b: SearchConfig,
    ra: int, rb: int, a_is_black: bool, open_plies: int = OPEN_PLIES, resolved: bool = False, device=None,
) -> Games:
    """One batch of games with shared nets, config A as black iff
    ``a_is_black``; ``Games.won`` is True where A won."""
    return play_batch(
        gen, Side(params, cfg_a, ra), Side(params, cfg_b, rb), ev, batch, a_is_black,
        N_MOVES, open_plies, resolved, device,
    )


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("cfg_a", help="SearchConfig overrides for side A (dict literal)")
    p.add_argument("cfg_b", help="SearchConfig overrides for side B (dict literal)")
    p.add_argument("--games", type=int, default=64, help="games per color")
    p.add_argument("--rollouts", type=int, default=400)
    p.add_argument("--rollouts-b", type=int, default=None, help="rollouts for B if different")
    p.add_argument("--policy", default=POLICY_WEIGHTS)
    p.add_argument("--value", default=VALUE_WEIGHTS)
    p.add_argument("--seed", type=int, default=5)
    p.add_argument("--resolved", action="store_true", help="dead-group-aware scoring of the finals")
    add_device_flag(p)
    args = p.parse_args(argv)

    dev = device_from(args)
    cfg_a = SearchConfig(**ast.literal_eval(args.cfg_a))
    cfg_b = SearchConfig(**ast.literal_eval(args.cfg_b))
    ra, rb = args.rollouts, args.rollouts_b or args.rollouts
    params = load_params(args.policy, args.value, dev)
    ev = mcts.net_evaluator(has_value=True)
    t0 = time.monotonic()
    wins, total = 0, 0
    for a_is_black in (True, False):
        # a generator seeded alike for both halves: the same openings, colours swapped
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        won = play(gen, params, ev, args.games, cfg_a, cfg_b, ra, rb, a_is_black,
                   resolved=args.resolved, device=dev).won
        wins += int(won.sum())
        total += won.numel()
        print(f"A as {'B' if a_is_black else 'W'}: {int(won.sum())}/{won.numel()}"
              f" ({time.monotonic() - t0:.0f}s)", flush=True)
    pw = wins / total
    print(f"\nA winrate {pw:.3f} +/- {interval(pw, total, 1e-9):.3f} over {total} games "
          f"(A: {ra} rollouts, B: {rb})", flush=True)


if __name__ == "__main__":
    main()
