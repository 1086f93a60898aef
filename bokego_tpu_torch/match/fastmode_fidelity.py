"""The fast-mode fidelity trade, measured by a match (counterpart of
``tools/measure_fastmode_fidelity.py``): the self-play configuration
(``use_kernel=True, eval_every=8, kernel_levels=6``, whose rollouts run
through the CUDA kernels ``descend_backprop`` and ``write_rows``) against
the exact reference cadence (``eval_every=1``, no kernel) at EQUAL rollouts
per move, shared nets (``policy_17.pt``, ``value_r2.pt``), both sides in one
process on one device.

    python -m bokego_tpu_torch.match.fastmode_fidelity [games_per_side] [n_rollouts] [--device cuda]

Defaults: 64 games a colour, 400 rollouts.  One generator seeded 11 draws
the openings of both halves in turn, as the JAX tool splits one key.
Prints ``fast as B: …``, ``fast as W: …`` and ``fast winrate p +/- ci (95%
CI)``, then the kernels' launch counts of the run: K1 (with its rollouts)
on the fast side, K2 on both, read from the program's counters.
"""

from __future__ import annotations

import argparse
import time

import torch

from bokego_tpu_torch.bin import add_device_flag, device_from
from bokego_tpu_torch.config import POLICY_WEIGHTS, VALUE_WEIGHTS, SearchConfig
from bokego_tpu_torch.match.common import interval, load_params
from bokego_tpu_torch.match.config_match import play
from bokego_tpu_torch.search import mcts
from bokego_tpu_torch.utils import metrics

FAST = SearchConfig(use_kernel=True, eval_every=8, kernel_levels=6, max_nodes=512)
EXACT = SearchConfig(eval_every=1, max_nodes=512)
SEED = 11


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("per_side", nargs="?", type=int, default=64, help="games per color")
    p.add_argument("n_rollouts", nargs="?", type=int, default=400)
    add_device_flag(p)
    args = p.parse_args(argv)

    dev = device_from(args)
    params = load_params(POLICY_WEIGHTS, VALUE_WEIGHTS, dev)
    ev = mcts.net_evaluator(has_value=True)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.monotonic()
    wins, total = 0, 0
    with metrics.recording(spans=False) as rec:
        for fast_is_black in (True, False):
            won = play(gen, params, ev, args.per_side, FAST, EXACT, args.n_rollouts, args.n_rollouts,
                       fast_is_black, device=dev).won
            wins += int(won.sum())
            total += won.numel()
            print(f"fast as {'B' if fast_is_black else 'W'}: {int(won.sum())}/{won.numel()} "
                  f"({time.monotonic() - t0:.0f}s elapsed)", flush=True)
    pw = wins / total
    print(
        f"\nfast-mode (kernel, eval_every=8, levels=6) vs exact (eval_every=1)"
        f" at {args.n_rollouts} rollouts/move, {total} games:\n"
        f"fast winrate {pw:.3f} +/- {interval(pw, total, 1e-9):.3f} (95% CI)"
    )
    c = rec.counters
    print(f"kernel launches: descend_backprop {c['ops.descend_backprop']:g} "
          f"({c['ops.descend_backprop.rollouts']:g} rollouts), write_rows {c['ops.write_rows']:g}", flush=True)


if __name__ == "__main__":
    main()
