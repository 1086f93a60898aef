"""Winrate of raw policies against a FIXED opponent (counterpart of
``tools/policy_curve.py``): every generation of a REINFORCE pool, or one
policy, plays raw-policy games against ``policy_17.pt``, the reference's own
evaluation protocol for REINFORCE progress, down to ``MAX_TURNS = 70`` and
the eye-filling filter.  Final positions are scored by the dead-group
resolver: raw Tromp-Taylor at turn 70 would miscount unfinished captures.

    python -m bokego_tpu_torch.match.policy_curve [--games 256] [--opponent data/weights/policy_17.pt] \\
        [--pool DIR | --single PATH.pt] [--seed 11] [--out FILE] [--device cuda]

``--pool`` holds ``policy_<n>.pt`` files (as ``bin.selfplay`` writes them);
``--single`` plays one checkpoint, named by its file.  Prints a header and
``gen N: W/T = p +- ci (Ts)`` per generation, and writes the same lines to
``--out`` (default ``data/match_logs/policy_curve.txt``, which git ignores:
the committed ``data/training_logs/policy_curve.txt`` is the TPU record).
Playouts and resolutions draw from a ``torch.Generator`` seeded by
``--seed`` plus the generation, not from ``jax.random``.
"""

from __future__ import annotations

import argparse
import os
import re
import time
from typing import NamedTuple

import torch

from bokego_tpu_torch.bin import add_device_flag, device_from
from bokego_tpu_torch.config import POLICY_WEIGHTS
from bokego_tpu_torch.env import state as st
from bokego_tpu_torch.env.state import GoState
from bokego_tpu_torch.features import features_batch
from bokego_tpu_torch.match.common import interval, load_net, resolved_scores
from bokego_tpu_torch.models import inference
from bokego_tpu_torch.search import playout as po

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MAX_TURNS = 70  # the reference's RL self-play horizon
POOL_FILE = re.compile(r"policy_(\d+)\.pt$")


def probs_fn(net):
    def fn(states: GoState) -> torch.Tensor:
        return inference.policy_probs(net, features_batch(states))

    return fn


class SideGames(NamedTuple):
    """A batch of raw-policy games of one colour."""

    won: torch.Tensor  # (B,) bool: "mine" won
    scores: torch.Tensor  # (B,) f32 resolved, black minus (white + komi)
    final: GoState  # (B, ...) final states


def play_side(gen: torch.Generator, mine, opp, batch: int, i_am_black: bool, device=None) -> SideGames:
    """One batch of raw-policy games of ``mine`` against ``opp``, ``mine``
    as black iff ``i_am_black``."""
    even = probs_fn(mine if i_am_black else opp)
    odd = probs_fn(opp if i_am_black else mine)
    states = st.new_game_batch(batch, device=device)
    final = po.playout_final(gen, even, odd, states, max_turns=MAX_TURNS, avoid_eyes=True)
    scores = resolved_scores(gen, final)
    won_black = scores > 0
    return SideGames(won=won_black if i_am_black else ~won_black, scores=scores, final=final)


def generation(mine, opp, games: int, seed: int, device=None) -> list[SideGames]:
    """``games`` a colour of ``mine`` against ``opp``, black first, from one
    generator seeded ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return [play_side(gen, mine, opp, games, i_am_black, device) for i_am_black in (True, False)]


def wins_of(sides: list[SideGames]) -> tuple[int, int]:
    """(wins, games) over the sides of a generation."""
    return sum(int(s.won.sum()) for s in sides), sum(s.won.numel() for s in sides)


def curve_line(gen_label, wins: int, total: int, seconds: float) -> str:
    p_hat = wins / total
    return f"gen {gen_label}: {wins}/{total} = {p_hat:.3f} +- {interval(p_hat, total):.3f} ({seconds:.0f}s)"


def pool_generations(pool: str) -> list[tuple[int, str]]:
    """``(n, path)`` of every ``policy_<n>.pt`` in ``pool``, by n."""
    found = []
    for name in os.listdir(pool) if os.path.isdir(pool) else ():
        m = POOL_FILE.fullmatch(name)
        if m:
            found.append((int(m.group(1)), os.path.join(pool, name)))
    if not found:
        raise SystemExit(
            f"{pool}: no policy_<n>.pt; export orbax generations with tools/export_policy_torch.py, "
            f"or pass --single PATH.pt"
        )
    return sorted(found)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--games", type=int, default=256, help="games per color")
    p.add_argument("--opponent", default=POLICY_WEIGHTS)
    p.add_argument("--pool", default=os.path.join(REPO, "data", "weights", "rl_pool"))
    p.add_argument("--out", default=os.path.join(REPO, "data", "match_logs", "policy_curve.txt"))
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("--single", default=None, help="evaluate ONE policy checkpoint instead of a pool")
    add_device_flag(p)
    args = p.parse_args(argv)

    dev = device_from(args)
    opp = load_net(args.opponent, "policy", dev)
    if args.single:
        m = POOL_FILE.search(args.single)
        gens = [(int(m.group(1)) if m else os.path.basename(args.single), args.single)]
    else:
        gens = pool_generations(args.pool)
    lines = [f"# winrate vs FIXED {os.path.basename(args.opponent)}, {2 * args.games} "
             f"raw-policy games/gen, resolved scoring, seed {args.seed}"]
    print(lines[0], flush=True)
    for gen_label, path in gens:
        mine = load_net(path, "policy", dev)
        t0 = time.monotonic()
        seed = args.seed + (gen_label if isinstance(gen_label, int) else 0)
        wins, total = wins_of(generation(mine, opp, args.games, seed, dev))
        lines.append(curve_line(gen_label, wins, total, time.monotonic() - t0))
        print(lines[-1], flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
