"""Simulation-mode search throughput on a batch of trees (the port's
counterpart of ``tools/measure_sim_throughput.py``).

    python -m bokego_tpu_torch.sim_throughput [--batch 256] [--rollouts 64] [--midgame-plies 40] [--device cuda]

The JAX tool's protocol: the shipped ``data/weights/policy_17.pt`` and
``value_r2.pt``; ``SearchConfig(no_sim=False, value_net_weight=0.5,
expand_thresh=16, max_nodes=2048)``, so every rollout plays its leaf out to
the end of the game with the policy (``mcts._simulate``); the games first
advanced by a policy playout of ``--midgame-plies`` plies; ``init_trees``,
one warm ``run_search`` of ``--rollouts``, then the best of three timed
runs on the same trees (synchronised host clock).  Every run checks that
each root's visits grew by exactly ``--rollouts``, so the rate counts what
ran.  No kernel runs on this path: the kernels serve ``no_sim`` searches
only, as in the JAX package.

Before the JAX tool's result line it prints the plies a playout, the
policy forwards and the ms a ply of the best run.  With ``--device cpu``
the counts are printed and every time and rate reads "not measured".
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from bokego_tpu_torch.bin import add_device_flag, device_from
from bokego_tpu_torch.config import POLICY_WEIGHTS, VALUE_WEIGHTS, SearchConfig
from bokego_tpu_torch.device import synchronize
from bokego_tpu_torch.env import state as st
from bokego_tpu_torch.measure import card_line
from bokego_tpu_torch.models import nets
from bokego_tpu_torch.search import mcts
from bokego_tpu_torch.search import playout as po

CONFIG = SearchConfig(no_sim=False, value_net_weight=0.5, expand_thresh=16, max_nodes=2048)
RUNS = 3  # timed runs after the warm one
MIDGAME_TURNS = 80  # max_turns of the midgame playout
NOT_MEASURED = "not measured"


def midgame(gen: torch.Generator, probs_fn, batch: int, plies: int, device) -> st.GoState:
    """``batch`` new games advanced by a policy playout of ``plies`` plies."""
    states = st.new_game_batch(batch, device=device)
    if plies:
        states = po.playout(gen, probs_fn, probs_fn, states, num_steps=plies, max_turns=MIDGAME_TURNS).final
    return states


@dataclasses.dataclass
class SimRuns:
    """The trees after the last run; per timed run its seconds (host clock,
    synchronised on a card) and the playouts' policy forwards."""

    trees: object
    seconds: list[float]
    forwards: list[int]


def sim_runs(states, ev: mcts.Evaluator, params, cfg: SearchConfig, rollouts: int, runs: int, device) -> SimRuns:
    """``init_trees``, one warm ``run_search`` of ``rollouts``, then ``runs``
    timed ones on the same trees (playouts drawn from generators seeded 0
    for the warm run and ``i + 1`` for timed run ``i``).  Raises unless every
    run grew every root's visits by exactly ``rollouts``."""
    forwards = [0]

    def policy_probs(params_, states_):
        forwards[0] += 1
        return ev.policy_probs(params_, states_)

    cev = ev._replace(policy_probs=policy_probs)
    trees = mcts.init_trees(states, cev, params, cfg)
    seconds, counts = [], []
    for i in range(runs + 1):
        gen = torch.Generator(device=device).manual_seed(i)
        before = trees.root_stats[:, 0].clone()
        forwards[0] = 0
        synchronize(device)
        t0 = time.perf_counter()
        trees = mcts.run_search(trees, cev, params, cfg, rollouts, gen=gen)
        synchronize(device)
        dt = time.perf_counter() - t0
        grown = trees.root_stats[:, 0] - before
        if not bool((grown == rollouts).all()):
            raise RuntimeError(f"root visits grew by {grown.tolist()}, not by {rollouts} rollouts")
        if i:
            seconds.append(dt)
            counts.append(forwards[0])
    return SimRuns(trees, seconds, counts)


def print_result(res: SimRuns, batch: int, rollouts: int, midgame_plies: int, on_card: bool) -> float | None:
    """Print the best run's playout counts and the JAX tool's result line;
    returns the rate (rollouts/s), ``None`` off the card."""
    best = min(range(len(res.seconds)), key=lambda i: res.seconds[i])
    fwd = res.forwards[best]
    ms_ply = f"{1e3 * res.seconds[best] / fwd:.2f}" if on_card else NOT_MEASURED
    print(
        f"playouts: {fwd / rollouts:.1f} plies a playout (policy forwards a rollout step, whose {batch} "
        f"playouts run in lockstep; {fwd} in the best run's {rollouts} steps), {ms_ply} ms a ply"
    )
    rate = None
    if on_card:
        print(f"timed runs (s): {', '.join(f'{s:.3f}' for s in res.seconds)}")
        rate = batch * rollouts / res.seconds[best]
    print(f"sim-mode: {NOT_MEASURED if rate is None else f'{rate:,.0f}'} rollouts/s/chip at B={batch} "
          f"(each rollout = full policy playout to terminal; "
          f"midgame start ply {midgame_plies})")
    return rate


def run(dev, batch: int, rollouts: int, midgame_plies: int, runs: int = RUNS) -> tuple[SimRuns, float | None]:
    """The JAX tool's protocol with the shipped nets on ``dev``: midgame
    states, the warm run and ``runs`` timed ones, the result printed;
    returns the runs and the rate (``None`` off the card)."""
    params = {"policy": nets.load_policy(POLICY_WEIGHTS, device=dev), "value": nets.load_value(VALUE_WEIGHTS, device=dev)}
    ev = mcts.net_evaluator()
    states = midgame(
        torch.Generator(device=dev).manual_seed(0), lambda s: ev.policy_probs(params, s), batch, midgame_plies, dev
    )
    res = sim_runs(states, ev, params, CONFIG, rollouts, runs, dev)
    return res, print_result(res, batch, rollouts, midgame_plies, dev.type == "cuda")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--rollouts", type=int, default=64)
    p.add_argument(
        "--midgame-plies", type=int, default=40,
        help="advance games this far first (sim leaves sit mid-game, where early exit matters)",
    )
    add_device_flag(p)
    args = p.parse_args(argv)
    dev = device_from(args)
    if dev.type == "cuda":
        print(card_line())
    run(dev, args.batch, args.rollouts, args.midgame_plies)


if __name__ == "__main__":
    main()
