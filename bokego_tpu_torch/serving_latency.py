"""Single-game serving throughput (rollouts/s) of the GTP engine (the
port's counterpart of ``tools/measure_serving_latency.py``).

    python -m bokego_tpu_torch.serving_latency [--time 4.0] [--trials 3] [--strong] [--forest N] [--leaf-batch K] [--device cuda]

The JAX tool's protocol: the shipped ``data/weights/policy_17.pt`` and
``value_r2.pt``; the engine's default search configuration, or
``--strong``'s (``expand_thresh=16``, a 65536-node pool), with
``--leaf-batch K`` leaf-parallel rollouts and ``--forest N`` root-parallel
trees; every path warmed once (``GTPEngine.warm_up`` in place of the JAX
tool's dispatch warm-ups).  Each trial starts a new game
(``GTPEngine.new_game``, the ``clear_board`` logic), reads the forest's
root visits, runs the timed path (``timed_rollout(--time)``) or the count
path (``rollout(--time * 2000)``), and reads them again: the rate is the
visits grown over the synchronised host time.  It prints the tool's three
lines, the best trial of each path first.  The timed path is named for
what the port runs: chunks of 8 rollouts, each synchronised, not the JAX
engine's pipelined dispatch.  Off the card the rates are the CPU's.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from bokego_tpu_torch.bin import add_device_flag, device_from
from bokego_tpu_torch.config import POLICY_WEIGHTS, VALUE_WEIGHTS, EngineConfig, SearchConfig
from bokego_tpu_torch.gtp.engine import GTPEngine, ROLLOUT_CHUNK
from bokego_tpu_torch.measure import card_line
from bokego_tpu_torch.models import nets
from bokego_tpu_torch.search.mcts import net_evaluator

PATHS = (f"timed-synchronised-chunks-of-{ROLLOUT_CHUNK}", "count-blocking")


def root_visits(eng: GTPEngine) -> float:
    """The root visits summed over the forest."""
    return float(eng.trees.root_stats[:, 0].sum())


def make_engine(dev, seconds: float, strong: bool, forest: int, leaf_batch: int) -> GTPEngine:
    """The engine with the shipped nets at the flags' configuration, warmed up."""
    params = {"policy": nets.load_policy(POLICY_WEIGHTS, device=dev), "value": nets.load_value(VALUE_WEIGHTS, device=dev)}
    scfg = SearchConfig(expand_thresh=16, max_nodes=65536) if strong else SearchConfig()
    if leaf_batch > 1:
        scfg = dataclasses.replace(scfg, leaf_batch=leaf_batch)
    ecfg = EngineConfig(pondering=False, time_lim=seconds, forest_size=forest)
    eng = GTPEngine(net_evaluator(has_value=True), params, scfg, ecfg, device=dev)
    eng.warm_up()
    return eng


def measure(eng: GTPEngine, seconds: float, trials: int) -> dict[str, list[tuple[float, float]]]:
    """Per path, each trial's ``(visits grown, seconds)`` from a new game."""
    out = {}
    for path in PATHS:
        out[path] = []
        for _ in range(trials):
            eng.new_game()
            eng._sync()
            v0 = root_visits(eng)
            t0 = time.monotonic()
            if path == PATHS[0]:
                eng.timed_rollout(seconds)
            else:
                eng.rollout(int(seconds * 2000))
            eng._sync()
            dt = time.monotonic() - t0
            out[path].append((root_visits(eng) - v0, dt))
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="single-game serving throughput (rollouts/s) of the GTP engine")
    p.add_argument("--time", type=float, default=4.0, help="seconds per trial")
    p.add_argument("--trials", type=int, default=3)
    p.add_argument("--strong", action="store_true", help="use the --strong serving config (65536-node pool)")
    p.add_argument("--forest", type=int, default=1,
                   help="root-parallel trees (rollouts/s aggregates over the forest)")
    p.add_argument("--leaf-batch", type=int, default=1, dest="leaf_batch",
                   help="K leaf-parallel rollouts per step with virtual loss")
    add_device_flag(p)
    args = p.parse_args(argv)
    dev = device_from(args)
    if dev.type == "cuda":
        print(card_line())
    eng = make_engine(dev, args.time, args.strong, args.forest, args.leaf_batch)
    print(f"config: {'strong' if args.strong else 'default'}, forest {args.forest}, "
          f"leaf_batch {args.leaf_batch}, {args.time}s/trial, device {dev}")
    for path, runs in measure(eng, args.time, args.trials).items():
        rates = [v / dt for v, dt in runs]
        print(f"{path}: {max(rates):,.0f} rollouts/s (trials: {', '.join(f'{r:,.0f}' for r in rates)})")


if __name__ == "__main__":
    main()
