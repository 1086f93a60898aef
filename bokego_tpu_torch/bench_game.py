"""One bench game move by move: the forwards and the synchronised time of
each move of ``bench.one_move``, summed over buckets of moves, to show where
a bench game's time goes as the game goes on.

    python -m bokego_tpu_torch.bench_game [--nets bench|seeded] [--bucket 10]
    python -m bokego_tpu_torch.bench_game --device cpu        # the bench's CPU smoke configuration

The bench's configuration and sizes (``bench.settings``: B=1024, or
``BOKEGO_BENCH_BATCH``, and 80 moves of 400 rollouts on the card; B=8 and
4 moves of 8 rollouts on the CPU).  ``--nets bench`` (the
default) plays the bench's nets (``bench.bench_nets``: the JAX bench's
``init_policy(PRNGKey(0))`` and ``init_value(PRNGKey(1))`` read from their
files); ``--nets seeded`` plays ``nets.init_policy(seed=0)`` and
``nets.init_value(seed=1)``, torch's stream under Flax's distributions,
which the bench played before it read those files.  A warm-up move is
played first and dropped, as the bench does; then each move is counted with
``mfu_report.counting`` (the forwards that ran, K1 and K2 launches) and
timed by the host clock between device synchronisations.

It prints the card's name and power limit, a markdown row per bucket of
``--bucket`` moves (forwards, ms, launches, games done at its end) and the
whole game, then one JSON line with the per-move forwards and ms.  Without
a GPU and without ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from bokego_tpu_torch import bench, mfu_report
from bokego_tpu_torch.bin import add_device_flag, device_from
from bokego_tpu_torch.config import BENCH_POLICY_WEIGHTS, BENCH_VALUE_WEIGHTS
from bokego_tpu_torch.device import synchronize
from bokego_tpu_torch.env import state as st
from bokego_tpu_torch.models import nets
from bokego_tpu_torch.search import mcts

NETS = ("bench", "seeded")


def game_nets(which: str, device) -> tuple[dict, mcts.Evaluator, str]:
    """The fp32 nets named by ``which`` (a member of ``NETS``), their
    evaluator and where they come from."""
    if which == "bench":
        params, ev = bench.bench_nets(device, "fp32")
        return params, ev, f"{os.path.basename(BENCH_POLICY_WEIGHTS)}, {os.path.basename(BENCH_VALUE_WEIGHTS)}"
    if which == "seeded":
        params = {"policy": nets.init_policy(seed=0, device=device), "value": nets.init_value(seed=1, device=device)}
        return params, mcts.net_evaluator(), "init_policy(seed=0), init_value(seed=1)"
    raise ValueError(f"nets {which!r}: expected one of {NETS}")


def play(device, which: str) -> dict:
    """One bench game at the bench's sizes on ``device``, after a warm-up
    move; the per-move forwards, ms and K1/K2 launches."""
    s = bench.settings(device)
    params, ev, source = game_nets(which, device)
    states = st.new_game_batch(s.batch, device=device)
    done = torch.zeros(s.batch, dtype=torch.bool, device=device)
    bench.one_move(states, done, ev, params, s.cfg, s.rollouts)  # warm-up
    per_move = []
    for _ in range(s.moves):
        synchronize(device)
        t0 = time.monotonic()
        with mfu_report.counting(ev) as (cev, counts):
            states, done = bench.one_move(states, done, cev, params, s.cfg, s.rollouts)
        synchronize(device)
        per_move.append(dict(
            forwards=len(counts.forwards), ms=1e3 * (time.monotonic() - t0),
            k1=int(counts.counters["ops.descend_backprop"]), k2=int(counts.counters["ops.write_rows"]), done=int(done.sum()),
        ))
    return dict(nets=which, source=source, batch=s.batch, rollouts=s.rollouts, moves=per_move)


def buckets(game: dict, size: int) -> list[dict]:
    """The game's moves summed over buckets of ``size`` moves."""
    out = []
    moves = game["moves"]
    for i in range(0, len(moves), size):
        part = moves[i:i + size]
        out.append(dict(
            first=i + 1, last=i + len(part), forwards=sum(m["forwards"] for m in part),
            ms=sum(m["ms"] for m in part), k1=sum(m["k1"] for m in part), k2=sum(m["k2"] for m in part),
            done=part[-1]["done"],
        ))
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="one bench game split into buckets of moves: forwards and ms")
    p.add_argument("--nets", choices=NETS, default="bench")
    p.add_argument("--bucket", type=int, default=10, help="moves a bucket")
    add_device_flag(p)
    args = p.parse_args(argv)
    dev = device_from(args)
    game = play(dev, args.nets)
    if dev.type == "cuda":
        from bokego_tpu_torch.measure import card_line

        print(card_line())
    print(f"nets {game['nets']} ({game['source']}); batch {game['batch']}, {game['rollouts']} rollouts a move, "
          f"{len(game['moves'])} moves after a warm-up; device {dev}")
    print("| moves | forwards | forwards a move | ms | ms a move | K1 launches | K2 launches | games done |")
    print("|---|---|---|---|---|---|---|---|")
    rows = buckets(game, args.bucket) + buckets(game, len(game["moves"]))
    for i, b in enumerate(rows):
        n = b["last"] - b["first"] + 1
        name = "all" if i == len(rows) - 1 else f"{b['first']}-{b['last']}"
        print(f"| {name} | {b['forwards']} | {b['forwards'] / n:.2f} | {b['ms']:.2f} | {b['ms'] / n:.2f} "
              f"| {b['k1']} | {b['k2']} | {b['done']} |")
    print(json.dumps({"nets": game["nets"], "forwards": [m["forwards"] for m in game["moves"]],
                      "ms": [m["ms"] for m in game["moves"]]}), flush=True)


if __name__ == "__main__":
    main()
