"""Where a self-play move's time goes on the GPU (the port's main path).

    python -m bokego_tpu_torch.measure

Runs the bench configuration (B=1024, 400 rollouts/move, eval_every=8,
kernel_levels=6, expand_thresh=100, max_nodes=512) with a seeded random-init
policy and ``data/weights/value_r2.pt``, and prints:

* for three moves played as the search plays them (``run_search``'s groups,
  one kernel launch per run of rollouts up to the next eval step), the
  host-clock time per phase, each phase ended by a device synchronise:
  ``init_trees``, the K1 launches (with their count and rollouts), the eval
  phases (features + nets + expansion), ``choose_action`` + rules step;
* for one move played rollout by rollout (``search_step``), the same split
  into light and eval rollouts: what a launch per rollout costs;
* from ``torch.profiler`` over one unsynchronised move through
  ``mcts.search``: device time by kernel name, the device-busy share of the
  move's wall time, and the K1 launches and rollouts of that move.

Needs a GPU; it raises without one.
"""

from __future__ import annotations

import collections
import subprocess
import time

import torch

from bokego_tpu_torch.config import BENCH_BATCH, BENCH_CONFIG as CFG, VALUE_WEIGHTS
from bokego_tpu_torch.env import rules, state as st
from bokego_tpu_torch.models import nets
from bokego_tpu_torch.ops import rollout
from bokego_tpu_torch.search import mcts

MOVES = 3  # synchronised grouped moves played before the stepped and the profiled one


def _sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _finish(states, trees, split):
    states, dt = _sync_time(lambda: rules.step(states, mcts.choose_action(trees)))
    split["choose + step"] += dt
    return {k: v * 1e3 for k, v in split.items()}, states


def group_split(states, params, ev) -> tuple[dict[str, float], object]:
    """Synchronised per-phase host time (ms) of one move played in
    ``run_search``'s groups; returns the split and the next states."""
    split = collections.Counter()
    trees, dt = _sync_time(lambda: mcts.init_trees(states, ev, params, CFG))
    split["init_trees"] += dt
    groups = mcts.rollout_groups(CFG.n_rollouts, CFG.eval_every)
    for length, evaluate in groups:
        res, dt = _sync_time(lambda: mcts.launch_rollouts(trees, ev, CFG, length))
        split[f"K1 launches ({len(groups)} for {CFG.n_rollouts} rollouts)"] += dt
        if evaluate:
            trees, dt = _sync_time(lambda: mcts.evaluate_leaves(trees, ev, params, CFG, res))
            split["eval phases"] += dt
    return _finish(states, trees, split)


def phase_split(states, params, ev) -> tuple[dict[str, float], object]:
    """Synchronised per-phase host time (ms) of one move played rollout by
    rollout (``search_step``); returns the split and the next states."""
    split = collections.Counter()
    trees, dt = _sync_time(lambda: mcts.init_trees(states, ev, params, CFG))
    split["init_trees"] += dt
    for i in range(CFG.n_rollouts):
        trees, dt = _sync_time(lambda: mcts.search_step(trees, ev, params, CFG, i))
        split["eval rollouts" if i % CFG.eval_every == 0 else "light rollouts"] += dt
    return _finish(states, trees, split)


def device_profile(states, params, ev) -> tuple[list[tuple[str, float, int]], float, float]:
    """Device time by kernel (ms, calls), total device ms and wall ms of one
    unsynchronised move under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        actions, _ = mcts.search(states, ev, params, CFG)
        rules.step(states, actions)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # Only device-side events: a host op's row repeats its kernels' time.
    rows = [
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    rows.sort(key=lambda r: -r[1])
    return rows, sum(r[1] for r in rows), wall


def main():
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    params = {"policy": nets.init_policy(128, seed=0, device=dev), "value": nets.load_value(VALUE_WEIGHTS, device=dev)}
    ev = mcts.net_evaluator()
    states = st.new_game_batch(BENCH_BATCH, device=dev)
    print(f"{torch.cuda.get_device_name(0)}; batch {BENCH_BATCH}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip().splitlines()[0])
    plan = [("grouped", group_split)] * MOVES + [("rollout by rollout", phase_split)]
    for m, (how, split_fn) in enumerate(plan):
        split, states = split_fn(states, params, ev)
        total = sum(split.values())
        parts = ", ".join(f"{k} {v:.2f} ms ({100 * v / total:.1f}%)" for k, v in split.items())
        print(f"move {m} ({how}): synchronised total {total:.2f} ms: {parts}")
    rollout.reset_launches()
    rows, dev_ms, wall = device_profile(states, params, ev)
    print(
        f"profiled move: wall {wall:.2f} ms, device busy {dev_ms:.2f} ms ({100 * dev_ms / wall:.1f}%), "
        f"idle {100 - 100 * dev_ms / wall:.1f}%; launches {dict(rollout.launches)}, "
        f"K1 rollouts {rollout.kernel_rollouts}"
    )
    ours = [r for r in rows if "descend_backprop_kernel" in r[0] or "write_rows_kernel" in r[0]]
    for name, ms, calls in rows[:15] + ours:
        print(f"  {ms:9.3f} ms  {calls:6d} calls  {1e3 * ms / calls:9.2f} us/call  {name[:90]}")


if __name__ == "__main__":
    main()
