"""Where a self-play move's time goes on the GPU (the port's main path).

    python -m bokego_tpu_torch.measure

Runs the bench configuration (B=1024, 400 rollouts/move, eval_every=8,
kernel_levels=6, expand_thresh=100, max_nodes=512) with a seeded random-init
policy and ``data/weights/value_r2.pt``, and prints, for three moves and then
a fourth under the profiler:

* host-clock time per phase of one move, each phase ended by a device
  synchronise: ``init_trees``, light rollouts (kernel only), eval rollouts
  (kernel + features + nets + expansion), ``choose_action`` + rules step;
* from ``torch.profiler`` over one unsynchronised move: device time by
  kernel name and the device-busy share of the move's wall time.

Needs a GPU; it raises without one.
"""

from __future__ import annotations

import collections
import time

import torch

from bokego_tpu_torch.config import BENCH_BATCH, BENCH_CONFIG as CFG, VALUE_WEIGHTS
from bokego_tpu_torch.env import rules, state as st
from bokego_tpu_torch.models import nets
from bokego_tpu_torch.search import mcts

MOVES = 3  # synchronised moves played before the profiled one


def _sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_split(states, params, ev) -> tuple[dict[str, float], object]:
    """Synchronised per-phase host time (ms) of one move; returns the split
    and the next states."""
    split = collections.Counter()
    trees, dt = _sync_time(lambda: mcts.init_trees(states, ev, params, CFG))
    split["init_trees"] += dt
    for i in range(CFG.n_rollouts):
        trees, dt = _sync_time(lambda: mcts.search_step(trees, ev, params, CFG, i))
        split["eval rollouts" if i % CFG.eval_every == 0 else "light rollouts"] += dt

    def finish():
        return rules.step(states, mcts.choose_action(trees))

    states, dt = _sync_time(finish)
    split["choose + step"] += dt
    return {k: v * 1e3 for k, v in split.items()}, states


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
    for m in range(MOVES):
        split, states = phase_split(states, params, ev)
        total = sum(split.values())
        parts = ", ".join(f"{k} {v:.2f} ms ({100 * v / total:.1f}%)" for k, v in split.items())
        print(f"move {m}: synchronised total {total:.2f} ms: {parts}")
    rows, dev_ms, wall = device_profile(states, params, ev)
    print(f"profiled move: wall {wall:.2f} ms, device busy {dev_ms:.2f} ms ({100 * dev_ms / wall:.1f}%), idle {100 - 100 * dev_ms / wall:.1f}%")
    ours = [r for r in rows if "descend_backprop_kernel" in r[0] or "write_rows_kernel" in r[0]]
    for name, ms, calls in rows[:15] + ours:
        print(f"  {ms:9.3f} ms  {calls:6d} calls  {1e3 * ms / calls:9.2f} us/call  {name[:90]}")


if __name__ == "__main__":
    main()
