"""Where a self-play move's and a served move's time go on the GPU (the
port's two main paths).

    python -m bokego_tpu_torch.measure

Runs the bench configuration (B=1024, 400 rollouts/move, eval_every=8,
kernel_levels=6, expand_thresh=100, max_nodes=512) with the bench's nets
(``bench.bench_nets``: the JAX bench's ``init_policy(PRNGKey(0))`` and
``init_value(PRNGKey(1))``), and prints:

* for three moves played as the search plays them (``run_search``'s groups,
  one kernel launch per run of rollouts up to the next eval step), the
  host-clock time per phase, each phase ended by a device synchronise:
  ``init_trees``, the K1 launches (with their count and rollouts), the eval
  phases (features + nets + expansion), ``choose_action`` + rules step;
* for one move played rollout by rollout (``search_step``), the same split
  into light and eval rollouts: what a launch per rollout costs;
* from ``torch.profiler`` over one unsynchronised move through
  ``mcts.search``: device time by kernel name, the device-busy share of the
  move's wall time, and the move's launches of the port's own kernels.

Then the serving path: the GTP engine with the shipped
``data/weights/policy_17.pt`` and ``value_r2.pt``, in its default
configuration (non-kernel search, one tree), as ``--fast --forest 8``, as
``--leaf-batch 8``, as ``--leaf-batch 16 --forest 8`` (all at ``-r 400``)
and as ``--simulate -r 8``, each after a warm-up and three generated moves:

* the synchronised host time of one ``genmove`` by phase: the search's
  chunks, the vote (``_root_child_visits``), the re-root (``advance_root``
  + ``compact`` + ``expand_roots``); and of the search, the leaf
  evaluations, the leaf-parallel steps' K descents with their virtual
  losses and their backprops, and simulation mode's playouts;
* one more ``genmove`` under ``torch.profiler``: device time by kernel, the
  device's busy and idle share, the port's own kernels' launches.

Then the training path: one AlphaZero self-play move at the trainer's
search (B=64, 64 rollouts, non-kernel) split into ``init_trees``, the
descents, the leaf evaluations and the backprops, and one SL step at B=256
split into the batch's featurisation and the step; each profiled as above.

Needs a GPU; it raises without one.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import subprocess
import time

import torch

from bokego_tpu_torch import bench
from bokego_tpu_torch.config import BENCH_BATCH, BENCH_CONFIG as CFG, POLICY_WEIGHTS, VALUE_WEIGHTS
from bokego_tpu_torch.device import fp32_only
from bokego_tpu_torch.env import rules, state as st
from bokego_tpu_torch.models import nets
from bokego_tpu_torch.search import leafpar, mcts
from bokego_tpu_torch.utils import metrics

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


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints them for the first card."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return smi.stdout.strip().splitlines()[0]


def group_split(states, params, ev, cfg) -> tuple[dict[str, float], object]:
    """Synchronised per-phase host time (ms) of one move at ``cfg`` played in
    ``run_search``'s groups; returns the split and the next states."""
    split = collections.Counter()
    trees, dt = _sync_time(lambda: mcts.init_trees(states, ev, params, cfg))
    split["init_trees"] += dt
    groups = mcts.rollout_groups(cfg.n_rollouts, cfg.eval_every)
    for length, evaluate in groups:
        res, dt = _sync_time(lambda: mcts.launch_rollouts(trees, ev, cfg, length))
        split[f"K1 launches ({len(groups)} for {cfg.n_rollouts} rollouts)"] += dt
        if evaluate:
            trees, dt = _sync_time(lambda: mcts.evaluate_leaves(trees, ev, params, cfg, res))
            split["eval phases"] += dt
    return _finish(states, trees, split)


def phase_split(states, params, ev, cfg) -> tuple[dict[str, float], object]:
    """Synchronised per-phase host time (ms) of one move at ``cfg`` played
    rollout by rollout (``search_step``); returns the split and the next
    states."""
    split = collections.Counter()
    trees, dt = _sync_time(lambda: mcts.init_trees(states, ev, params, cfg))
    split["init_trees"] += dt
    for i in range(cfg.n_rollouts):
        trees, dt = _sync_time(lambda: mcts.search_step(trees, ev, params, cfg, i))
        split["eval rollouts" if i % cfg.eval_every == 0 else "light rollouts"] += dt
    return _finish(states, trees, split)


def device_profile(move) -> tuple[list[tuple[str, float, int]], float, float]:
    """Device time by kernel (ms, calls), total device ms and wall ms of one
    unsynchronised call of ``move`` under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        move()
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


def print_profile(what: str, move) -> None:
    """Device time by kernel of ``move`` (the top 15, then the port's own
    kernels: ``ops.<name>`` counts the launches of ``<name>_kernel``) and
    the device's busy share."""
    with metrics.recording(spans=False) as rec:
        rows, dev_ms, wall = device_profile(move)
    launched = {k[len("ops."):]: int(n) for k, n in rec.counters.items() if k.startswith("ops.")}
    print(
        f"profiled {what}: wall {wall:.2f} ms, device busy {dev_ms:.2f} ms ({100 * dev_ms / wall:.1f}%), "
        f"idle {100 - 100 * dev_ms / wall:.1f}%; launches {launched}"
    )
    ours = [r for r in rows if any(f"{k}_kernel" in r[0] for k in launched)]
    for name, ms, calls in rows[:15] + ours:
        print(f"  {ms:9.3f} ms  {calls:6d} calls  {1e3 * ms / calls:9.2f} us/call  {name[:90]}")


# Phases inside a served search, each a function that the search looks up in
# its module when it calls it: (label, module, function name).
SEARCH_PHASES = (
    ("leaf evaluations (features, nets, expansion)", mcts, "_eval_and_expand"),
    ("leaf evaluations (features, nets, expansion)", leafpar, "_eval_and_expand_k"),
    ("K descents with virtual loss", leafpar, "_select_k"),
    ("backprops of K paths", leafpar, "_backprop_k"),
    ("playouts", mcts, "_simulate"),
    ("playouts", leafpar, "_simulate"),
)


# The phases of a non-kernel rollout step (the AlphaZero trainer's search).
ROLLOUT_PHASES = (
    ("descents", mcts, "_descend_batch"),
    ("leaf evaluations (features, nets, expansion)", mcts, "_eval_and_expand"),
    ("backprops", mcts, "_backprop_batch"),
)


@contextlib.contextmanager
def timed_phases(log: dict[str, list[float]], phases=SEARCH_PHASES):
    """While open, every call of a function of ``phases`` ends in a device
    synchronise and adds its host time to ``log[label]``."""
    plain = [(module, name, getattr(module, name)) for _, module, name in phases]

    def timed(label, fn):
        def call(*args, **kwargs):
            out, dt = _sync_time(lambda: fn(*args, **kwargs))
            log.setdefault(label, []).append(dt)
            return out

        return call

    for (label, module, name), (_, _, fn) in zip(phases, plain):
        setattr(module, name, timed(label, fn))
    try:
        yield
    finally:
        for module, name, fn in plain:
            setattr(module, name, fn)


def served_move(dev, params, flags: list[str]) -> None:
    """Split and profile of one generated move of the GTP engine."""
    from bokego_tpu_torch import cli
    from bokego_tpu_torch.config import EngineConfig
    from bokego_tpu_torch.gtp.engine import GTPEngine

    args = cli.build_parser().parse_args(flags)
    ecfg = EngineConfig(time_lim=None, n_rollouts=args.r, pondering=False, forest_size=args.forest)
    eng = GTPEngine(mcts.net_evaluator(), params, cli.search_config(args, dev), ecfg, device=dev)
    eng.running = True
    eng.warm_up()
    for color in ("black", "white", "black"):
        eng.send(f"genmove {color}")
    split, inside = {}, {}
    before = eng.trees.root_stats[:, 0].clone()
    with timed_phases(inside):
        _, split["search"] = _sync_time(lambda: eng.rollout(args.r))
    rollouts = int((eng.trees.root_stats[:, 0] - before)[0])
    visits, split["vote"] = _sync_time(eng._root_child_visits)
    _, split["re-root"] = _sync_time(lambda: eng._apply_move(max(sorted(visits), key=visits.get)))
    total = sum(split.values())
    parts = ", ".join(f"{k} {1e3 * v:.2f} ms ({100 * v / total:.1f}%)" for k, v in split.items())
    phases = "; ".join(f"{len(v)} {k} {1e3 * sum(v):.2f} ms" for k, v in inside.items())
    print(
        f"served move ({' '.join(flags)}): synchronised total {1e3 * total:.2f} ms: {parts}; {rollouts} rollouts "
        f"per tree, {rollouts / split['search']:.1f} rollouts/s per tree; of the search: {phases}"
    )
    print_profile(f"served move ({' '.join(flags)})", lambda: eng.send("genmove black"))


def training_moves(dev, params) -> None:
    """Split and profile of one AlphaZero self-play move and one SL step."""
    import numpy as np

    from bokego_tpu_torch.train import alphazero as az
    from bokego_tpu_torch.train import gendata, sl

    cfg = az.default_config(80)
    ev = mcts.net_evaluator()
    gen = torch.Generator(device=dev).manual_seed(0)
    roots = gendata.generate(gen, params["policy"], 64, max_turns=20).final  # midgame roots
    trees, t_init = _sync_time(lambda: mcts.init_trees(roots, ev, params, cfg, gen=gen))
    inside = {}
    with timed_phases(inside, ROLLOUT_PHASES):
        _, t_search = _sync_time(lambda: mcts.run_search(trees, ev, params, cfg, 64, gen=gen))
    phases = "; ".join(f"{len(v)} {k} {1e3 * sum(v):.2f} ms" for k, v in inside.items())
    print(
        f"AlphaZero self-play move (B=64, 64 rollouts): init_trees {1e3 * t_init:.2f} ms, 64 rollouts "
        f"{1e3 * t_search:.2f} ms ({1e3 * t_search / 64:.2f} ms a rollout step); of the rollouts: {phases}"
    )

    def az_move():
        t = mcts.init_trees(roots, ev, params, cfg, gen=gen)
        mcts.run_search(t, ev, params, cfg, 64, gen=gen)

    print_profile("AlphaZero self-play move (B=64, 64 rollouts)", az_move)

    packed = gendata.trajectory_to_packed(gendata.generate(gen, params["policy"], 256, max_turns=40))
    batches = packed.batches(256, np.random.default_rng(0), device=dev)
    net = copy.deepcopy(params["policy"]).train()
    opt = sl.make_optimizer(net, 1e-4)
    for _ in range(3):  # warm-up
        fts, moves = next(batches)
        sl.train_step(net, opt, sl.policy_loss, fts, torch.as_tensor(moves, device=dev).long())
    (fts, moves), t_feat = _sync_time(lambda: next(batches))
    targets = torch.as_tensor(moves, device=dev).long()
    _, t_step = _sync_time(lambda: sl.train_step(net, opt, sl.policy_loss, fts, targets))
    print(f"SL policy step (B=256): featurise the batch {1e3 * t_feat:.2f} ms, forward + backward + Adam {1e3 * t_step:.2f} ms")

    def sl_step():
        f, m = next(batches)
        sl.train_step(net, opt, sl.policy_loss, f, torch.as_tensor(m, device=dev).long())

    print_profile("SL policy step (B=256)", sl_step)


def main():
    dev = torch.device("cuda")
    fp32_only()
    params, ev = bench.bench_nets(dev, "fp32")
    states = st.new_game_batch(BENCH_BATCH, device=dev)
    print(f"{torch.cuda.get_device_name(0)}; batch {BENCH_BATCH}")
    print(card_line())
    plan = [("grouped", group_split)] * MOVES + [("rollout by rollout", phase_split)]
    for m, (how, split_fn) in enumerate(plan):
        split, states = split_fn(states, params, ev, CFG)
        total = sum(split.values())
        parts = ", ".join(f"{k} {v:.2f} ms ({100 * v / total:.1f}%)" for k, v in split.items())
        print(f"move {m} ({how}): synchronised total {total:.2f} ms: {parts}")

    def selfplay_move():
        actions, _ = mcts.search(states, ev, params, CFG)
        rules.step(states, actions)

    print_profile("self-play move", selfplay_move)
    served = {"policy": nets.load_policy(POLICY_WEIGHTS, device=dev), "value": nets.load_value(VALUE_WEIGHTS, device=dev)}
    for flags in (
        ["-r", "400"],
        ["-r", "400", "--fast", "--forest", "8"],
        ["-r", "400", "--leaf-batch", "8"],
        ["-r", "400", "--leaf-batch", "16", "--forest", "8"],
        ["-r", "8", "--simulate"],
    ):
        served_move(dev, served, flags)
    training_moves(dev, served)


if __name__ == "__main__":
    main()
