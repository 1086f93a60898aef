"""Weak scaling of sharded self-play over the data-parallel mesh (the port's
counterpart of ``tools/measure_scaling.py``).

    python -m bokego_tpu_torch.parallel.scaling [N] [K]                             # NCCL, rank r on cuda:r
    python -m bokego_tpu_torch.parallel.scaling 2 4 --device cuda:0 --backend gloo  # 2 ranks sharing one card
    python -m bokego_tpu_torch.parallel.scaling 2 2 --device cpu                    # gloo on the CPU

The JAX tool's protocol: ``selfplay`` at K games on one device, then
``selfplay_sharded`` at n x K games over n ranks for n = 2, 4 and N (those
not above N; the JAX tool assumes N >= 4), each with the JAX tool's
random-init nets (``init_policy(PRNGKey(0))``, ``init_value(PRNGKey(1))``,
read through ``bench.bench_nets``) at
``SearchConfig(expand_thresh=2, no_sim=True, max_nodes=128,
max_turns=16)``, 8 moves of 8 rollouts, one warm run and one timed run
(synchronised host clock; ranks meet at a barrier before it).  Then
``selfplay`` at N x K on one device against the sharded run at N x K:
actions and scores IDENTICAL or DIFFER.  It prints the JAX tool's markdown
table and that line.

Every n starts its ranks with ``parallel.mesh.spawn``: NCCL with one card
per rank by default (raising where the machine has fewer than N), gloo on
the CPU with ``--device cpu``, and gloo with every rank on one card only
when asked (``--device cuda:0 --backend gloo``).  Ranks sharing a card or
the CPU's cores scale no wall clock: the check that transfers is the
equality, and the per-rank time.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch
import torch.distributed as dist

from bokego_tpu_torch import bench
from bokego_tpu_torch.config import SearchConfig
from bokego_tpu_torch.device import fp32_only, synchronize
from bokego_tpu_torch.parallel import mesh as mesh_lib
from bokego_tpu_torch.parallel.selfplay import selfplay, selfplay_sharded

CFG = SearchConfig(expand_thresh=2, no_sim=True, max_nodes=128, max_turns=16)
N_MOVES, N_ROLLOUTS = 8, 8


def _play(params, ev, batch: int, device, mesh=None):
    """A warm run, then a timed one; returns its result and seconds."""

    def run():
        if mesh is None:
            return selfplay(params, ev, CFG, batch, N_MOVES, N_ROLLOUTS, device=device)
        return selfplay_sharded(mesh, params, ev, CFG, batch, N_MOVES, N_ROLLOUTS)

    run()
    if mesh is not None:
        dist.barrier(group=mesh.group)
    synchronize(device)
    t0 = time.monotonic()
    out = run()
    synchronize(device)
    return out, time.monotonic() - t0


def _setup(device):
    """The bench's nets and evaluator on ``device``, in fp32."""
    fp32_only()
    return bench.bench_nets(device, "fp32")


def _rank(mesh: mesh_lib.Mesh, batch: int, path: str) -> None:
    """One rank of a sharded run; rank 0 saves actions, scores and seconds."""
    if mesh.device.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // mesh.size))
    params, ev = _setup(mesh.device)
    out, dt = _play(params, ev, batch, mesh.device, mesh)
    if mesh.rank == 0:
        torch.save({"actions": out.actions.cpu(), "scores": out.scores.cpu(), "seconds": dt}, path)


def sharded(n: int, batch: int, device=None, backend: str | None = None) -> dict:
    """``selfplay_sharded`` of ``batch`` games over ``n`` spawned ranks:
    rank 0's actions, scores and timed seconds."""
    with tempfile.TemporaryDirectory(prefix="bokego_scaling_") as tmp:
        path = os.path.join(tmp, "out.pt")
        mesh_lib.spawn(_rank, n, batch, path, device=device, backend=backend)
        return torch.load(path, weights_only=True)


def single(batch: int, device) -> dict:
    """``selfplay`` of ``batch`` games on one device, in this process."""
    params, ev = _setup(device)
    out, dt = _play(params, ev, batch, device)
    return {"actions": out.actions.cpu(), "scores": out.scores.cpu(), "seconds": dt}


def measure(n_ranks: int, k: int, device=None, backend: str | None = None) -> tuple[list, bool, bool]:
    """The table's rows ``(ranks, games, seconds)`` and whether the sharded
    run at ``n_ranks * k`` has the single-device run's actions and scores."""
    one = mesh_lib.rank_device(0, n_ranks, device)  # raises for too few cards before any run
    rows = [(1, k, single(k, one)["seconds"])]
    for n in dict.fromkeys(m for m in (2, 4, n_ranks) if m <= n_ranks):
        last = sharded(n, n * k, device, backend)
        rows.append((n, n * k, last["seconds"]))
    full = single(n_ranks * k, one)
    return rows, torch.equal(full["actions"], last["actions"]), torch.equal(full["scores"], last["scores"])


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="weak scaling of sharded self-play, and its equality to one device")
    p.add_argument("n", type=int, nargs="?", default=8, help="number of ranks (devices)")
    p.add_argument("k", type=int, nargs="?", default=16, help="games per rank")
    p.add_argument("--device", default=None,
                   help="'cpu' for gloo on the CPU, or one card for every rank with --backend gloo "
                        "(default: one GPU per rank, NCCL)")
    p.add_argument("--backend", default=None, help="'gloo' to share one card between the ranks")
    args = p.parse_args(argv)
    rows, same, same_scores = measure(args.n, args.k, args.device, args.backend)
    where = args.device or "one card per rank"
    print(f"mesh: {args.n} ranks ({args.backend or ('gloo' if where == 'cpu' else 'nccl')} on {where}), "
          f"k={args.k} games/rank\n")
    print("| devices | games | wall s | games/s | per-device games/s |")
    print("|---|---|---|---|---|")
    for n, b, dt in rows:
        print(f"| {n} | {b} | {dt:.2f} | {b / dt:.1f} | {b / dt / n:.1f} |")
    print(
        f"\nsharded(n={args.n}) vs single-device at equal batch+seed: "
        f"actions {'IDENTICAL' if same else 'DIFFER'}, "
        f"scores {'IDENTICAL' if same_scores else 'DIFFER'}",
        flush=True,
    )


if __name__ == "__main__":
    main()
