"""The multi-device dry run (counterpart of ``dryrun_multichip`` in the JAX
package's ``__graft_entry__.py``): one REINFORCE data-parallel step, one
sharded MCTS search and one sharded AlphaZero trajectory and step, at the
JAX dry run's sizes (2 games per device, 6 turns, 4 rollouts, node pools of
256 and 128) with seeded random-init nets, each printing one ``dryrun:``
line from rank 0.

    python -m bokego_tpu_torch.parallel.dryrun 2              # NCCL, ranks on cuda:0 and cuda:1
    python -m bokego_tpu_torch.parallel.dryrun 2 --device cpu  # gloo on the CPU

It spawns N ranks (``parallel.mesh.spawn``): NCCL on N GPUs by default,
raising when there are fewer; gloo on the CPU when asked.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from bokego_tpu_torch.parallel import mesh as mesh_lib

GAMES_PER_DEVICE = 2
MAX_TURNS = 6
ROLLOUTS = 4


def rank_seed(seed: int, rank: int) -> int:
    """A generator seed per rank (the JAX dry run's ``fold_in(rng, rank)``):
    each rank plays its own games."""
    return int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])


def _body(mesh: mesh_lib.Mesh) -> None:
    from bokego_tpu_torch.config import SearchConfig
    from bokego_tpu_torch.device import fp32_only
    from bokego_tpu_torch.env import state as st
    from bokego_tpu_torch.models import nets
    from bokego_tpu_torch.parallel.selfplay import search_sharded
    from bokego_tpu_torch.search import mcts
    from bokego_tpu_torch.train import alphazero as az
    from bokego_tpu_torch.train import reinforce

    fp32_only()
    dev, n = mesh.device, mesh.size
    if dev.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))

    def report(line: str) -> None:
        if mesh.rank == 0:
            print(line, flush=True)

    # REINFORCE: each rank's own games, gradients and loss averaged, one AdamW step
    policy = mesh_lib.replicate(nets.init_policy(seed=0, device=dev), mesh)
    opponent = nets.init_policy(seed=1, device=dev).eval()
    optimizer = reinforce.make_optimizer(policy, lr=1e-5)
    gen = torch.Generator(device=dev).manual_seed(rank_seed(2, mesh.rank))
    traj, rewards = reinforce.play_games(gen, policy, opponent, GAMES_PER_DEVICE, MAX_TURNS, True)
    loss = reinforce.update(policy, optimizer, traj, rewards, 0, mesh=mesh)
    report(f"dryrun: REINFORCE dp step on {n} devices, loss={float(loss):.4f}")

    # one batched-MCTS search over a game batch sharded over the ranks
    cfg = SearchConfig(expand_thresh=2, no_sim=True, max_nodes=256, max_turns=MAX_TURNS)
    ev = mcts.net_evaluator(has_value=True)
    value = nets.init_value(seed=3, device=dev)
    params = mesh_lib.replicate({"policy": policy, "value": value}, mesh)
    batch = n * GAMES_PER_DEVICE
    actions, _ = search_sharded(mesh, st.new_game_batch(batch, device=dev), ev, params, cfg, ROLLOUTS)
    report(f"dryrun: sharded MCTS search ok, actions={actions[:4].tolist()}...")

    # AlphaZero: a sharded trajectory with root noise, then one step with
    # the global normalisation
    az_cfg = SearchConfig(expand_thresh=2, no_sim=True, max_nodes=128, noise_weight=0.25, max_turns=MAX_TURNS)
    state = az.make_state(policy, value, lr=1e-4)
    gen = torch.Generator(device=dev).manual_seed(5)
    traj = az.selfplay_with_targets(
        gen, ev, params, az_cfg, batch, MAX_TURNS, ROLLOUTS, temperature=1.0, temp_moves=2, mesh=mesh
    )
    pl, vl = az.az_step(state, traj, mesh=mesh)
    report(f"dryrun: sharded AZ step ok, policy_ce={float(pl):.3f} value_mse={float(vl):.3f}")


def dryrun_multichip(n: int, device=None) -> None:
    """The dry run on ``n`` ranks: NCCL with rank r on ``cuda:r`` by default
    (raising for fewer than ``n`` GPUs), gloo on the CPU for ``device="cpu"``."""
    mesh_lib.spawn(_body, n, device=device)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="data-parallel dry run: REINFORCE, search and AlphaZero over N ranks")
    p.add_argument("n", type=int, nargs="?", default=8, help="number of ranks (devices)")
    p.add_argument("--device", default=None, help="'cpu' for gloo on the CPU (default: one GPU per rank, NCCL)")
    args = p.parse_args(argv)
    dryrun_multichip(args.n, device=args.device)


if __name__ == "__main__":
    main()
