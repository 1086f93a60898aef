"""REINFORCE self-play training (counterpart of ``bin/selfplay.py``): the
latest pool policy plays randomly drawn earlier generations, and each epoch
appends a new generation (``policy_<n>.pt``) to the pool:

    python -m bokego_tpu_torch.bin.selfplay -e 1 -n 64 -b 16 -w pool/
"""

import argparse
import os

from bokego_tpu_torch.bin import add_device_flag, device_from


def main(argv=None):
    p = argparse.ArgumentParser(description="REINFORCE self-play training")
    p.add_argument("-e", metavar="E", type=int, default=1, help="number of epochs")
    p.add_argument("-b", metavar="B", type=int, default=16, help="games per batch")
    p.add_argument("-n", metavar="N", type=int, default=64, help="iterations per epoch")
    p.add_argument("-f", metavar="PATH", default=os.path.join(os.getcwd(), "RL_stats.txt"), help="stats file")
    p.add_argument("-w", metavar="PATH", default=os.path.join("data", "weights"), help="weights pool directory")
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--max-turns", type=int, default=70)
    p.add_argument("--seed", type=int, default=0)
    add_device_flag(p)
    args = p.parse_args(argv)
    device = device_from(args)

    import numpy as np
    import torch

    from bokego_tpu_torch.models import nets
    from bokego_tpu_torch.train import checkpoints, reinforce

    latest = checkpoints.latest_policy(args.w)
    # every generation this run will write, checked before any is played
    checkpoints.next_generation(args.w, args.e + (latest is None))
    if latest is None:
        print("Empty pool: seeding policy_0 with fresh init")
        net = nets.init_policy(seed=args.seed, device=device)
        n_latest = checkpoints.save_next_policy(args.w, net)
    else:
        n_latest, ckpt = latest
        net = nets.from_state_dict("policy", ckpt, device)
    # the optimizer threads through the epochs of this process only, as in
    # the JAX package (and the reference's per-invocation Adam)
    optimizer = None
    print(f"Opponent pool size: {n_latest}")

    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    for epoch in range(args.e):
        print(f"Epoch: {epoch + 1}")
        opp_id, opp_ckpt = checkpoints.sample_opponent(args.w, rng)
        print(f"Playing against Policy {opp_id}")
        result = reinforce.train_epoch(
            gen, net, nets.from_state_dict("policy", opp_ckpt, device), n_iters=args.n,
            batch_games=args.b, max_turns=args.max_turns, lr=args.lr, optimizer=optimizer,
        )
        optimizer = result.optimizer
        with open(args.f, "a+") as f:
            f.write(f"Policy {n_latest} vs. Policy {opp_id}\n")
            f.write(f"Batch Size: {args.b}, Iterations: {args.n}\n")
            f.write(",".join(f"{w:.3f}" for w in result.winrates) + "\n")
        n_latest = checkpoints.save_next_policy(args.w, net, optimizer)
        print(f"Saved policy_{n_latest}")


if __name__ == "__main__":
    main()
