"""Policy-SL training data from self-play (counterpart of
``bin/gen_policy_data.py``):

    python -m bokego_tpu_torch.bin.gen_policy_data -n 1024 -o moves.csv
    python -m bokego_tpu_torch.bin.gen_policy_data -n 4096 -o shards/sp --packed
"""

import argparse
import time

from bokego_tpu_torch.bin import add_device_flag, device_from


def main(argv=None):
    p = argparse.ArgumentParser(description="self-play -> policy SL csv")
    p.add_argument("-n", metavar="GAMES", type=int, default=1024, help="number of games")
    p.add_argument("-o", metavar="PATH", required=True, help="output csv, or shard prefix with --packed")
    p.add_argument("--packed", action="store_true",
                   help="write .pshard.npz shards directly (vectorised, no csv intermediate)")
    p.add_argument("--policy", help="policy checkpoint (.pt; a seeded random init without it)")
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--max-turns", type=int, default=70)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-augment", action="store_true")
    add_device_flag(p)
    args = p.parse_args(argv)
    device = device_from(args)

    import torch

    from bokego_tpu_torch.cli import load_variables
    from bokego_tpu_torch.train import gendata
    from bokego_tpu_torch.train.data import save_shards

    policy = load_variables(args.policy, "policy", device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    done = chunk = total_pos = 0
    t0 = time.monotonic()
    while done < args.n:
        traj = gendata.generate(gen, policy, args.batch, max_turns=args.max_turns)
        if args.packed:
            ds = gendata.trajectory_to_packed(traj, augment=not args.no_augment)
            save_shards(f"{args.o}-c{chunk:03d}", ds, shard_size=len(ds))
            n_pos = len(ds)
        else:
            rows = gendata.trajectory_to_rows(traj)
            gendata.write_csv(args.o, rows, augment=not args.no_augment)
            n_pos = len(rows)
        chunk += 1
        done += args.batch
        total_pos += n_pos
        dt = time.monotonic() - t0
        print(f"{min(done, args.n)}/{args.n} games, {total_pos} positions ({total_pos / dt:.0f} pos/s)", flush=True)


if __name__ == "__main__":
    main()
