"""Value-net data generation (counterpart of ``bin/genvals.py``): labelled
positions in device batches, appended (x8 D4) to a csv that
``bokego_tpu_torch.bin.train`` reads:

    python -m bokego_tpu_torch.bin.genvals -n 1 -o values.csv --sl policy.pt
"""

import argparse

from bokego_tpu_torch.bin import add_device_flag, device_from


def main(argv=None):
    p = argparse.ArgumentParser(description="generate data for value net")
    p.add_argument("-n", metavar="N", type=int, default=1, help="number of games to generate, in thousands")
    p.add_argument("-o", metavar="PATH", required=True, help="output csv")
    p.add_argument("--sl", help="SL policy checkpoint (.pt; a seeded random init without it)")
    p.add_argument("--rl", help="RL policy checkpoint (.pt; the SL policy without it)")
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-augment", action="store_true")
    p.add_argument("--min-r", type=int, default=70, help="earliest random-move turn")
    p.add_argument("--max-r", type=int, default=90)
    p.add_argument("--max-turns", type=int, default=90)
    p.add_argument("--raw-tt-labels", action="store_true",
                   help="label with raw Tromp-Taylor instead of the dead-group-aware resolved score")
    add_device_flag(p)
    args = p.parse_args(argv)
    device = device_from(args)

    import torch

    from bokego_tpu_torch.cli import load_variables
    from bokego_tpu_torch.train import genvals

    sl_net = load_variables(args.sl, "policy", device)
    rl_net = load_variables(args.rl, "policy", device) if args.rl else sl_net
    total = args.n * 1000
    gen = torch.Generator(device=device).manual_seed(args.seed)
    written = 0
    while written < total:
        samples = genvals.generate(
            gen, sl_net, rl_net, args.batch, max_turns=args.max_turns, min_r=args.min_r,
            max_r=args.max_r, resolved_labels=not args.raw_tt_labels,
        )
        rows = genvals.samples_to_rows(samples)
        genvals.write_csv(args.o, rows, augment=not args.no_augment)
        written += len(rows)
        print(f"{written}/{total} positions", flush=True)


if __name__ == "__main__":
    main()
