"""Featurise a csv of positions into a compressed npz, or pack it into
shards (counterpart of ``bin/process_data.py``):

    python -m bokego_tpu_torch.bin.process_data moves.csv moves.npz
    python -m bokego_tpu_torch.bin.process_data moves.csv shards/moves --shards
"""

import argparse

from bokego_tpu_torch.bin import add_device_flag, device_from


def main(argv=None):
    p = argparse.ArgumentParser(description="csv -> npz feature precompute")
    p.add_argument("csv", help="input csv (board, ko, last, move|val)")
    p.add_argument("out", help="output path: .npz (feature precompute) or a "
                   "shard prefix with --shards (packed raw positions)")
    p.add_argument("--shards", action="store_true",
                   help="write packed .pshard.npz shards (constant-memory "
                   "streaming SL; features computed on the device at train time)")
    p.add_argument("--shard-size", type=int, default=262144)
    add_device_flag(p)
    args = p.parse_args(argv)
    device = device_from(args)

    from bokego_tpu_torch.train import data

    if args.shards:
        paths = data.pack_csv_to_shards(args.csv, args.out, args.shard_size)
        total = sum(len(data.load_shard(path)) for path in paths)
        print(f"wrote {len(paths)} shards: {total} positions")
        return
    ds = data.load_csv(args.csv, device)
    data.save_npz(args.out, ds)
    print(f"wrote {args.out}: {len(ds)} positions ({'vals' if ds.is_value else 'moves'})")


if __name__ == "__main__":
    main()
