"""Supervised training CLI (counterpart of ``bin/train.py``):

    python -m bokego_tpu_torch.bin.train -d data.csv --kind value -e 3 -o value.pt
    python -m bokego_tpu_torch.bin.train -d 'shards/*.pshard.npz' --kind policy --lr 1e-3
"""

import argparse

from bokego_tpu_torch.bin import add_device_flag, device_from


def main(argv=None):
    p = argparse.ArgumentParser(description="SL training for policy/value nets")
    p.add_argument("-d", metavar="DATA", required=True,
                   help="csv, npz, .pshard.npz, a glob of shards or a directory of them")
    p.add_argument("-c", metavar="CHECKPOINT", help=".pt checkpoint to resume (net, optimizer, epoch)")
    p.add_argument("-e", metavar="EPOCHS", type=int, default=1)
    p.add_argument("--kind", choices=("policy", "value"), default="value")
    p.add_argument("--bs", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("-o", "--out", default="checkpoint.pt", help="output checkpoint (.pt)")
    p.add_argument("--stats", default="stats.txt")
    p.add_argument("--init-from-policy", help="bootstrap the value trunk from a policy .pt")
    add_device_flag(p)
    args = p.parse_args(argv)
    device = device_from(args)

    from bokego_tpu_torch.cli import load_variables
    from bokego_tpu_torch.models import nets
    from bokego_tpu_torch.train import checkpoints, data, sl

    print("Loading data...")
    dataset = data.load_streaming(args.d)
    print(f"Number of board positions: {len(dataset)}")

    start_epoch, opt_state = 0, None
    if args.c:
        print("Loading checkpoint...")
        ckpt = checkpoints.load_checkpoint(args.c)
        net = nets.from_state_dict(args.kind, ckpt, device)
        opt_state = ckpt.get("optimizer_state_dict")
        start_epoch = int(ckpt.get("epoch", 0))
    else:
        net = load_variables(None, args.kind, device)
        if args.kind == "value" and args.init_from_policy:
            nets.value_from_policy(net, load_variables(args.init_from_policy, "policy", device))

    state = sl.train(
        dataset, net, kind=args.kind, epochs=args.e, batch_size=args.bs, lr=args.lr,
        weight_decay=args.weight_decay, opt_state=opt_state, start_epoch=start_epoch,
        stats_path=args.stats,
    )
    checkpoints.save_variables(args.out, state.net, state.optimizer, {"epoch": state.epoch})
    print(f"Saved {args.out} (epoch {state.epoch})")


if __name__ == "__main__":
    main()
