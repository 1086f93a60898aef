"""AlphaZero-style closed-loop training (counterpart of ``bin/alphazero.py``):

    python -m bokego_tpu_torch.bin.alphazero --iters 8 --batch 256 -o az --resume

Checkpoints: ``{out}_ckpt.pt`` holds policy, value and the iteration in one
atomic write and is what ``--resume`` reads; ``{out}_policy.pt`` /
``{out}_value.pt`` (reference layout) and ``{out}_iter.txt`` follow it.
"""

import argparse
import os

from bokego_tpu_torch.bin import add_device_flag, device_from


def main(argv=None):
    p = argparse.ArgumentParser(description="AlphaZero-style training loop")
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--moves", type=int, default=80)
    p.add_argument("--rollouts", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--temp-moves", type=int, default=12,
                   help="sample by visits for the first T plies, greedy after")
    p.add_argument("--updates-per-iter", type=int, default=1)
    p.add_argument("--policy", help="initial policy (.pt; a seeded random init without it)")
    p.add_argument("--value", help="initial value net (.pt; a seeded random init without it)")
    p.add_argument("-o", "--out", default="az_ckpt", help="output path prefix")
    p.add_argument("--save-every", type=int, default=16, help="checkpoint every K iters")
    p.add_argument("--resume", action="store_true",
                   help="continue from {out}_ckpt.pt (or the split {out}_policy.pt / "
                        "{out}_value.pt and {out}_iter.txt) if present; the optimizers restart fresh")
    p.add_argument("--seed", type=int, default=0)
    add_device_flag(p)
    args = p.parse_args(argv)
    device = device_from(args)

    from bokego_tpu_torch.cli import load_variables
    from bokego_tpu_torch.models import nets
    from bokego_tpu_torch.train import alphazero as az, checkpoints

    start_iter = 0
    iter_path = args.out + "_iter.txt"
    ckpt_path = args.out + "_ckpt.pt"
    split = {kind: f"{args.out}_{kind}.pt" for kind in ("policy", "value")}
    if args.resume and os.path.exists(ckpt_path):
        payload = checkpoints.load_checkpoint(ckpt_path)
        policy = nets.from_state_dict("policy", payload["policy"], device)
        value = nets.from_state_dict("value", payload["value"], device)
        start_iter = int(payload["iter"])
        print(f"resuming from {ckpt_path} at iter {start_iter}")
    elif args.resume and os.path.exists(split["policy"]):
        policy = load_variables(split["policy"], "policy", device)
        value = load_variables(split["value"], "value", device)
        if os.path.exists(iter_path):
            with open(iter_path) as f:
                start_iter = int(f.read().strip())
        print(f"resuming from {args.out}_* at iter {start_iter}")
    else:
        policy = load_variables(args.policy, "policy", device)
        value = load_variables(args.value, "value", device)

    def save_all(it, state):
        # the resume state first, in one atomic write; the split files and
        # the iteration file are derived from it
        checkpoints.atomic_save(
            {"policy": state.policy.state_dict(), "value": state.value.state_dict(), "iter": it}, ckpt_path
        )
        checkpoints.save_variables(split["policy"], state.policy)
        checkpoints.save_variables(split["value"], state.value)
        with open(iter_path, "w") as f:
            f.write(str(it))

    def checkpoint(it, state):
        if it % args.save_every and it != start_iter + args.iters:
            return
        save_all(it, state)
        print(f"checkpointed {args.out}_* at iter {it}", flush=True)

    state = az.train(
        args.seed, policy, value, iters=args.iters, batch=args.batch, n_moves=args.moves,
        n_rollouts=args.rollouts, lr=args.lr, temperature=args.temperature,
        temp_moves=args.temp_moves, updates_per_iter=args.updates_per_iter,
        start_iter=start_iter, checkpoint_fn=checkpoint,
    )
    save_all(start_iter + args.iters, state)
    print(f"saved {split['policy']} and {split['value']}")


if __name__ == "__main__":
    main()
