"""Export an orbax policy or value checkpoint to a torch ``.pt`` file in the
reference key layout, which ``bokego_tpu_torch`` reads without JAX.

    JAX_PLATFORMS=cpu python tools/export_policy_torch.py \\
        [data/weights/policy_17_flax] [data/weights/policy_17.pt]
    JAX_PLATFORMS=cpu python tools/export_policy_torch.py --kind value \\
        data/weights/value_own data/weights/value_own.pt

``--kind`` is ``policy`` (the default) or ``value``.  Run once per
checkpoint; the output is committed (about 3.9 MB).  Give an exported policy
a name that is not ``policy_<n>.pt``, which is how the port's opponent pool
names its generations.
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None):
    p = argparse.ArgumentParser(description="orbax checkpoint -> torch .pt (reference layout)")
    p.add_argument("--kind", choices=("policy", "value"), default="policy")
    p.add_argument("src", nargs="?", default=os.path.join(REPO, "data", "weights", "policy_17_flax"))
    p.add_argument("dst", nargs="?", default=os.path.join(REPO, "data", "weights", "policy_17.pt"))
    args = p.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    from bokego_tpu.models import convert
    from bokego_tpu.train import checkpoints

    to_torch = convert.policy_to_torch if args.kind == "policy" else convert.value_to_torch
    state_dict = to_torch(checkpoints.load_variables(os.path.abspath(args.src)))
    convert.save_torch(args.dst, state_dict)
    print(f"{args.dst}: {args.kind}, {len(state_dict)} tensors, {os.path.getsize(args.dst)} bytes")


if __name__ == "__main__":
    main()
