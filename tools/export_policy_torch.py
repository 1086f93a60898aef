"""Export an orbax policy checkpoint to a torch ``.pt`` file in the
reference key layout, which ``bokego_tpu_torch`` reads without JAX.

    JAX_PLATFORMS=cpu python tools/export_policy_torch.py \\
        [data/weights/policy_17_flax] [data/weights/policy_17.pt]

Run once per checkpoint; the output is committed (about 3.6 MB).
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from bokego_tpu.models import convert
    from bokego_tpu.train import checkpoints

    src = argv[1] if len(argv) > 1 else os.path.join(REPO, "data", "weights", "policy_17_flax")
    dst = argv[2] if len(argv) > 2 else os.path.join(REPO, "data", "weights", "policy_17.pt")
    state_dict = convert.policy_to_torch(checkpoints.load_variables(os.path.abspath(src)))
    convert.save_torch(dst, state_dict)
    print(f"{dst}: {len(state_dict)} tensors, {os.path.getsize(dst)} bytes")


if __name__ == "__main__":
    main(sys.argv)
