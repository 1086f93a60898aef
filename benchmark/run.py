"""Run one cell of the benchmark of ``bokego_tpu_torch`` and print its
result as one JSON line:

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout; it exits non-zero without printing a
result when no CUDA device is present, when the cell asks for more devices
than there are, or when JAX or the JAX package is loaded.  ``--device
cpu`` with ``--batch`` and ``--rollouts`` runs the harness at a small size
on the CPU for its tests; ``--control tf32`` runs the program with TF32 on,
the control that the check must refuse.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".bench_cache"
# Every cache at a fixed path inside the checkout, before torch starts.
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
os.environ["USE_FLAX"] = "0"
os.environ["OMP_NUM_THREADS"] = "1"  # one intra-op thread, as the configurations state ("assumed")
sys.path.insert(0, str(ROOT))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", default=None, help=argparse.SUPPRESS)
    p.add_argument("--batch", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--rollouts", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--control", choices=("tf32",), default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    torch.set_num_threads(1)
    from benchmark.harness import main as harness

    return harness.run(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
