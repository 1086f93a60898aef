"""CLI entry point of the port's GTP engine (counterpart of
``bokego_tpu/cli.py``):

    python -m bokego_tpu_torch.cli -r 400 --no-ponder -p data/weights/policy_17.pt -v data/weights/value_r2.pt

``-t`` seconds per move, ``-r`` rollouts per move (overrides ``-t``),
``-p``/``-v`` weights as torch ``.pt`` files in the reference key layout
(a seeded random init without them), ``--fast`` for the CUDA rollout
kernels with amortised leaf evaluation, ``--simulate`` for policy playouts
to the end of the game at every leaf, ``--leaf-batch K`` for K leaf-parallel
rollouts per step.  The engine runs on the GPU and raises without one;
``--device cpu`` asks for the CPU.  ``-g`` is accepted for interface parity.
"""

from __future__ import annotations

import argparse
import dataclasses


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="bokego-tpu-torch GTP engine")
    p.add_argument("-t", metavar="SEC", type=float, dest="t", default=10.0,
                   help="time limit in seconds for each move")
    p.add_argument("-r", dest="r", type=int, default=None,
                   help="number of rollouts per move (overrides -t)")
    p.add_argument("-p", metavar="PATH", type=str, dest="p", default=None,
                   help="path to policy weights (.pt)")
    p.add_argument("-v", metavar="PATH", type=str, dest="v", default=None,
                   help="path to value weights (.pt)")
    p.add_argument("-g", "--gpu", action="store_true",
                   help="accepted for parity; the GPU is the default device")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' to run on the CPU)")
    p.add_argument("--simulate", action="store_true",
                   help="enable simulations to end of game")
    p.add_argument("--forest", type=int, default=1,
                   help="number of root-parallel trees")
    p.add_argument("--no-ponder", action="store_true",
                   help="disable pondering between commands")
    p.add_argument("--fast", action="store_true",
                   help="GPU perf mode: CUDA rollout kernels + amortized "
                        "leaf evaluation (eval_every=8)")
    p.add_argument("--noise", type=float, default=None,
                   help="Dirichlet root-noise weight; per-tree noise "
                        "diversifies --forest root-parallel search (fresh "
                        "noise at every re-root, so subtree reuse is kept)")
    p.add_argument("--expand-thresh", type=int, default=None,
                   help="visits before leaf expansion (default 100)")
    p.add_argument("--max-nodes", type=int, default=None,
                   help="node-pool capacity per tree")
    p.add_argument("--leaf-batch", type=int, default=None, dest="leaf_batch",
                   help="K leaf-parallel rollouts per step with virtual loss "
                        "(search/leafpar.py): one K-wide net forward in "
                        "place of K dependent evaluations at batch 1. "
                        "Composes with --forest (K x forest leaves per "
                        "forward); not with --fast (non-kernel path only)")
    p.add_argument("--strong", action="store_true",
                   help="tuned serving preset: expand_thresh=16, "
                        "max_nodes=65536")
    return p


def load_variables(path: str | None, kind: str, device=None):
    """The policy or value net on ``device``: from a torch ``.pt`` checkpoint
    in the reference key layout, or a seeded random init without a path."""
    from bokego_tpu_torch.models import nets

    if path is None:
        return (nets.init_policy if kind == "policy" else nets.init_value)(device=device)
    if not path.endswith(".pt"):
        raise ValueError(
            f"{path}: the port reads torch .pt checkpoints only; export an orbax "
            f"directory with tools/export_policy_torch.py --kind {kind}"
        )
    return (nets.load_policy if kind == "policy" else nets.load_value)(path, device=device)


def search_config(args, device):
    """The search configuration the flags select on ``device``."""
    from bokego_tpu_torch.config import SearchConfig

    noise = 0.0 if args.noise is None else args.noise
    sim = args.simulate
    if args.fast and device.type == "cuda":
        # the rollout kernels serve no_sim searches only
        scfg = SearchConfig(
            no_sim=not sim, use_kernel=not sim, eval_every=8, max_nodes=512, noise_weight=noise
        )
    else:
        scfg = SearchConfig(no_sim=not sim, noise_weight=noise)
    overrides = {}
    if args.strong:
        overrides.update(expand_thresh=16, max_nodes=65536)
    if args.expand_thresh is not None:
        overrides["expand_thresh"] = args.expand_thresh
    if args.max_nodes is not None:
        overrides["max_nodes"] = args.max_nodes
    if args.leaf_batch is not None and args.leaf_batch > 1:
        # leaf-parallel search is non-kernel only: drop --fast's kernel and eval_every
        overrides.update(leaf_batch=args.leaf_batch, use_kernel=False, eval_every=1)
    return dataclasses.replace(scfg, **overrides)


def main(argv=None):
    args = build_parser().parse_args(argv)

    from bokego_tpu_torch.config import EngineConfig
    from bokego_tpu_torch.device import fp32_only, resolve_device
    from bokego_tpu_torch.gtp.engine import GTPEngine
    from bokego_tpu_torch.search.mcts import net_evaluator

    device = resolve_device(args.device)
    fp32_only()  # the nets serve in full fp32, as every parity check assumes
    scfg = search_config(args, device)
    params = {
        "policy": load_variables(args.p, "policy", device),
        "value": load_variables(args.v, "value", device),
    }
    ecfg = EngineConfig(
        time_lim=None if args.r else args.t,
        n_rollouts=args.r,
        pondering=not args.no_ponder,
        forest_size=args.forest,
    )
    GTPEngine(net_evaluator(has_value=True), params, scfg, ecfg, device=device).start()


if __name__ == "__main__":
    main()
