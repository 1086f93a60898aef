"""Search and engine configuration (copies of ``bokego_tpu.config``'s
``SearchConfig`` and ``EngineConfig``).

Same fields, defaults and validation.  In the port, ``use_kernel`` selects
the fused rollout kernel K1 over the descent and backprop kernels K3/K4
(``ops/rollout.py``; every expansion runs K2 either way) and
``kernel_block`` is kept for parity of the field set only: the CUDA kernel
blocks trees on its own.
"""

from __future__ import annotations

import dataclasses
import os
import warnings


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """PUCT search knobs (reference mcts.py:58-70 defaults)."""

    expand_thresh: int = 100  # visits before a leaf is expanded
    branch_num: int | None = None  # top-k children to expand; None = all legal
    exploration_weight: float = 4.0  # PUCT c
    value_net_weight: float = 0.5  # λ mixing sims and value net
    noise_weight: float = 0.0  # Dirichlet root-noise weight
    dirichlet_alpha: float = 0.1
    no_sim: bool = True  # value-net-only leaf eval
    max_turns: int = 80  # terminal cutoff in search
    max_nodes: int = 1024  # node-pool size per tree
    n_rollouts: int = 400  # rollouts per move
    max_depth: int = 64  # descend depth bound of the non-kernel path
    use_kernel: bool = False  # fused descend/backprop kernel (no_sim only)
    kernel_levels: int = 8  # kernel descend depth bound
    kernel_block: int = 8  # trees per kernel program (TPU blocking)
    eval_every: int = 1  # run leaf eval/expansion on every E-th rollout only;
    # between eval steps an unvalued leaf backs up a neutral 0
    leaf_batch: int = 1  # K leaf-parallel rollouts per step (virtual loss)
    leaf_vloss: float = 1.0  # virtual loss per traversed edge (K>1 only)

    def __post_init__(self):
        if self.leaf_batch > 1:
            if self.eval_every != 1:
                raise ValueError(
                    "leaf_batch > 1 requires eval_every == 1 (leaf-parallel "
                    "search already amortizes evaluation across K descents)"
                )
            if self.use_kernel:
                raise ValueError(
                    "leaf_batch > 1 is non-kernel only (the rollout kernel "
                    "fuses the K=1 cadence); set use_kernel=False"
                )
        if self.use_kernel and self.eval_every == 1:
            # The kernel backprops BEFORE valuation, so even at E=1 a fresh
            # leaf's first visit backs up a neutral value.
            warnings.warn(
                "SearchConfig(use_kernel=True, eval_every=1): the rollout "
                "kernel delays first-visit valuation by one rollout even at "
                "eval_every=1; for exact reference semantics use "
                "use_kernel=False, for throughput use eval_every>=2.",
                stacklevel=2,
            )


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """GTP engine / serving knobs."""

    time_lim: float | None = 10.0  # seconds per move
    n_rollouts: int | None = None  # rollout-count mode instead of timed
    pondering: bool = True  # rollouts while waiting for input
    resign_threshold: float = 0.1  # surrender if winrate < this
    resign_turn: int = 50  # ... after this turn
    komi: float = 5.5
    forest_size: int = 1  # root-parallel trees


# The bench configuration (bench.py, BASELINE.json config 4): the self-play
# main path that chip_smoke.py drives and measure.py profiles, at B=1024.
BENCH_CONFIG = SearchConfig(
    expand_thresh=100, no_sim=True, max_turns=80, max_nodes=512, n_rollouts=400,
    use_kernel=True, kernel_block=64, kernel_levels=6, eval_every=8,
)
BENCH_BATCH = 1024
# Shipped weights in the reference torch key layout (the policy is the
# export of data/weights/policy_17_flax by tools/export_policy_torch.py).
_WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data", "weights")
VALUE_WEIGHTS = os.path.join(_WEIGHTS, "value_r2.pt")
POLICY_WEIGHTS = os.path.join(_WEIGHTS, "policy_17.pt")
# The JAX bench's random-init nets, init_policy(PRNGKey(0)) and
# init_value(PRNGKey(1)), exported by tools/export_policy_torch.py: the nets
# of the bench, mfu_report, measure's self-play split and parallel.scaling.
BENCH_POLICY_WEIGHTS = os.path.join(_WEIGHTS, "jax_init_policy_key0.pt")
BENCH_VALUE_WEIGHTS = os.path.join(_WEIGHTS, "jax_init_value_key1.pt")
