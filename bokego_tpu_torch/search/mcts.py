"""Batched PUCT Monte-Carlo tree search, kernel path (counterpart of
``bokego_tpu/search/mcts.py``).

Rollouts run through the fused descend/backprop kernel
(``ops/rollout.descend_backprop``), which also applies the root's own stat
update; on eval steps the leaves are evaluated with one batched net forward
and expanded, the parent rows landing through the ``write_rows`` kernel.
The order is the JAX kernel path's delayed valuation: backprop with the
leaf's current cached value first, then eval/expand
(``SearchConfig.eval_every``).

A step that is not an eval step is the kernel and nothing else (the JAX
package's ``lax.cond(any_work, …)`` is false there and every write is
dropped), and the JAX package runs the steps in a ``lax.scan`` under
``jit``.  Here ``run_search`` groups the steps so that every group ends on
an eval step and gives each group to one kernel launch: at ``eval_every=8``
a launch runs eight rollouts per tree back to back on the device, with no
host work between them.  ``search_step`` is a group of one.  The eval phase
is decided on the host: only on eval steps is the any-work flag
synchronised, and ``_expand_batch`` with its ``write_rows`` launch runs only
when that flag is true; the JAX package calls them on every rollout with an
all-false mask when there is no work, which writes nothing, so the results
are the same.

Not in this slice (they raise ``NotImplementedError``): the non-kernel
search path (``use_kernel=False``), simulation mode (``no_sim=False``) and
Dirichlet root noise.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from bokego_tpu_torch.config import SearchConfig
from bokego_tpu_torch.coords import NN, PASS_ACTION
from bokego_tpu_torch.env import rules
from bokego_tpu_torch.env.state import GoState
from bokego_tpu_torch.features import features_batch, features_from_tables
from bokego_tpu_torch.models import inference
from bokego_tpu_torch.ops import rollout
from bokego_tpu_torch.search import tree as tr
from bokego_tpu_torch.search.tree import Tree, empty_tree, expand_core, gather_states


class Evaluator(NamedTuple):
    """Leaf evaluation callbacks.

    ``evaluate(params, states) -> (probs (B, 81), values (B,) | None)``;
    ``evaluate_fts(params, fts)`` does the same from precomputed features,
    letting eval steps share one group analysis between the features and
    the successors (``rules.leaf_analysis``).
    """

    evaluate: Callable
    has_value: bool
    evaluate_fts: Callable | None = None


def net_evaluator(has_value: bool = True) -> Evaluator:
    """Evaluator over the nets; ``params = {"policy": PolicyNet, "value":
    ValueNet}`` (modules on the search's device, in eval mode)."""

    def evaluate_fts(params, fts):
        probs = inference.policy_probs(params["policy"], fts)
        vals = inference.value_fn(params["value"], fts) if has_value else None
        return probs, vals

    def evaluate(params, states):
        return evaluate_fts(params, features_batch(states))

    return Evaluator(evaluate=evaluate, has_value=has_value, evaluate_fts=evaluate_fts)


def _mix_weight(cfg: SearchConfig, has_value: bool) -> float:
    """λ: 1.0 in no_sim mode, 0.0 without a value net, else the config's."""
    if cfg.no_sim:
        return 1.0
    if not has_value:
        return 0.0
    return cfg.value_net_weight


def _with_values(probs: torch.Tensor, vals: torch.Tensor | None):
    """Zero values for an evaluator without a value net."""
    if vals is None:
        vals = torch.zeros(probs.shape[0], dtype=torch.float32, device=probs.device)
    return probs, vals


def choose_action(trees: Tree) -> torch.Tensor:
    """Most-visited root child's action per tree (lowest index on ties);
    PASS where the root has no children."""
    row = tr.take_rows(trees.pstats, trees.root)  # (B, 8, 128)
    valid = row[:, tr.C_CHILD, :NN] >= 0
    n = torch.where(valid, row[:, tr.C_N, :NN], -1.0)
    best = n.argmax(1)
    return torch.where(valid.any(1), best, PASS_ACTION)


def _expand_batch(trees: Tree, nodes, probs, need, cfg: SearchConfig, precomputed=None) -> Tree:
    """Batched expansion; the parent rows land in place through the
    ``write_rows`` kernel."""
    trees, rows, did = expand_core(
        trees, nodes, probs, need, cfg.branch_num, cfg.max_turns, precomputed
    )
    rollout.write_rows(trees.pstats, nodes, rows, did)
    return trees


def init_trees(root_states: GoState, ev: Evaluator, params, cfg: SearchConfig) -> Tree:
    """Build a batch of trees and expand and value their roots."""
    if cfg.noise_weight > 0:
        raise NotImplementedError("Dirichlet root noise is not ported yet")
    trees = empty_tree(root_states, cfg.max_nodes, cfg.max_turns)
    probs, vals = _with_values(*ev.evaluate(params, root_states))
    need = torch.ones_like(trees.root, dtype=torch.bool)
    trees = _expand_batch(trees, trees.root, probs, need, cfg)
    return tr.set_leaf_value(trees, trees.root, vals)


def launch_rollouts(trees: Tree, ev: Evaluator, cfg: SearchConfig, rollouts: int) -> torch.Tensor:
    """``rollouts`` consecutive rollouts on every tree in one kernel launch
    (tree stats and root stats updated in place, no device sync); returns the
    kernel's ``res`` for the last of them."""
    has_value = ev.has_value
    return rollout.descend_backprop(
        trees.pstats,
        trees.value,
        trees.root,
        trees.root_stats,
        c=cfg.exploration_weight,
        w=_mix_weight(cfg, has_value),
        use_value=has_value,
        levels=cfg.kernel_levels,
        rollouts=rollouts,
    )


def evaluate_leaves(trees: Tree, ev: Evaluator, params, cfg: SearchConfig, res: torch.Tensor) -> Tree:
    """The eval phase of an eval step: value and expand the leaves that the
    rollout described by ``res`` reached, where any tree has work."""
    kd = rollout.unpack(res)
    leaves = kd.leaf
    leaf_visits = torch.where(kd.depth > 0, kd.leaf_n, kd.root_n)
    # A depth-0 leaf is an unexpanded root: the self-play loop checks root
    # terminality, so only deeper leaves read the C_TERM flag.
    leaf_terminal = (kd.depth > 0) & (kd.leaf_terminal > 0)
    # ~expanded also guards the kernel's level bound: a descent that runs out
    # of levels stops at an internal node, which must not be re-expanded.
    need = (
        (leaf_visits > cfg.expand_thresh)
        & ~leaf_terminal
        & ~tr.take_rows(trees.expanded, leaves)
    )
    if not bool(need.any() | (kd.leaf_unvalued > 0).any()):
        return trees

    leaf_states = gather_states(trees.nodes, leaves)
    if ev.evaluate_fts is not None:
        la = rules.leaf_analysis(leaf_states)
        probs, vals = _with_values(*ev.evaluate_fts(params, features_from_tables(leaf_states, la.mt)))
        pre = (la.children, la.legal)
    else:
        probs, vals = _with_values(*ev.evaluate(params, leaf_states))
        pre = rules.child_states(leaf_states)
    trees = _expand_batch(trees, leaves, probs, need, cfg, precomputed=pre)
    return tr.set_leaf_value(trees, leaves, vals)


def _rollout_group(
    trees: Tree, ev: Evaluator, params, cfg: SearchConfig, rollouts: int, evaluate: bool
) -> Tree:
    res = launch_rollouts(trees, ev, cfg, rollouts)
    return evaluate_leaves(trees, ev, params, cfg, res) if evaluate else trees


def _check_ported(cfg: SearchConfig) -> None:
    if not (cfg.use_kernel and cfg.no_sim):
        raise NotImplementedError(
            "only the kernel path (use_kernel=True, no_sim=True) is ported yet"
        )


def _is_eval_step(cfg: SearchConfig, step_idx: int) -> bool:
    return cfg.eval_every <= 1 or step_idx % cfg.eval_every == 0


def search_step(trees: Tree, ev: Evaluator, params, cfg: SearchConfig, step_idx: int = 0) -> Tree:
    """One synchronised rollout across every tree (in place)."""
    _check_ported(cfg)
    return _rollout_group(trees, ev, params, cfg, 1, _is_eval_step(cfg, step_idx))


def rollout_groups(n_rollouts: int, eval_every: int) -> list[tuple[int, bool]]:
    """Steps ``0..n_rollouts-1`` cut into runs that each end on an eval step
    (``step % eval_every == 0``; every step when ``eval_every <= 1``), as
    ``(length, True)``, and the steps after the last eval step as
    ``(length, False)``."""
    groups, start = [], 0
    for stop in range(0, n_rollouts, max(eval_every, 1)):
        groups.append((stop - start + 1, True))
        start = stop + 1
    if start < n_rollouts:
        groups.append((n_rollouts - start, False))
    return groups


def run_search(trees: Tree, ev: Evaluator, params, cfg: SearchConfig, n_rollouts: int) -> Tree:
    """``n_rollouts`` synchronised rollouts, one kernel launch per run of
    steps up to and including the next eval step."""
    _check_ported(cfg)
    for length, evaluate in rollout_groups(n_rollouts, cfg.eval_every):
        trees = _rollout_group(trees, ev, params, cfg, length, evaluate)
    return trees


def search(
    root_states: GoState,
    ev: Evaluator,
    params,
    cfg: SearchConfig,
    n_rollouts: int | None = None,
) -> tuple[torch.Tensor, Tree]:
    """Fresh-tree search: init, rollouts, choose.  Returns (actions, trees);
    actions use the device encoding (81 = pass)."""
    n = cfg.n_rollouts if n_rollouts is None else n_rollouts
    trees = init_trees(root_states, ev, params, cfg)
    trees = run_search(trees, ev, params, cfg, n)
    return choose_action(trees), trees
