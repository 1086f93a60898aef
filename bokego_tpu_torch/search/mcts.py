"""Batched PUCT Monte-Carlo tree search (counterpart of
``bokego_tpu/search/mcts.py``).

Two rollout paths, chosen by ``SearchConfig.use_kernel``.  Both expand
leaves the same way (:func:`_expand_batch`): ``tree.expand_core`` creates
the children and ``ops/rollout.write_rows`` lands the parent rows, one
launch of K2 on the card and its plain version on the CPU.

The non-kernel path (the serving default): a PUCT walk from every root to a
leaf (:func:`_descend_batch`, which also decides which leaves to expand and
whether any tree has work), then the leaf evaluation with one batched net
forward and the expansion, then the backprop of the leaf's value up the
recorded path (:func:`_backprop_batch`): the exact reference cadence at
``eval_every == 1``; at ``eval_every > 1`` the backprop comes first and
evaluation runs only on every E-th step, as on the kernel path.  On the card
the walk and the backprop are one launch each (``ops/rollout``'s K3
``descend_path`` and K4 ``backprop_path``), and the host reads the device
once a rollout, the work flag, on eval steps; on the CPU they are the plain
torch versions, all trees in lockstep with a host read per tree level.

On the kernel path rollouts run through the fused descend/backprop kernel
(``ops/rollout.descend_backprop``), which also applies the root's own stat
update; on eval steps the leaves are evaluated with one batched net forward
and expanded.  The order is the JAX kernel path's delayed valuation:
backprop with the leaf's current cached value first, then eval/expand
(``SearchConfig.eval_every``).

A step that is not an eval step is the kernel and nothing else (the JAX
package's ``lax.cond(any_work, …)`` is false there and every write is
dropped), and the JAX package runs the steps in a ``lax.scan`` under
``jit``.  Here ``run_search`` groups the steps so that every group ends on
an eval step and gives each group to one kernel launch: at ``eval_every=8``
a launch runs eight rollouts per tree back to back on the device, with no
host work between them.  ``search_step`` is a group of one.  The eval phase
is decided on the host: only on eval steps is the any-work flag
synchronised, and ``_expand_batch`` runs only when that flag is true; the
JAX package calls them on every rollout with an all-false mask when there
is no work, which writes nothing, so the results are the same.

Simulation mode (``no_sim=False``) plays every leaf out to the end of the
game with the policy on every step (:func:`_simulate`) and backs the
Tromp-Taylor reward up the Wq plane beside the value net's Wv; PUCT mixes
the two by ``value_net_weight``.  The rollout kernel is a ``no_sim`` kernel,
so with ``use_kernel=True`` and ``no_sim=False`` the search takes the
non-kernel path, as in the JAX package (the CLI's ``--simulate`` sets
``use_kernel=False``).  The playouts draw from the ``torch.Generator``
passed as ``gen``; without simulations ``gen`` is not read.  Leaf-parallel
search (``leaf_batch > 1``) is :mod:`bokego_tpu_torch.search.leafpar`.

Serving helpers: Dirichlet root noise (a draw and a pure mixing function),
:func:`advance_root` / :func:`expand_roots` for subtree reuse between moves,
:func:`pv_walk` and :func:`root_winrate`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from bokego_tpu_torch.config import SearchConfig
from bokego_tpu_torch.coords import NN, PASS_ACTION
from bokego_tpu_torch.env import rules
from bokego_tpu_torch.env.state import GoState
from bokego_tpu_torch.features import features_batch
from bokego_tpu_torch.models import inference
from bokego_tpu_torch.ops import rollout
from bokego_tpu_torch.search import playout as po
from bokego_tpu_torch.search import tree as tr
from bokego_tpu_torch.search.tree import Tree, empty_tree, expand_core, gather_states, take_rows
from bokego_tpu_torch.utils import metrics


class Evaluator(NamedTuple):
    """Leaf evaluation callbacks.

    ``evaluate(params, states) -> (probs (B, 81), values (B,) | None)``;
    ``evaluate_fts(params, fts)`` does the same from precomputed features,
    letting eval steps share one group analysis between the features and
    the successors (``rules.leaf_analysis``); ``policy_probs(params, states)
    -> (B, 81)`` is the policy alone, which simulation mode's playouts need
    (without it ``no_sim=False`` raises).
    """

    evaluate: Callable
    has_value: bool
    evaluate_fts: Callable | None = None
    policy_probs: Callable | None = None


def net_evaluator(has_value: bool = True, dtype: torch.dtype | None = None) -> Evaluator:
    """Evaluator over the nets; ``params = {"policy": PolicyNet, "value":
    ValueNet}`` (modules on the search's device, in eval mode).

    ``dtype=torch.bfloat16`` is the JAX evaluator's bf16 route: the
    parameters rounded to bf16 on each call (or stored in bf16 once) and
    the features cast to bf16, so the stem convolution runs in bf16 and the
    rest in float32 on rounded weights (``models/nets.py``); probabilities
    and values come back as float32.  The default computes in float32."""

    def evaluate_fts(params, fts):
        probs = inference.policy_probs(params["policy"], fts, dtype)
        vals = inference.value_fn(params["value"], fts, dtype) if has_value else None
        return probs, vals

    def evaluate(params, states):
        return evaluate_fts(params, features_batch(states))

    def policy_probs(params, states):
        return inference.policy_probs(params["policy"], features_batch(states), dtype)

    return Evaluator(
        evaluate=evaluate, has_value=has_value, evaluate_fts=evaluate_fts, policy_probs=policy_probs
    )


def pv_evaluator() -> Evaluator:
    """Evaluator over one joint policy-value net; ``params = {"pv":
    ResNetPV}`` (``models/resnet.py``, on the search's device, in eval mode;
    its ``inference()`` copy for serving).  Every callback runs the one
    forward of ``inference.policy_value``."""

    def evaluate_fts(params, fts):
        return inference.policy_value(params["pv"], fts)

    def evaluate(params, states):
        return evaluate_fts(params, features_batch(states))

    def policy_probs(params, states):
        return evaluate(params, states)[0]

    return Evaluator(
        evaluate=evaluate, has_value=True, evaluate_fts=evaluate_fts, policy_probs=policy_probs
    )


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
    """Batched expansion: the children through ``expand_core``, the parent
    rows in place through ``rollout.write_rows``."""
    with metrics.span("search.expand"):
        trees, rows, did = expand_core(
            trees, nodes, probs, need, cfg.branch_num, cfg.max_turns, precomputed
        )
        rollout.write_rows(trees.pstats, nodes, rows, did)
        return trees


def dirichlet_noise(gen: torch.Generator, batch: int, alpha: float, device) -> torch.Tensor:
    """``(batch, 81)`` draws of Dirichlet(alpha, ..., alpha): gamma draws
    from ``gen`` (on ``device``), normalised.  Drawn in float64, where a
    gamma of small ``alpha`` does not underflow to an all-zero row."""
    conc = torch.full((batch, NN), alpha, dtype=torch.float64, device=device)
    g = torch._standard_gamma(conc, generator=gen)
    return (g / g.sum(-1, keepdim=True).clamp(min=1e-300)).float()


def mix_noise(probs: torch.Tensor, noise: torch.Tensor, weight: float) -> torch.Tensor:
    """Root priors with noise mixed in: ``(1 - weight) * probs + weight * noise``."""
    return (1.0 - weight) * probs + weight * noise


def init_trees(
    root_states: GoState,
    ev: Evaluator,
    params,
    cfg: SearchConfig,
    gen: torch.Generator | None = None,
    noise: torch.Tensor | None = None,
) -> Tree:
    """Build a batch of trees and expand and value their roots.  With
    ``cfg.noise_weight > 0`` the root priors are mixed with ``noise (B, 81)``,
    drawn from ``gen`` when it is not given."""
    with metrics.span("search.init_trees"):
        trees = empty_tree(root_states, cfg.max_nodes, cfg.max_turns)
        probs, vals = _with_values(*ev.evaluate(params, root_states))
        if cfg.noise_weight > 0:
            if noise is None:
                if gen is None:
                    raise ValueError("noise_weight > 0 needs a torch.Generator (or the noise itself)")
                noise = dirichlet_noise(gen, probs.shape[0], cfg.dirichlet_alpha, probs.device)
            probs = mix_noise(probs, noise, cfg.noise_weight)
        need = torch.ones_like(trees.root, dtype=torch.bool)
        trees = _expand_batch(trees, trees.root, probs, need, cfg)
        return tr.set_leaf_value(trees, trees.root, vals)


def launch_rollouts(trees: Tree, ev: Evaluator, cfg: SearchConfig, rollouts: int) -> torch.Tensor:
    """``rollouts`` consecutive rollouts on every tree in one kernel launch
    (tree stats and root stats updated in place, no device sync); returns the
    kernel's ``res`` for the last of them."""
    has_value = ev.has_value
    with metrics.span("search.k1"):
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
    with metrics.span("search.eval"):
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
        with metrics.span("sync.any_work"):
            work = bool(need.any() | (kd.leaf_unvalued > 0).any())
        if not work:
            return trees
        return _eval_and_expand(trees, ev, params, cfg, leaves, need)


def _rollout_group(
    trees: Tree, ev: Evaluator, params, cfg: SearchConfig, rollouts: int, evaluate: bool
) -> Tree:
    res = launch_rollouts(trees, ev, cfg, rollouts)
    return evaluate_leaves(trees, ev, params, cfg, res) if evaluate else trees


# A recorded PUCT walk per tree, with its leaves' expansion flags and the
# batch's any-work flag (``ops/rollout.PathDescent``).
_Descent = rollout.PathDescent


def _descend_batch(trees: Tree, cfg: SearchConfig, w: float) -> _Descent:
    """PUCT walk from every root to a leaf, at most ``max_depth - 1``
    levels, with each leaf's ``need`` (visits above ``expand_thresh``, not
    terminal, not expanded) and the batch's ``work`` flag (``need`` or an
    unvalued leaf anywhere): one launch of K3 (``rollout.descend_path``) on
    the card, on the CPU its plain version, all trees in lockstep with one
    host read per level.  Exact score ties go to the lowest action."""
    with metrics.span("search.descend"):
        return rollout.descend_path(
            trees.pstats, trees.value, trees.terminal, trees.expanded, trees.root, trees.root_stats,
            c=cfg.exploration_weight, w=w, levels=cfg.max_depth - 1, expand_thresh=cfg.expand_thresh,
        )


def _backprop_batch(
    trees: Tree, desc: _Descent, sim_reward: torch.Tensor | None, use_value: bool
) -> Tree:
    """Add the visit, the playout's reward (``sim_reward (B,)`` from the
    leaf mover's side; ``None`` without simulations) and the leaf's cached
    value up every recorded path, the sign flipping per ply, and update the
    roots' own stats (in place): one launch of K4 (``rollout.backprop_path``)
    on the card, on the CPU one ``index_put_(accumulate=True)`` per stat
    plane."""
    with metrics.span("search.backprop"):
        rollout.backprop_path(trees.pstats, trees.value, trees.root_stats, desc, sim_reward, use_value)
        return trees


def _eval_and_expand(trees: Tree, ev: Evaluator, params, cfg: SearchConfig, leaves, need) -> Tree:
    """Value the leaves with one net forward and expand those in ``need``."""
    with metrics.span("search.eval_and_expand"):
        leaf_states = gather_states(trees.nodes, leaves)
        if ev.evaluate_fts is not None:
            la = rules.leaf_analysis(leaf_states)
            probs, vals = _with_values(*ev.evaluate_fts(params, la.planes))
            pre = (la.children, la.legal)
        else:
            probs, vals = _with_values(*ev.evaluate(params, leaf_states))
            pre = rules.child_states(leaf_states, with_hash=False)
        trees = _expand_batch(trees, leaves, probs, need, cfg, precomputed=pre)
        return tr.set_leaf_value(trees, leaves, vals)


def _simulate(
    gen: torch.Generator, leaf_states: GoState, ev: Evaluator, params, cfg: SearchConfig
) -> torch.Tensor:
    """Policy playout of every leaf to the end of the game (no own-eye
    fills); (B,) Tromp-Taylor reward from the side of the player to move at
    the leaf."""
    if ev.policy_probs is None:
        raise ValueError("simulation mode (no_sim=False) needs an Evaluator with policy_probs")
    if gen is None:
        raise ValueError("simulation mode (no_sim=False) needs a torch.Generator (gen=)")

    def probs_fn(states):
        return ev.policy_probs(params, states)

    final = po.playout_final(
        gen, probs_fn, probs_fn, leaf_states, max_turns=cfg.max_turns, avoid_eyes=True
    )
    r_black = po.rewards(final)
    return torch.where(leaf_states.turn % 2 == 0, r_black, -r_black)


def _search_step_plain(
    trees: Tree, ev: Evaluator, params, cfg: SearchConfig, step_idx: int, gen: torch.Generator | None
) -> Tree:
    """One rollout on every tree without the kernels.  In simulation mode
    every leaf is played out on every step, whether or not the step
    evaluates."""
    desc = _descend_batch(trees, cfg, _mix_weight(cfg, ev.has_value))
    leaves, need = desc.leaf, desc.need
    work = False
    if _is_eval_step(cfg, step_idx):
        with metrics.span("sync.work_flag"):
            work = bool(desc.work)
    sim_r = None if cfg.no_sim else _simulate(gen, gather_states(trees.nodes, leaves), ev, params, cfg)
    if cfg.eval_every > 1:
        # delayed valuation, as on the kernel path: backprop with the value
        # cached so far, then evaluate and expand
        trees = _backprop_batch(trees, desc, sim_r, ev.has_value)
        return _eval_and_expand(trees, ev, params, cfg, leaves, need) if work else trees
    # the exact reference ordering: evaluate the leaf, then backprop it
    if work:
        trees = _eval_and_expand(trees, ev, params, cfg, leaves, need)
    return _backprop_batch(trees, desc, sim_r, ev.has_value)


def _is_eval_step(cfg: SearchConfig, step_idx: int) -> bool:
    return cfg.eval_every <= 1 or step_idx % cfg.eval_every == 0


def _kernel_path(cfg: SearchConfig) -> bool:
    """The rollout kernel serves ``no_sim`` searches only."""
    return cfg.use_kernel and cfg.no_sim


def search_step(
    trees: Tree, ev: Evaluator, params, cfg: SearchConfig, step_idx: int = 0,
    gen: torch.Generator | None = None,
) -> Tree:
    """One synchronised rollout across every tree (in place).  ``gen`` draws
    the playouts of simulation mode and is not read otherwise."""
    if not _kernel_path(cfg):
        return _search_step_plain(trees, ev, params, cfg, step_idx, gen)
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


def run_search(
    trees: Tree, ev: Evaluator, params, cfg: SearchConfig, n_rollouts: int,
    gen: torch.Generator | None = None,
) -> Tree:
    """``n_rollouts`` synchronised rollouts (steps ``0..n_rollouts-1``); on
    the kernel path one kernel launch per run of steps up to and including
    the next eval step.  ``gen`` as in :func:`search_step`."""
    metrics.count("search.rollouts", n_rollouts)
    if not _kernel_path(cfg):
        for i in range(n_rollouts):
            trees = _search_step_plain(trees, ev, params, cfg, i, gen)
        return trees
    for length, evaluate in rollout_groups(n_rollouts, cfg.eval_every):
        trees = _rollout_group(trees, ev, params, cfg, length, evaluate)
    return trees


def search(
    root_states: GoState,
    ev: Evaluator,
    params,
    cfg: SearchConfig,
    n_rollouts: int | None = None,
    gen: torch.Generator | None = None,
) -> tuple[torch.Tensor, Tree]:
    """Fresh-tree search: init, rollouts, choose.  Returns (actions, trees);
    actions use the device encoding (81 = pass).  ``gen`` draws the root
    noise when ``cfg.noise_weight > 0`` and the playouts in simulation mode."""
    n = cfg.n_rollouts if n_rollouts is None else n_rollouts
    with metrics.span("search", request=metrics.NEXT):
        trees = init_trees(root_states, ev, params, cfg, gen=gen)
        trees = run_search(trees, ev, params, cfg, n, gen=gen)
        return choose_action(trees), trees


# ---------------------------------------------------------------------------
# Serving helpers: tree reuse between moves, analysis.


def root_winrate(trees: Tree, w: float) -> torch.Tensor:
    """(B,) root winrate in [0, 1] from each root's own (N, Wq, Wv); 0 where
    a root has no visits."""
    n, q, v = trees.root_stats.unbind(-1)
    mixed = ((1.0 - w) * q + w * v) / n.clamp(min=1.0)
    return torch.where(n > 0, (mixed + 1.0) / 2.0, 0.0)


def add_root_noise(trees: Tree, noise: torch.Tensor, weight: float) -> Tree:
    """Mix ``noise (B, 81)`` (see :func:`dirichlet_noise`) into every root's
    stored priors, in place.

    Child rows store clean priors (expansion writes the raw probabilities;
    only a root's row is ever noised), so after :func:`advance_root` the new
    root's row is clean and noising it again gives set-root-time noise."""
    ar = torch.arange(trees.root.shape[0], device=trees.root.device)
    prior = trees.pstats[ar, trees.root, tr.C_PRIOR, :NN]
    trees.pstats[ar, trees.root, tr.C_PRIOR, :NN] = mix_noise(prior, noise, weight)
    return trees


def pv_walk(trees: Tree, root_actions: torch.Tensor, depth: int = 8, index: int = 0) -> torch.Tensor:
    """Principal variations below ``root_actions (k,)`` at the root of tree
    ``index``, on the device: follow the most-visited child ``depth`` plies.
    Returns int64[k, depth] actions, -1 once a line runs out."""
    pstats = trees.pstats[index]
    root_row = pstats[trees.root[index]]
    cur = root_row[tr.C_CHILD].gather(0, root_actions.long()).long()  # (k,)
    out = []
    for _ in range(depth):
        crow = pstats[cur.clamp(min=0)]  # (k, 8, 128)
        valid = crow[:, tr.C_CHILD, :NN] >= 0
        cn = torch.where(valid, crow[:, tr.C_N, :NN], -1.0)
        nxt_a = cn.argmax(1)
        has = (cur >= 0) & valid.any(1) & (cn.gather(1, nxt_a[:, None])[:, 0] > 0)
        child = crow[:, tr.C_CHILD, :NN].gather(1, nxt_a[:, None])[:, 0].long()
        cur = torch.where(has, child, -1)
        out.append(torch.where(has, nxt_a, -1))
    return torch.stack(out, 1)


def advance_root(trees: Tree, actions: torch.Tensor) -> tuple[Tree, torch.Tensor]:
    """Re-root each tree at its child for ``actions (B,)``.  Returns
    ``(trees, ok)``, the new ``Tree`` sharing the pools of the old: ``ok`` is
    False where no such child exists (a terminal root, an unexpanded action
    or a pass); such a tree keeps its root and the caller must rebuild.  Off-path nodes stay allocated until
    :func:`bokego_tpu_torch.search.tree.compact` relabels the kept subtree."""
    row = take_rows(trees.pstats, trees.root)  # (B, 8, 128)
    a = actions.clamp(0, NN - 1)[:, None]
    child = row[:, tr.C_CHILD, :NN].gather(1, a)[:, 0]
    ok = (child >= 0) & (actions >= 0) & (actions < NN)
    # the new root's own stats come from its edge entry at the old root
    new_rs = torch.cat([row[:, ch, :NN].gather(1, a) for ch in (tr.C_N, tr.C_WQ, tr.C_WV)], dim=1)
    trees = dataclasses.replace(
        trees,
        root=torch.where(ok, child.long(), trees.root),
        root_stats=torch.where(ok[:, None], new_rs, trees.root_stats),
    )
    return trees, ok


def expand_roots(trees: Tree, ev: Evaluator, params, cfg: SearchConfig) -> Tree:
    """Make sure every root is expanded and valued: used after
    :func:`advance_root` lands on a child that was still a leaf."""
    root_states = gather_states(trees.nodes, trees.root)
    probs, vals = _with_values(*ev.evaluate(params, root_states))
    need = ~take_rows(trees.expanded, trees.root)
    trees = _expand_batch(trees, trees.root, probs, need, cfg)
    return tr.set_leaf_value(trees, trees.root, vals)
