"""Leaf-parallel PUCT search: K rollouts per step with virtual loss
(counterpart of ``bokego_tpu/search/leafpar.py``).

One served tree is bound by its chain of dependent steps: every rollout of
``mcts.search_step`` is a descent, a net forward at batch 1 and a backprop.
Leaf-parallel search batches the forward:

  select    K PUCT descents, each leaving a virtual loss on its path so that
            the next descent goes elsewhere instead of onto the same leaf,
  evaluate  ONE policy/value forward over all K leaves of every tree,
  expand    the leaves past ``expand_thresh``, sub-batch by sub-batch (slot
            allocation is a running counter, and the ``expanded`` flag keeps
            a leaf reached twice from being expanded twice),
  backprop  one add per traversed edge and stat plane that removes the
            virtual loss and applies the real (reward, value) update with
            the per-ply sign flips, path by path.

The virtual loss pretends the rollout already lost: every traversed edge
gets ``N += vl, Wq += vl, Wv += vl`` at selection time.  Stats are stored
from the child's side (PUCT selects by ``-avg + U``), so adding to W marks
the child as winning, which the parent avoids, and the extra visits shrink
the U term.  With ``vl = 1`` a later descent of the same step reads exactly
the visit counts it would have seen had the earlier rollouts completed, so
``expand_thresh`` means what it means in the sequential search; the
backprop nets every virtual term out (N gets ``1 - vl + vl = 1``).

``K = 1`` (which forces ``vl = 0``) is the sequential search, bit for bit.
``K > 1`` is the usual approximation: descents of one step do not see each
other's evaluations, so two of them may reach the same unexpanded leaf and
both back up its one value.

Shapes are (K leaves, B trees): a forest of 8 at ``leaf_batch=16`` evaluates
128 positions a step.  Non-kernel path only (the rollout kernel fuses the
K=1 cadence); ``eval_every`` must be 1.  Trees are updated in place, so a
virtual loss is visible to the next descent at once.
"""

from __future__ import annotations

import functools

import torch

from bokego_tpu_torch.config import SearchConfig
from bokego_tpu_torch.env import rules
from bokego_tpu_torch.env.state import GoState
from bokego_tpu_torch.search import tree as tr
from bokego_tpu_torch.search.mcts import (
    Evaluator,
    _Descent,
    _descend_batch,
    _expand_batch,
    _mix_weight,
    _simulate,
    _with_values,
)
from bokego_tpu_torch.search.tree import Tree

_STAT_PLANES = (tr.C_N, tr.C_WQ, tr.C_WV)


def _stack_descents(descs: list[_Descent]) -> _Descent:
    """K descents as one ``_Descent`` with a leading K dimension.  The
    descent loop ends early, so the K records differ in their number of
    levels: ``rows`` and ``acts`` are padded with 0 to the deepest (``depth``
    says which levels a path used)."""
    levels = max(d.rows.shape[1] for d in descs)

    def padded(x):
        return torch.nn.functional.pad(x, (0, levels - x.shape[1]))

    return _Descent(
        leaf=torch.stack([d.leaf for d in descs]),
        rows=torch.stack([padded(d.rows) for d in descs]),
        acts=torch.stack([padded(d.acts) for d in descs]),
        leaf_n=torch.stack([d.leaf_n for d in descs]),
        depth=torch.stack([d.depth for d in descs]),
    )


def _take_k(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N) at (K, B) indices -> (K, B)."""
    return x.gather(1, idx.T).T


def _edge_offsets(pstats: torch.Tensor, descs: _Descent) -> torch.Tensor:
    """int64 (K, 3, B, L): where N, Wq and Wv of the edge that path k of tree
    b traversed at level i lie in ``pstats.view(-1)``.  Unused levels point
    at an edge of slot 0, where they will add 0."""
    batch, n_pool, n_ch, n_lane = pstats.shape
    dev = descs.rows.device
    b_idx = torch.arange(batch, device=dev)[:, None]
    edge = ((b_idx * n_pool + descs.rows) * n_ch) * n_lane + descs.acts  # plane 0 of each edge
    return torch.stack([edge + plane * n_lane for plane in _STAT_PLANES], dim=1)


def _accumulate(pstats: torch.Tensor, offsets: torch.Tensor, updates: torch.Tensor) -> None:
    """``pstats.view(-1)[offsets] += updates`` (both (K, 3, B, L)), path by
    path: one ``index_add_`` for each k = 0..K-1.  The edges of one path are
    distinct, so within a call every edge takes one term (and some slot-0
    edge the zeros of the unused levels), and an edge that several paths
    share takes their terms in the order of k: on the CPU and on the GPU
    alike, and as the JAX package's scatter-add does on the CPU.  One
    accumulate over all K paths would leave that order to the library
    (``index_put_(accumulate=True)`` on CUDA sums duplicates as a tree), and
    the last place of Wv with it."""
    flat = pstats.view(-1)
    for k in range(offsets.shape[0]):
        flat.index_add_(0, offsets[k].reshape(-1), updates[k].reshape(-1))


def _used_levels(descs: _Descent) -> torch.Tensor:
    """bool (K, B, L): the levels at which a path traversed an edge."""
    lvl = torch.arange(descs.rows.shape[-1], device=descs.rows.device)
    return lvl < descs.depth[..., None]


def _apply_vloss(trees: Tree, desc: _Descent, vl: float) -> Tree:
    """Add the virtual loss along one descent's path, in place: N, Wq and Wv
    of every traversed edge ``+= vl``.  The root's own ``root_stats`` never
    feed selection (``_descend_batch`` reads edge rows only), so they take
    none."""
    one = _Descent(*(x[None] for x in desc))
    amount = torch.where(_used_levels(one), vl, 0.0)  # (1, B, L)
    _accumulate(trees.pstats, _edge_offsets(trees.pstats, one), amount[:, None].expand(-1, 3, -1, -1))
    return trees


def _backprop_k(
    trees: Tree,
    descs: _Descent,  # stacked to (K, B, ...)
    sim_r: torch.Tensor | None,  # (K, B) playout rewards; None without simulations
    vl: float,
    use_value: bool,
) -> Tree:
    """Backprop of K paths, in place: every traversed edge loses its
    selection-time virtual loss and takes the real update (sign flipping per
    ply) in one add per plane, edges shared by several paths adding up path
    by path; the roots' own N grows by K."""
    n_k, _, levels = descs.rows.shape
    leaf_val = torch.nan_to_num(_take_k(trees.value, descs.leaf))  # (K, B)
    used = _used_levels(descs)
    lvl = torch.arange(levels, device=used.device)
    # the edge at level i leads to the node at depth i + 1: sign (-1)^(depth-i-1)
    sign = torch.where((descs.depth[..., None] - lvl - 1) % 2 == 0, 1.0, -1.0)
    root_sign = torch.where(descs.depth % 2 == 0, 1.0, -1.0)  # (K, B)

    def real(amount):  # (K, B) per path -> (K, B, L) per edge
        return sign * amount[..., None] if amount is not None else torch.zeros_like(sign)

    wq = sim_r
    wv = leaf_val if use_value else None
    updates = torch.stack([torch.full_like(sign, 1.0 - vl), real(wq) - vl, real(wv) - vl], dim=1)
    _accumulate(trees.pstats, _edge_offsets(trees.pstats, descs), torch.where(used[:, None], updates, 0.0))
    trees.root_stats[:, 0] += float(n_k)
    for col, amount in ((1, wq), (2, wv)):
        if amount is not None:
            # path by path too: a library sum may pair the terms differently
            trees.root_stats[:, col] += functools.reduce(torch.add, (root_sign * amount).unbind(0))
    return trees


def _select_k(trees: Tree, cfg: SearchConfig, w: float, K: int, vl: float) -> _Descent:
    """K descents, each leaving its virtual loss (in place) for the next to
    see; the records stacked to (K, B, ...)."""
    singles = []
    for _ in range(K):
        d = _descend_batch(trees, cfg, w)
        if vl:
            _apply_vloss(trees, d, vl)
        singles.append(d)
    return _stack_descents(singles)


def _flat_leaf_states(trees: Tree, leaves: torch.Tensor) -> GoState:
    """The states at ``leaves (K, B)`` as one batch of K*B (k-major)."""
    b_idx = torch.arange(leaves.shape[1], device=leaves.device).expand_as(leaves)
    return trees.nodes.map(lambda x: x[b_idx, leaves].flatten(0, 1))


def _eval_and_expand_k(
    trees: Tree, ev: Evaluator, params, cfg: SearchConfig, leaves, flat_states: GoState, can_expand, need_k
) -> Tree:
    """Value all K*B leaves with one net forward, expand sub-batch by
    sub-batch those in ``need_k`` (a flag per sub-batch), and cache the
    values where none is cached yet.  ``can_expand (K, B)`` holds what does
    not change while the step expands: enough visits and not terminal."""
    n_k, batch = leaves.shape
    if ev.evaluate_fts is not None:
        # one group analysis over all K*B leaves serves the features and the
        # successors that every expansion writes
        la = rules.leaf_analysis(flat_states)
        probs, vals = _with_values(*ev.evaluate_fts(params, la.planes))
        children, legal = la.children, la.legal
    else:
        probs, vals = _with_values(*ev.evaluate(params, flat_states))
        children, legal = rules.child_states(flat_states, with_hash=False)
    probs = probs.unflatten(0, (n_k, batch))
    vals = vals.unflatten(0, (n_k, batch))
    children = children.map(lambda x: x.unflatten(0, (n_k, batch)))
    legal = legal.unflatten(0, (n_k, batch))
    for k in range(n_k):
        if not need_k[k]:
            continue
        # ``expanded`` is read from the tree as it is now, so a leaf that an
        # earlier sub-batch expanded is skipped
        need_now = can_expand[k] & ~tr.take_rows(trees.expanded, leaves[k])
        pre = (children.map(lambda x: x[k]), legal[k])
        trees = _expand_batch(trees, leaves[k], probs[k], need_now, cfg, precomputed=pre)
    # a leaf reached twice carries the same value twice
    cur = trees.value.gather(1, leaves.T)
    trees.value.scatter_(1, leaves.T, torch.where(cur.isnan(), vals.T, cur))
    return trees


def search_step_k(
    trees: Tree,
    ev: Evaluator,
    params,
    cfg: SearchConfig,
    K: int,
    vl: float = 1.0,
    gen: torch.Generator | None = None,
) -> Tree:
    """K leaf-parallel rollouts on every tree (one step, in place).

    Like K calls of ``mcts.search_step``, except that the K descents share
    one evaluation round.  The roots' visit counts grow by exactly K, so
    rollout budgets count as before.  ``gen`` draws the playouts of
    simulation mode and is not read otherwise.
    """
    if cfg.eval_every != 1:
        raise ValueError("leaf-parallel search requires eval_every == 1")
    if K == 1:
        vl = 0.0  # the exact sequential arithmetic
    has_value = ev.has_value
    descs = _select_k(trees, cfg, _mix_weight(cfg, has_value), K, vl)

    leaves = descs.leaf  # (K, B)
    # leaf_n was read after the virtual losses of the earlier descents, so at
    # vl=1 it counts them as visits, like the sequential search would; the
    # root (depth 0) takes no virtual loss and reads its own stats
    leaf_visits = torch.where(descs.depth > 0, descs.leaf_n, trees.root_stats[None, :, 0])
    can_expand = (leaf_visits > cfg.expand_thresh) & ~_take_k(trees.terminal, leaves)
    need = can_expand & ~_take_k(trees.expanded, leaves)
    unvalued = _take_k(trees.value, leaves).isnan()
    # one read for the host: which sub-batches may expand (a sub-batch with
    # no candidate now has none later in the step), whether a leaf lacks a value
    *need_k, any_unvalued = torch.cat([need.any(1), unvalued.any()[None]]).tolist()
    work = any(need_k) or any_unvalued

    # simulation mode plays out every leaf on every step; without it the
    # states are gathered only when some leaf has work
    flat_states = _flat_leaf_states(trees, leaves) if work or not cfg.no_sim else None
    if work:
        trees = _eval_and_expand_k(trees, ev, params, cfg, leaves, flat_states, can_expand, need_k)
    sim_r = None
    if not cfg.no_sim:
        sim_r = _simulate(gen, flat_states, ev, params, cfg).unflatten(0, leaves.shape)
    return _backprop_k(trees, descs, sim_r, vl, has_value)


def run_search_k(
    trees: Tree,
    ev: Evaluator,
    params,
    cfg: SearchConfig,
    n_rollouts: int,
    K: int,
    vl: float = 1.0,
    gen: torch.Generator | None = None,
) -> Tree:
    """``n_rollouts`` leaf-parallel rollouts as ``ceil(n_rollouts / K)`` steps
    of K: a count that K does not divide rounds up to the next step."""
    for _ in range(-(-n_rollouts // K)):
        trees = search_step_k(trees, ev, params, cfg, K, vl, gen=gen)
    return trees
