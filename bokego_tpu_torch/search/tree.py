"""Batched array search trees: preallocated node pools on the device.

Counterpart of ``bokego_tpu/search/tree.py``.  A :class:`Tree` holds B trees
of ``max_nodes`` slots each; every per-edge statistic lives in per-parent
rows ``pstats f32[B, Nmax, 8, 128]`` (channel planes x lane-padded actions),
the same layout as the JAX package, so tree state compares array for array
and the rollout kernels read one contiguous 4 KB row per level.

Unlike the JAX package, the search's functions update the tree's tensors
in place (torch tensors are mutable): a B=1024, Nmax=512 ``pstats`` is
2 GiB, and a copy per expansion would double the memory and the traffic.
Only :func:`compact`, a permutation of the whole pool, returns new tensors.
"""

from __future__ import annotations

import dataclasses

import torch

from bokego_tpu_torch.coords import NN
from bokego_tpu_torch.env import rules
from bokego_tpu_torch.env.state import GoState
from bokego_tpu_torch.utils import metrics

# pstats channel planes; lanes >= 81 and planes >= 6 are padding, and the
# child plane pads with -1 so "no child" masking covers them.
C_N, C_WQ, C_WV, C_PRIOR, C_CHILD = 0, 1, 2, 3, 4
C_TERM = 5  # child-terminal flags
NUM_CH = 6
CH_PAD = 8
LANE_PAD = 128
NO_CHILD = -1.0


@dataclasses.dataclass
class Tree:
    """B fixed-capacity search trees (leading batch dim on every field)."""

    nodes: GoState  # (B, Nmax, ...) position at each node
    parent: torch.Tensor  # int64[B, Nmax]
    action: torch.Tensor  # int64[B, Nmax] move that led here
    pstats: torch.Tensor  # f32[B, Nmax, 8, 128]
    root_stats: torch.Tensor  # f32[B, 3] root's own (N, Wq, Wv)
    value: torch.Tensor  # f32[B, Nmax] cached leaf value; NaN = unknown
    expanded: torch.Tensor  # bool[B, Nmax]
    terminal: torch.Tensor  # bool[B, Nmax]
    n_nodes: torch.Tensor  # int64[B] allocation pointer
    root: torch.Tensor  # int64[B] current root index

    @property
    def capacity(self) -> int:
        return self.parent.shape[-1]


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, ...) at (B,) indices -> (B, ...)."""
    return x[torch.arange(x.shape[0], device=x.device), idx]


def gather_states(nodes: GoState, idx: torch.Tensor) -> GoState:
    """Node states (B, Nmax, ...) at (B,) indices -> (B, ...)."""
    return nodes.map(lambda x: take_rows(x, idx))


def empty_tree(root_states: GoState, max_nodes: int, max_turns: int) -> Tree:
    """Fresh pools with each root at slot 0 (children not yet expanded)."""
    batch = root_states.board.shape[0]
    dev = root_states.board.device

    def pool(x):
        out = x.new_zeros((batch, max_nodes) + x.shape[1:])
        out[:, 0] = x
        return out

    pstats = torch.zeros((batch, max_nodes, CH_PAD, LANE_PAD), dtype=torch.float32, device=dev)
    pstats[:, :, C_CHILD, :] = NO_CHILD
    terminal = torch.zeros((batch, max_nodes), dtype=torch.bool, device=dev)
    terminal[:, 0] = rules.is_terminal(root_states, max_turns)
    i64 = dict(dtype=torch.int64, device=dev)
    return Tree(
        nodes=root_states.map(pool),
        parent=torch.full((batch, max_nodes), -1, **i64),
        action=torch.full((batch, max_nodes), -1, **i64),
        pstats=pstats,
        root_stats=torch.zeros((batch, 3), dtype=torch.float32, device=dev),
        value=torch.full((batch, max_nodes), float("nan"), dtype=torch.float32, device=dev),
        expanded=torch.zeros((batch, max_nodes), dtype=torch.bool, device=dev),
        terminal=terminal,
        n_nodes=torch.ones((batch,), **i64),
        root=torch.zeros((batch,), **i64),
    )


def expand_core(
    tree: Tree,
    node: torch.Tensor,
    probs: torch.Tensor,
    need: torch.Tensor,
    branch_num: int | None,
    max_turns: int,
    precomputed: tuple[GoState, torch.Tensor] | None = None,
) -> tuple[Tree, torch.Tensor, torch.Tensor]:
    """Create the children of ``node[b]`` for every legal point move, in
    place, except the parent-row write: returns ``(tree, new_row, did)``, and
    the search lands ``new_row`` where ``did`` through
    ``ops/rollout.write_rows``.

    PASS is never a tree edge; ``branch_num`` keeps only the top-k priors
    (lowest index on ties).  No-op for a tree where ``need`` is False, the
    node is terminal, or the pool lacks room.
    """
    batch = node.shape[0]
    dev = node.device
    if precomputed is None:
        csts, legal = rules.child_states(gather_states(tree.nodes, node), with_hash=False)
    else:
        csts, legal = precomputed
    mask = legal[:, :NN]
    if branch_num is not None and 0 <= branch_num < NN:
        order = torch.argsort(-probs, dim=1, stable=True)
        topk = torch.zeros_like(mask).scatter_(1, order[:, :branch_num], True)
        mask = mask & topk
    count = mask.sum(1)
    room = tree.n_nodes + count <= tree.capacity
    need = need & ~take_rows(tree.terminal, node)
    write = mask & (need & room)[:, None]
    rank = torch.cumsum(write.long(), dim=1) - 1
    slots = tree.n_nodes[:, None] + rank  # meaningful where write

    with metrics.span("sync.expand_nonzero"):
        b_idx, a_idx = write.nonzero(as_tuple=True)
    s_idx = slots[b_idx, a_idx]
    for pool, child in zip(tree.nodes.tensors(), csts.tensors()):
        pool[b_idx, s_idx] = child[b_idx, a_idx]
    child_terminal = rules.is_terminal(csts.map(lambda x: x[:, :NN]), max_turns)
    tree.parent[b_idx, s_idx] = node[b_idx]
    tree.action[b_idx, s_idx] = a_idx
    tree.terminal[b_idx, s_idx] = child_terminal[b_idx, a_idx]

    did = need & room
    ar = torch.arange(batch, device=dev)
    tree.expanded[ar, node] |= did
    tree.n_nodes += torch.where(did, count, 0)

    new_row = torch.zeros((batch, CH_PAD, LANE_PAD), dtype=torch.float32, device=dev)
    new_row[:, C_CHILD] = NO_CHILD
    new_row[:, C_PRIOR, :NN] = probs
    new_row[:, C_CHILD, :NN] = torch.where(write, slots.float(), NO_CHILD)
    new_row[:, C_TERM, :NN] = child_terminal.float()
    return tree, new_row, did


def reachable_from_root(tree: Tree) -> torch.Tensor:
    """bool[B, Nmax]: the nodes in each current root's subtree.

    Pointer doubling over the parent array: give the root a self-loop, then
    square the ancestor map log2(Nmax) times; chains through the root
    saturate at the root, all others (old ancestors, off-path subtrees,
    unallocated slots) at -1.
    """
    n = tree.capacity
    idx = torch.arange(n, device=tree.parent.device)
    root = tree.root[:, None]
    p = torch.where(idx == root, idx, tree.parent)
    for _ in range(max(1, (n - 1).bit_length())):
        p = torch.where(p >= 0, p.gather(1, p.clamp(min=0)), -1)
    return p == root


def compact(tree: Tree) -> Tree:
    """Move each current root's subtree to the head of its pool, freeing
    every off-path slot for reuse; returns new tensors.

    One permutation per tree relabels the kept subtree into slots ``[0, k)``
    in their old relative order (a stable sort: children allocate after
    their parent, so the root lands at slot 0) and resets the rest to pool
    defaults (stats 0, child -1, value NaN).  Tree structure and every
    per-edge statistic are unchanged, only slot numbers move, so a search
    continued after compaction chooses exactly as one continued without it.
    """
    batch, n = tree.parent.shape
    dev = tree.parent.device
    idx = torch.arange(n, device=dev)
    ar = torch.arange(batch, device=dev)[:, None]
    keep = reachable_from_root(tree)
    order = torch.argsort((~keep).to(torch.uint8), dim=1, stable=True)
    new_of_old = torch.empty_like(order).scatter_(1, order, idx.expand(batch, n))
    k = keep.sum(1)
    fresh = idx >= k[:, None]

    def take(x):
        return x[ar, order]

    def relabel(x):
        return torch.where(x >= 0, new_of_old.gather(1, x.clamp(min=0)), -1)

    pstats = take(tree.pstats)
    child = pstats[:, :, C_CHILD, :]
    flat = relabel(child.long().reshape(batch, -1)).reshape(child.shape)
    pstats[:, :, C_CHILD, :] = flat.float()
    pstats.masked_fill_(fresh[:, :, None, None], 0.0)
    pstats[:, :, C_CHILD].masked_fill_(fresh[:, :, None], NO_CHILD)
    return Tree(
        nodes=tree.nodes.map(take),
        parent=torch.where(fresh, -1, relabel(take(tree.parent))),
        action=torch.where(fresh, -1, take(tree.action)),
        pstats=pstats,
        root_stats=tree.root_stats,
        value=torch.where(fresh, float("nan"), take(tree.value)),
        expanded=take(tree.expanded) & ~fresh,
        terminal=take(tree.terminal) & ~fresh,
        n_nodes=k,
        root=new_of_old.gather(1, tree.root[:, None])[:, 0],
    )


def set_leaf_value(tree: Tree, node: torch.Tensor, val: torch.Tensor) -> Tree:
    """Cache ``val[b]`` at ``node[b]`` where no value is cached yet."""
    cur = tree.value.gather(1, node[:, None])
    tree.value.scatter_(1, node[:, None], torch.where(cur.isnan(), val[:, None], cur))
    return tree
