"""The search's four rollout kernels: wrappers, plain versions, launch counts.

K1 serves the kernel path and K2 every expansion, on either path.
``descend_backprop`` (K1) replaces the Pallas kernel
``bokego_tpu/ops/rollout.py::descend_backprop`` (body ``_kernel``) together
with the scan of light search steps the JAX package runs around it:
``rollouts`` consecutive rollouts on every tree, each one fused PUCT descent
for at most ``levels`` levels, the leaf's cached value (NaN -> 0, flagged
unvalued), the in-place backprop of N (and Wv) over every traversed edge and
the root's own stat update.  ``write_rows`` (K2) replaces
``bokego_tpu/ops/rollout.py::write_rows`` (body ``_write_rows_kernel``):
``pstats[b, node[b]] = rows[b]`` where ``mask[b]``, in place.

K3 and K4 serve the non-kernel path (``mcts._descend_batch`` and
``_backprop_batch``: the GTP engine's default search, simulation mode,
leaf-parallel search, AlphaZero self-play) and replace no Pallas kernel.
``descend_path`` (K3) walks every root to a leaf for at most ``levels``
levels and records the path (:class:`PathDescent`), with each leaf's
expansion flag and the batch's any-work flag computed on the device;
``backprop_path`` (K4) adds the visit, the playout reward and the leaf's
value up that path and updates the roots' own stats.  A rollout of that
path is then two launches and one host read (the flag), where the plain
versions make about 25 torch ops and a host read per tree level and three
sorted ``index_put_`` calls.

The CUDA kernels are in ``csrc/rollout.cu``.  What bounds them on the H100
is not bytes but latency: a chain of dependent row loads per tree, a launch
per call and, when every rollout is a launch, the host between them.  K1's
design answers with one launch for all the rollouts up to the next leaf
evaluation (one warp owns a tree and loops, so re-walked rows come from
cache), loads of only the lanes and planes the score needs, and a path kept
in registers; K3/K4 are bound by one dependent row load a level and then
the launch; the source's header note has the details.  Each wrapper takes
its plain PyTorch version only for CPU tensors (the tests); for a CUDA
tensor it launches the kernel or raises.  Each wrapper counts its kernel
launches through ``utils/metrics.count`` as ``ops.<wrapper>`` (K1 also the
rollouts they ran, as ``ops.descend_backprop.rollouts``), once a launch
returned without error; a run of the plain version counts nothing.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from bokego_tpu_torch.coords import NN
from bokego_tpu_torch.ops import check_tensor as _check
from bokego_tpu_torch.search.tree import (
    C_CHILD,
    C_N,
    C_PRIOR,
    C_TERM,
    C_WQ,
    C_WV,
    CH_PAD,
    LANE_PAD,
    take_rows,
)
from bokego_tpu_torch.utils import metrics

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib():
    from bokego_tpu_torch.ops import build

    lib = build.load("rollout")
    if not getattr(lib, "_bokego_typed", False):
        lib.bokego_descend_backprop.argtypes = [
            _P, _P, _P, _P, _P, _I, _I, _I, _I,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, _I, _P,
        ]
        lib.bokego_descend_backprop.restype = _I
        lib.bokego_write_rows.argtypes = [_P, _P, _P, _P, _I, _I, _P]
        lib.bokego_write_rows.restype = _I
        lib.bokego_max_levels.restype = _I
        lib.bokego_descend_path.argtypes = [
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float, _P,
        ]
        lib.bokego_descend_path.restype = _I
        lib.bokego_backprop_path.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
        lib.bokego_backprop_path.restype = _I
        lib._bokego_typed = True
    return lib


def _check_pstats(pstats: torch.Tensor) -> tuple[int, int]:
    if pstats.dim() != 4 or pstats.shape[2:] != (CH_PAD, LANE_PAD):
        raise ValueError(f"pstats: shape {tuple(pstats.shape)}, expected (B, N, 8, 128)")
    _check("pstats", pstats, torch.float32, tuple(pstats.shape), pstats.device)
    if pstats.device.type not in ("cpu", "cuda"):
        raise ValueError(f"pstats: unsupported device {pstats.device}")
    return pstats.shape[0], pstats.shape[1]


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


# ---------------------------------------------------------------------------
# K1: fused descend + backprop


class KernelDescent(NamedTuple):
    """The last rollout of a ``descend_backprop`` call, per tree."""

    leaf: torch.Tensor  # (B,) int64
    leaf_n: torch.Tensor  # (B,) f32 — leaf's edge visit count (pre-increment)
    leaf_val: torch.Tensor  # (B,) f32 — cached leaf value, NaN -> 0
    leaf_unvalued: torch.Tensor  # (B,) f32 — 1.0 where the value was NaN
    depth: torch.Tensor  # (B,) int64
    leaf_terminal: torch.Tensor  # (B,) f32 — C_TERM of the leaf's edge; 0 at depth 0
    root_n: torch.Tensor  # (B,) f32 — the root's own N before that rollout's update


def unpack(res: torch.Tensor) -> KernelDescent:
    """Split the kernel's ``res (B, 128)`` lanes into named fields."""
    return KernelDescent(
        leaf=res[:, 0].long(),
        leaf_n=res[:, 2],
        leaf_val=res[:, 3],
        leaf_unvalued=res[:, 4],
        depth=res[:, 1].long(),
        leaf_terminal=res[:, 5],
        root_n=res[:, 6],
    )


def _rollout_plain(pstats, value, root, root_stats, c, w, use_value, levels) -> torch.Tensor:
    """One rollout on every tree, vectorised over trees, looping over
    ``levels``; returns ``res (B, 128)``."""
    batch = pstats.shape[0]
    dev = pstats.device
    ar = torch.arange(batch, device=dev)
    lane = torch.arange(LANE_PAD, device=dev)
    cur = root
    active = torch.ones(batch, dtype=torch.bool, device=dev)
    depth = torch.zeros(batch, dtype=torch.int64, device=dev)
    leaf_n = torch.zeros(batch, dtype=torch.float32, device=dev)
    leaf_term = torch.zeros(batch, dtype=torch.float32, device=dev)
    node_hist, act_hist = [], []
    for _ in range(levels):
        row = pstats[ar, cur]  # (B, 8, 128)
        kids = row[:, C_CHILD]
        valid = kids >= 0
        nf = row[:, C_N]
        avg = torch.where(
            nf > 0,
            ((1.0 - w) * row[:, C_WQ] + w * row[:, C_WV]) / nf.clamp(min=1.0),
            0.0,
        )
        total = torch.where(valid, nf, 0.0).sum(1).clamp(min=1.0)
        score = -avg + c * row[:, C_PRIOR] * total.sqrt()[:, None] / (1.0 + nf)
        score = torch.where(valid, score, float("-inf"))
        mx = score.max(1).values
        best_a = torch.where(score == mx[:, None], lane, LANE_PAD).min(1).values
        internal = valid.any(1) & active
        node_hist.append(cur)
        act_hist.append(torch.where(internal, best_a, 0))
        cur = torch.where(internal, kids[ar, best_a].long(), cur)
        leaf_n = torch.where(internal, nf[ar, best_a], leaf_n)
        leaf_term = torch.where(internal, row[:, C_TERM][ar, best_a], leaf_term)
        depth = torch.where(internal, depth + 1, depth)
        active = internal

    vsel = value[ar, cur]
    unval = vsel.isnan()
    v = torch.where(unval, 0.0, vsel)
    for i in range(levels):
        upd = i < depth
        node, act = node_hist[i], act_hist[i]
        pstats[ar, node, C_N, act] += torch.where(upd, 1.0, 0.0)
        if use_value:
            sign = torch.where((depth - i - 1) % 2 == 0, 1.0, -1.0)
            pstats[ar, node, C_WV, act] += torch.where(upd, sign * v, 0.0)

    res = torch.zeros((batch, LANE_PAD), dtype=torch.float32, device=dev)
    res[:, 0] = cur.float()
    res[:, 1] = depth.float()
    res[:, 2] = leaf_n
    res[:, 3] = v
    res[:, 4] = unval.float()
    res[:, 5] = leaf_term
    res[:, 6] = root_stats[:, 0]
    # The root's own update, from the root player's side.
    root_sign = torch.where(depth % 2 == 0, 1.0, -1.0)
    zeros = torch.zeros_like(root_sign)
    root_stats += torch.stack(
        [torch.ones_like(root_sign), zeros, root_sign * v if use_value else zeros], dim=-1
    )
    return res


def descend_backprop_plain(
    pstats: torch.Tensor,
    value: torch.Tensor,
    root: torch.Tensor,
    root_stats: torch.Tensor,
    *,
    c: float,
    w: float,
    use_value: bool = True,
    levels: int = 8,
    rollouts: int = 1,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same per-tree algorithm,
    ``rollouts`` times in sequence.  Updates ``pstats`` and ``root_stats`` in
    place and returns the last rollout's ``res (B, 128)``."""
    if rollouts < 1:
        raise ValueError(f"rollouts={rollouts}: at least 1")
    for _ in range(rollouts):
        res = _rollout_plain(pstats, value, root, root_stats, c, w, use_value, levels)
    return res


def descend_backprop(
    pstats: torch.Tensor,
    value: torch.Tensor,
    root: torch.Tensor,
    root_stats: torch.Tensor,
    *,
    c: float,
    w: float,
    use_value: bool = True,
    levels: int = 8,
    rollouts: int = 1,
) -> torch.Tensor:
    """``rollouts`` fused rollouts in sequence on every tree; ``pstats`` and
    ``root_stats f32[B, 3]`` (the root's own N, Wq, Wv) are updated in place.

    Returns ``res f32[B, 128]`` describing the last rollout, with lanes
    ``[leaf, depth, leaf_n, v, unvalued, leaf_terminal, root N before that
    rollout]`` (see :func:`unpack`).  The caller does any leaf evaluation and
    expansion.  ``pstats`` rows keep the child plane at -1 in lanes 81..127.
    """
    batch, n_pool = _check_pstats(pstats)
    _check("value", value, torch.float32, (batch, n_pool), pstats.device)
    _check("root", root, torch.int64, (batch,), pstats.device)
    _check("root_stats", root_stats, torch.float32, (batch, 3), pstats.device)
    if pstats.device.type == "cpu":
        return descend_backprop_plain(
            pstats, value, root, root_stats,
            c=c, w=w, use_value=use_value, levels=levels, rollouts=rollouts,
        )
    if rollouts < 1:
        raise ValueError(f"rollouts={rollouts}: at least 1")
    lib = _lib()
    if not 0 <= levels <= lib.bokego_max_levels():
        raise ValueError(f"levels={levels} outside [0, {lib.bokego_max_levels()}]")
    res = torch.empty((batch, LANE_PAD), dtype=torch.float32, device=pstats.device)
    stream = torch.cuda.current_stream(pstats.device).cuda_stream
    err = lib.bokego_descend_backprop(
        pstats.data_ptr(), value.data_ptr(), root.data_ptr(), root_stats.data_ptr(),
        res.data_ptr(), batch, n_pool, levels, rollouts, c, w, 1.0 - w, int(use_value), stream,
    )
    _raise_on(err, "descend_backprop")
    metrics.count("ops.descend_backprop")
    metrics.count("ops.descend_backprop.rollouts", rollouts)
    return res


# ---------------------------------------------------------------------------
# K2: in-place parent-row write


def write_rows_plain(
    pstats: torch.Tensor, node: torch.Tensor, rows: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version: ``pstats[b, node[b]] = rows[b]`` where mask."""
    ar = torch.arange(pstats.shape[0], device=pstats.device)
    old = pstats[ar, node]
    pstats[ar, node] = torch.where(mask[:, None, None], rows, old)
    return pstats


def write_rows(
    pstats: torch.Tensor, node: torch.Tensor, rows: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """``pstats[b, node[b]] = rows[b]`` where ``mask[b]``, in place; returns
    ``pstats``."""
    batch, n_pool = _check_pstats(pstats)
    _check("rows", rows, torch.float32, (batch, CH_PAD, LANE_PAD), pstats.device)
    _check("mask", mask, torch.bool, (batch,), pstats.device)
    _check("node", node, torch.int64, (batch,), pstats.device)
    if pstats.device.type == "cpu":
        return write_rows_plain(pstats, node, rows, mask)
    lib = _lib()
    stream = torch.cuda.current_stream(pstats.device).cuda_stream
    err = lib.bokego_write_rows(
        pstats.data_ptr(), node.data_ptr(), rows.data_ptr(), mask.data_ptr(),
        batch, n_pool, stream,
    )
    _raise_on(err, "write_rows")
    metrics.count("ops.write_rows")
    return pstats


# ---------------------------------------------------------------------------
# K3 / K4: the non-kernel search's descent and backprop


class PathDescent(NamedTuple):
    """A recorded PUCT walk per tree; level ``i`` holds the edge taken from
    the node at depth ``i``.  Columns past a tree's depth hold the leaf and
    action 0 (the plain version ends its loop once every tree has stopped,
    so its ``L`` may be smaller than ``levels``).  ``need`` and ``work``
    are left ``None`` by callers that stack descents (``search/leafpar``)."""

    leaf: torch.Tensor  # (B,) int64 leaf node
    rows: torch.Tensor  # (B, L) int64 parent node of each traversed edge
    acts: torch.Tensor  # (B, L) int64 action of each traversed edge
    leaf_n: torch.Tensor  # (B,) f32 the leaf's edge visit count (before this rollout)
    depth: torch.Tensor  # (B,) int64 number of traversed edges
    need: torch.Tensor | None = None  # (B,) bool: expand the leaf
    work: torch.Tensor | None = None  # () bool: some leaf needs expanding or has no value


_flag_workspace: dict[torch.device, torch.Tensor] = {}


def _flag_ws(device: torch.device) -> torch.Tensor:
    """K3's two-int workspace for the batch's any-work flag on ``device``
    (the OR and a CTA ticket): zeroed once here, and left zeroed by every
    launch, so launches on one stream at a time share it."""
    ws = _flag_workspace.get(device)
    if ws is None:
        ws = _flag_workspace[device] = torch.zeros(2, dtype=torch.int32, device=device)
    return ws


def descend_path_plain(
    pstats, value, terminal, expanded, root, root_stats, *, c: float, w: float, levels: int,
    expand_thresh: float,
) -> PathDescent:
    """Plain PyTorch version of K3: every tree in lockstep, one row gather
    per level, finished trees idle, and the loop ends (one host read per
    level) once every tree has stopped or ``levels`` levels ran.  Exact
    score ties go to the lowest action, as ``argmax`` gives them.  ``need``
    is the search's expansion rule: the leaf's visits (the root's own at
    depth 0) above ``expand_thresh``, not terminal, not expanded; ``work``
    is ``need`` or an unvalued leaf in any tree."""
    batch = root.shape[0]
    dev = root.device
    cur = root
    done = torch.zeros(batch, dtype=torch.bool, device=dev)
    leaf_n = torch.zeros(batch, dtype=torch.float32, device=dev)
    depth = torch.zeros(batch, dtype=torch.int64, device=dev)
    rows, acts = [], []
    for _ in range(levels):
        row = take_rows(pstats, cur)  # (B, 8, 128)
        kids = row[:, C_CHILD, :NN]
        valid = kids >= 0
        # terminal nodes never have children, so "has any child" alone
        # decides whether a node is internal
        internal = valid.any(1) & ~done
        nf = row[:, C_N, :NN]
        avg = torch.where(
            nf > 0,
            ((1.0 - w) * row[:, C_WQ, :NN] + w * row[:, C_WV, :NN]) / nf.clamp(min=1.0),
            0.0,
        )
        total = torch.where(valid, nf, 0.0).sum(1).clamp(min=1.0)
        score = -avg + c * row[:, C_PRIOR, :NN] * total.sqrt()[:, None] / (1.0 + nf)
        score = torch.where(valid, score, float("-inf"))
        best_a = score.argmax(1)
        best = kids.gather(1, best_a[:, None])[:, 0].long()
        rows.append(cur)
        acts.append(torch.where(internal, best_a, 0))
        leaf_n = torch.where(internal, nf.gather(1, best_a[:, None])[:, 0], leaf_n)
        depth = torch.where(internal, depth + 1, depth)
        cur = torch.where(internal, best, cur)
        done = done | ~internal
        with metrics.span("sync.descend_level"):
            finished = bool(done.all())
        if finished:
            break
    leaf_visits = torch.where(depth > 0, leaf_n, root_stats[:, 0])
    need = (leaf_visits > expand_thresh) & ~take_rows(terminal, cur) & ~take_rows(expanded, cur)
    work = need.any() | take_rows(value, cur).isnan().any()
    return PathDescent(
        leaf=cur, rows=torch.stack(rows, 1), acts=torch.stack(acts, 1), leaf_n=leaf_n, depth=depth,
        need=need, work=work,
    )


def descend_path(
    pstats: torch.Tensor,
    value: torch.Tensor,
    terminal: torch.Tensor,
    expanded: torch.Tensor,
    root: torch.Tensor,
    root_stats: torch.Tensor,
    *,
    c: float,
    w: float,
    levels: int,
    expand_thresh: float,
) -> PathDescent:
    """One PUCT walk per tree from ``root`` to a leaf, at most ``levels``
    levels, reading ``pstats`` only: the recorded path, each leaf's ``need``
    and the batch's ``work`` flag (see :func:`descend_path_plain`), all on
    the tensors' device.  On a CUDA tensor one launch of K3, with ``rows``
    and ``acts`` ``levels`` wide."""
    batch, n_pool = _check_pstats(pstats)
    dev = pstats.device
    _check("value", value, torch.float32, (batch, n_pool), dev)
    _check("terminal", terminal, torch.bool, (batch, n_pool), dev)
    _check("expanded", expanded, torch.bool, (batch, n_pool), dev)
    _check("root", root, torch.int64, (batch,), dev)
    _check("root_stats", root_stats, torch.float32, (batch, 3), dev)
    if levels < 1:
        raise ValueError(f"levels={levels}: at least 1")
    if dev.type == "cpu":
        return descend_path_plain(
            pstats, value, terminal, expanded, root, root_stats,
            c=c, w=w, levels=levels, expand_thresh=expand_thresh,
        )
    lib = _lib()
    i64 = dict(dtype=torch.int64, device=dev)
    leaf, depth = torch.empty(batch, **i64), torch.empty(batch, **i64)
    rows, acts = torch.empty((batch, levels), **i64), torch.empty((batch, levels), **i64)
    leaf_n = torch.empty(batch, dtype=torch.float32, device=dev)
    need = torch.empty(batch, dtype=torch.bool, device=dev)
    work = torch.empty((), dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.bokego_descend_path(
        pstats.data_ptr(), value.data_ptr(), terminal.data_ptr(), expanded.data_ptr(),
        root.data_ptr(), root_stats.data_ptr(), leaf.data_ptr(), rows.data_ptr(), acts.data_ptr(),
        leaf_n.data_ptr(), depth.data_ptr(), need.data_ptr(), _flag_ws(dev).data_ptr(),
        work.data_ptr(), batch, n_pool, levels, c, w, 1.0 - w, float(expand_thresh), stream,
    )
    _raise_on(err, "descend_path")
    metrics.count("ops.descend_path")
    return PathDescent(leaf=leaf, rows=rows, acts=acts, leaf_n=leaf_n, depth=depth, need=need, work=work)


def backprop_path_plain(pstats, value, root_stats, leaf, rows, acts, depth, sim_reward, use_value) -> None:
    """Plain PyTorch version of K4: one ``index_put_(accumulate=True)`` per
    stat plane.  The edges of one path are distinct, so each takes exactly
    one add; unused levels add 0."""
    batch, levels = rows.shape
    dev = rows.device
    # NaN = not evaluated yet (possible only at eval_every > 1): backs up 0
    leaf_val = torch.nan_to_num(take_rows(value, leaf))
    lvl = torch.arange(levels, device=dev)[None, :]
    used = lvl < depth[:, None]
    # the edge at level i leads to the node at depth i + 1: sign (-1)^(depth-i-1)
    sign = torch.where((depth[:, None] - lvl - 1) % 2 == 0, 1.0, -1.0)
    b_idx = torch.arange(batch, device=dev)[:, None].expand(batch, levels)
    plane = torch.zeros_like(rows)
    root_sign = torch.where(depth % 2 == 0, 1.0, -1.0)
    pstats.index_put_((b_idx, rows, plane + C_N, acts), used.float(), accumulate=True)
    root_stats[:, 0] += 1.0
    # root_stats' columns (N, Wq, Wv) are numbered like the stat planes
    for use, amount, ch in ((sim_reward is not None, sim_reward, C_WQ), (use_value, leaf_val, C_WV)):
        if use:
            pstats.index_put_(
                (b_idx, rows, plane + ch, acts),
                torch.where(used, sign * amount[:, None], 0.0),
                accumulate=True,
            )
            root_stats[:, ch] += root_sign * amount


def backprop_path(
    pstats: torch.Tensor,
    value: torch.Tensor,
    root_stats: torch.Tensor,
    desc: PathDescent,
    sim_reward: torch.Tensor | None,
    use_value: bool,
) -> None:
    """Add the visit, the playout's reward (``sim_reward (B,)`` from the
    leaf mover's side, into Wq; ``None`` without simulations) and, with
    ``use_value``, the leaf's cached value (NaN -> 0, into Wv) up every
    path of ``desc``, the sign flipping per ply, and update the roots' own
    ``root_stats`` (N, Wq, Wv); all in place.  On a CUDA tensor one launch
    of K4."""
    batch, n_pool = _check_pstats(pstats)
    dev = pstats.device
    levels = desc.rows.shape[-1]
    _check("value", value, torch.float32, (batch, n_pool), dev)
    _check("root_stats", root_stats, torch.float32, (batch, 3), dev)
    _check("leaf", desc.leaf, torch.int64, (batch,), dev)
    _check("depth", desc.depth, torch.int64, (batch,), dev)
    _check("rows", desc.rows, torch.int64, (batch, levels), dev)
    _check("acts", desc.acts, torch.int64, (batch, levels), dev)
    if sim_reward is not None:
        _check("sim_reward", sim_reward, torch.float32, (batch,), dev)
    if dev.type == "cpu":
        return backprop_path_plain(
            pstats, value, root_stats, desc.leaf, desc.rows, desc.acts, desc.depth, sim_reward, use_value
        )
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.bokego_backprop_path(
        pstats.data_ptr(), value.data_ptr(), root_stats.data_ptr(), desc.leaf.data_ptr(),
        desc.rows.data_ptr(), desc.acts.data_ptr(), desc.depth.data_ptr(),
        None if sim_reward is None else sim_reward.data_ptr(), int(use_value), batch, n_pool, levels,
        stream,
    )
    _raise_on(err, "backprop_path")
    metrics.count("ops.backprop_path")
