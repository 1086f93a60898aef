"""The search's two rollout kernels: wrappers, plain versions, launch counts.

``descend_backprop`` replaces the Pallas kernel
``bokego_tpu/ops/rollout.py::descend_backprop`` (body ``_kernel``) together
with the scan of light search steps the JAX package runs around it:
``rollouts`` consecutive rollouts on every tree, each one fused PUCT descent
for at most ``levels`` levels, the leaf's cached value (NaN -> 0, flagged
unvalued), the in-place backprop of N (and Wv) over every traversed edge and
the root's own stat update.  ``write_rows`` replaces
``bokego_tpu/ops/rollout.py::write_rows`` (body ``_write_rows_kernel``):
``pstats[b, node[b]] = rows[b]`` where ``mask[b]``, in place.

The CUDA kernels are in ``csrc/rollout.cu``.  What bounds K1 on the H100 is
not bytes but latency: a chain of dependent row loads per tree, a launch per
call and, when every rollout is a launch, the host between them.  Its design
answers with one launch for all the rollouts up to the next leaf evaluation
(one warp owns a tree and loops, so re-walked rows come from cache), loads
of only the lanes and planes the score needs, and a path kept in registers;
the source's header note has the details.  Each wrapper takes its plain
PyTorch version only for CPU tensors (the tests); for a CUDA tensor it
launches the kernel or raises.  ``launches`` counts kernel launches and
``kernel_rollouts`` the rollouts those launches of K1 ran.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from bokego_tpu_torch.search.tree import (
    C_CHILD,
    C_N,
    C_PRIOR,
    C_TERM,
    C_WQ,
    C_WV,
    CH_PAD,
    LANE_PAD,
)

launches = {"descend_backprop": 0, "write_rows": 0}
kernel_rollouts = 0  # rollouts run by descend_backprop's kernel launches

_P, _I = ctypes.c_void_p, ctypes.c_int


def reset_launches() -> None:
    global kernel_rollouts
    for k in launches:
        launches[k] = 0
    kernel_rollouts = 0


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
        lib._bokego_typed = True
    return lib


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple, device) -> None:
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


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
    global kernel_rollouts
    launches["descend_backprop"] += 1
    kernel_rollouts += rollouts
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
    launches["write_rows"] += 1
    return pstats
