"""K5 ``leaf_tables``: the eval phase's board analysis in one launch.

``leaf_tables(board, ko, turn, last_move)`` turns a batch of positions into
what the search's eval step needs from them: the group labels, liberties
and sizes of ``rules.group_info``, the move tables of ``rules._analyze``,
the successors of ``rules._leaf_analysis`` (their boards and ko points) and
the 27 planes of ``features._planes``, bit for bit.  With
``successors=False`` it writes the planes alone (``features_batch``).  The
CUDA kernel is in ``csrc/leaf.cu``, whose header note gives its design and
bound; it replaces no Pallas kernel (the JAX package's ``group_info`` is a
jitted ``lax.while_loop``) and reads nothing back to the host.

The plain versions are ``env/rules.py`` and ``features.py`` themselves:
``rules.leaf_analysis`` and ``features.features_batch`` take them for CPU
tensors and this wrapper for CUDA tensors (:func:`on_card`).  The wrapper
launches the kernel or raises; it counts its launches through
``utils/metrics.count`` as ``ops.leaf_tables``, once a launch returned
without error.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from bokego_tpu_torch.coords import NN
from bokego_tpu_torch.ops import check_tensor
from bokego_tpu_torch.utils import metrics

_PLANES = 27  # features.NUM_PLANES (features imports this module)
_P = ctypes.c_void_p


class LeafTables(NamedTuple):
    """The kernel's outputs for ``B`` positions; ``None`` where not asked for."""

    labels: torch.Tensor | None  # int64[B, 81]: group's lowest point, 81 at empty points
    libs: torch.Tensor | None  # int64[B, 81]: the group's liberties at each stone
    sizes: torch.Tensor | None  # int64[B, 81]: the group's stones at each stone
    legal: torch.Tensor | None  # bool[B, 82]: index 81 (the pass) always True
    libs_after: torch.Tensor | None  # int64[B, 81], 0 at illegal points
    caps: torch.Tensor | None  # int64[B, 81], 0 at illegal points
    child_board: torch.Tensor | None  # int8[B, 82, 81]: row 81 is the pass
    child_ko: torch.Tensor | None  # int64[B, 82]
    planes: torch.Tensor  # float32[B, 9, 9, 27]


def _lib():
    from bokego_tpu_torch.ops import build

    lib = build.load("leaf")
    if not getattr(lib, "_bokego_typed", False):
        lib.bokego_leaf_tables.argtypes = [_P, _P, _P, _P, ctypes.c_int] + [_P] * 10
        lib.bokego_leaf_tables.restype = ctypes.c_int
        lib._bokego_typed = True
    return lib


def on_card(board: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernel's), False for a CPU tensor (the
    plain version's); any other device raises."""
    if board.device.type == "cuda":
        return True
    if board.device.type == "cpu":
        return False
    raise ValueError(f"board: unsupported device {board.device}")


def leaf_tables(
    board: torch.Tensor,
    ko: torch.Tensor,
    turn: torch.Tensor,
    last_move: torch.Tensor,
    successors: bool = True,
) -> LeafTables:
    """One K5 launch over ``board (B, 81)`` int8 and ``ko``, ``turn``,
    ``last_move (B,)`` int64, all contiguous on one CUDA device.  Every
    output is written with ``successors``, only the planes without."""
    if board.dim() != 2 or board.shape[1] != NN:
        raise ValueError(f"board: shape {tuple(board.shape)}, expected (B, {NN})")
    batch, dev = board.shape[0], board.device
    check_tensor("board", board, torch.int8, (batch, NN), dev)
    for name, x in (("ko", ko), ("turn", turn), ("last_move", last_move)):
        check_tensor(name, x, torch.int64, (batch,), dev)
    if dev.type != "cuda":
        raise ValueError(f"board: on {dev}; the kernel takes CUDA tensors (the plain version: rules, features)")
    if batch >= 2**31:
        raise ValueError(f"batch {batch}: the grid has a CTA a board, at most 2**31 - 1")
    i64 = dict(dtype=torch.int64, device=dev)
    planes = torch.empty((batch, 9, 9, _PLANES), dtype=torch.float32, device=dev)
    if successors:
        labels, libs, sizes, libs_after, caps = (torch.empty((batch, NN), **i64) for _ in range(5))
        legal = torch.empty((batch, NN + 1), dtype=torch.bool, device=dev)
        child_board = torch.empty((batch, NN + 1, NN), dtype=torch.int8, device=dev)
        child_ko = torch.empty((batch, NN + 1), **i64)
        outs = (labels, libs, sizes, legal, libs_after, caps, child_board, child_ko)
    else:
        outs = (None,) * 8
    err = _lib().bokego_leaf_tables(
        board.data_ptr(), ko.data_ptr(), turn.data_ptr(), last_move.data_ptr(), batch,
        *(None if x is None else x.data_ptr() for x in outs), planes.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"leaf_tables kernel launch failed: cudaError {err}")
    metrics.count("ops.leaf_tables")
    return LeafTables(*outs, planes)
