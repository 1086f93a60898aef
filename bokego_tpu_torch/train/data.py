"""Training data: npz/csv loading, feature precomputation, D4 augmentation
(counterpart of ``bokego_tpu/train/data.py``).

Formats (reference-compatible, shared with the JAX package):
* ``.npz`` with ``features`` (n, 27, 9, 9) NCHW float and ``moves`` (or
  ``targets``) or ``vals`` (n, 1); loaded into NHWC like the nets' inputs.
* ``.csv`` with positional columns (board, ko, last, move|val): board is the
  81-char ``.XO`` string; the side to move is the opponent of the stone at
  ``last``.
* ``.pshard.npz`` packed shards: raw positions (board uint8, ko, last, turn,
  targets, is_value) whose feature planes are computed on the device per
  minibatch.  Shards written by either package load in the other.

Batch order and augmentation draws come from the caller's
``np.random.Generator``, in the JAX package's order, so the same seed gives
the same batches in both packages.  The D4 group acts on planes, boards and
move indices alike: ``k = rot + 4 * refl``, first the transpose, then ``rot``
quarter turns counterclockwise.
"""

from __future__ import annotations

import csv
import dataclasses
import glob
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch

from bokego_tpu_torch.coords import N, NN, PASS_ACTION
from bokego_tpu_torch.device import resolve_device
from bokego_tpu_torch.env.state import DEFAULT_KOMI, GoState
from bokego_tpu_torch.features import features_batch


def d4_apply_planes(fts: np.ndarray, k: int) -> np.ndarray:
    """Apply symmetry k (0..7) to NHWC planes (..., 9, 9, C)."""
    out = fts
    if k >= 4:
        out = np.swapaxes(out, -3, -2)
    return np.rot90(out, k % 4, axes=(-3, -2))


def d4_apply_moves(moves: np.ndarray, k: int) -> np.ndarray:
    """Apply the same symmetry to squashed move indices (negatives fixed)."""
    moves = np.asarray(moves)
    x, y = moves // N, moves % N
    if k >= 4:
        x, y = y, x
    for _ in range(k % 4):
        # a counterclockwise quarter turn on (row, col): (x, y) -> (N-1-y, x)
        x, y = N - 1 - y, x
    return np.where(moves < 0, moves, N * x + y)


def d4_apply_boards(boards: np.ndarray, k: int) -> np.ndarray:
    """Apply symmetry k to raw boards (..., 81)."""
    b = boards.reshape(boards.shape[:-1] + (N, N))
    if k >= 4:
        b = np.swapaxes(b, -2, -1)
    b = np.rot90(b, k % 4, axes=(-2, -1))
    return np.ascontiguousarray(b).reshape(boards.shape)


def d4_board_string(board_str: str, k: int) -> str:
    """Apply symmetry k to an 81-char ``'.XO'`` board string."""
    arr = np.frombuffer(board_str.encode(), dtype=np.uint8)
    return d4_apply_boards(arr, k).tobytes().decode()


def augment_batch(fts, targets, k, is_move_target: bool):
    f = d4_apply_planes(fts, k)
    t = d4_apply_moves(targets, k) if is_move_target else targets
    return f, t


@dataclasses.dataclass
class GoDataset:
    """In-memory dataset of (features NHWC, targets), both numpy."""

    features: np.ndarray  # (n, 9, 9, 27) float32
    targets: np.ndarray  # (n,) int32 moves or float32 values
    is_value: bool

    def __len__(self):
        return self.features.shape[0]

    def batches(
        self, batch_size: int, rng: np.random.Generator, augment: bool = True, device=None, rows: slice | None = None
    ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Shuffled epoch of minibatches with random D4 augmentation (numpy:
        ``device`` is accepted for the packed datasets' interface).  With
        ``rows``, only those rows of each minibatch (a data-parallel rank's),
        drawn from ``rng`` as the whole minibatch is."""
        del device
        idx = rng.permutation(len(self))
        for i in range(0, len(self) - batch_size + 1, batch_size):
            sel = idx[i : i + batch_size][rows or slice(None)]
            f, t = self.features[sel], self.targets[sel]
            if augment:
                k = int(rng.integers(8))
                f, t = augment_batch(f, t, k, not self.is_value)
            yield f, t


def load_npz(path: str) -> GoDataset:
    """The reference npz layout (NCHW features)."""
    z = np.load(path)
    fts = np.moveaxis(z["features"].astype(np.float32), 1, -1)
    if "vals" in z.files:
        return GoDataset(fts, z["vals"].reshape(-1).astype(np.float32), True)
    key = "moves" if "moves" in z.files else "targets"
    return GoDataset(fts, z[key].reshape(-1).astype(np.int32), False)


def save_npz(path: str, dataset: GoDataset):
    """Write the reference-compatible compressed npz (NCHW)."""
    payload = {"features": np.moveaxis(dataset.features, -1, 1)}
    payload["vals" if dataset.is_value else "moves"] = dataset.targets.reshape(-1, 1)
    np.savez_compressed(path, **payload)


_BOARD_LUT = np.zeros(256, np.uint8)
_BOARD_LUT[ord("X")] = 1
_BOARD_LUT[ord("O")] = 2


_BOARD_CHARS = np.array([".", "X", "O"])


def _encode_boards(board_strs: list[str]) -> np.ndarray:
    """81-char '.XO' strings -> uint8 (n, 81)."""
    raw = np.frombuffer("".join(board_strs).encode(), np.uint8)
    return _BOARD_LUT[raw.reshape(-1, NN)]


def board_strings(boards: np.ndarray) -> list[str]:
    """(n, 81) boards (0 empty, 1 black, 2 white) -> 81-char '.XO' strings."""
    return ["".join(row) for row in _BOARD_CHARS[boards]]


def _states(boards, ko, turn, last, device) -> GoState:
    """Packed position arrays -> a batch of states on ``device`` (no hash:
    the features do not read it)."""
    n = boards.shape[0]

    def vec(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=device)

    return GoState(
        board=torch.as_tensor(boards.astype(np.int8), device=device),
        ko=vec(ko),
        turn=vec(turn),
        last_move=vec(last),
        hash=torch.zeros((n, 2), dtype=torch.int64, device=device),
        komi=torch.full((n,), DEFAULT_KOMI, dtype=torch.float32, device=device),
        invalid=torch.zeros((n,), dtype=torch.bool, device=device),
    )


def rows_to_features(rows: list[tuple[str, int | None, int]], chunk: int = 1024, device=None) -> np.ndarray:
    """Featurise (board, ko, last) rows on the device in chunks.

    As ``bokego_tpu.env.state.from_board_string`` reads them: the side to
    move is white iff the stone at ``last`` is black (Python indexing, so
    ``last = -1`` reads the last point), and ``last = -1`` is a pass."""
    dev = resolve_device(device)
    out = []
    for i in range(0, len(rows), chunk):
        block = rows[i : i + chunk]
        boards = _encode_boards([b for b, _, _ in block])
        last = np.array([la for _, _, la in block], np.int64)
        ko = np.array([-1 if ko is None else ko for _, ko, _ in block], np.int64)
        turn = (boards[np.arange(len(block)), last % NN] == 1).astype(np.int64)
        last_move = np.where(last == -1, PASS_ACTION, last)
        out.append(features_batch(_states(boards, ko, turn, last_move, dev)).cpu().numpy())
    return np.concatenate(out, axis=0)


def _value_targets(targets) -> np.ndarray:
    # val 1 = the player who made the labelled (random) move won; the value
    # for the side to move is the negation
    return np.array([-1.0 if v in ("1", "True") else 1.0 for v in targets], np.float32)


def _csv_kind(path: str) -> bool:
    """True for a value csv (last header column ``val``)."""
    with open(path) as f:
        return next(csv.reader(f))[-1].strip().lower() == "val"


def _read_csv(path: str) -> Iterator[list[str]]:
    """The non-empty records of a reference csv, header skipped."""
    with open(path) as f:
        reader = csv.reader(f)
        next(reader)
        yield from (rec for rec in reader if rec)


def load_csv(path: str, device=None) -> GoDataset:
    """Reference csv layout: board, ko, last, move|val (positional)."""
    rows, targets = [], []
    for rec in _read_csv(path):
        ko = None if rec[1] in ("", "None") else int(rec[1])
        rows.append((rec[0], ko, int(rec[2])))
        targets.append(rec[3])
    is_value = _csv_kind(path)
    fts = rows_to_features(rows, device=device)
    t = _value_targets(targets) if is_value else np.array([int(v) for v in targets], np.int32)
    return GoDataset(fts, t, is_value)


def load(path: str, device=None) -> GoDataset:
    if path.endswith(".npz"):
        return load_npz(path)
    if path.endswith(".csv"):
        return load_csv(path, device)
    raise ValueError(f"unsupported dataset {path}")


# -- packed / streaming datasets ---------------------------------------------
#
# Positions stay in their raw form (84 bytes: board + ko + last + turn) and
# the 27 feature planes are computed on the device per minibatch, so the
# reference's SL scale (23M positions, ~1.9 GB raw) fits in host memory and
# shards stream from disk at constant memory.


@dataclasses.dataclass
class PackedDataset:
    """Raw positions in host memory; feature planes computed on the device
    per batch.  ``ko``/``last`` are -1 when absent, ``last`` may be 81
    (pass); ``turn`` is the move parity (0 = black to play)."""

    boards: np.ndarray  # uint8 (n, 81)
    ko: np.ndarray  # int16 (n,)
    last: np.ndarray  # int16 (n,)
    turn: np.ndarray  # int8 (n,)
    targets: np.ndarray  # int32 moves or float32 values
    is_value: bool

    def __len__(self):
        return self.boards.shape[0]

    def _featurize(self, sel: np.ndarray, k: int, device) -> tuple[torch.Tensor, np.ndarray]:
        boards = self.boards[sel]
        ko = self.ko[sel].astype(np.int32)
        last = self.last[sel].astype(np.int32)
        targets = self.targets[sel]
        if k:
            boards = d4_apply_boards(boards, k)
            ko = d4_apply_moves(ko, k)
            # PASS (81) and none (-1) are fixed points of the action map
            last = np.where(last >= NN, last, d4_apply_moves(last, k))
            if not self.is_value:
                targets = d4_apply_moves(targets, k).astype(np.int32)
        return features_batch(_states(boards, ko, self.turn[sel], last, device)), targets

    def batches(
        self, batch_size: int, rng: np.random.Generator, augment: bool = True, device=None, rows: slice | None = None
    ) -> Iterator[tuple[torch.Tensor, np.ndarray]]:
        """Shuffled epoch of (features on ``device``, numpy targets); with
        ``rows``, only those rows of each minibatch are featurised and
        returned (a data-parallel rank's share)."""
        dev = resolve_device(device)
        idx = rng.permutation(len(self))
        for i in range(0, len(self) - batch_size + 1, batch_size):
            sel = idx[i : i + batch_size][rows or slice(None)]
            k = int(rng.integers(8)) if augment else 0
            yield self._featurize(sel, k, dev)


def _pack_records(records: list[list[str]], is_value: bool) -> PackedDataset:
    """Reference csv records -> packed arrays; the side to move is the
    opponent of the stone at ``last``."""
    b = _encode_boards([rec[0] for rec in records])
    last = np.array([int(rec[2]) for rec in records], np.int16)
    turn = (b[np.arange(len(b)), np.clip(last, 0, NN - 1)] == 1).astype(np.int8)
    ko = np.array([-1 if rec[1] in ("", "None") else int(rec[1]) for rec in records], np.int16)
    targets = [rec[3] for rec in records]
    t = _value_targets(targets) if is_value else np.array([int(v) for v in targets], np.int32)
    return PackedDataset(b, ko, last, turn, t, is_value)


def pack_csv(path: str) -> PackedDataset:
    """Parse a reference-layout csv straight into packed arrays."""
    return _pack_records(list(_read_csv(path)), _csv_kind(path))


def _save_shard(path: str, ds: PackedDataset, sl: slice = slice(None)) -> None:
    np.savez_compressed(
        path, boards=ds.boards[sl], ko=ds.ko[sl], last=ds.last[sl], turn=ds.turn[sl],
        targets=ds.targets[sl], is_value=np.array(ds.is_value),
    )


def pack_csv_to_shards(path: str, prefix: str, shard_size: int = 262144) -> list[str]:
    """Stream a reference-layout csv into ``<prefix>-NNNNN.pshard.npz`` files
    at constant memory."""
    paths: list[str] = []
    is_value = _csv_kind(path)
    block: list[list[str]] = []

    def flush():
        if block:
            p = f"{prefix}-{len(paths):05d}.pshard.npz"
            _save_shard(p, _pack_records(block, is_value))
            paths.append(p)
            block.clear()

    for rec in _read_csv(path):
        block.append(rec)
        if len(block) >= shard_size:
            flush()
    flush()
    return paths


def save_shards(prefix: str, ds: PackedDataset, shard_size: int = 262144) -> list[str]:
    """Write ``<prefix>-NNNNN.pshard.npz`` files of at most ``shard_size``
    positions."""
    paths = []
    for s, i in enumerate(range(0, len(ds), shard_size)):
        path = f"{prefix}-{s:05d}.pshard.npz"
        _save_shard(path, ds, slice(i, i + shard_size))
        paths.append(path)
    return paths


def load_shard(path: str) -> PackedDataset:
    z = np.load(path)
    return PackedDataset(z["boards"], z["ko"], z["last"], z["turn"], z["targets"], bool(z["is_value"]))


@dataclasses.dataclass
class ShardedDataset:
    """Shards streamed one at a time (constant memory): a shuffled shard
    order, shuffled positions within each shard; the next shard is
    decompressed on a worker thread while the device trains on this one."""

    paths: list[str]
    _lengths: list[int] = dataclasses.field(default=None)
    is_value: bool = dataclasses.field(default=None)

    def __post_init__(self):
        if self._lengths is None:
            self._lengths = []
            for p in self.paths:
                with np.load(p) as z:
                    self._lengths.append(z["boards"].shape[0])
                    self.is_value = bool(z["is_value"])

    def __len__(self):
        return sum(self._lengths)

    def batches(
        self, batch_size: int, rng: np.random.Generator, augment: bool = True, device=None, rows: slice | None = None
    ) -> Iterator[tuple[torch.Tensor, np.ndarray]]:
        order = [self.paths[int(si)] for si in rng.permutation(len(self.paths))]
        with ThreadPoolExecutor(max_workers=1) as pool:
            nxt = pool.submit(load_shard, order[0])
            for i in range(len(order)):
                shard = nxt.result()
                if i + 1 < len(order):
                    nxt = pool.submit(load_shard, order[i + 1])
                yield from shard.batches(batch_size, rng, augment, device, rows)


def load_streaming(path: str):
    """Any dataset form for constant-memory training: a csv (packed in
    memory, featurised on the device), one ``.pshard.npz``, a glob of shards,
    a directory of shards, or a legacy feature npz (in memory)."""
    if "*" in path or "?" in path:
        paths = sorted(glob.glob(path))
        if not paths:
            raise FileNotFoundError(path)
        return ShardedDataset(paths)
    if path.endswith(".pshard.npz"):
        return load_shard(path)
    if path.endswith(".csv"):
        return pack_csv(path)
    if path.endswith(".npz"):
        return load_npz(path)
    if os.path.isdir(path):
        paths = sorted(glob.glob(os.path.join(path, "*.pshard.npz")))
        if paths:
            return ShardedDataset(paths)
    raise ValueError(f"unsupported dataset {path}")
