"""What decides ``correct``: the timed path's outputs against the plain
reference (``benchmark/reference``).

Every number compared is printed beside its limit, on standard error and
under the result line's last key.  The limits of the forward's gaps are in
the configuration's file (``check``), set from sound runs and from the
control (``PERF.md``); the counts of rule, legality and search errors are
exact (limit 0).
"""

from __future__ import annotations

import collections
import sys

import numpy as np
import torch

from benchmark.reference import features as ref_features
from benchmark.reference import nets as ref_nets
from benchmark.reference import rules as ref_rules

_OPS = {"<=": lambda v, lim: v <= lim, ">=": lambda v, lim: v >= lim}


class Check:
    """Numbers compared, each with its limit."""

    def __init__(self):
        self.items: list[tuple[str, float, str, float]] = []

    def add(self, name: str, value, op: str, limit) -> None:
        self.items.append((name, value, op, limit))

    @property
    def ok(self) -> bool:
        return bool(self.items) and all(
            v is not None and np.isfinite(v) and _OPS[op](v, lim) for _, v, op, lim in self.items
        )

    def line(self) -> dict:
        return {name: {"value": v, "limit": lim, "holds": op} for name, v, op, lim in self.items}

    def print(self) -> None:
        for name, v, op, lim in self.items:
            print(f"check {name} {v} {op} {lim}", file=sys.stderr)
        print(f"check correct {self.ok}", file=sys.stderr, flush=True)


class ForwardLog:
    """Rows of the nets' forwards on the timed path: the position each row
    evaluated and the probabilities and value the program returned, and
    for a leaf of a tree the parent's position and the action between.

    ``per_call`` rows of each forward are kept, chosen by a seeded list of
    indices on the device, so recording costs a few small gathers and no
    synchronisation.  A hook on the search's ``_eval_and_expand`` leaves
    the trees and leaves in ``pending``; the forward inside it takes its
    rows' positions from there (a forward from features has no positions
    of its own), with the parent and action of each leaf."""

    FIELDS = ("board", "ko", "turn", "last_move")

    def __init__(self, device, per_call: int, seed: int):
        self.per_call = per_call
        pool = np.random.default_rng([seed, 7]).integers(0, 2**31 - 1, size=1 << 16)
        self.pool = torch.as_tensor(pool, dtype=torch.int64, device=device)
        self.calls = 0
        self.unpaired = 0  # forwards from features outside an expansion of leaves
        self.pending = None
        self.parts = collections.defaultdict(list)

    def _pick(self, batch: int) -> torch.Tensor:
        k = min(self.per_call, batch)
        start = (self.calls * k) % (self.pool.shape[0] - k)
        self.calls += 1
        return self.pool[start : start + k] % batch

    def add(self, states, probs, vals) -> None:
        """Rows of a forward over ``states``, with no parent."""
        idx = self._pick(probs.shape[0])
        for f in self.FIELDS:
            self.parts[f].append(getattr(states, f).index_select(0, idx))
            self.parts["parent_" + f].append(getattr(states, f).index_select(0, idx))
        self.parts["action"].append(torch.full_like(idx, -1))
        self._add_outputs(idx, probs, vals)

    def add_leaves(self, trees, leaves, probs, vals) -> None:
        """Rows of a forward over the trees' ``leaves``, with their parents."""
        idx = self._pick(probs.shape[0])
        leaf = leaves.index_select(0, idx)
        parent = trees.parent[idx, leaf]
        self.parts["action"].append(torch.where(parent >= 0, trees.action[idx, leaf], -1))
        for f in self.FIELDS:
            pool = getattr(trees.nodes, f)
            self.parts[f].append(pool[idx, leaf])
            self.parts["parent_" + f].append(pool[idx, parent.clamp(min=0)])
        self._add_outputs(idx, probs, vals)

    def _add_outputs(self, idx, probs, vals) -> None:
        self.parts["probs"].append(probs.index_select(0, idx).float())
        self.parts["vals"].append(vals.index_select(0, idx).float())

    def install(self) -> None:
        """Hook the search's expansion of leaves, so that its forward finds
        the trees; nothing when the program has no such function."""
        from bokego_tpu_torch.search import mcts

        plain = getattr(mcts, "_eval_and_expand", None)
        if plain is None:
            return

        def _eval_and_expand(trees, ev, params, cfg, leaves, need):
            self.pending = (trees, leaves)
            try:
                return plain(trees, ev, params, cfg, leaves, need)
            finally:
                self.pending = None

        mcts._eval_and_expand = _eval_and_expand
        self._restore = (mcts, plain)

    def remove(self) -> None:
        if getattr(self, "_restore", None):
            mod, plain = self._restore
            mod._eval_and_expand = plain
            self._restore = None

    def wrap(self, ev):
        """``ev`` with both of its evaluations recorded."""
        plain_evaluate, plain_fts = ev.evaluate, ev.evaluate_fts

        def evaluate(params, states):
            probs, vals = plain_evaluate(params, states)
            if self.pending is None:
                self.add(states, probs, vals)
            else:
                self.add_leaves(*self.pending, probs, vals)
                self.pending = None
            return probs, vals

        def evaluate_fts(params, fts):
            probs, vals = plain_fts(params, fts)
            if self.pending is None:
                self.unpaired += 1
            else:
                self.add_leaves(*self.pending, probs, vals)
                self.pending = None
            return probs, vals

        return ev._replace(evaluate=evaluate, evaluate_fts=evaluate_fts)

    def rows(self) -> dict:
        if not self.parts:
            return {}
        return {k: torch.cat(v).cpu() for k, v in self.parts.items()}


def _game(rows: dict, i: int, prefix: str = "") -> ref_rules.OracleGame:
    return ref_rules.game_from_fields(*(rows[prefix + f][i].tolist() for f in ForwardLog.FIELDS))


def forward_gaps(log: ForwardLog, sample: int, seed: int, policy_path, value_path):
    """Over a seeded sample of the logged rows: ``(rows compared, widest
    probability gap, widest value gap, leaves whose parent was replayed,
    leaves that differ from the reference's successor)``.  The reference
    recomputes the features from each position alone and runs its own
    float32 forward; a leaf's position must equal the reference rules'
    move from its parent's position."""
    rows = log.rows()
    n = 0 if not rows else rows["probs"].shape[0]
    if n == 0:
        return 0, float("nan"), float("nan"), 0, 0
    pick = np.sort(np.random.default_rng([seed, 11]).choice(n, size=min(n, sample), replace=False))
    games = [_game(rows, int(i)) for i in pick]
    successors = wrong = 0
    for i, game in zip(pick, games):
        action = int(rows["action"][i])
        if action < 0:
            continue
        successors += 1
        parent, move = _game(rows, int(i), "parent_"), ref_rules.action_to_move(action)
        if not parent.is_legal(move):
            wrong += 1
            continue
        parent.play(move)
        wrong += (parent.board, parent.ko, parent.turn, parent.last_move) != (game.board, game.ko, game.turn, game.last_move)
    probs, vals = ref_nets.forward(ref_nets.load(policy_path), ref_nets.load(value_path), ref_features.batch(games))
    idx = torch.as_tensor(pick)
    prob_gap = float((rows["probs"][idx] - probs).abs().max())
    value_gap = float((rows["vals"][idx] - vals).abs().max())
    return len(pick), prob_gap, value_gap, successors, wrong


def same_position(game: ref_rules.OracleGame, board, ko: int, turn: int, last_move: int) -> bool:
    """Whether the program's fields equal the reference game's position."""
    ref = ref_rules.game_from_fields(board, ko, turn, last_move)
    return (game.board, game.ko, game.turn, game.last_move) == (ref.board, ref.ko, ref.turn, ref.last_move)
