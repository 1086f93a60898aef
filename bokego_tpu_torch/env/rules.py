"""Batched 9x9 Go rules: stepping, legality, liberties, successors, scoring.

Counterpart of ``bokego_tpu/env/rules.py``, written on explicit batches:
every function takes boards ``(B, 81)`` and per-game ``(B,)`` fields where
the JAX package vmaps a single-board function.  Semantics are the JAX
package's exactly (captures before suicide, single-stone ko, Tromp-Taylor
area, incremental Zobrist); ``tests/test_torch_env.py`` holds them equal.

The two label propagations (:func:`group_info`, :func:`area_colors`) are
host loops that stop once every board of the batch has reached its fixed
point, the counterpart of the vmapped ``lax.while_loop``.  On CUDA tensors
:func:`leaf_analysis` runs none of this: one launch of K5
(``ops/leaf.leaf_tables``) computes its group info, move tables,
successors and planes, equal to this module's torch code, which stays the
plain version for CPU tensors.
"""

from __future__ import annotations

import dataclasses
import functools
from types import SimpleNamespace
from typing import NamedTuple

import torch

from bokego_tpu_torch.coords import BLACK, DIAGONALS, EMPTY, NEIGHBORS, NN, PASS_ACTION, WHITE
from bokego_tpu_torch.env import zobrist
from bokego_tpu_torch.env.state import NO_KO, GoState
from bokego_tpu_torch.ops import leaf
from bokego_tpu_torch.utils import metrics

_OFF = -1  # colour read at the off-board pad
_NO_GROUP = NN  # label of empty / off-board points


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> SimpleNamespace:
    """Constant tables on ``device`` (built once per device)."""
    i64 = dict(dtype=torch.int64, device=device)
    return SimpleNamespace(
        nbrs=torch.as_tensor(NEIGHBORS, **i64),  # (81, 4), off-board -> NN
        diags=torch.as_tensor(DIAGONALS, **i64),  # (81, 4), off-board -> NN
        # 1 where a point has fewer than 4 on-board diagonals (edge, corner)
        diag_deficit=torch.as_tensor(((DIAGONALS < NN).sum(1) < 4).astype("int64"), **i64),
        zt=torch.as_tensor(zobrist.TABLE.astype("int64"), **i64),  # (3, 81, 2)
        zflip=torch.as_tensor(zobrist.FLIP.astype("int64"), **i64),  # (2,)
        iota=torch.arange(NN, **i64),
        actions=torch.arange(NN + 1, **i64),
        shifts=torch.arange(32, **i64),
        eye=torch.eye(NN, dtype=torch.bool, device=device),
    )


def _pad(v: torch.Tensor, fill) -> torch.Tensor:
    """Append a sentinel at index NN so off-board gathers are neutral."""
    return torch.cat([v, v.new_full(v.shape[:-1] + (1,), fill)], dim=-1)


def _opponent(color: torch.Tensor) -> torch.Tensor:
    return torch.where(color == BLACK, WHITE, BLACK).to(torch.int8)


def _xor_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """XOR-reduce 32-bit words held in int64 along (non-negative) ``dim``."""
    shifts = _tables(x.device).shifts
    parity = ((x.unsqueeze(-1) >> shifts) & 1).sum(dim) & 1
    return (parity << shifts).sum(-1)


class GroupInfo(NamedTuple):
    """Per-point group facts. Empty points carry label NN and zeros."""

    labels: torch.Tensor  # int64[B, 81] — min point index of the group
    libs: torch.Tensor  # int64[B, 81] — liberties of the group at each stone
    sizes: torch.Tensor  # int64[B, 81] — stones in the group at each stone


def group_info(board: torch.Tensor) -> GroupInfo:
    """Label every chain and count its distinct liberties and its size."""
    t = _tables(board.device)
    stone = board != EMPTY
    labels = torch.where(stone, t.iota, _NO_GROUP)
    nbr_color = _pad(board, _OFF)[:, t.nbrs]  # (B, 81, 4)
    same = stone[..., None] & (nbr_color == board[..., None])
    while True:
        nbr_lab = torch.where(same, _pad(labels, _NO_GROUP)[:, t.nbrs], _NO_GROUP)
        new = torch.minimum(labels, nbr_lab.amin(-1))
        # Pointer jump: a label is a stone of the same group with a label no
        # larger, so following it only speeds the walk to the group minimum.
        new = _pad(new, _NO_GROUP).gather(1, new)
        with metrics.span("sync.group_pass"):
            fixed = torch.equal(new, labels)
        if fixed:
            break
        labels = new

    # Every empty point adds 1 to each distinct neighbouring group label.
    e_nbr = torch.where(
        (board == EMPTY)[..., None], _pad(labels, _NO_GROUP)[:, t.nbrs], _NO_GROUP
    )
    l0, l1, l2, l3 = e_nbr.unbind(-1)
    c0 = l0 != _NO_GROUP
    c1 = (l1 != _NO_GROUP) & (l1 != l0)
    c2 = (l2 != _NO_GROUP) & (l2 != l0) & (l2 != l1)
    c3 = (l3 != _NO_GROUP) & (l3 != l0) & (l3 != l1) & (l3 != l2)
    counts = torch.zeros(board.shape[0], NN + 1, dtype=torch.int64, device=board.device)
    for lk, ck in ((l0, c0), (l1, c1), (l2, c2), (l3, c3)):
        counts.scatter_add_(1, lk, ck.long())
    libs = torch.where(stone, counts.gather(1, labels), 0)
    size_by_label = torch.zeros_like(counts).scatter_add_(1, labels, stone.long())
    sizes = torch.where(stone, size_by_label.gather(1, labels), 0)
    return GroupInfo(labels=labels, libs=libs, sizes=sizes)


def _dilate_rows(m: torch.Tensor) -> torch.Tensor:
    """4-neighbour dilation of each row of a (..., 81) boolean mask."""
    g = m.reshape(m.shape[:-1] + (9, 9))
    out = g.clone()
    out[..., :-1, :] |= g[..., 1:, :]
    out[..., 1:, :] |= g[..., :-1, :]
    out[..., :, :-1] |= g[..., :, 1:]
    out[..., :, 1:] |= g[..., :, :-1]
    return out.reshape(m.shape)


class MoveTables(NamedTuple):
    """Facts about playing at every point for the side to move; values at
    illegal points are zeroed."""

    legal: torch.Tensor  # bool[B, 81]
    libs_after: torch.Tensor  # int64[B, 81] — own-group liberties after playing
    caps: torch.Tensor  # int64[B, 81] — opponent stones captured by playing
    info: GroupInfo


class _Analysis(NamedTuple):
    mt: MoveTables
    cap: torch.Tensor  # bool[B, 81, 81]: cap[b, a, q] — q captured by playing a
    surrounded: torch.Tensor  # bool[B, 81] — every on-board neighbour is opp


def _analyze(board: torch.Tensor, ko: torch.Tensor, color: torch.Tensor) -> _Analysis:
    """All 81 candidate moves at once, from one group analysis (the shared
    body of ``move_tables``, ``child_states`` and ``leaf_analysis``)."""
    t = _tables(board.device)
    info = group_info(board)
    opp = _opponent(color)[:, None, None]
    own = color[:, None, None]
    empty = board == EMPTY

    nbr_color = _pad(board, _OFF)[:, t.nbrs]  # (B, 81, 4)
    nbr_lab = _pad(info.labels, _NO_GROUP)[:, t.nbrs]
    nbr_libs = _pad(info.libs, 0)[:, t.nbrs]

    own_adj_lab = torch.where(nbr_color == own, nbr_lab, _NO_GROUP)
    dying_adj_lab = torch.where((nbr_color == opp) & (nbr_libs == 1), nbr_lab, _NO_GROUP)
    labels_q = info.labels[:, None, :, None]  # (B, 1, 81, 1)
    # grp[b, p, q]: q belongs to the merged own group after playing at p
    grp = (labels_q == own_adj_lab[:, :, None, :]).any(-1) & (board[:, None, :] == own)
    grp |= t.eye
    # cap[b, p, q]: q is captured by playing at p
    cap = (labels_q == dying_adj_lab[:, :, None, :]).any(-1) & (board[:, None, :] == opp)
    caps = cap.sum(-1)
    empty_after = (empty[:, None, :] | cap) & ~t.eye
    libs_after = (empty_after & _dilate_rows(grp)).sum(-1)
    legal = empty & (libs_after > 0) & (t.iota != ko[:, None])
    mt = MoveTables(
        legal=legal,
        libs_after=torch.where(legal, libs_after, 0),
        caps=torch.where(legal, caps, 0),
        info=info,
    )
    surrounded = ((nbr_color == _OFF) | (nbr_color == opp)).all(-1)
    return _Analysis(mt=mt, cap=cap, surrounded=surrounded)


def move_tables(board: torch.Tensor, ko: torch.Tensor, color: torch.Tensor) -> MoveTables:
    """Legality, liberties-after and captures of all 81 moves."""
    return _analyze(board, ko, color).mt


def legal_mask(state: GoState) -> torch.Tensor:
    """bool[B, 82] — legality of each point plus PASS (always legal)."""
    mt = move_tables(state.board, state.ko, state.to_play)
    return _pad(mt.legal, True)


def step(state: GoState, action: torch.Tensor) -> GoState:
    """Apply ``action[b]`` (0..80 point, 81 pass) for each side to move.

    An illegal action leaves that position unchanged and latches ``invalid``.
    """
    with metrics.span("rules.step"):
        t = _tables(state.board.device)
        board, ko, turn = state.board, state.ko, state.turn
        action = action.long()
        color = state.to_play
        opp = _opponent(color)
        is_pass = action == PASS_ACTION
        in_range = (action >= 0) & (action < NN)
        p = torch.where(in_range, action, 0)

        info = group_info(board)
        nbrs = t.nbrs[p]  # (B, 4)
        nbr_color = _pad(board, _OFF).gather(1, nbrs)
        nbr_lab = _pad(info.labels, _NO_GROUP).gather(1, nbrs)
        nbr_libs = _pad(info.libs, 0).gather(1, nbrs)

        dying_lab = torch.where(
            (nbr_color == opp[:, None]) & (nbr_libs == 1), nbr_lab, _NO_GROUP
        )
        captured = (board == opp[:, None]) & (
            info.labels[:, :, None] == dying_lab[:, None, :]
        ).any(-1)
        n_captured = captured.sum(-1)

        empty_nbr = (nbr_color == EMPTY).any(-1)
        joins_live = ((nbr_color == color[:, None]) & (nbr_libs >= 2)).any(-1)
        legal_point = (
            in_range
            & (board.gather(1, p[:, None])[:, 0] == EMPTY)
            & (p != ko)
            & (empty_nbr | (n_captured > 0) | joins_live)
        )

        surrounded = ((nbr_color == _OFF) | (nbr_color == opp[:, None])).all(-1)
        cap_idx = captured.int().argmax(-1)  # first captured point; 0 if none
        new_ko = torch.where((n_captured == 1) & surrounded, cap_idx, NO_KO)
        placed = board.scatter(1, p[:, None], color[:, None])
        new_board = torch.where(captured, EMPTY, placed)

        me, them = turn % 2, (turn + 1) % 2
        ko_old = torch.where((ko != NO_KO)[:, None], t.zt[2, ko.clamp(min=0)], 0)
        ko_new = torch.where((new_ko != NO_KO)[:, None], t.zt[2, new_ko.clamp(min=0)], 0)
        cap_xor = _xor_reduce(torch.where(captured[..., None], t.zt[them], 0), dim=1)
        h = state.hash ^ t.zt[me, p] ^ ko_old ^ ko_new ^ cap_xor ^ t.zflip
        h_pass = state.hash ^ ko_old ^ t.zflip

        ok = is_pass | legal_point
        return GoState(
            board=torch.where((is_pass | ~ok)[:, None], board, new_board),
            ko=torch.where(~ok, ko, torch.where(is_pass, NO_KO, new_ko)),
            turn=torch.where(ok, turn + 1, turn),
            last_move=torch.where(ok, action, state.last_move),
            hash=torch.where(
                (~ok)[:, None], state.hash, torch.where(is_pass[:, None], h_pass, h)
            ),
            komi=state.komi,
            invalid=state.invalid | ~ok,
        )


def area_colors(board: torch.Tensor) -> torch.Tensor:
    """int8[B, 81] Tromp-Taylor area per point: BLACK, WHITE or EMPTY."""
    empty = board == EMPTY
    rb, rw = board == BLACK, board == WHITE
    while True:
        nrb = rb | (_dilate_rows(rb) & empty)
        nrw = rw | (_dilate_rows(rw) & empty)
        if torch.equal(nrb, rb) and torch.equal(nrw, rw):
            break
        rb, rw = nrb, nrw
    b_pts = (board == BLACK) | (empty & rb & ~rw)
    w_pts = (board == WHITE) | (empty & rw & ~rb)
    return torch.where(b_pts, BLACK, torch.where(w_pts, WHITE, EMPTY)).to(torch.int8)


def score(state: GoState) -> torch.Tensor:
    """float32[B] Tromp-Taylor area score, black minus (white + komi)."""
    colors = area_colors(state.board)
    b_area = (colors == BLACK).sum(-1, dtype=torch.float32)
    w_area = (colors == WHITE).sum(-1, dtype=torch.float32)
    return b_area - w_area - state.komi


def eye_colors(board: torch.Tensor) -> torch.Tensor:
    """int8[B, 81]: the colour whose one-point eye each point is, else 0.

    A point is a c-eye iff it is empty, all its on-board neighbours are c,
    and it has at most one fault: an off-board diagonal deficit counts as
    one, each diagonal holding the opponent as one.
    """
    t = _tables(board.device)
    board_p = _pad(board, _OFF)
    nbr_color = board_p[:, t.nbrs]  # (B, 81, 4)
    off = nbr_color == _OFF
    diag_color = board_p[:, t.diags]
    empty = board == EMPTY

    def for_color(c):
        surrounded = empty & (off | (nbr_color == c)).all(-1) & (~off).any(-1)
        enemy = (diag_color != _OFF) & (diag_color != c) & (diag_color != EMPTY)
        return surrounded & (t.diag_deficit + enemy.sum(-1) <= 1)

    is_b, is_w = for_color(BLACK), for_color(WHITE)
    return torch.where(is_b, BLACK, torch.where(is_w, WHITE, EMPTY)).to(torch.int8)


def play_moves(state: GoState, actions: torch.Tensor) -> GoState:
    """Replay an action sequence ``(T, B)`` on a batch of positions."""
    for a in actions:
        state = step(state, a)
    return state


def is_terminal(state: GoState, max_turns: int) -> torch.Tensor:
    """Game over past ``max_turns`` or right after a pass."""
    with metrics.span("rules.is_terminal"):
        return (state.turn > max_turns) | (state.last_move == PASS_ACTION)


class LeafAnalysis(NamedTuple):
    """The search's eval/expansion needs from one group analysis: the
    feature tables, all successors and the feature planes."""

    mt: MoveTables
    children: GoState  # (B, 82, ...) successors, hashes zeroed
    legal: torch.Tensor  # bool[B, 82]
    planes: torch.Tensor | None = None  # float32[B, 9, 9, 27]; None from _leaf_analysis


def _children(state: GoState, boards: torch.Tensor, ko: torch.Tensor) -> GoState:
    """The hashless successors ``(B, 82, ...)`` with the given boards and
    ko points; the rest follows from ``state``."""
    t = _tables(state.board.device)
    batch = boards.shape[0]
    return GoState(
        board=boards,
        ko=ko,
        turn=(state.turn + 1)[:, None].expand(batch, NN + 1),
        last_move=t.actions.expand(batch, NN + 1),
        hash=boards.new_zeros((batch, NN + 1, 2), dtype=torch.int64),
        komi=state.komi[:, None].expand(batch, NN + 1),
        invalid=state.invalid[:, None].expand(batch, NN + 1),
    )


def _leaf_analysis(state: GoState) -> tuple[LeafAnalysis, torch.Tensor]:
    """:func:`leaf_analysis` without the planes, and the capture table
    ``cap[b, a, q]`` it used."""
    t = _tables(state.board.device)
    board = state.board
    color = state.to_play
    an = _analyze(board, state.ko, color)

    placed = torch.where(t.eye, color[:, None, None], board[:, None, :])
    new_boards = torch.where(an.cap, EMPTY, placed)  # (B, 81, 81)
    cap_idx = an.cap.int().argmax(-1)
    new_ko = torch.where((an.mt.caps == 1) & an.surrounded, cap_idx, NO_KO)
    children = _children(state, torch.cat([new_boards, board[:, None, :]], dim=1), _pad(new_ko, NO_KO))
    return LeafAnalysis(mt=an.mt, children=children, legal=_pad(an.mt.legal, True)), an.cap


def _leaf_analysis_card(state: GoState) -> LeafAnalysis:
    """:func:`leaf_analysis` by one K5 launch."""
    lt = leaf.leaf_tables(
        state.board.contiguous(), state.ko.contiguous(), state.turn.contiguous(), state.last_move.contiguous()
    )
    mt = MoveTables(
        legal=lt.legal[:, :NN],
        libs_after=lt.libs_after,
        caps=lt.caps,
        info=GroupInfo(labels=lt.labels, libs=lt.libs, sizes=lt.sizes),
    )
    children = _children(state, lt.child_board, lt.child_ko)
    return LeafAnalysis(mt=mt, children=children, legal=lt.legal, planes=lt.planes)


def leaf_analysis(state: GoState) -> LeafAnalysis:
    """Move tables, every hashless successor of each position and its
    feature planes: one K5 launch for CUDA tensors, the torch code of this
    module and ``features`` for CPU tensors."""
    with metrics.span("rules.leaf_analysis"):
        if leaf.on_card(state.board):
            return _leaf_analysis_card(state)
        from bokego_tpu_torch.features import features_from_tables  # features imports this module

        la = _leaf_analysis(state)[0]
        return la._replace(planes=features_from_tables(state, la.mt))


def child_states(state: GoState, with_hash: bool = True) -> tuple[GoState, torch.Tensor]:
    """All 82 successors ``(B, 82, ...)`` (index 81 = pass) and their
    legality.  Rows at illegal points carry garbage (masked by ``legal``).

    ``with_hash=False`` is the form the search uses (trees never read node
    hashes): it skips the per-child Zobrist XOR-reduce and leaves the hash
    fields zeroed.  With hashes, every legal successor carries the hash that
    :func:`step` would give it."""
    la, cap = _leaf_analysis(state)
    if not with_hash:
        return la.children, la.legal
    t = _tables(state.board.device)
    me, them = state.turn % 2, (state.turn + 1) % 2
    ko, new_ko = state.ko, la.children.ko[:, :NN]
    ko_old = torch.where((ko != NO_KO)[:, None], t.zt[2, ko.clamp(min=0)], 0)  # (B, 2)
    ko_new = torch.where((new_ko != NO_KO)[..., None], t.zt[2, new_ko.clamp(min=0)], 0)  # (B, 81, 2)
    cap_xor = _xor_reduce(torch.where(cap[..., None], t.zt[them][:, None], 0), dim=2)
    h = (state.hash ^ ko_old ^ t.zflip)[:, None, :] ^ t.zt[me] ^ ko_new ^ cap_xor
    h_pass = state.hash ^ ko_old ^ t.zflip
    children = dataclasses.replace(la.children, hash=torch.cat([h, h_pass[:, None, :]], dim=1))
    return children, la.legal
