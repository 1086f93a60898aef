"""Plain reference rules of 9x9 Go, in pure Python.

A frozen copy of the repository's clean-room oracle (``tests/oracle.py``):
an independent re-implementation of the rules with the reference engine's
observable semantics (captures before suicide, the single-capture
fully-surrounded ko rule, one-ply ko lifetime, Tromp-Taylor area scoring),
written on int lists and BFS.  It imports nothing of the program under test.
Extended only where the program's documented rules need more: the terminal
flag at ``max_turns`` (:func:`is_terminal`) and the conversion from the
program's encodings (:func:`game_from_fields`).
"""

from __future__ import annotations

from collections import deque

N = 9
NN = 81
EMPTY, BLACK, WHITE = 0, 1, 2
PASS = -1


def _neighbors(p: int):
    x, y = divmod(p, N)
    if x > 0:
        yield p - N
    if x < N - 1:
        yield p + N
    if y > 0:
        yield p - 1
    if y < N - 1:
        yield p + 1


def _diagonals(p: int):
    x, y = divmod(p, N)
    for dx, dy in ((1, 1), (1, -1), (-1, -1), (-1, 1)):
        nx, ny = x + dx, y + dy
        if 0 <= nx < N and 0 <= ny < N:
            yield N * nx + ny


NEIGHBORS = [list(_neighbors(p)) for p in range(NN)]
DIAGONALS = [list(_diagonals(p)) for p in range(NN)]


def group_of(board, p):
    """BFS the chain containing p. Returns (stones:set, liberties:set)."""
    color = board[p]
    assert color != EMPTY
    stones, libs, seen = {p}, set(), {p}
    q = deque([p])
    while q:
        cur = q.popleft()
        for nb in NEIGHBORS[cur]:
            if nb in seen:
                continue
            if board[nb] == color:
                seen.add(nb)
                stones.add(nb)
                q.append(nb)
            elif board[nb] == EMPTY:
                libs.add(nb)
    return stones, libs


class OracleGame:
    def __init__(self, board=None, ko=None, turn=0, last_move=None, komi=5.5):
        self.board = list(board) if board is not None else [EMPTY] * NN
        self.ko = ko
        self.turn = turn
        self.last_move = last_move
        self.komi = komi

    @property
    def to_play(self):
        return BLACK if self.turn % 2 == 0 else WHITE

    def copy(self):
        return OracleGame(self.board, self.ko, self.turn, self.last_move, self.komi)

    def _try_play(self, p):
        """Compute the successor position; raise ValueError if illegal.

        Returns (new_board, new_ko, captured:list).
        """
        if p == self.ko:
            raise ValueError("ko")
        if self.board[p] != EMPTY:
            raise ValueError("occupied")
        color = self.to_play
        opp = WHITE if color == BLACK else BLACK

        surrounded_by_opp = all(self.board[nb] == opp for nb in NEIGHBORS[p])

        board = list(self.board)
        board[p] = color
        captured = []
        for nb in NEIGHBORS[p]:
            if board[nb] == opp:
                stones, libs = group_of(board, nb)
                if not libs:
                    for s in stones:
                        if board[s] == opp:  # not already removed
                            board[s] = EMPTY
                            captured.append(s)
        _, own_libs = group_of(board, p)
        if not own_libs:
            raise ValueError("suicide")
        new_ko = captured[0] if (len(captured) == 1 and surrounded_by_opp) else None
        return board, new_ko, captured

    def play(self, p):
        if p == PASS:
            self.ko = None
            self.turn += 1
            self.last_move = PASS
            return
        self.board, self.ko, _ = self._try_play(p)
        self.turn += 1
        self.last_move = p

    def is_legal(self, p):
        if p == PASS:
            return True
        try:
            self._try_play(p)
            return True
        except ValueError:
            return False

    def legal_moves(self):
        return {p for p in range(NN) if self.board[p] == EMPTY and self.is_legal(p)}

    def liberties(self):
        """Per-point group liberty counts; 0 at empty points."""
        out = [0] * NN
        done = set()
        for p in range(NN):
            if self.board[p] != EMPTY and p not in done:
                stones, libs = group_of(self.board, p)
                for s in stones:
                    out[s] = len(libs)
                done |= stones
        return out

    def move_effects(self, p):
        """(libs_after, n_captured) of playing at legal point p."""
        board, _, captured = self._try_play(p)
        _, libs = group_of(board, p)
        return len(libs), len(captured)

    def score(self):
        """Tromp-Taylor: black area - white area - komi."""

        def reach(color):
            seen = {p for p in range(NN) if self.board[p] == color}
            q = deque(seen)
            out = set(seen)
            while q:
                cur = q.popleft()
                for nb in NEIGHBORS[cur]:
                    if nb not in out and self.board[nb] == EMPTY:
                        out.add(nb)
                        q.append(nb)
            return out

        rb, rw = reach(BLACK), reach(WHITE)
        b = sum(
            1
            for p in range(NN)
            if self.board[p] == BLACK or (self.board[p] == EMPTY and p in rb and p not in rw)
        )
        w = sum(
            1
            for p in range(NN)
            if self.board[p] == WHITE or (self.board[p] == EMPTY and p in rw and p not in rb)
        )
        return b - w - self.komi

    def eye_color(self, p):
        """Corrected-diagonals one-point-eye heuristic; 0 if not an eye."""
        if self.board[p] != EMPTY:
            return EMPTY
        nb_colors = {self.board[nb] for nb in NEIGHBORS[p]}
        if len(nb_colors) != 1 or EMPTY in nb_colors:
            return EMPTY
        color = nb_colors.pop()
        diags = DIAGONALS[p]
        faults = 1 if len(diags) < 4 else 0
        faults += sum(1 for d in diags if self.board[d] not in (color, EMPTY))
        return color if faults <= 1 else EMPTY


# ---------------------------------------------------------------------------
# Extensions for the benchmark.

PASS_ACTION = NN  # the program's device encoding of a pass
NONE = -1  # the program's "no move" / "no ko" sentinel


def action_to_move(a: int) -> int:
    """The program's action id (81 = pass) as this module's move (-1 = pass)."""
    return PASS if a == PASS_ACTION else int(a)


def is_terminal(game: OracleGame, max_turns: int) -> bool:
    """Game over past ``max_turns`` plies or right after a pass."""
    return game.turn > max_turns or game.last_move == PASS


def game_from_fields(board, ko: int, turn: int, last_move: int, komi: float = 5.5) -> OracleGame:
    """An ``OracleGame`` from the program's fields: ``ko`` and ``last_move``
    use -1 for none, ``last_move`` 81 for a pass."""
    return OracleGame(
        board=[int(v) for v in board],
        ko=None if ko == NONE else int(ko),
        turn=int(turn),
        last_move=None if last_move == NONE else action_to_move(last_move),
        komi=komi,
    )
