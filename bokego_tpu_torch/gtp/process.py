"""GTP subprocess client and engine-vs-engine match harness (counterpart of
``bokego_tpu/gtp/process.py``; ``tests/test_torch_process.py`` holds the two
to the same results and SGF bytes).

Run any GTP engine under a subprocess, play two engines to double-pass,
score, write the SGF.  A neutral referee replays every generated move on a
host-side board (``bokego_tpu_torch.native``) and scores the final position
with dead-group judgment.

Two differences from the JAX harness, both deliberate: the referee is the
port's own ``native`` binding, and the match goes on without one only when
that binding raises ``native.NativeUnavailable`` (the JAX harness catches
every ``Exception`` there), so a referee that fails for another reason is
not hidden; and without a referee no move can be found impossible, so the
score is always black's ``final_score`` (the JAX harness keeps a ``"?"``
branch for a truncated game that it cannot reach).
"""

from __future__ import annotations

import shlex
from subprocess import PIPE, Popen, TimeoutExpired

from bokego_tpu_torch import native, sgf
from bokego_tpu_torch.coords import PASS, squash


class GTPProcess:
    """A GTP engine running in a subprocess."""

    def __init__(self, label: str, cmd: str, verbose: bool = False):
        self.id = label
        self.verbose = verbose
        self._name: str | None = None
        self.subproc = Popen(shlex.split(cmd), stdin=PIPE, stdout=PIPE)
        try:
            version = self.send("protocol_version")
            assert version == "2", f"wrong protocol version {version!r}"
        except Exception:
            self.close()
            raise

    def send(self, command: str) -> str:
        """Send one command, return the stripped response payload (empty
        when the engine has already exited, as one may right after
        resigning)."""
        if self.verbose:
            print(f"[{self.id}] >> {command}")
        try:
            self.subproc.stdin.write((command.rstrip("\n") + "\n").encode())
            self.subproc.stdin.flush()
        except (BrokenPipeError, OSError):
            return ""
        lines = []
        while True:
            raw = self.subproc.stdout.readline()
            if not raw:
                break  # engine died
            line = raw.decode()
            if line == "\n" and lines:
                break  # GTP responses end with a blank line
            if line != "\n":
                lines.append(line.rstrip("\n"))
        reply = "\n".join(lines)
        if self.verbose:
            print(f"[{self.id}] << {reply}")
        return reply.lstrip("=? ").strip()

    def close(self):
        try:
            self.subproc.communicate(b"quit\n", timeout=10)
        except TimeoutExpired:
            self.subproc.kill()
        except Exception:
            self.subproc.kill()

    # typed wrappers
    @property
    def name(self) -> str:
        if self._name is None:
            self._name = self.send("name")
        return self._name

    def version(self) -> str:
        return self.send("version")

    def known(self, cmd: str) -> bool:
        return self.send(f"known_command {cmd}").lower() == "true"

    def boardsize(self, n: int) -> str:
        return self.send(f"boardsize {n}")

    def komi(self, komi: float) -> str:
        return self.send(f"komi {komi}")

    def clear_board(self) -> str:
        return self.send("clear_board")

    def genmove(self, color: str) -> str:
        return self.send(f"genmove {color}")

    def play(self, color: str, vertex: str) -> str:
        return self.send(f"play {color} {vertex}")

    def showboard(self) -> str:
        return self.send("showboard")

    def final_score(self) -> str:
        return self.send("final_score")


def gtp_match(
    black_cmd: str,
    white_cmd: str,
    sgf_path: str | None = None,
    komi: float = 5.5,
    verbose: bool = False,
    max_moves: int = 200,
) -> bool:
    """Play black vs white to double-pass (or resign); True iff black wins."""
    black = GTPProcess("black", black_cmd, verbose)
    white = GTPProcess("white", white_cmd, verbose)
    try:
        for eng in (black, white):
            eng.name  # cache while alive (a resigner may exit early)
            eng.boardsize(9)
            eng.komi(komi)
            eng.clear_board()

        # Neutral referee: replay every generated move on a host-side board
        # (native C++ rules, no device).  Catches desyncs the engines cannot
        # see (an engine that samples occupied points past its terminal
        # horizon) and scores without asking an engine.
        try:
            referee = native.NativeBoard(komi)
        except native.NativeUnavailable:
            referee = None

        moves: list[int] = []
        passes = 0
        resigned: str | None = None
        illegal_by: str | None = None
        while passes < 2 and len(moves) < max_moves:
            for color, me, other in (("black", black, white), ("white", white, black)):
                vertex = me.genmove(color).upper()
                if not vertex:
                    raise RuntimeError(f"no move received from {color}")
                if vertex == "RESIGN":
                    resigned = color
                    break
                mv = PASS if vertex == "PASS" else squash(vertex)
                if referee is not None and mv != PASS:
                    try:
                        referee.play(mv)
                    except ValueError:
                        # impossible on the true board: end the game here
                        # rather than record/relay a desynced move
                        illegal_by = color
                        break
                elif referee is not None:
                    referee.play(PASS)
                passes = passes + 1 if mv == PASS else 0
                moves.append(mv)  # passes too — SGF colors stay aligned
                other.play(color, vertex)
                if passes >= 2 or len(moves) >= max_moves:
                    break
            if resigned or illegal_by:
                break

        comment = ""
        if resigned:
            score = "W+R" if resigned == "black" else "B+R"
        elif illegal_by is not None and len(moves) < 80:
            # A mid-game impossible move means the engine desynced from the
            # true board: forfeit against it (the truncated position could
            # otherwise still score in the offender's favor).  Past the
            # move-80 horizon the game is effectively over (an engine may
            # sample without legality checks there): those truncations
            # score neutrally below.
            score = "W+F" if illegal_by == "black" else "B+F"
            comment = (
                f"game truncated: {illegal_by} generated an impossible "
                f"move at move {len(moves) + 1}; scored as a forfeit"
            )
        else:
            if illegal_by is not None:
                comment = (
                    f"game truncated: {illegal_by} generated an impossible "
                    f"move at move {len(moves) + 1} (past the move-80 "
                    f"horizon); scored on the final position"
                )
            if referee is not None:
                # The neutral referee is authoritative: dead-group-aware
                # majority ownership over random resolutions.
                tt = referee.resolved_score()
                score = (
                    f"B+{tt:g}" if tt > 0 else f"W+{-tt:g}" if tt < 0 else "0"
                )
            else:
                # only a referee finds a move impossible: the game is intact
                score = black.final_score()
        if sgf_path:
            sgf.write_sgf(
                moves, sgf_path, komi=komi, black=black.name, white=white.name,
                result=score, comment=comment,
            )
        return "B" in score
    finally:
        black.close()
        white.close()
