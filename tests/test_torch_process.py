"""Port parity: the GTP subprocess client and the engine-vs-engine match
harness (``bokego_tpu_torch/gtp/process.py``) against the JAX package's
(``bokego_tpu/gtp/process.py``), over real pipes.

Scripted engines are small jax-free Python scripts written into
``tmp_path`` (as ``tests/test_match.py`` writes its bad engine); their move
lists are random legal games built at test time with the port's ``native``
rules.  The port's engine runs as ``python -m bokego_tpu_torch.cli --device
cpu``, the JAX engine as ``boke.py`` on the CPU.  Tolerance everywhere:
exact (moves, results, SGF bytes, replies).
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from bokego_tpu import native as jnative
from bokego_tpu.gtp import process as jprocess
from bokego_tpu_torch import native, sgf
from bokego_tpu_torch.coords import PASS, squash, unsquash
from bokego_tpu_torch.gtp import process

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = "-p data/weights/policy_17.pt -v data/weights/value_r2.pt"
PORT_CLI = f"{sys.executable} -m bokego_tpu_torch.cli --device cpu --no-ponder"

SCRIPTED = """\
import sys
name, moves_path, score = sys.argv[1:4]
moves = open(moves_path).read().split()
for line in sys.stdin:
    parts = line.split()
    cmd = parts[0] if parts else ""
    if cmd == "genmove":
        if not moves or moves[0] == "DIE":
            sys.exit(0)
        reply = moves.pop(0)
    else:
        reply = {"protocol_version": "2", "name": name, "final_score": score}.get(cmd, "")
    print(f"= {reply}", end="\\n\\n", flush=True)
    if cmd == "quit":
        break
"""


@pytest.fixture(autouse=True)
def _repo_env(monkeypatch):
    """Engines started from any directory find both packages, a JAX engine
    runs on the CPU, and each engine computes on one thread, so that the
    engines of a match do not crowd each other out of the CPU."""
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(filter(None, [REPO, os.environ.get("PYTHONPATH")])))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("BOKEGO_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.chdir(REPO)


def _legal_game(seed: int, n: int) -> list[str]:
    """``n`` random legal moves (no pass) from the empty board, as GTP
    vertices, drawn on the port's native board."""
    rng = np.random.default_rng(seed)
    board = native.NativeBoard(5.5)
    out = []
    for _ in range(n):
        mv = int(rng.choice(np.flatnonzero(board.legal_moves())))
        board.play(mv)
        out.append(unsquash(mv))
    return out


def _occupied(game: list[str]) -> str:
    """A vertex that is occupied after ``game``."""
    board = native.replay([squash(v) for v in game])
    return unsquash(int(np.flatnonzero(board.board)[0]))


def _case(name: str) -> tuple[list[str], int]:
    """The move sequence (alternating from black) and ``max_moves`` of a
    scripted case; ``RESIGN``, ``DIE`` and impossible vertices end it."""
    if name == "two_passes":
        return _legal_game(1, 20) + ["pass", "pass"], 200
    if name == "black_resigns":
        return _legal_game(2, 10) + ["resign"], 200
    if name == "white_resigns":
        return _legal_game(3, 11) + ["resign"], 200
    if name == "black_impossible_before_80":
        game = _legal_game(4, 12)
        return game + [_occupied(game)], 200
    if name == "white_impossible_past_80":
        game = _legal_game(5, 85)
        return game + [_occupied(game)], 200
    if name == "max_moves":
        return _legal_game(6, 30), 17
    if name == "dies_midgame":
        return _legal_game(7, 9) + ["DIE"], 200
    if name == "no_referee":
        return _legal_game(8, 14) + ["pass", "pass"], 200
    if name == "no_referee_impossible":  # unseen without a referee: the game goes on
        game = _legal_game(9, 12)
        return game + [_occupied(game), "pass", "pass"], 200
    raise ValueError(name)


def _scripted(tmp_path, label: str, moves: list[str], score: str = "B+3.5") -> str:
    """The command of a scripted engine that answers ``genmove`` with
    ``moves`` in turn (and exits on ``DIE`` or when they run out),
    ``final_score`` with ``score`` and every other command with ``=``."""
    script = tmp_path / "scripted.py"
    script.write_text(SCRIPTED)
    path = tmp_path / f"{label}.txt"
    path.write_text(" ".join(moves))
    return f"{sys.executable} {script} scripted-{label} {path} {score}"


def _engines(tmp_path, moves: list[str]) -> tuple[str, str]:
    """Black's and white's scripted engines for a game of ``moves``."""
    return _scripted(tmp_path, "black", moves[0::2]), _scripted(tmp_path, "white", moves[1::2])


def _play(harness, black: str, white: str, path: str, max_moves: int):
    """The harness's return value and SGF text, or the error it raised."""
    try:
        won = harness.gtp_match(black, white, sgf_path=path, max_moves=max_moves)
    except RuntimeError as e:
        return ("raised", str(e)), None
    return won, open(path).read()


CASES = ["two_passes", "black_resigns", "white_resigns", "black_impossible_before_80",
         "white_impossible_past_80", "max_moves", "dies_midgame", "no_referee", "no_referee_impossible"]


@pytest.mark.parametrize("case", CASES)
def test_gtp_match_matches_jax_harness(case, tmp_path, monkeypatch):
    """The port's ``gtp_match`` and the JAX package's, on the same scripted
    engines: the same return value (or the same ``RuntimeError``) and
    byte-identical SGF text."""
    moves, max_moves = _case(case)
    if case.startswith("no_referee"):
        def unavailable(komi):
            raise native.NativeUnavailable("no native library")

        monkeypatch.setattr(native, "NativeBoard", unavailable)
        monkeypatch.setattr(jnative, "NativeBoard", unavailable)
    black, white = _engines(tmp_path, moves)
    got = _play(process, black, white, str(tmp_path / "port.sgf"), max_moves)
    want = _play(jprocess, black, white, str(tmp_path / "jax.sgf"), max_moves)
    assert got == want

    won, text = got
    expect = {
        "two_passes": ("RE[", None), "black_resigns": ("RE[W+R]", False), "white_resigns": ("RE[B+R]", True),
        "black_impossible_before_80": ("RE[W+F]", False), "white_impossible_past_80": ("past the move-80 horizon", None),
        "max_moves": ("RE[", None), "no_referee": ("RE[B+3.5]", True), "no_referee_impossible": ("RE[B+3.5]", True),
    }
    if case == "dies_midgame":
        assert won == ("raised", "no move received from white")
        return
    mark, result = expect[case]
    assert mark in text
    if result is not None:
        assert won is result
    if case == "black_impossible_before_80":
        assert "truncated" in text and "move 13" in text
    if case == "white_impossible_past_80":
        assert "truncated" in text and "move 86" in text and "RE[W+F]" not in text and "RE[B+F]" not in text
    if case == "max_moves":
        assert len(sgf.read_moves(str(tmp_path / "port.sgf"))) == 17
    if case == "two_passes":
        assert sgf.read_moves(str(tmp_path / "port.sgf"))[-2:] == [PASS, PASS]


def test_gtp_process_replies_match_jax_client():
    """One port CLI process driven by the port's ``GTPProcess`` and one by
    the JAX package's, with the same commands: the same replies, and each
    process exits with code 0 after ``close()``."""

    def session(cls):
        proc = cls("port", f"{PORT_CLI} -r 4 {WEIGHTS}")
        try:
            replies = [
                proc.name, proc.version(), proc.known("genmove"), proc.known("no_such_command"),
                proc.boardsize(9), proc.komi(5.5), proc.clear_board(), proc.genmove("black"),
                proc.play("white", "C3"), proc.genmove("black"), proc.showboard(), proc.final_score(),
            ]
        finally:
            proc.close()
        return replies, proc.subproc.returncode

    with ThreadPoolExecutor(2) as pool:  # the two processes side by side
        got, want = (f.result() for f in [pool.submit(session, process.GTPProcess), pool.submit(session, jprocess.GTPProcess)])
    assert got == want
    assert got[1] == 0
    assert got[0][0] == "bokego-tpu-torch" and got[0][2] is True and got[0][3] is False


def test_self_match(tmp_path):
    """``tests/test_match.py::test_self_match`` on the port's engine."""
    out = str(tmp_path / "match.sgf")
    cmd = f"{PORT_CLI} -r 4"
    won = process.gtp_match(cmd, cmd, sgf_path=out, max_moves=10)
    assert isinstance(won, bool)
    assert os.path.exists(out)
    assert len(sgf.read_moves(out)) >= 8
    assert sgf.read_result(out)


def test_referee_forfeits_midgame_impossible_move(tmp_path):
    """``tests/test_match.py::test_referee_forfeits_midgame_impossible_move``
    on the port's engine: black's second A1 is impossible on the true board,
    a forfeit against black, and the SGF says so."""
    out = str(tmp_path / "forfeit.sgf")
    black = _scripted(tmp_path, "black", ["A1"] * 20)
    won = process.gtp_match(black, f"{PORT_CLI} -r 4", sgf_path=out, max_moves=40)
    assert won is False
    text = open(out).read()
    assert "RE[W+F]" in text
    assert "truncated" in text


def test_jax_engine_against_port_engine_over_pipes(tmp_path):
    """The JAX engine (``boke.py`` on the CPU) as black against the port's
    CLI as white, both on the shipped nets: the same moves and result as a
    port-vs-port game with the same flags."""
    flags = f"--no-ponder -r 8 {WEIGHTS}"
    jax_engine = f"{sys.executable} boke.py {flags}"
    port_engine = f"{sys.executable} -m bokego_tpu_torch.cli --device cpu {flags}"
    mixed, same = str(tmp_path / "mixed.sgf"), str(tmp_path / "port.sgf")
    with ThreadPoolExecutor(2) as pool:  # the two matches side by side
        games = [pool.submit(process.gtp_match, black, port_engine, sgf_path=path, max_moves=8)
                 for black, path in ((jax_engine, mixed), (port_engine, same))]
        won_mixed, won_port = (g.result() for g in games)
    assert won_mixed == won_port
    assert len(sgf.read_moves(mixed)) == 8
    assert sgf.read_moves(mixed) == sgf.read_moves(same)
    assert sgf.read_result(mixed) == sgf.read_result(same)
