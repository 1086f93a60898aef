"""Optional host-side gnugo bridge, an external scoring oracle (copy of
``bokego_tpu/gnugo.py`` over the port's own ``sgf``).

The game goes to a temporary SGF and ``gnugo --chinese-rules --score``
answers; every function returns ``None`` when gnugo is not installed, and
the caller falls through to Tromp-Taylor.  Device code never calls this; it
exists for evaluation parity and for batch-scoring SGF files.
"""

from __future__ import annotations

import os
import tempfile
from shutil import which
from subprocess import PIPE, Popen

from bokego_tpu_torch import sgf


def available() -> bool:
    return which("gnugo") is not None


def gnu_score_moves(moves: list[int], komi: float = 5.5) -> int | None:
    """+1 iff black wins per gnugo; None if gnugo is absent."""
    path = which("gnugo")
    if path is None:
        return None
    tmp = os.path.join(tempfile.gettempdir(), f"bokego_tpu_torch_{os.getpid()}.sgf")
    sgf.write_sgf(moves, tmp, komi=komi)
    try:
        p = Popen([path, "--chinese-rules", "--score", "-l", tmp], stdin=PIPE, stdout=PIPE)
        line = p.stdout.readline().decode().strip()
        p.communicate()
    finally:
        os.remove(tmp)
    if not line:
        return None
    return 1 if line[0] == "B" else -1


def gnu_final_score_sgf(sgf_path: str) -> str | None:
    """Ask gnugo for ``final_score`` of an SGF."""
    path = which("gnugo")
    if path is None:
        return None
    p = Popen([path, "--mode", "gtp", "--chinese-rules", "-l", sgf_path], stdin=PIPE, stdout=PIPE)
    out, _ = p.communicate(b"final_score\nquit\n")
    for line in out.decode().splitlines():
        if line.startswith("="):
            return line.lstrip("= ").strip()
    return None


def annotate_results(paths: list[str]) -> dict[str, str]:
    """Batch-score the SGFs that lack ``RE[]`` and write it into them."""
    done = {}
    for p in paths:
        if sgf.read_result(p):
            continue
        score = gnu_final_score_sgf(p)
        if score is None:
            continue
        with open(p) as f:
            text = f.read()
        text = text.replace("SZ[9]", f"SZ[9]RE[{score}]", 1)
        with open(p, "w") as f:
            f.write(text)
        done[p] = score
    return done
