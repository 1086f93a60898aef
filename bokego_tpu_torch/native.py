"""ctypes bindings to the native host-side Go rules library (the port's
own copy of ``bokego_tpu/native/__init__.py``).

The device rules (``env/rules.py``) are the product path; the C++ library
``native/goboard.cc`` serves host code: the match referee, the engine's
dead-group-aware ``final_score``, SGF replay.  It is compiled with g++ at
first use into the git-ignored ``bokego_tpu_torch/_build/`` (not through
``native/Makefile``, which writes into the JAX package).  Where it cannot
be built or loaded, every entry point raises :class:`NativeUnavailable`.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_HERE, "_build", "libgoboard.so")
_SRC = os.path.normpath(os.path.join(_HERE, "..", "native", "goboard.cc"))

_lib = None


class NativeUnavailable(RuntimeError):
    """The native library could not be built or loaded."""


def build() -> None:
    """Compile ``native/goboard.cc`` with g++ (the flags of
    ``native/Makefile``); an atomic rename publishes the library."""
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = [os.environ.get("CXX", "g++"), "-O2", "-fPIC", "-std=c++17", "-shared", "-o", tmp, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except (OSError, subprocess.CalledProcessError) as e:
        raise NativeUnavailable(f"cannot build {_SRC}: {getattr(e, 'stderr', '') or e}") from e
    os.replace(tmp, _LIB_PATH)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH) or os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC):
        build()
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError as e:
        raise NativeUnavailable(f"cannot load {_LIB_PATH}: {e}") from e
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    c_i32p = ctypes.POINTER(ctypes.c_int32)
    lib.go_play.argtypes = [i8p, c_i32p, c_i32p, ctypes.c_int32]
    lib.go_play.restype = ctypes.c_int
    lib.go_legal.argtypes = [i8p, ctypes.c_int32, ctypes.c_int32, u8p]
    lib.go_liberties.argtypes = [i8p, i32p]
    lib.go_score.argtypes = [i8p, ctypes.c_float]
    lib.go_score.restype = ctypes.c_float
    lib.go_replay.argtypes = [i32p, ctypes.c_int32, i8p, c_i32p, c_i32p]
    lib.go_replay.restype = ctypes.c_int
    lib.go_ownership.argtypes = [
        i8p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_uint64, i8p,
    ]
    lib.go_resolved_score.argtypes = [
        i8p, ctypes.c_int32, ctypes.c_int32, ctypes.c_float, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_uint64,
    ]
    lib.go_resolved_score.restype = ctypes.c_float
    _lib = lib
    return lib


def available() -> bool:
    try:
        _load()
    except NativeUnavailable:
        return False
    return True


class NativeBoard:
    """A mutable host-side game.

    Board cells: 0 empty / 1 black / 2 white; moves are host coords
    (PASS = -1).
    """

    def __init__(self, komi: float = 5.5):
        _load()
        self.board = np.zeros(81, np.int8)
        self._ko = ctypes.c_int32(-1)
        self._turn = ctypes.c_int32(0)
        self.komi = komi

    @property
    def ko(self) -> int | None:
        return None if self._ko.value < 0 else int(self._ko.value)

    @property
    def turn(self) -> int:
        return int(self._turn.value)

    def play(self, move: int) -> int:
        """Play a host-coord move (PASS=-1). Returns captures; raises on
        illegal moves."""
        action = 81 if move == -1 else move
        caps = _load().go_play(
            self.board, ctypes.byref(self._ko), ctypes.byref(self._turn), action
        )
        if caps < 0:
            raise ValueError(f"illegal move {move}")
        return caps

    def legal_moves(self) -> np.ndarray:
        out = np.zeros(81, np.uint8)
        _load().go_legal(self.board, self._ko.value, self._turn.value, out)
        return out.astype(bool)

    def liberties(self) -> np.ndarray:
        out = np.zeros(81, np.int32)
        _load().go_liberties(self.board, out)
        return out

    def score(self) -> float:
        return float(_load().go_score(self.board, ctypes.c_float(self.komi)))

    def ownership(self, n_playouts: int = 127, max_steps: int = 160,
                  seed: int = 1) -> np.ndarray:
        """int8[81] majority point owner (0 neutral / 1 black / 2 white)
        from ``n_playouts`` random resolutions played to double-pass."""
        out = np.zeros(81, np.int8)
        _load().go_ownership(
            self.board, self._ko.value, self._turn.value, n_playouts,
            max_steps, seed, out,
        )
        return out

    def resolved_score(self, n_playouts: int = 127, max_steps: int = 160,
                       seed: int = 1) -> float:
        """Dead-group-aware area score, black minus (white + komi)."""
        return float(_load().go_resolved_score(
            self.board, self._ko.value, self._turn.value,
            ctypes.c_float(self.komi), n_playouts, max_steps, seed,
        ))


def resolved_score_raw(
    board: np.ndarray, ko: int | None, turn: int, komi: float,
    n_playouts: int = 127, max_steps: int = 160, seed: int = 1,
) -> float:
    """Dead-group-aware score for a raw position (0/1/2 board array)."""
    return float(_load().go_resolved_score(
        np.ascontiguousarray(board, np.int8),
        -1 if ko is None else int(ko), int(turn),
        ctypes.c_float(komi), n_playouts, max_steps, seed,
    ))


def replay(moves: list[int], komi: float = 5.5) -> NativeBoard:
    """Replay a game from the empty board; raises on the first illegal
    move."""
    b = NativeBoard(komi)
    arr = np.asarray(moves, np.int32)
    rc = _load().go_replay(
        arr, len(arr), b.board, ctypes.byref(b._ko), ctypes.byref(b._turn)
    )
    if rc != -2:
        raise ValueError(f"illegal move at index {rc}")
    return b
