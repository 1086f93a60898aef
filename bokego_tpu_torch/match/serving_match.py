"""In-process TIMED match between two serving configurations (counterpart of
``tools/serving_match.py``): which configuration is stronger per second of
wall clock, the question for serving that a fixed-rollout match cannot
ask.  Both GTP engines live in one process and alternate moves on one
device, so each side spends its budget with the device to itself
(pondering off).  A neutral referee (``native.NativeBoard``) checks every
move, forfeits an impossible one, and scores a game played out with the
dead-group resolver.

    python -m bokego_tpu_torch.match.serving_match '{"expand_thresh": 16, "max_nodes": 65536}' \\
        '{"use_kernel": True, "eval_every": 8, "max_nodes": 512}' --forest-b 8 \\
        [--forest-a 1] [--games 16] [--time 0.5] [--open-plies 6] [--seed 11] [--device cuda]

The configs are dict literals of ``SearchConfig`` overrides (``no_sim`` is
set); the second one above is the CLI's ``--fast``, whose forest runs the
CUDA kernels.  Prints a line per game and ``A winrate p +/- ci over N games
at Ts/move``.  Each game's shared opening is sampled from A's policy on an
empty board, from a ``torch.Generator`` seeded by ``--seed`` (the JAX tool
sampled from A's current position, which after the first game is the last
game's final one).
"""

from __future__ import annotations

import argparse
import ast
import time
from typing import Callable, NamedTuple

import torch

from bokego_tpu_torch import native
from bokego_tpu_torch.bin import add_device_flag, device_from
from bokego_tpu_torch.config import POLICY_WEIGHTS, VALUE_WEIGHTS, EngineConfig, SearchConfig
from bokego_tpu_torch.coords import PASS, RESIGN, from_action, unsquash
from bokego_tpu_torch.env import rules, state as st
from bokego_tpu_torch.gtp.engine import GTPEngine
from bokego_tpu_torch.match import common
from bokego_tpu_torch.search import mcts

MAX_MOVES = 170


class GameResult(NamedTuple):
    a_won: bool
    how: str  # "resign", "forfeit", or the resolved score as "+1.5"
    moves: list[int]  # host moves (PASS = -1), the opening included
    seconds: list[float]  # wall time of each generated move


def sample_opening(gen: torch.Generator, engine: GTPEngine, plies: int) -> list[int]:
    """``plies`` opening moves sampled from ``engine``'s policy on an empty
    board (host moves, PASS = -1)."""
    s = st.new_game(float(engine.state.komi[0]), device=engine.device)
    done = torch.zeros(1, dtype=torch.bool, device=engine.device)
    moves = []
    for _ in range(plies):
        mv = common.sample_opening(gen, engine.ev.policy_probs(engine.params, s), s, done)
        s = rules.step(s, mv)
        moves.append(from_action(int(mv[0])))
    return moves


def play_game(
    a: GTPEngine, b: GTPEngine, a_is_black: bool, opening: list[int], log: Callable[[str], None]
) -> GameResult:
    """One game from a new board: the opening played on both engines, then
    ``genmove`` in turn until two passes, a resignation, an impossible move
    (forfeit) or ``MAX_MOVES``."""
    a.new_game()
    b.new_game()
    referee = native.NativeBoard(5.5)
    for mv in opening:
        referee.play(mv)
        a.input_move(mv)
        b.input_move(mv)
    moves, seconds = list(opening), []
    passes = 0
    while passes < 2 and len(moves) < MAX_MOVES:
        black_to_move = len(moves) % 2 == 0
        mover, tag = (a, "A") if black_to_move == a_is_black else (b, "B")
        other = b if mover is a else a
        t0 = time.monotonic()
        mv = mover.genmove()
        seconds.append(time.monotonic() - t0)
        if mv == RESIGN:
            log(f"  {tag} resigned after {len(moves)} moves")
            return GameResult(mover is b, "resign", moves, seconds)
        try:
            referee.play(mv)
        except ValueError:
            log(f"  {tag} played an impossible move at {len(moves)} — forfeit")
            return GameResult(mover is b, "forfeit", moves + [mv], seconds)
        passes = passes + 1 if mv == PASS else 0
        other.input_move(mv)
        moves.append(mv)
        if len(moves) <= len(opening) + 2:
            log(f"  move {len(moves)}: {tag} {unsquash(mv)} ({seconds[-1]:.2f}s)")
    score = referee.resolved_score()
    log(f"  played out ({len(moves)} moves): resolved {score:+.1f}")
    return GameResult((score > 0) == a_is_black, f"{score:+.1f}", moves, seconds)


def make_engine(ev: mcts.Evaluator, params, cfg: dict, forest: int, seconds: float, device) -> GTPEngine:
    """A timed engine without pondering, warmed up (its first move's clock
    sees no set-up)."""
    scfg = SearchConfig(no_sim=True, **cfg)
    ecfg = EngineConfig(time_lim=seconds, pondering=False, forest_size=forest)
    engine = GTPEngine(ev, params, scfg, ecfg, device=device)
    engine.warm_up()
    return engine


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("cfg_a")
    p.add_argument("cfg_b")
    p.add_argument("--forest-a", type=int, default=1)
    p.add_argument("--forest-b", type=int, default=1)
    p.add_argument("--games", type=int, default=16)
    p.add_argument("--time", type=float, default=0.5)
    p.add_argument("--open-plies", type=int, default=6)
    p.add_argument("--policy", default=POLICY_WEIGHTS)
    p.add_argument("--value", default=VALUE_WEIGHTS)
    p.add_argument("--seed", type=int, default=11)
    add_device_flag(p)
    args = p.parse_args(argv)

    dev = device_from(args)
    params = common.load_params(args.policy, args.value, dev)
    ev = mcts.net_evaluator(has_value=True)
    a = make_engine(ev, params, ast.literal_eval(args.cfg_a), args.forest_a, args.time, dev)
    b = make_engine(ev, params, ast.literal_eval(args.cfg_b), args.forest_b, args.time, dev)

    def log(msg):
        print(msg, flush=True)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    a_wins = 0
    t0 = time.monotonic()
    for g in range(args.games):
        opening = sample_opening(gen, a, args.open_plies)
        a_is_black = g % 2 == 0
        res = play_game(a, b, a_is_black, opening, log)
        a_wins += res.a_won
        log(f"game {g + 1}: A as {'B' if a_is_black else 'W'} {'WON' if res.a_won else 'lost'} ({res.how}) "
            f"[{a_wins}/{g + 1}] ({time.monotonic() - t0:.0f}s)")
    pw = a_wins / args.games
    log(f"\nA winrate {pw:.3f} +/- {common.interval(pw, args.games, 1e-9):.3f} over {args.games} games "
        f"at {args.time}s/move")


if __name__ == "__main__":
    main()
