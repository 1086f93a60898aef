"""The GTP entry: one controller in a closed loop on an in-process engine.

The engine is built as the program's CLI builds it (``cli.build_parser``,
``cli.search_config``, ``cli.load_variables``, the ``EngineConfig`` of
``cli.main``), from the configuration's flags, with the configuration's
overrides of the engine's settings.  Each turn the controller sends
``play <opponent> <vertex>`` and then ``genmove <engine>`` through
``GTPEngine.send``; after ``plies_per_game`` plies ``clear_board`` starts
the next game, and the engine's colour alternates by game.  The opponent's
moves are sampled at the mix's temperature from the reference policy over
the moves that the reference rules call legal, with a generator seeded by
``--seed``.  Each ``genmove`` answered with a move is timed from its
``send`` to its reply.  A request answered with an error, or one that
raises, is no served move: it is counted as failed (over the whole run),
left out of the latencies, fails the check, and starts a new game.

Recorded for the check: every ply (the move, the engine's position after
it) and, for each ``genmove``, the root's child visits when the move was
chosen, their sum before the search and the rollouts the search ran; rows
of the nets' forwards (``ForwardLog``).
"""

from __future__ import annotations

import dataclasses
import statistics
import sys
import time

import numpy as np
import torch

from benchmark.harness import check as chk
from benchmark.harness import openings
from benchmark.reference import features as ref_features
from benchmark.reference import nets as ref_nets
from benchmark.reference import rules as ref_rules

COLUMNS = "ABCDEFGHJ"
COLOR = {ref_rules.BLACK: "black", ref_rules.WHITE: "white"}


def vertex(move: int) -> str:
    return "pass" if move == ref_rules.PASS else f"{COLUMNS[move % 9]}{move // 9 + 1}"


def parse_vertex(text: str) -> int:
    text = text.strip().upper()
    if text == "PASS":
        return ref_rules.PASS
    return 9 * (int(text[1:]) - 1) + COLUMNS.index(text[0])


class Opponent:
    """Moves sampled from the reference policy over the reference rules'
    legal moves (a pass when there is none)."""

    def __init__(self, policy_path, seed: int, temperature: float):
        self.sd = ref_nets.load(str(policy_path))
        self.rng = np.random.default_rng([seed, 5])
        self.temperature = temperature

    def move(self, game: ref_rules.OracleGame) -> int:
        planes = ref_features.planes(game)
        probs = ref_nets.policy_probs(self.sd, torch.from_numpy(planes)[None])[0]
        return openings.choose(self.rng, planes, probs, self.temperature)


class Entry:
    def __init__(self, run):
        from bokego_tpu_torch import cli
        from bokego_tpu_torch.config import EngineConfig
        from bokego_tpu_torch.gtp.engine import GTPEngine
        from bokego_tpu_torch.search import mcts

        self.run = run
        conf, self.traffic = run.cell.config, run.cell.traffic
        args = cli.build_parser().parse_args(conf["cli_flags"])
        if run.args.rollouts:
            args.r = run.args.rollouts
        scfg = cli.search_config(args, run.device)
        params = {
            "policy": cli.load_variables(str(run.path(conf["nets"]["policy"])), "policy", run.device),
            "value": cli.load_variables(str(run.path(conf["nets"]["value"])), "value", run.device),
        }
        run.mark("nets")
        ecfg = EngineConfig(
            time_lim=None if args.r else args.t,
            n_rollouts=args.r,
            pondering=not args.no_ponder,
            forest_size=args.forest,
        )
        ecfg = dataclasses.replace(ecfg, **conf["engine"])
        self.log = chk.ForwardLog(run.device, self.traffic["forward_rows_per_call"], run.seed)
        ev = self.log.wrap(mcts.net_evaluator(has_value=True))
        self.log.install()
        self.engine = GTPEngine(ev, params, scfg, ecfg, device=run.device, seed=run.seed)
        self.engine.running = True
        self._instrument(self.engine)
        self.opponent = Opponent(run.path(conf["nets"]["policy"]), run.seed, self.traffic["opponent_temperature"])
        self.komi = ecfg.komi
        self.game_index = -1
        self.game = None
        self.plies: list[tuple] = []  # (game, move, engine board, ko, turn, last_move)
        self.genmoves: list[dict] = []
        self.latencies: list[float] = []  # seconds of each genmove answered with a move
        self.requests = self.failed = 0  # over the whole run: warm-up, window and segments
        self.window_from = (0, 0)

    def _instrument(self, engine):
        """Per-instance wrappers that record what each ``genmove`` chose
        from; each calls the class's method, so span hooks still apply."""
        cls = type(engine)
        self._current = None

        def genmove(*a, **k):
            self._current = {"rollouts": 0, "before": None, "visits": None}
            try:
                return cls.genmove(engine, *a, **k)
            finally:
                self.genmoves.append(self._current)
                self._current = None

        def rollout(n):
            if self._current is not None and self._current["before"] is None:
                self._current["before"] = sum(cls._root_child_visits(engine).values()) if engine.trees else 0
            return cls.rollout(engine, n)

        def run_chunk(n):
            if self._current is not None:
                self._current["rollouts"] += n
            return cls._run_chunk(engine, n)

        def root_child_visits():
            visits = cls._root_child_visits(engine)
            if self._current is not None:
                self._current["visits"] = dict(visits)
            return visits

        engine.genmove, engine.rollout = genmove, rollout
        engine._run_chunk, engine._root_child_visits = run_chunk, root_child_visits

    def _send(self, cmd: str) -> str:
        """The engine's reply; a request that raises is answered ``?``."""
        try:
            return self.engine.send(cmd) or "?"
        except Exception as e:  # noqa: BLE001 - counted as a failed request
            if not self.failed:
                print(f"request {cmd!r} raised {e!r}", file=sys.stderr)
            return "?"

    def new_game(self):
        self.engine.send("clear_board")
        self.game_index += 1
        self.game = ref_rules.OracleGame(komi=self.komi)
        colors = self.traffic["engine_colors"]
        name = colors[self.game_index % len(colors)]
        self.engine_color = ref_rules.BLACK if name == "black" else ref_rules.WHITE

    def request(self) -> bool:
        """One request of the controller; True when it was a ``genmove``."""
        if self.game is None or self.game.turn >= self.traffic["plies_per_game"]:
            self.new_game()
        color = self.game.to_play
        is_genmove = color == self.engine_color
        self.requests += 1
        if is_genmove:
            n = len(self.genmoves)
            t0 = time.perf_counter()
            reply = self._send(f"genmove {COLOR[color]}")
            seconds = time.perf_counter() - t0
            ok = reply.startswith("=") and len(self.genmoves) == n + 1
            try:
                move = parse_vertex(reply[1:]) if ok and "resign" not in reply else None
            except (ValueError, IndexError):
                move = None
            if move is not None:
                self.genmoves[-1].update(reply=move, index=len(self.plies))
                self.latencies.append(seconds)  # a failed request is no served move
        else:
            move = self.opponent.move(self.game)
            reply = self._send(f"play {COLOR[color]} {vertex(move)}")
            ok = reply.startswith("=")
        if not ok or move is None:
            self.failed += 1
            self.game = None
            return is_genmove
        s = self.engine.state
        self.plies.append((self.game_index, move, s.board[0].clone(), s.ko[0].clone(), s.turn[0].clone(), s.last_move[0].clone()))
        if self.game.is_legal(move):
            self.game.play(move)
        else:
            self.game = None  # the check finds the illegal move
        return is_genmove

    # -- the run's segments ---------------------------------------------------

    def warm_up(self):
        self.engine._ensure_tree()
        self.engine.warm_up()
        self.game = None
        while not self.request():
            pass
        self.opponent.move(ref_rules.OracleGame())
        self.run.sync()

    def start_window(self):
        self.latencies = []
        self.window_from = (self.requests, self.failed)
        self.game = None

    def play(self, seconds: float | None = None, units: int | None = None) -> tuple[int, float]:
        """Requests until ``seconds`` have passed (ending on a request
        boundary) or ``units`` genmoves ran; returns (genmoves, seconds)."""
        t0 = time.perf_counter()
        n = 0
        while True:
            n += self.request()
            elapsed = time.perf_counter() - t0
            if (seconds is not None and elapsed >= seconds) or (units is not None and n >= units):
                return n, elapsed

    def segment_start(self):
        self.game = None

    def end_to_end(self, genmoves: int, seconds: float) -> dict:
        ms = [1e3 * x for x in self.latencies]
        self.window = (self.requests - self.window_from[0], self.failed - self.window_from[1])
        if not ms:
            return {}
        p90 = statistics.quantiles(ms, n=10, method="inclusive")[8] if len(ms) > 1 else ms[0]
        if len(ms) > 1:
            deciles = [round(x, 1) for x in statistics.quantiles(ms, n=10, method="inclusive")]
            print(f"genmove ms: {len(ms)} requests, min {min(ms):.1f}, deciles {deciles}, max {max(ms):.1f}", file=sys.stderr)
        return {"genmove_ms_p50": statistics.median(ms), "genmove_ms_p90": p90}

    def attempted_failed(self) -> tuple[int, int]:
        return self.window

    def release(self):
        self.log.remove()
        self.engine.trees = None
        del self.engine

    # -- the check ------------------------------------------------------------

    def check(self, c: chk.Check):
        positions = illegal = rule_errors = search_errors = 0
        game, game_index = None, None
        for i, (g, move, board, ko, turn, last_move) in enumerate(self.plies):
            if g != game_index:
                game, game_index = ref_rules.OracleGame(komi=self.komi), g
            if game is None:
                continue
            if not game.is_legal(move):
                illegal += 1
                game = None
                continue
            game.play(move)
            positions += 1
            if not chk.same_position(game, board.cpu().tolist(), int(ko), int(turn), int(last_move)):
                rule_errors += 1
        for gm in self.genmoves:
            visits = gm.get("visits")
            if "reply" not in gm:
                continue
            if visits:
                best = max(visits.values())
                expect = min(a for a, v in visits.items() if v == best)
                if gm["reply"] != ref_rules.action_to_move(expect):
                    search_errors += 1
                if sum(visits.values()) - (gm["before"] or 0) != gm["rollouts"]:
                    search_errors += 1
        n_rows, prob_gap, value_gap, successors, wrong = chk.forward_gaps(
            self.log, self.traffic["check_forward_rows"], self.run.seed,
            self.run.path(self.run.cell.config["nets"]["policy"]),
            self.run.path(self.run.cell.config["nets"]["value"]),
        )
        limits = self.run.cell.config["check"]
        c.add("prob_gap", prob_gap, "<=", limits["prob_gap"])
        c.add("value_gap", value_gap, "<=", limits["value_gap"])
        c.add("forward_rows", n_rows, ">=", 1)
        c.add("unpaired_forwards", self.log.unpaired, "<=", 0)
        c.add("leaf_successor_errors", wrong, "<=", 0)
        c.add("leaf_successors", successors, ">=", 1)
        c.add("failed_requests", self.failed, "<=", 0)
        c.add("rule_errors", rule_errors, "<=", 0)
        c.add("illegal_moves", illegal, "<=", 0)
        c.add("positions", positions, ">=", 1)
        c.add("search_errors", search_errors, "<=", 0)
        c.add("genmoves_checked", sum(1 for gm in self.genmoves if gm.get("visits")), ">=", 1)
