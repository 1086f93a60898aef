"""The batched self-play entry: ``B`` games in lockstep on the kernel path.

Each move is the loop body of the program's ``parallel/selfplay.selfplay``
with its generator passed on: ``mcts.search(states, ev, params, cfg,
gen=gen)`` (root noise drawn from ``gen``), PASS where a game is done,
``rules.step``, ``done |= rules.is_terminal``.  The rate is the moves of
live games over the window's seconds.

The mix's data decides where games start and when they restart:
``start_plies`` ``[lo, hi]`` (default ``[0, 0]``, the empty board) gives
``openings`` seeded openings of lengths spread over that range, drawn from
the reference policy at ``opening_temperature`` (``harness/openings.py``);
slot ``b`` starts from opening ``b % openings``, played through the
program's ``rules.step``.  ``restart`` ``"batch"`` starts the whole batch
afresh after ``moves_per_game`` moves; ``"slot"`` restarts each game from
the empty board as soon as it ends, so that a staggered start keeps its
mix of game phases.

Recorded for the check, without a synchronisation: the start positions
and every move of a seeded sample of the games (actions, positions,
terminal flags, restarts); over every game,
on the device, that the root's own visits and its children's visits both
equal the rollouts and that the action played is the most-visited child
(the lowest action on ties); rows of the nets' forwards (``ForwardLog``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import check as chk
from benchmark.harness import openings
from benchmark.reference import rules as ref_rules

FIELDS = ("board", "ko", "turn", "last_move")


class Entry:
    def __init__(self, run):
        from bokego_tpu_torch.config import SearchConfig
        from bokego_tpu_torch.models import nets
        from bokego_tpu_torch.search import mcts

        self.run = run
        conf, traffic = run.cell.config, run.cell.traffic
        search = dict(conf["search"])
        if run.args.rollouts:
            search["n_rollouts"] = run.args.rollouts
        self.cfg = SearchConfig(**search)
        self.batch = run.args.batch or conf["batch"]
        self.moves_per_game = traffic["moves_per_game"]
        self.restart = traffic.get("restart", "batch")
        if self.restart not in ("batch", "slot"):
            raise ValueError(f"restart {self.restart!r} is neither 'batch' nor 'slot'")
        self.params = {
            "policy": nets.load_policy(str(run.path(conf["nets"]["policy"])), device=run.device),
            "value": nets.load_value(str(run.path(conf["nets"]["value"])), device=run.device),
        }
        run.mark("nets")
        self.log = chk.ForwardLog(run.device, traffic["forward_rows_per_call"], run.seed)
        self.ev = self.log.wrap(mcts.net_evaluator(has_value=True))
        self.log.install()
        self.gen = torch.Generator(device=run.device).manual_seed(run.seed)
        picked = np.random.default_rng([run.seed, 3]).choice(
            self.batch, size=min(self.batch, traffic["check_games"]), replace=False
        )
        self.games = torch.as_tensor(np.sort(picked), dtype=torch.int64, device=run.device)
        self.record = {k: [] for k in ("batch", "searched", "played", *FIELDS, "done", "restarted")}
        self.start = self.start_states(traffic)
        self.search_errors = torch.zeros((), dtype=torch.int64, device=run.device)
        self.search_checked = 0
        self.batch_id = -1
        self.live_moves = torch.zeros((), dtype=torch.int64, device=run.device)
        self.new_batch()

    def start_states(self, traffic):
        """The batch's start positions: the openings' actions played
        through the program's rules (the empty board without openings)."""
        from bokego_tpu_torch.env import rules
        from bokego_tpu_torch.env import state as st

        states = st.new_game_batch(self.batch, device=self.run.device)
        lo, hi = traffic.get("start_plies", (0, 0))
        self.openings = [[]]
        self.opening_games = [ref_rules.OracleGame()]
        if hi > 0:
            self.openings, self.opening_games = openings.make(
                traffic["openings"], lo, hi, self.run.seed, self.run.path(self.run.cell.config["nets"]["policy"]),
                traffic.get("opening_temperature", 1.0), self.run.device,
            )
        n = len(self.openings)
        for t in range(max(len(a) for a in self.openings)):
            acts = [a[t] if t < len(a) else -1 for a in self.openings]
            act = torch.as_tensor(acts, device=self.run.device)[torch.arange(self.batch, device=self.run.device) % n]
            moved = rules.step(states, act.clamp(min=0))
            states = _where(act >= 0, moved, states)
        self.start_fields = [getattr(states, f)[self.games].cpu() for f in FIELDS]
        self.empty = st.new_game_batch(self.batch, device=self.run.device)
        return states

    def new_batch(self):
        self.states = self.start.map(torch.clone)
        self.done = torch.zeros(self.batch, dtype=torch.bool, device=self.run.device)
        self.batch_moves = 0
        self.batch_id += 1

    def move(self):
        from bokego_tpu_torch.coords import NN, PASS_ACTION
        from bokego_tpu_torch.env import rules
        from bokego_tpu_torch.search import mcts
        from bokego_tpu_torch.search.tree import C_CHILD, C_N

        before = self.done
        actions, trees = mcts.search(self.states, self.ev, self.params, self.cfg, gen=self.gen)
        played = torch.where(before, PASS_ACTION, actions)
        self.states = rules.step(self.states, played)
        self.done = before | rules.is_terminal(self.states, self.cfg.max_turns)
        self.live_moves += (~before).sum()
        after, ended = self.states, self.done

        ar = torch.arange(self.batch, device=actions.device)
        rows = trees.pstats[ar, trees.root]
        has = rows[:, C_CHILD, :NN] >= 0
        visits = rows[:, C_N, :NN]
        expect = torch.where(has.any(1), torch.where(has, visits, -1.0).argmax(1), PASS_ACTION)
        r = float(self.cfg.n_rollouts)
        bad = (
            (trees.root_stats[:, 0] != r)
            | (has.any(1) & (torch.where(has, visits, 0.0).sum(1) != r))
            | (actions != expect)
        )
        self.search_errors += bad.sum()
        self.search_checked += self.batch

        g = self.games
        rec = self.record
        rec["batch"].append(self.batch_id)
        rec["searched"].append(actions[g])
        rec["played"].append(played[g])
        for f in FIELDS:
            rec[f].append(getattr(after, f)[g])
        rec["done"].append(ended[g])
        self.batch_moves += 1
        if self.restart == "slot":
            self.states = _where(ended, self.empty, self.states)
            self.done = torch.zeros_like(ended)
        rec["restarted"].append(ended[g] & (self.restart == "slot"))
        if self.restart == "batch" and self.batch_moves == self.moves_per_game:
            self.new_batch()

    # -- the run's segments ---------------------------------------------------

    def warm_up(self):
        self.move()
        self.new_batch()
        self.run.sync()

    def play(self, seconds: float | None = None, units: int | None = None) -> tuple[int, float]:
        """Moves until ``seconds`` have passed (ending on a move boundary)
        or ``units`` moves ran; returns (moves, seconds)."""
        t0 = time.perf_counter()
        n = 0
        while True:
            self.move()
            n += 1
            self.run.sync()
            elapsed = time.perf_counter() - t0
            if (seconds is not None and elapsed >= seconds) or (units is not None and n >= units):
                return n, elapsed

    def start_window(self):
        self.live_moves.zero_()

    def segment_start(self):
        self.new_batch()

    def end_to_end(self, moves: int, seconds: float) -> dict:
        live = int(self.live_moves)
        self.window_live_moves = live
        return {"selfplay_moves_per_s": live / seconds}

    def attempted_failed(self) -> tuple[int, int]:
        return self.window_live_moves, 0

    def release(self):
        self.log.remove()
        del self.states, self.done, self.params

    # -- the check ------------------------------------------------------------

    def check(self, c: chk.Check):
        rec = {k: (v if k == "batch" else torch.stack(v).cpu()) for k, v in self.record.items()}
        moves = len(rec["batch"])
        max_turns = self.cfg.max_turns
        slots = self.games.cpu().tolist()
        states = illegal = rule_errors = opening_errors = 0
        for j, slot in enumerate(slots):
            start = self.opening_games[slot % len(self.opening_games)]
            if not chk.same_position(start, self.start_fields[0][j].tolist(), *(int(x[j]) for x in self.start_fields[1:])):
                opening_errors += 1
            game, done, last_batch = None, False, None
            for m in range(moves):
                if rec["batch"][m] != last_batch:
                    game, done, last_batch = start.copy(), False, rec["batch"][m]
                elif m > 0 and bool(rec["restarted"][m - 1, j]):
                    game, done = ref_rules.OracleGame(), False
                if game is None:
                    continue
                searched, played = int(rec["searched"][m, j]), int(rec["played"][m, j])
                if played != (ref_rules.PASS_ACTION if done else searched):
                    rule_errors += 1
                move = ref_rules.action_to_move(played)
                if not game.is_legal(move):
                    illegal += 1
                    game = None
                    continue
                game.play(move)
                done = done or ref_rules.is_terminal(game, max_turns)
                states += 1
                fields = [rec[f][m, j] for f in FIELDS]
                if not chk.same_position(game, fields[0].tolist(), *(int(x) for x in fields[1:])):
                    rule_errors += 1
                elif bool(rec["done"][m, j]) != done:
                    rule_errors += 1
        n_rows, prob_gap, value_gap, successors, wrong = chk.forward_gaps(
            self.log, self.run.cell.traffic["check_forward_rows"], self.run.seed,
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
        c.add("opening_errors", opening_errors, "<=", 0)
        c.add("rule_errors", rule_errors, "<=", 0)
        c.add("illegal_actions", illegal, "<=", 0)
        c.add("positions_unchecked", self.games.shape[0] * moves - states, "<=", 0)
        c.add("search_errors", int(self.search_errors), "<=", 0)
        c.add("roots_checked", self.search_checked, ">=", 1)


def _where(mask: torch.Tensor, a, b):
    """The position of ``a`` where ``mask``, else of ``b``, field by field."""
    return type(a)(*(torch.where(mask.view(-1, *[1] * (x.dim() - 1)), x, y) for x, y in zip(a.tensors(), b.tensors())))
