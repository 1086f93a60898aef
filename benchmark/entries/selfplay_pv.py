"""The batched self-play entry with one joint policy-value net: AlphaGo
Zero's residual tower (``bokego_tpu_torch.models.resnet``) in place of
BokeGo's pair of nets.

The move loop, the recorded games, the rules check and the search check are
those of ``entries/selfplay.py``.  The weights are the reference's: drawn at
set-up from the configuration's ``nets.init_seed`` by
``reference/agz.init_state`` and calibrated by ``reference/agz.calibrate`` on
positions of seeded random games of the reference rules
(:func:`calibration_planes`), not from ``--seed``, so every run plays the
same weights; the root noise is drawn from ``--seed``.  The program gets
that float32 state dict through ``resnet.from_state_dict`` and searches
through ``mcts.pv_evaluator`` on the net's inference form (BatchNorm folded,
the weights cast once to bf16, the configuration's precision,
channels-last), recorded by ``ForwardLog``.

The check compares a seeded sample of the recorded rows with the float32
reference (``benchmark/reference/agz.py``) on the same state dict, run on the
run's device with TF32 off: the widest gap of the log-probabilities of the
81 board points (``logp_gap``) and of the values (``value_gap``).  With
seeded weights the policy is flat enough that gaps of raw probabilities
would say little.  The same reference outputs must show that the weights
can be told apart at all: the median of the largest board probability and
the median |value| within the configuration's ranges, and few values dead
(exactly 0) or saturated (|v| > 0.999), where a one-hot policy or a dead
value head would make a gap read 0 whatever the program computes.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.entries import selfplay
from benchmark.harness import check as chk
from benchmark.reference import agz as ref_agz
from benchmark.reference import features as ref_features
from benchmark.reference import rules as ref_rules


class Entry(selfplay.Entry):
    def __init__(self, run):
        from bokego_tpu_torch.config import SearchConfig
        from bokego_tpu_torch.models import resnet
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
        n = conf["nets"]
        state = ref_agz.init_state(
            n["init_seed"], planes=n["planes"], filters=n["channels"], blocks=n["residual_blocks"],
            policy_filters=n["policy_filters"], value_filters=n["value_filters"], value_hidden=n["value_hidden"],
            board=n["board"],
        )
        # the reference's weights, kept on the host; the device holds the program's serving form alone
        self.reference_state = ref_agz.calibrate(state, calibration_planes(n["init_seed"]), device=run.device)
        self.params = {"pv": resnet.from_state_dict(self.reference_state, run.device).inference(torch.bfloat16)}
        run.mark("nets")
        self.log = chk.ForwardLog(run.device, traffic["forward_rows_per_call"], run.seed)
        self.ev = self.log.wrap(mcts.pv_evaluator())
        self.log.install()
        self.gen = torch.Generator(device=run.device).manual_seed(run.seed)
        picked = np.random.default_rng([run.seed, 3]).choice(
            self.batch, size=min(self.batch, traffic["check_games"]), replace=False
        )
        self.games = torch.as_tensor(np.sort(picked), dtype=torch.int64, device=run.device)
        self.record = {k: [] for k in ("batch", "searched", "played", *selfplay.FIELDS, "done", "restarted")}
        self.start = self.start_states(traffic)
        self.search_errors = torch.zeros((), dtype=torch.int64, device=run.device)
        self.search_checked = 0
        self.batch_id = -1
        self.live_moves = torch.zeros((), dtype=torch.int64, device=run.device)
        self.new_batch()

    # -- the check ------------------------------------------------------------

    def replay(self) -> dict:
        """The recorded games replayed on the reference rules: counts of
        positions checked and of opening, rule and legality errors."""
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
                fields = [rec[f][m, j] for f in selfplay.FIELDS]
                if not chk.same_position(game, fields[0].tolist(), *(int(x) for x in fields[1:])):
                    rule_errors += 1
                elif bool(rec["done"][m, j]) != done:
                    rule_errors += 1
        return {
            "opening_errors": opening_errors, "rule_errors": rule_errors, "illegal_actions": illegal,
            "positions_unchecked": len(slots) * moves - states,
        }

    def check(self, c: chk.Check):
        replayed = self.replay()
        got = pv_gaps(
            self.log, self.run.cell.traffic["check_forward_rows"], self.run.seed, self.reference_state, self.run.device
        )
        limits = self.run.cell.config["check"]
        c.add("logp_gap", got["logp_gap"], "<=", limits["logp_gap"])
        c.add("value_gap", got["value_gap"], "<=", limits["value_gap"])
        for name in ("top_prob_median", "abs_value_median"):
            lo, hi = limits[name]
            c.add(f"{name}_above", got[name], ">=", lo)
            c.add(f"{name}_below", got[name], "<=", hi)
        c.add("value_dead_or_saturated_share", got["value_dead_or_saturated_share"], "<=",
              limits["value_dead_or_saturated_share"])
        c.add("forward_rows", got["rows"], ">=", 1)
        c.add("unpaired_forwards", self.log.unpaired, "<=", 0)
        c.add("leaf_successor_errors", got["wrong"], "<=", 0)
        c.add("leaf_successors", got["successors"], ">=", 1)
        for name in ("opening_errors", "rule_errors", "illegal_actions", "positions_unchecked"):
            c.add(name, replayed[name], "<=", 0)
        c.add("search_errors", int(self.search_errors), "<=", 0)
        c.add("roots_checked", self.search_checked, ">=", 1)


CALIBRATION_GAMES, CALIBRATION_PLIES = 8, (4, 20, 36, 52)


def calibration_planes(seed: int):
    """The reference features of ``CALIBRATION_GAMES`` games of uniformly
    random legal moves of the reference rules (a pass where no point is
    legal), seeded by ``seed``, taken after each ply of
    ``CALIBRATION_PLIES``: ``(games * plies, 27, 9, 9)``."""
    rng = np.random.default_rng([seed, 19])
    games = []
    for _ in range(CALIBRATION_GAMES):
        game = ref_rules.OracleGame()
        for ply in range(max(CALIBRATION_PLIES) + 1):
            if ply in CALIBRATION_PLIES:
                games.append(game.copy())
            legal = sorted(game.legal_moves())
            game.play(legal[rng.integers(len(legal))] if legal else ref_rules.PASS)
    return ref_features.batch(games)


def pv_gaps(log: chk.ForwardLog, sample: int, seed: int, state: dict, device) -> dict:
    """Over a seeded sample of the logged rows (the rows that
    ``check.forward_gaps`` samples): the rows compared, the widest gap of
    the board points' log-probabilities and of the values, the leaves whose
    parent was replayed and those that differ from the reference's
    successor, and of the reference's own outputs the median largest board
    probability, the median |value| and the share of values dead or
    saturated.  The reference recomputes the features from each position
    alone and runs its own float32 forward on ``device``."""
    rows = log.rows()
    n = 0 if not rows else rows["probs"].shape[0]
    if n == 0:
        nan = float("nan")
        return {"rows": 0, "logp_gap": nan, "value_gap": nan, "successors": 0, "wrong": 0,
                "top_prob_median": nan, "abs_value_median": nan, "value_dead_or_saturated_share": nan}
    pick = np.sort(np.random.default_rng([seed, 11]).choice(n, size=min(n, sample), replace=False))
    games = [chk._game(rows, int(i)) for i in pick]
    successors = wrong = 0
    for i, game in zip(pick, games):
        action = int(rows["action"][i])
        if action < 0:
            continue
        successors += 1
        parent, move = chk._game(rows, int(i), "parent_"), ref_rules.action_to_move(action)
        if not parent.is_legal(move):
            wrong += 1
            continue
        parent.play(move)
        wrong += (parent.board, parent.ko, parent.turn, parent.last_move) != (game.board, game.ko, game.turn, game.last_move)
    logits, values = ref_agz.forward(state, ref_features.batch(games), device=device)
    logp = ref_agz.board_log_probs(logits)
    idx = torch.as_tensor(pick)
    return {
        "rows": len(pick),
        "logp_gap": float((torch.log(rows["probs"][idx]) - logp).abs().max()),
        "value_gap": float((rows["vals"][idx] - values).abs().max()),
        "successors": successors,
        "wrong": wrong,
        "top_prob_median": float(logp.exp().max(1).values.median()),
        "abs_value_median": float(values.abs().median()),
        "value_dead_or_saturated_share": float(((values.abs() > 0.999) | (values == 0)).float().mean()),
    }
