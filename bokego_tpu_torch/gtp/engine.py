"""Go Text Protocol engine driving the batched device search (counterpart
of ``bokego_tpu/gtp/engine.py``).

The protocol is a host loop and the search state is a device-resident array
tree, or a *forest* of ``forest_size`` root-parallel trees whose visit
counts are summed when a move is chosen.  Same command table, response
framing (``={id} ...`` / ``?{id} ...``), pondering between inputs,
single-level undo, out-of-turn PASS insertion, surrender rule, count- or
time-limited rollouts and ``analyze`` streaming as the JAX engine; in count
mode it runs the same chunks of rollouts (``run_search`` restarts its step
index in every chunk, so the chunking decides which steps evaluate leaves)
and so plays the same moves for the same ``-r``.  With ``leaf_batch`` K > 1
the chunks run as leaf-parallel steps (``search/leafpar.py``), and in
simulation mode the engine's one generator draws the playouts.

What differs: there is no compile and no dispatch to amortise, so the timed
search runs chunks of 8 rollouts against a running per-chunk time measured
on the device after a warm-up (:meth:`GTPEngine.warm_up`), with no dispatch
estimates, floors or pipelined enqueue.  All device work stays on the main
thread; the stdin thread only reads.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from threading import Thread

import torch

from bokego_tpu_torch import native, sgf
from bokego_tpu_torch.config import EngineConfig, SearchConfig
from bokego_tpu_torch.coords import (
    FLOWERS9,
    NN,
    PASS,
    PASS_ACTION,
    RESIGN,
    from_action,
    squash,
    to_action,
    unsquash,
)
from bokego_tpu_torch.device import resolve_device
from bokego_tpu_torch.env import rules, state as st
from bokego_tpu_torch.search import leafpar, mcts
from bokego_tpu_torch.search import tree as tr
from bokego_tpu_torch.search.playout import select_moves
from bokego_tpu_torch.utils import metrics

NAME = "bokego-tpu-torch"
VERSION = "0.1"

COMMANDS = (
    "name", "boardsize", "clear_board", "komi",
    "play", "genmove", "reg_genmove", "final_score",
    "quit", "version", "showboard", "clear_cache",
    "last_move", "move_history", "undo", "help",
    "known_command", "protocol_version", "list_commands",
    "set_fixed_handicap", "printsgf", "loadsgf",
    "analyze", "pondering",
)

COLORS = ("black", "b", "w", "white")

ROLLOUT_CHUNK = 8  # rollouts per small chunk: the deadline's granularity
BIG_CHUNK = 256  # count mode runs chunks of 256 while at least 256 are left
# (the JAX engine's chunking, kept so that both play the same moves)
PONDER_CHUNK = ROLLOUT_CHUNK  # rollouts between two looks at the input
EXPANSION_SLOTS = NN + 1  # pool slots an expansion may need


class GTPEngine:
    """GTP v2 engine; reads stdin/writes stdout, or a pipe-like connection."""

    def __init__(
        self,
        evaluator: mcts.Evaluator,
        params,
        search_cfg: SearchConfig = SearchConfig(),
        engine_cfg: EngineConfig = EngineConfig(),
        connection=None,
        seed: int = 0,
        device=None,
    ):
        self.ev = evaluator
        self.params = params
        self.scfg = search_cfg
        self.ecfg = engine_cfg
        self._conn = connection
        self.device = resolve_device(device)
        self.pondering = engine_cfg.pondering
        self.time_lim = engine_cfg.time_lim
        self.n_rollouts = engine_cfg.n_rollouts
        self.forest = max(1, engine_cfg.forest_size)
        # one generator for root noise, move sampling and simulation mode's playouts
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._w = mcts._mix_weight(search_cfg, evaluator.has_value)
        self._clock = time.monotonic
        self._chunk_s: float | None = None  # running time of a ROLLOUT_CHUNK
        self.rebuilds = 0  # forests built from scratch (no subtree to reuse)
        self._warned_native = False

        self.running = False
        self._input: list[str | None] = [None]
        self._move_history: list[int] = []
        self._last_state = None
        self._undid = False
        self.state = st.new_game(engine_cfg.komi, device=self.device)
        self.trees: tr.Tree | None = None

    # -- small reads of the (batch of one) game state ------------------------

    def _turn(self) -> int:
        with metrics.span("sync.turn"):
            return int(self.state.turn[0])

    def _komi(self) -> float:
        return float(self.state.komi[0])

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- tree management ----------------------------------------------------

    def _new_forest(self) -> tr.Tree:
        """A fresh forest rooted at the current state."""
        batch = self.state.map(lambda x: x.repeat_interleave(self.forest, 0))
        return mcts.init_trees(batch, self.ev, self.params, self.scfg, gen=self._gen)

    def _rebuild(self):
        self.trees = self._new_forest()
        self.rebuilds += 1

    def _ensure_tree(self):
        if self.trees is None:
            self._rebuild()

    def _run_chunk(self, n: int):
        """``n`` rollouts on the forest; with ``leaf_batch`` K > 1 as
        ``ceil(n / K)`` leaf-parallel steps of K, so a K that does not divide
        the chunk runs more rollouts than the chunk counts."""
        cfg = self.scfg
        if cfg.leaf_batch > 1:
            self.trees = leafpar.run_search_k(
                self.trees, self.ev, self.params, cfg, n, cfg.leaf_batch, cfg.leaf_vloss, gen=self._gen
            )
        else:
            self.trees = mcts.run_search(self.trees, self.ev, self.params, cfg, n, gen=self._gen)

    def _pool_full(self) -> bool:
        """True when some tree cannot fit another expansion (82 slots).

        Rollouts past this point cannot deepen the tree: an unexpandable
        leaf's cached value is frozen, so PUCT revisits whichever leaf looks
        best forever and one optimistic evaluation soaks up the visits.  When
        the pool is spent, the right move is to stop searching."""
        with metrics.span("sync.pool_full"):
            used = int(self.trees.n_nodes.max())
        return used + EXPANSION_SLOTS > self.scfg.max_nodes

    def rollout(self, n: int) -> bool:
        """Do about ``n`` rollouts, rounded up to whole chunks: 256 while at
        least 256 are left, else 8.  Returns False when the node pool is
        exhausted and nothing was done."""
        with metrics.span("gtp.search"):
            self._ensure_tree()
            done = 0
            while done < n:
                if self._pool_full():
                    return done > 0
                chunk = BIG_CHUNK if n - done >= BIG_CHUNK else ROLLOUT_CHUNK
                self._run_chunk(chunk)
                done += chunk
            return True

    def _timed_chunk(self):
        """One synchronised ROLLOUT_CHUNK; folds its time into the running
        per-chunk value (the mean of the old value and the new reading)."""
        t0 = self._clock()
        self._run_chunk(ROLLOUT_CHUNK)
        self._sync()
        dt = self._clock() - t0
        self._chunk_s = dt if self._chunk_s is None else 0.5 * (self._chunk_s + dt)

    def timed_rollout(self, seconds: float) -> int:
        """Roll out in chunks of 8 until the time left is under one chunk's
        running time, or the pool is full; returns the chunks run.

        Each chunk is synchronised, so no unfinished device work is queued
        behind the deadline.  The first chunk always runs (a move is never
        chosen on zero visits); every later chunk starts only if its running
        time fits, so a move runs past ``seconds`` by at most the amount one
        chunk exceeds that running value (plus, for a budget under one chunk,
        that first chunk)."""
        self._ensure_tree()
        t0 = self._clock()
        chunks = 0
        while not self._pool_full():
            if chunks and seconds - (self._clock() - t0) <= self._chunk_s:
                break
            self._timed_chunk()
            chunks += 1
        return chunks

    def warm_up(self):
        """Run every path a move takes once on a scratch forest, then time a
        chunk, so that no clock of a game sees first-call set-up (cuDNN's
        algorithm choice, the kernels' build and load, allocator growth): one
        rebuild, two chunks (the second one sets the per-chunk time), one
        advance / compact / expand."""
        keep, keep_rebuilds = self.trees, self.rebuilds
        self.trees = self._new_forest()
        self._run_chunk(ROLLOUT_CHUNK)
        self._sync()
        self._chunk_s = None
        self._timed_chunk()
        visits = self._root_child_visits()
        if visits:
            actions = torch.full((self.forest,), max(visits, key=visits.get), device=self.device)
            scratch, _ = mcts.advance_root(self.trees, actions)
            scratch = mcts.expand_roots(tr.compact(scratch), self.ev, self.params, self.scfg)
            if self.scfg.noise_weight > 0:
                self._fresh_noise(scratch)
        self._sync()
        self.trees, self.rebuilds = keep, keep_rebuilds

    def winrate(self) -> float | None:
        """Root winrate pooled over the whole forest: the per-tree root (N,
        W_sim, W_val) triples are summed, as the visit counts are when a move
        is chosen.  ``None`` for a freshly built forest with no visits: the
        winrate is unknown then, not 0, and must not trigger a resignation."""
        if self.trees is None:
            return None
        with metrics.span("sync.winrate"):
            n, q, v = self.trees.root_stats.double().sum(0).tolist()
        if n <= 0:
            return None
        mixed = ((1.0 - self._w) * q + self._w * v) / n
        return float((mixed + 1.0) / 2.0)

    def _root_rows(self) -> torch.Tensor:
        return tr.take_rows(self.trees.pstats, self.trees.root)  # (forest, 8, 128)

    def _root_child_visits(self) -> dict[int, int]:
        """action -> visits summed across the forest (the root-parallel
        vote), aggregated on the device; only an (81,) vector is copied."""
        rows = self._root_rows()
        has = rows[:, tr.C_CHILD, :NN] >= 0
        n = torch.where(has, rows[:, tr.C_N, :NN], 0.0).sum(0)
        with metrics.span("sync.root_visits"):
            vis = torch.where(has.any(0), n.long(), -1).tolist()
        return {a: v for a, v in enumerate(vis) if v >= 0}

    def _analyze_stats(self, k: int):
        """Top-``k`` root children by pooled visits, on the device: visits
        summed across the forest, the mixed value from the pooled (N, W_sim,
        W_val), priors from tree 0.  Returns lists ``(actions, visits, mixed,
        prior)``; children that exist in no tree pad with visits -1.  Equal
        visits keep the lower action first, as ``lax.top_k`` orders them: a
        stable descending sort, cut to ``k`` (``torch.topk`` gives no tie
        order, and ties are common in an analyze tick)."""
        rows = self._root_rows()
        has = rows[:, tr.C_CHILD, :NN] >= 0
        n = torch.where(has, rows[:, tr.C_N, :NN], 0.0).sum(0)
        wq = torch.where(has, rows[:, tr.C_WQ, :NN], 0.0).sum(0)
        wv = torch.where(has, rows[:, tr.C_WV, :NN], 0.0).sum(0)
        mixed = ((1.0 - self._w) * wq + self._w * wv) / n.clamp(min=1.0)
        top_n, top_a = torch.sort(torch.where(has.any(0), n, -1.0), descending=True, stable=True)
        top_n, top_a = top_n[:k], top_a[:k]
        out = torch.stack([top_a.float(), top_n, mixed[top_a], rows[0, tr.C_PRIOR, :NN][top_a]])
        top_a, top_n, mixed, prior = out.tolist()
        return [int(a) for a in top_a], [int(x) for x in top_n], mixed, prior

    def _fresh_noise(self, trees: tr.Tree) -> tr.Tree:
        noise = mcts.dirichlet_noise(self._gen, self.forest, self.scfg.dirichlet_alpha, self.device)
        return mcts.add_root_noise(trees, noise, self.scfg.noise_weight)

    def _apply_move(self, action: int):
        """Step the engine state; re-root the forest into the played child
        (subtree reuse) or rebuild when the child is not in the tree or the
        pool is running low."""
        with metrics.span("gtp.apply_move"):
            with metrics.span("sync.apply_move"):
                action_t = torch.tensor([action], device=self.device)
            nxt = rules.step(self.state, action_t)
            with metrics.span("sync.apply_move"):
                invalid = bool(nxt.invalid[0])
            if invalid:
                # rules.step latches `invalid`: keep the state from before
                raise ValueError("illegal move")
            self.state = nxt
            if self.trees is not None:
                actions = torch.full((self.forest,), action, device=self.device)
                trees, ok = mcts.advance_root(self.trees, actions)
                with metrics.span("sync.apply_move"):
                    reused = bool(ok.all())
                if reused:
                    # relabel the kept subtree to the pool head so that every
                    # off-path slot is reusable
                    trees = tr.compact(trees)
                    with metrics.span("sync.apply_move"):
                        used = int(trees.n_nodes.max())
                    if used + EXPANSION_SLOTS <= self.scfg.max_nodes - 2:
                        trees = mcts.expand_roots(trees, self.ev, self.params, self.scfg)
                        if self.scfg.noise_weight > 0:
                            # fresh root noise each move; child rows store clean
                            # priors, so reuse stays exact
                            trees = self._fresh_noise(trees)
                        self.trees = trees
                        return
            self._rebuild()

    def input_move(self, mv: int):
        """Play a host-encoded move, with undo bookkeeping."""
        self._last_state = self.state
        self._apply_move(to_action(mv))
        self._move_history.append(mv)
        self._undid = False

    # -- move generation ----------------------------------------------------

    @property
    def surrender(self) -> bool:
        wr = self.winrate()
        return (
            wr is not None
            and wr < self.ecfg.resign_threshold
            and self._turn() > self.ecfg.resign_turn
        )

    def genmove(self, resign: bool | None = None) -> int:
        """Generate a move for the side to move."""
        condition = self.surrender if resign is None else resign
        if condition:
            self.running = False
            return RESIGN

        self._ensure_tree()
        if self.time_lim:
            self.timed_rollout(self.time_lim)
        elif self.n_rollouts:
            self.rollout(self.n_rollouts)
        visits = self._root_child_visits()
        if not visits:
            # no expanded children (a terminal root, or a pool too small to
            # expand it): sample from the policy
            action = self._policy_fallback_action()
        else:
            action = max(sorted(visits), key=lambda a: visits[a])
        mv = from_action(action)
        self._last_state = self.state
        self._apply_move(action)
        self._move_history.append(mv)
        self._undid = False
        return mv

    def _policy_fallback_action(self) -> int:
        """Sample a legal non-eye move from the policy; PASS if none."""
        probs, _ = self.ev.evaluate(self.params, self.state)
        done = torch.zeros(1, dtype=torch.bool, device=self.device)
        return int(select_moves(self._gen, probs, self.state, avoid_eyes=True, done=done)[0])

    # -- analyze ------------------------------------------------------------

    def analyze(self, interval_cs: int, k: int = 3):
        """Stream ``info`` lines until input arrives."""
        yield "= \n"
        self._ensure_tree()
        while True:
            if self._pool_full():  # keep streaming, but leave the device idle
                time.sleep(interval_cs / 200.0)
            else:
                self.timed_rollout(interval_cs / 200.0)
            if self._input[0] is not None:
                yield "\n"
                break
            top_a, top_n, mixed, prior = self._analyze_stats(k)
            # ascending visit order; the top k pad with no-child slots at -1
            best = [a for a, n in zip(top_a, top_n) if n >= 0][::-1]
            stats = dict(zip(top_a, zip(top_n, mixed, prior)))
            # the principal variations are walked on the device: only a
            # (k, depth) action array is copied
            pvs = mcts.pv_walk(
                self.trees, torch.tensor(best, dtype=torch.int64, device=self.device), depth=8
            ).tolist()
            out = ""
            for i, a in enumerate(best):
                n, v, pr = stats[a]
                child_wr = (v + 1) / 2
                pv = [a] + [x for x in pvs[i] if x >= 0]
                out += (
                    f"info move {unsquash(a)} visits {n} "
                    f"winrate {10000 * (1 - child_wr):.0f} "
                    f"prior {10000 * pr:.0f} "
                    "pv " + " ".join(unsquash(pv)) + " "
                )
            yield out + "\n"

    # -- protocol loop ------------------------------------------------------

    def start(self):
        """Main loop: warm up, then dispatch commands and ponder while idle."""
        self.running = True
        self._ensure_tree()
        self.warm_up()
        while self.running:
            self._get_input()
            while self._input[0] is None:
                if not (self.pondering and self.rollout(PONDER_CHUNK)):
                    time.sleep(0.1)
            out = self.send(self._input[0])
            if hasattr(out, "__next__"):  # analyze generator
                self._get_input()
                while self._input[0] is None:
                    try:
                        self._emit(next(out))
                    except StopIteration:
                        break
                out = self.send(self._input[0])
            self._emit(out)

    def stop(self):
        self._input[0] = "quit"
        self.running = False

    def _emit(self, text):
        if text is None:
            return
        if self._conn is not None:
            self._conn.send(text)
        else:
            try:
                print(text, end="")
                sys.stdout.flush()
            except BrokenPipeError:
                # the other end of stdout is gone: shut down quietly
                self.running = False

    def _get_input(self):
        """Read the next line on a thread of its own (it only reads; every
        device call stays on the main thread)."""
        self._input[0] = None

        def wait():
            if self._conn is not None:
                while not self._conn.poll():
                    time.sleep(0.1)
                self._input[0] = self._conn.recv()
            else:
                try:
                    self._input[0] = input()
                except EOFError:
                    self._input[0] = "quit"

        Thread(target=wait, daemon=True).start()

    # -- command dispatch ---------------------------------------------------

    def send(self, cmd: str):
        """Process one GTP command; returns the framed response string (or a
        generator for ``analyze``).  Only the verb is case-normalised;
        arguments pass through raw so that paths survive."""
        if not self.running or not cmd:
            return None
        parts = cmd.split()
        cmd_id = ""
        if parts and parts[0].isdigit():
            cmd_id = parts[0]
            parts = parts[1:]
        if not parts:
            return "? \n\n"
        name, args = parts[0].lower(), parts[1:]
        if name not in COMMANDS:
            return f"?{cmd_id} unknown command '{name}'\n\n"
        with metrics.span(f"gtp.{name}", request=cmd_id or metrics.NEXT):
            result = getattr(self, f"_cmd_{name}")(args)
        if hasattr(result, "__next__"):
            return result
        valid, out = result
        mark = "=" if valid else "?"
        return f"{mark}{cmd_id} {out}\n\n"

    def _cmd_protocol_version(self, args):
        return True, "2"

    def _cmd_version(self, args):
        return True, VERSION

    def _cmd_name(self, args):
        return True, NAME

    def _cmd_known_command(self, args):
        if len(args) != 1:
            return False, ""
        return True, "true" if args[0].lower() in COMMANDS else "false"

    def _cmd_help(self, args):
        return True, "\n".join(COMMANDS)

    _cmd_list_commands = _cmd_help

    def _cmd_boardsize(self, args):
        if len(args) != 1 or args[0] != "9":
            return False, f"{NAME} only plays on 9x9 board"
        return True, ""

    def new_game(self):
        """``clear_board``: an empty board at the current komi, the move
        history and the undo state dropped, and a fresh forest in place of
        the last game's trees.  An engine that resigned plays again."""
        self.state = st.new_game(self._komi(), device=self.device)
        self._move_history = []
        self._last_state = None
        self._rebuild()
        self.running = True

    def _cmd_clear_board(self, args):
        self.new_game()
        return True, ""

    def _cmd_komi(self, args):
        if not args:
            return False, "usage: komi <num-komi>"
        try:
            komi = float(args[0])
        except ValueError:
            return False, "invalid komi value"
        self.state = dataclasses.replace(self.state, komi=torch.full_like(self.state.komi, komi))
        self._rebuild()
        return True, ""

    def _cmd_play(self, args):
        color = args[0].lower() if args else ""
        if len(args) < 2 or color not in COLORS:
            return False, "usage: play <color> <vertex>"
        if args[1].lower() == "resign":
            self.running = False
            return True, ""
        try:
            mv = squash(args[1])
        except ValueError:
            return False, "invalid coordinate"
        turn = 0 if "b" in color else 1
        before = self.state
        before_last, before_undid = self._last_state, self._undid
        inserted_pass = False
        try:
            if turn != self._turn() % 2:
                # out-of-turn play: insert a PASS first
                self._last_state = self.state
                self._apply_move(PASS_ACTION)
                inserted_pass = True
                self._apply_move(to_action(mv))
                self._move_history.append(mv)
                self._undid = False
            else:
                self.input_move(mv)
        except ValueError:
            # atomic: the inserted PASS goes when the move itself was
            # rejected (the pair would silently flip the turn parity), and
            # the undo bookkeeping rolls back with it
            self.state = before
            self._last_state, self._undid = before_last, before_undid
            if inserted_pass:
                # the forest was already re-rooted at the post-PASS position:
                # drop it (rebuilt lazily at the next search)
                self.trees = None
            print(
                f"[engine] rejected play {color} {args[1]} (turn {self._turn()})",
                file=sys.stderr,
                flush=True,
            )
            return False, "illegal move"
        return True, ""

    def _cmd_genmove(self, args, resign=None):
        color = args[0].lower() if args else ""
        if len(args) != 1 or color not in COLORS:
            return False, "usage: genmove <color>"
        turn = 0 if "b" in color else 1
        if turn != self._turn() % 2:
            self.input_move(PASS)
            self._undid = True
        mv = self.genmove(resign)
        if mv == RESIGN:
            self.running = False
            return True, "resign"
        return True, unsquash(mv)

    def _cmd_reg_genmove(self, args):
        return self._cmd_genmove(args, resign=False)

    def _cmd_undo(self, args):
        if self._undid or self._last_state is None:
            return False, "cannot undo"
        self.state = self._last_state
        self._move_history.pop()
        self._last_state = None
        self._undid = True
        self._rebuild()
        return True, ""

    def _cmd_last_move(self, args):
        lm = int(self.state.last_move[0])
        if lm == st.NO_MOVE:
            return False, "no previous move known"
        color = "black " if self._turn() % 2 == 1 else "white "
        return True, color + unsquash(from_action(lm))

    def _cmd_showboard(self, args):
        return True, "\n" + st.render(self.state)

    def _cmd_final_score(self, args):
        """Dead-group-aware once the game is over (majority ownership over
        random resolutions, ``native.resolved_score_raw``); raw Tromp-Taylor
        before that, where a random continuation estimates nothing, and
        where the native library is unavailable (said once on stderr)."""
        over = int(self.state.last_move[0]) == PASS_ACTION or self._turn() > self.scfg.max_turns
        score = None
        if over:
            ko = int(self.state.ko[0])
            try:
                score = native.resolved_score_raw(
                    self.state.board[0].cpu().numpy(), ko if ko >= 0 else None,
                    self._turn(), self._komi(),
                )
            except native.NativeUnavailable as e:
                if not self._warned_native:
                    print(f"[engine] final_score is raw Tromp-Taylor: {e}", file=sys.stderr, flush=True)
                    self._warned_native = True
        if score is None:
            score = float(rules.score(self.state)[0])
        if abs(score) < 1e-4:
            return True, "0"
        return True, f"B+{score}" if score > 0 else f"W+{-score}"

    def _cmd_move_history(self, args):
        return True, "\n".join(unsquash(self._move_history))

    def _cmd_set_fixed_handicap(self, args):
        if len(args) != 1 or not args[0].isnumeric():
            return False, "usage: set_fixed_handicap <num-handicaps>"
        if st.to_board_string(self.state) != "." * NN:
            return False, "board is not empty"
        n = int(args[0])
        if not 1 < n <= 5:
            return False, "invalid number of handicaps"
        stones = FLOWERS9[:n]
        board = ["."] * NN
        for p in stones:
            board[p] = "X"
        self.state = st.from_board_string(
            "".join(board), turn=1, komi=self._komi(), device=self.device
        )
        self._move_history = []
        self._rebuild()
        return True, " ".join(unsquash(list(stones)))

    def _cmd_printsgf(self, args):
        path = args[0] if args else os.path.join(os.getcwd(), "bokego.sgf")
        return True, sgf.write_sgf(self._move_history, path, komi=self._komi())

    def _cmd_loadsgf(self, args):
        # loadsgf <path> [move-number]: every move is replayed; the number
        # only decides the colour in the reply
        if not args or (len(args) > 1 and not args[1].isnumeric()):
            return False, "usage: loadsgf <path-to-sgf> [move-number]"
        try:
            moves = sgf.read_moves(args[0])
            mv_num = int(args[1]) - 1 if len(args) > 1 else len(moves)
            for mv in moves:
                self.input_move(mv)
            return True, "black" if mv_num % 2 == 0 else "white"
        except IOError as e:
            return False, str(e)
        except ValueError:
            return False, "illegal move in sgf"

    def _cmd_clear_cache(self, args):
        self._rebuild()
        self._undid = True
        return True, ""

    def _cmd_analyze(self, args):
        color = args[0].lower() if args else ""
        if len(args) != 2 or color not in COLORS or not args[1].isnumeric():
            return False, "usage: analyze <color> <interval>"
        turn = 0 if "b" in color else 1
        if turn != self._turn() % 2:
            return False, f"it is not {color}'s turn"
        return self.analyze(int(args[1]))

    def _cmd_pondering(self, args):
        arg = args[0].lower() if args else ""
        if len(args) != 1 or arg not in ("on", "off"):
            return False, "usage: pondering <on/off>"
        self.pondering = arg == "on"
        return True, ""

    def _cmd_quit(self, args):
        self.running = False
        return True, ""
