"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
 1. build the CUDA kernels from ``bokego_tpu_torch/ops/csrc`` with nvcc;
 2. K1 ``descend_backprop`` on trees warmed by the port's own search
    (B=1024, Nmax=512, levels=6), at the main path's c and w and at w=0.5
    with random Wq on deeper descents: one launch of 8 rollouts against its
    plain PyTorch version at 8 rollouts and against 8 launches of one
    rollout, everything bit for bit; timed at 1 and at 8 rollouts a launch;
 3. K2 ``write_rows`` against its plain version, masks all false, all true
    and mixed;
 4. the nets on the GPU against the same nets on the CPU, TF32 off;
 5. a small self-play with a deterministic evaluator, GPU against CPU;
 6. the self-play path: ``selfplay`` at the bench configuration (B=1024, 400
    rollouts/move, eval_every=8, kernel_levels=6, expand_thresh=100,
    max_nodes=512) with a seeded random-init 128-channel policy and the
    shipped ``data/weights/value_r2.pt`` for MOVES moves, launch counts read
    around it (51 K1 launches and 400 K1 rollouts a move);
 7. K1 and K2 at the serving path's shapes against their plain versions, bit
    for bit: B=1 and B=8 at Nmax=512, levels=8, on trees warmed by the port's
    own search with the shipped nets; B=2 and B=34 at Nmax=65536 (a pool of
    34 such trees passes 2^31 floats) with every pool reversed, so that the
    roots sit in the last row and the walks read the highest offsets;
 8. the non-kernel search, GPU against CPU, deterministic evaluator: equal
    trees and chosen actions after ``run_search`` at eval_every 1 and 2, and
    again after ``advance_root`` + ``compact`` + ``expand_roots`` and a second
    search; a search continued with and without ``compact`` picks the same;
 9. the serving path: the GTP engine in process with the shipped
    ``policy_17.pt`` and ``value_r2.pt``, a scripted session answered twice,
    in the default configuration (``-r 400``, non-kernel search, one tree:
    no kernel launch) and in the ``--fast`` one (``--forest 8 -r 400``: K1
    and K2, launch counts read around the session): framing, every generated
    vertex legal on a ``NativeBoard`` referee, no rebuild where the played
    child was in the tree, ``analyze``, ``final_score``, SGF out and in;
    every ``analyze`` tick lists the moves and visits of the top k children
    in the order recomputed on the host from the root rows (pooled visits,
    the lower action first among equal visits, as ``lax.top_k`` orders
    them), at k=3 on a searched and on a fresh root and at k=81;
10. the engine as a process: ``python -m bokego_tpu_torch.cli`` through
    ``GTPProcess`` for a few moves at ``-r 64 --fast --forest 8``; then
    ``gtp_match`` between two engine processes on the card, black ``-r 64
    --fast --forest 8`` (K1/K2 at B=8, levels=8, in a subprocess, where the
    launch counts cannot be read) against white at ``-t 0.5``, PIPE_MOVES
    moves with the native referee: the SGF reads back, every move legal, a
    result and no forfeit or truncation; the match's seconds, each side's
    s/move and each process's start-up are printed; then the count-mode pair
    (``-r 64`` against ``-r 64 --fast --forest 8``) twice, side by side,
    printing whether the two SGFs are equal (not gated: cuDNN's choice of
    algorithm in another process is no contract);
11. leaf-parallel search without simulations, GPU against CPU, deterministic
    evaluators (plain and fused evaluation), K = 1, 4, 8 at B=8: equal trees
    and chosen actions, and K = 1 equal to ``run_search``;
12. simulation mode with the one-hot playout policy (one point of mass, so
    the draws of the two devices' generators cannot matter), GPU against
    CPU: ``run_search`` at eval_every 1 and 2 and ``run_search_k`` at K = 4;
13. one served session per search-mode flag with the shipped nets: ``--leaf-batch
    8`` and ``--leaf-batch 16 --forest 8`` at ``-r 400``, ``--simulate`` at
    ``-r SIM_ROLLOUTS``: no kernel launch, every root's visits grown by
    exactly the rollouts of the chunks run, every vertex legal on the
    referee; s/genmove, rollouts/s, leaf evaluations with their batch and
    plies per playout are printed.

14. gendata: ``gendata.generate`` of the shipped ``policy_17.pt`` at B=512,
    70 turns, packed x8 into ``.pshard.npz`` shards;
15. one SL step (train-mode BatchNorm, Adam) of the policy and of the value
    net on the same batch, GPU against CPU: loss, gradients, statistics;
16. SL of the policy (on the moves) and of the shipped value net (on each
    game's outcome) for 200 steps at B=256 from those positions, features
    computed on the device per batch: ms/step, positions/s;
17. genvals: one batch of 512 labelled positions, resolved labels;
18. one REINFORCE iteration (``-b 16 --max-turns 70``), self-play and update
    timed apart;
19. the AlphaZero trajectory with the deterministic evaluator at temperature
    0 without noise, GPU against CPU, then one iteration at B=AZ_BATCH, AZ_MOVES moves,
    AZ_ROLLOUTS rollouts with the shipped nets (self-play and update timed apart);
    phases 14-19 launch neither kernel (counts read around them);
20. every training entry point (``python -m bokego_tpu_torch.bin.<name>``)
    as a process on the GPU at a small size, ``alphazero --resume`` too, in
    three waves of processes side by side.

21. data parallelism over NCCL at world 1 on ``cuda:0`` (a process group of
    this process alone): ``selfplay_sharded`` at the bench configuration and
    B=1024 for DP_MOVES moves with the main path's nets, timed beside the
    unsharded ``selfplay``, 51 K1 launches a move (counts read around each
    run), then with the deterministic evaluator equal to ``selfplay`` move
    for move;
22. the dp SL step (policy and value, B=256, cuDNN deterministic) at world 1
    equal to ``train_step`` bit for bit;
23. gloo, two spawned ranks sharing ``cuda:0``: sharded self-play of 2 x 256
    games equal to unsharded B=512 game for game (deterministic evaluator,
    bench configuration), 51 K1 launches a move on rank 0 (counts read
    around its sharded run: the ``selfplay_sharded`` path), and one dp SL
    step of each net on the card within phase 15's bounds of the same
    2-rank step on the CPU; then, on rank 0 alone, K1 and K2 against their
    plain versions at the rank's shapes (B=256, Nmax=512, levels=6), timed;
24. the dry run ``python -m bokego_tpu_torch.parallel.dryrun 1`` as a
    process: exit 0 and its three ``dryrun:`` lines;
25. phase 23 over NCCL on two cards where the machine has two; otherwise one
    line saying it was not run.

26. M1, the policy curve (``bokego_tpu_torch.match.policy_curve``): the
    repo's REINFORCE generations 8 and 0 (``rl8_policy.pt``,
    ``rl0_policy.pt``) against ``policy_17.pt``, CURVE_GAMES raw-policy games
    a colour each, 70 turns, resolved scoring; each winrate within CURVE_Z
    two-sample standard errors of its TPU record, and gen 8 above gen 0;
27. M2, the anchor match cut to ANCHOR_GAMES a colour at ANCHOR_ROLLOUTS
    rollouts (``weights_match``: ``rl8_policy.pt`` + ``value_own.pt``
    against ``policy_17.pt`` + ``value_r2.pt``, expand_thresh 16, max_nodes
    2048, resolved): every game finished or at the move cap, finite scores;
    the winrate is printed, not gated;
28. M3, the fast-mode fidelity match cut to FIDELITY_GAMES a colour at
    FIDELITY_ROLLOUTS rollouts (``config_match.play`` with
    ``fastmode_fidelity``'s FAST against EXACT): the FAST side's K1 and K2
    launches read around it (one K1 launch per rollout group, at most 8
    rollouts a launch); then K1 and K2 at its shapes (B=8 and the record
    run's B=64, Nmax=512, levels=6) against their plain versions;
29. M4, the serving match (``serving_match.play_game``): MATCH_GAMES timed
    games at MATCH_SECONDS a move, the CLI's default configuration against
    ``--fast --forest 8``, a native referee: no forfeit, every game ended by
    two passes, a resignation or the move cap, and the ``--fast`` side
    launched K1.

30. the roofline report (``bokego_tpu_torch.mfu_report``) at the bench
    configuration for one synchronised move, its table printed: in the
    split move and in the timed move (counts read around each) 51 K1
    launches and at most the JAX tool's 51 forwards at B=1024 (an eval step
    on which no tree has work skips its forward, as in the JAX package),
    one K2 launch for each, FLOP counts equal to
    ``net_flops`` and the nominal one to ``torch.utils.flop_counter``'s on
    the card, the convolution kernels named; then K1 and K2 against their
    plain versions at B=1024, Nmax=512, levels=6;
31. batched simulation throughput (``bokego_tpu_torch.sim_throughput``) at
    B=SIM_BATCH from ply SIM_PLIES, cut to SIM_TOOL_ROLLOUTS rollouts and
    SIM_RUNS timed run: no kernel launch, every root's visits grown by
    exactly the runs' rollouts, the JAX tool's result line printed.

32. the headline bench, ``python -m bokego_tpu_torch.bench``, as a process
    at its full default (B=1024, 80 moves of 400 rollouts, fp32): exit 0 and
    one JSON line with ``bench.py``'s keys, a positive value and
    ``vs_baseline`` null, printed;
33. the bf16 route: ``net_evaluator(dtype=torch.bfloat16)`` on the card
    against the CPU at B=256 positions of seeded random games, with the
    shipped nets and with the bench's random-init nets, within BF16_TOL on
    probabilities and values; nets stored in bf16 give the bits of the
    per-call rounding; then BENCH_PAIR_MOVES bench moves at B=1024 in turns,
    fp32, bf16, bf16, fp32 (``bench.run`` in process, launch counts read
    around each run: 51 K1 launches a move), ms/move printed, and the share
    of games with the same board after those moves, fp32 against bf16 and
    each against its repeat;
34. the batch variant: the bench at B=BIG_BATCH for BIG_MOVES moves in
    process, its K1 and K2 launches a move and ``max_memory_allocated``;
    then K1 and K2 against their plain versions at B=BIG_BATCH, Nmax=512,
    levels=6, bit for bit, timed;
35. ``serving_latency`` at ``--time LATENCY_SECONDS``, one trial, in the
    default configuration and with a forest of 8: root visits grew on both
    paths, no kernel launch;
36. ``python -m bokego_tpu_torch.parallel.scaling 2 SCALING_K --device
    cuda:0 --backend gloo``: exit 0, actions and scores IDENTICAL.

The last seven lines of standard output are the training phases' figures,
the data-parallel phases' figures, the matches' figures, the tools'
figures, the bench phases' figures, the kernels' JSON record (K1 and K2
once at the self-play path's shapes, once at the serving path's, once at
the ``selfplay_sharded`` path's per-rank shapes with rank 0's launches of
phase 23, once at the fidelity match's shapes with its FAST side's
launches, the serving match's launches beside the serving path's shapes,
which its ``--fast --forest 8`` side shares, phase 30's move's launches
beside the records at its shapes, the bench path's launches (phase 33's
first fp32 run, the warm-up move included) beside phases 2-3's records at
its shapes, and phase 34's launches beside its records at B=BIG_BATCH) and
the device line ``{"ok": true, "device": {...}}``; the line before them is
``nvidia-smi``'s name and power limit.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from bokego_tpu_torch.config import POLICY_WEIGHTS, VALUE_WEIGHTS
from bokego_tpu_torch.mfu_report import bound_ms, k1_work

MOVES = 20  # self-play moves of the self-play path
SERVE_ROLLOUTS = 400  # rollouts per generated move of the served sessions
SERVE_FOREST = 8  # trees of the --fast session
ANALYZE_TICKS = 4  # analyze ticks held against the host's order, per stream
PIPE_MOVES = 16  # phase 10: moves of each gtp_match between two engine processes
# phase 10's engine process: the CLI with the shipped nets, flags appended
_ENGINE = f"{sys.executable} -m bokego_tpu_torch.cli --no-ponder -p {POLICY_WEIGHTS} -v {VALUE_WEIGHTS}"
SIM_ROLLOUTS = 16  # rollouts per generated move of the --simulate session: every
# rollout plays its leaf to the end of the game (up to 82 plies, each a policy
# forward and a host read), about 1 s a rollout on an H100 (PERF.md)
FUSED = 8  # rollouts per launch in the K1 check: the main path's eval_every
GEN_BATCH = 512  # games of the gendata phase and positions of the genvals batch
SL_BATCH, SL_STEPS = 256, 200  # SL phase: steps at this batch, policy and value
AZ_BATCH, AZ_MOVES, AZ_ROLLOUTS = 64, 40, 64  # the AlphaZero iteration (bin defaults but the batch, and 40 of
# its 80 moves to keep the script within half its time limit)
DP_MOVES = 4  # self-play moves of each data-parallel self-play run
DP_BATCH = 512  # global games of the 2-rank runs (2 x 256)
CURVE_GAMES = 256  # M1: raw-policy games a colour per generation, as the TPU record
CURVE_RECORDS = {8: (359, 512), 0: (185, 512)}  # data/training_logs/policy_curve.txt (TPU)
CURVE_Z = 3.29  # M1's gate: two-sample standard errors from the TPU record
ANCHOR_GAMES, ANCHOR_ROLLOUTS = 4, 32  # M2: the anchor match cut to 4 games a colour at 32 rollouts
FIDELITY_GAMES, FIDELITY_ROLLOUTS = 8, 64  # M3: the fidelity match cut to 8 games a colour at 64 rollouts
MATCH_GAMES, MATCH_SECONDS, MATCH_OPENING = 2, 0.1, 6  # M4: timed serving games
SIM_BATCH, SIM_PLIES = 256, 40  # phase 31: sim_throughput's batch and midgame start, as the JAX tool's
SIM_TOOL_ROLLOUTS, SIM_RUNS = 8, 1  # phase 31: cut from 64 rollouts and 3 timed runs
BENCH_PAIR_MOVES = 12  # phase 33: moves of each paired fp32 / bf16 bench run at B=1024 (cut from 20
# to pay for phase 10's matches)
BIG_BATCH, BIG_MOVES = 4096, 8  # phase 34: the batch variant (BASELINE.json config 4's 4096 games)
BF16_TOL = 1e-4  # phase 33: the bf16 evaluator on the card against the CPU (ATOL_BF16 of tests/test_torch_bench.py)
LATENCY_SECONDS = 1.0  # phase 35: serving_latency's --time, one trial a path
SCALING_K = 4  # phase 36: games per rank of parallel.scaling over 2 gloo ranks on cuda:0


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, msg: str) -> None:
    """Fail the run (a raising check: asserts vanish under ``python -O``)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def _events_ms(run, iters: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_ms(fn, iters: int) -> tuple[float, float]:
    """Per-call time of ``fn`` by CUDA events: ``(device_ms, eager_ms)``.

    ``device_ms`` replays ``iters`` calls captured in one CUDA graph, so the
    host's launch path (Python, ctypes) is left out; ``eager_ms`` launches
    them one by one from Python, as the search does, and includes it where
    the host is slower than the device."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up, as graph capture asks
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    device = _events_ms(graph.replay, iters)
    eager = _events_ms(lambda: [fn() for _ in range(iters)], iters)
    del graph
    return device, eager


def reverse_pools(trees):
    """The same trees with every pool reversed: node i moves to slot
    Nmax-1-i, so the roots sit in the last row of their pools."""
    import dataclasses

    from bokego_tpu_torch.search.tree import C_CHILD

    top = trees.capacity - 1

    def flip(x):
        return x.flip(1)

    def relabel(x):
        return torch.where(x >= 0, top - x, x)

    pstats = flip(trees.pstats)
    pstats[:, :, C_CHILD] = relabel(pstats[:, :, C_CHILD])
    return dataclasses.replace(
        trees, nodes=trees.nodes.map(flip), parent=relabel(flip(trees.parent)), action=flip(trees.action),
        pstats=pstats, value=flip(trees.value), expanded=flip(trees.expanded),
        terminal=flip(trees.terminal), root=top - trees.root,
    )


def check_serving_kernels(dev, params, roots) -> dict:
    """Phase 7; returns the K1 and K2 records at the --fast engine's shapes
    (B=SERVE_FOREST, Nmax=512, levels=8)."""
    from bokego_tpu_torch.search import mcts

    shapes = ((1, 512, 200, False), (SERVE_FOREST, 512, 200, False), (2, 65536, 64, True), (34, 65536, 64, True))
    return check_kernels_at(dev, mcts.net_evaluator(), params, roots, shapes, levels=8, record_at=(SERVE_FOREST, 512))


def check_kernels_at(dev, ev, params, roots, shapes, levels: int, record_at: tuple[int, int]) -> dict:
    """K1 (1, 7 and FUSED rollouts a launch) and K2 (three masks) against
    their plain versions on trees warmed by ``ev`` from the first ``B`` of
    ``roots``, for each ``(B, Nmax, warm rollouts, pools reversed)`` of
    ``shapes``; returns their records (times, bounds, error) at the
    ``record_at`` ``(B, Nmax)``."""
    from bokego_tpu_torch.config import SearchConfig
    from bokego_tpu_torch.ops import rollout
    from bokego_tpu_torch.search import mcts

    gen = torch.Generator(device=dev).manual_seed(2)
    records = {}
    for batch, n_pool, warm_rollouts, flip in shapes:
        cfg = SearchConfig(
            use_kernel=True, eval_every=2, expand_thresh=0, branch_num=8, max_nodes=n_pool, kernel_levels=levels
        )
        states = roots.map(lambda x: x[:batch].clone())
        trees = mcts.run_search(mcts.init_trees(states, ev, params, cfg), ev, params, cfg, warm_rollouts)
        if flip:
            trees = reverse_pools(trees)
            check(bool((trees.root == n_pool - 1).all()), "reversed pools: roots not in the last row")
        kw = dict(c=cfg.exploration_weight, w=1.0, use_value=True, levels=levels)
        shape = f"B={batch} Nmax={n_pool} levels={levels}"
        err = 0.0
        for n_roll in (1, 7, FUSED):
            p_k, p_p = trees.pstats.clone(), trees.pstats.clone()
            rs_k, rs_p = trees.root_stats.clone(), trees.root_stats.clone()
            res_k = rollout.descend_backprop(p_k, trees.value, trees.root, rs_k, rollouts=n_roll, **kw)
            res_p = rollout.descend_backprop_plain(p_p, trees.value, trees.root, rs_p, rollouts=n_roll, **kw)
            torch.cuda.synchronize()
            check(torch.equal(res_k, res_p), f"K1 result differs from plain ({shape}, {n_roll} rollouts)")
            check(torch.equal(p_k, p_p), f"K1 pstats differ from plain ({shape}, {n_roll} rollouts)")
            check(torch.equal(rs_k, rs_p), f"K1 root stats differ from plain ({shape}, {n_roll} rollouts)")
            check(not torch.equal(p_k, trees.pstats), f"K1 wrote nothing ({shape})")
            err = max(
                err, float((res_k - res_p).abs().max()), float((rs_k - rs_p).abs().max()),
                float((p_k - p_p).abs().max()),
            )
            depth = rollout.unpack(res_k).depth
            del p_k, p_p
        check(int(depth.max()) >= 2, f"warm trees too shallow ({shape}): depth {depth.tolist()[:8]}")
        # K2: masks all false, all true, mixed; nodes in the upper half of the pool
        node = torch.randint(n_pool // 2, n_pool, (batch,), device=dev, generator=gen)
        node[-1] = n_pool - 1
        rows = torch.randn((batch, 8, 128), device=dev, generator=gen)
        k2_err = 0.0
        for name, mask in (
            ("none", torch.zeros(batch, dtype=torch.bool, device=dev)),
            ("all", torch.ones(batch, dtype=torch.bool, device=dev)),
            ("mixed", torch.arange(batch, device=dev) % 2 == 0),
        ):
            p_k, p_p = trees.pstats.clone(), trees.pstats.clone()
            rollout.write_rows(p_k, node, rows, mask)
            rollout.write_rows_plain(p_p, node, rows, mask)
            torch.cuda.synchronize()
            check(torch.equal(p_k, p_p), f"K2 differs from plain ({shape}, mask {name})")
            check(bool(mask.any()) != torch.equal(p_k, trees.pstats), f"K2 wrote wrongly ({shape}, mask {name})")
            k2_err = max(k2_err, float((p_k - p_p).abs().max()))
            del p_k, p_p
        log(
            f"K1/K2 at {shape}{' (pools reversed)' if flip else ''}: 1, 7 and {FUSED} fused rollouts and three "
            f"masks equal the plain versions bit for bit (tolerance 0); last depths {depth.tolist()[:8]}"
        )
        if (batch, n_pool) == record_at:
            # times and bounds at the recorded shapes
            singles_p, singles_rs = trees.pstats.clone(), trees.root_stats.clone()
            singles = [
                rollout.descend_backprop(singles_p, trees.value, trees.root, singles_rs, **kw) for _ in range(FUSED)
            ]
            p_k, p_p = trees.pstats.clone(), trees.pstats.clone()
            rs_k, rs_p = trees.root_stats.clone(), trees.root_stats.clone()
            ms, eager = time_ms(
                lambda: rollout.descend_backprop(p_k, trees.value, trees.root, rs_k, rollouts=FUSED, **kw), 100
            )
            plain, _ = time_ms(
                lambda: rollout.descend_backprop_plain(p_p, trees.value, trees.root, rs_p, rollouts=FUSED, **kw), 5
            )
            n_bytes, n_ops = k1_work(singles, trees.parent, levels, planes=4)
            b_ms, b_by = bound_ms(n_bytes, n_ops)
            mean_depth = float(rollout.unpack(singles[0]).depth.float().mean())
            records["descend_backprop"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                rollouts_per_launch=FUSED,
            )
            log(
                f"K1 descend_backprop rollouts/launch={FUSED}: {shape} mean_depth={mean_depth:.3f}; kernel_ms={ms:.5f} "
                f"plain_ms={plain:.5f} bound_ms={b_ms:.5f} ({b_by}, {n_bytes} B needed); eager kernel_ms={eager:.5f}"
            )
            mask = torch.arange(batch, device=dev) % 2 == 0
            b_idx = mask.nonzero().squeeze(1)
            n_idx, r_idx = node[b_idx], rows[b_idx]
            k2_ms, k2_eager = time_ms(lambda: rollout.write_rows(p_k, node, rows, mask), 200)
            k2_plain, _ = time_ms(lambda: rollout.write_rows_plain(p_k, node, rows, mask), 50)
            k2_lib, _ = time_ms(lambda: p_k.__setitem__((b_idx, n_idx), r_idx), 200)
            b_ms, b_by = bound_ms(int(mask.sum()) * 2 * 8 * 128 * 4 + batch * (8 + 1), 0)
            records["write_rows"] = dict(
                max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain, bound_ms=b_ms, bound_by=b_by, library_ms=k2_lib
            )
            log(
                f"K2 write_rows: {shape} masked={int(mask.sum())}; kernel_ms={k2_ms:.5f} plain_ms={k2_plain:.5f} "
                f"library_ms={k2_lib:.5f} bound_ms={b_ms:.5f}; eager kernel_ms={k2_eager:.5f}"
            )
            del p_k, p_p, singles_p
        del trees
        torch.cuda.empty_cache()
    return records


def _same_trees(a, b, what: str) -> None:
    """Every tree array and the chosen actions of ``a`` (on the GPU) equal
    those of ``b`` (on the CPU)."""
    from bokego_tpu_torch.search import mcts

    for f in ("pstats", "root_stats", "n_nodes", "parent", "action", "value", "expanded", "terminal", "root"):
        x, y = getattr(a, f).cpu(), getattr(b, f)
        check(torch.equal(x.nan_to_num(7.0), y.nan_to_num(7.0)), f"GPU vs CPU: {f} differs ({what})")
    check(torch.equal(mcts.choose_action(a).cpu(), mcts.choose_action(b)), f"chosen actions differ ({what})")


def _random_roots(batch: int, n_moves: int, seed: int):
    """Positions of seeded random games, on the CPU."""
    from bokego_tpu_torch.env import rules, state as st

    roots = st.new_game_batch(batch, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    for _ in range(n_moves):
        legal = rules.legal_mask(roots)[:, :81].float()
        roots = rules.step(roots, torch.multinomial(legal, 1, generator=gen)[:, 0])
    return roots


def check_plain_search(dev) -> None:
    """Phase 8: the non-kernel search on the GPU against the CPU."""
    from bokego_tpu_torch.config import SearchConfig
    from bokego_tpu_torch.ops import rollout
    from bokego_tpu_torch.search import mcts, tree as tr
    from tests.torch_fake_eval import fake_evaluator

    fev = fake_evaluator()
    roots = _random_roots(4, 12, seed=3)

    def same(a, b, what):
        _same_trees(a, b, f"non-kernel search, {what}")

    def grow(cfg, where):
        states = roots.map(lambda x: x.to(where))
        return mcts.run_search(mcts.init_trees(states, fev, None, cfg), fev, None, cfg, 100)

    def regrow(cfg, where, compact):
        """The engine's re-root (with or without compaction) and a second search."""
        t = grow(cfg, where)
        t, ok = mcts.advance_root(t, mcts.choose_action(t))
        check(bool(ok.all()), "advance_root: the chosen child is missing")
        t = mcts.expand_roots(tr.compact(t) if compact else t, fev, None, cfg)
        return mcts.run_search(t, fev, None, cfg, 60)

    rollout.reset_launches()
    for eval_every in (1, 2):
        cfg = SearchConfig(expand_thresh=3, max_nodes=4096, eval_every=eval_every)
        gpu, cpu = grow(cfg, dev), grow(cfg, "cpu")
        same(gpu, cpu, f"eval_every={eval_every}")
        check(int(gpu.n_nodes.max()) > 82, "non-kernel search did not expand below the root")
        gpu, cpu = regrow(cfg, dev, True), regrow(cfg, "cpu", True)
        same(gpu, cpu, f"eval_every={eval_every}, after advance/compact/expand and a second search")
        check(gpu.root.tolist() == [0] * 4, "compact did not move the roots to slot 0")
        loose = regrow(cfg, dev, False)
        check(
            torch.equal(mcts.choose_action(loose), mcts.choose_action(gpu))
            and torch.equal(loose.root_stats, gpu.root_stats)
            and int(gpu.n_nodes.max()) < int(loose.n_nodes.min()),
            "a search continued with and without compact chose differently",
        )
    check(rollout.launches == {"descend_backprop": 0, "write_rows": 0}, "the non-kernel search launched a kernel")
    log("non-kernel search: GPU equals CPU at eval_every 1 and 2, before and after advance/compact/expand; compact leaves choices unchanged")


def analyze_ticks(eng, stream, k: int, what: str) -> int:
    """Phase 9's analyze check: ANALYZE_TICKS info lines of ``stream``, each
    equal in moves and visits to the top ``k`` recomputed on the host from
    the root rows copied to the CPU (visits pooled over the forest, a
    stable order: the lower action first among equal visits), and
    ``_analyze_stats(k)``'s actions equal to that order; then the stream
    ends on input.  Returns how many ticks had a tie among the listed
    children's visits (the order had to break it)."""
    import numpy as np

    from bokego_tpu_torch.coords import NN, unsquash
    from bokego_tpu_torch.search import tree as tr

    tied = 0
    for tick in range(ANALYZE_TICKS):
        line = next(stream)
        check(re.match(r"info move [A-HJ][1-9] visits \d+ winrate \d+ prior \d+ pv [A-HJ][1-9]", line) is not None,
              f"{what}: analyze line {line!r}")
        rows = eng._root_rows().cpu().numpy()
        has = rows[:, tr.C_CHILD, :NN] >= 0
        x = np.where(has.any(0), np.where(has, rows[:, tr.C_N, :NN], 0.0).sum(0), -1.0)
        order = np.argsort(-x, kind="stable")[:k]
        best = [int(a) for a in order if x[a] >= 0][::-1]  # the stream's ascending visit order
        shown = re.findall(r"info move (\S+) visits (\d+) ", line)
        check(shown == [(unsquash(a), str(int(x[a]))) for a in best],
              f"{what}: analyze tick {tick} shows {shown}, the host order is {[(unsquash(a), int(x[a])) for a in best]}")
        top_a = eng._analyze_stats(k)[0]
        check(top_a == order.tolist(), f"{what}: _analyze_stats({k}) gives {top_a}, the host order is {order.tolist()}")
        tied += any(int((x == x[a]).sum()) > 1 for a in best)
    eng._input[0] = "showboard"
    check(next(stream) == "\n", f"{what}: analyze did not end on input")
    eng._input[0] = None
    return tied


def serve_session(dev, params, fast: bool) -> dict:
    """Phase 9: one scripted GTP session in process; returns the launch counts."""
    from bokego_tpu_torch import cli, native
    from bokego_tpu_torch.config import EngineConfig
    from bokego_tpu_torch.coords import NN, squash
    from bokego_tpu_torch.gtp.engine import GTPEngine
    from bokego_tpu_torch.ops import rollout
    from bokego_tpu_torch.search import mcts

    flags = ["-r", str(SERVE_ROLLOUTS), "--no-ponder"] + (["--fast", "--forest", str(SERVE_FOREST)] if fast else [])
    args = cli.build_parser().parse_args(flags)
    scfg = cli.search_config(args, dev)
    check(scfg.use_kernel == fast and scfg.eval_every == (8 if fast else 1), f"unexpected search config {scfg}")
    ecfg = EngineConfig(time_lim=None, n_rollouts=args.r, pondering=False, forest_size=args.forest)
    eng = GTPEngine(mcts.net_evaluator(), params, scfg, ecfg, device=dev)
    eng.running = True
    name = "--fast --forest 8" if fast else "default"
    t0 = time.monotonic()
    eng.warm_up()
    torch.cuda.synchronize()
    log(f"engine ({name}): warm-up {time.monotonic() - t0:.2f} s, chunk of 8 rollouts {1e3 * eng._chunk_s:.2f} ms")
    rollout.reset_launches()

    def ok(cmd, want=None):
        out = eng.send(cmd)
        check(out.startswith("= ") and out.endswith("\n\n"), f"{name}: {cmd!r} -> {out!r}")
        check(want is None or out[2:].strip() == want, f"{name}: {cmd!r} -> {out!r}, expected {want!r}")
        return out[2:].strip()

    def fail(cmd, want):
        out = eng.send(cmd)
        check(out == f"? {want}\n\n", f"{name}: {cmd!r} -> {out!r}, expected an error {want!r}")

    gen_ms, gen_launches, gen_chunks, gen_full = [], [], [], []
    run_chunk, rollout_n = eng._run_chunk, eng.rollout

    def recorded_chunk(n):
        gen_chunks[-1].append(n)
        run_chunk(n)

    def recorded_rollout(n):
        out = rollout_n(n)
        gen_full[-1] = eng._pool_full()  # read before the move re-roots and compacts
        return out

    eng._run_chunk, eng.rollout = recorded_chunk, recorded_rollout

    def genmove(color):
        """A generated move: legal on the referee, no rebuild, same board."""
        referee = native.replay(eng._move_history, 5.5)
        gen_chunks.append([])
        gen_full.append(False)
        rebuilds, before = eng.rebuilds, dict(rollout.launches)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        vertex = ok(f"genmove {color}")
        torch.cuda.synchronize()
        gen_ms.append((time.monotonic() - t0) * 1e3)
        gen_launches.append({k: rollout.launches[k] - before[k] for k in before})
        check(re.fullmatch(r"[A-HJ][1-9]|PASS", vertex) is not None, f"{name}: genmove gave {vertex!r}")
        referee.play(squash(vertex))  # raises on an illegal move
        check(eng.state.board[0].cpu().numpy().tolist() == referee.board.tolist(), f"{name}: board differs from the referee's")
        check(eng.rebuilds == rebuilds, f"{name}: genmove {color} rebuilt the forest though the child was in the tree")
        return vertex

    check(eng.send("7 protocol_version") == "=7 2\n\n", f"{name}: framing with an id")
    for cmd in ("boardsize 9", "komi 5.5", "clear_board"):
        ok(cmd, "")
    rebuilds = eng.rebuilds
    ok("play black E5", "")
    check(eng.rebuilds == rebuilds, f"{name}: play into an expanded root rebuilt the forest")
    first = genmove("white")
    ok(f"play white {'A1' if first != 'A1' else 'J9'}", "")  # out of turn: a PASS goes in first
    check(eng._turn() == 4, f"{name}: out-of-turn play did not insert a pass (turn {eng._turn()})")
    ok("undo", "")
    check(eng._turn() == 2, f"{name}: undo did not restore the position before the inserted pass")
    fail("undo", "cannot undo")
    fail("play black E5", "illegal move")
    fail(f"play black {first}", "illegal move")
    fail("play black Z9", "invalid coordinate")
    fail("frobnicate", "unknown command 'frobnicate'")
    for i in range(6):
        genmove("black" if i % 2 == 0 else "white")
    check(len(eng._move_history) == 8, f"{name}: history {eng._move_history}")
    # Count mode: one chunk of 256, then chunks of 8; a move stops short of
    # that only where the node pool was full when it stopped.
    full_chunks = [256] * (SERVE_ROLLOUTS // 256) + [8] * (SERVE_ROLLOUTS % 256 // 8)
    for chunks, pool_full in zip(gen_chunks, gen_full):
        check(
            chunks == full_chunks or (pool_full and chunks == full_chunks[: len(chunks)]),
            f"{name}: a genmove ran the chunks {chunks} (pool full: {pool_full}), expected {full_chunks}",
        )
    check(gen_chunks[0] == full_chunks, f"{name}: the first genmove stopped early: {gen_chunks[0]}")
    if fast:
        # every K1 launch of a move belongs to a chunk it ran, and none is missing
        k1 = [g["descend_backprop"] for g in gen_launches]
        want_k1 = [sum(len(mcts.rollout_groups(c, 8)) for c in chunks) for chunks in gen_chunks]
        check(k1 == want_k1, f"K1 launches per genmove {k1}, expected {want_k1} from the chunks {gen_chunks}")
        check(k1[0] == 69, f"K1 launches of a full genmove {k1[0]}, expected 69")
    # Not claimed: one timed move, then the pondering rate on the next root
    # (both end early where the node pool fills up first).
    eng._run_chunk, eng.rollout = run_chunk, rollout_n
    eng.time_lim, eng.n_rollouts = 1.0, None
    referee = native.replay(eng._move_history, 5.5)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    vertex = ok("genmove black")
    torch.cuda.synchronize()
    timed = time.monotonic() - t0
    referee.play(squash(vertex))
    eng.time_lim, eng.n_rollouts = None, SERVE_ROLLOUTS
    t0, pondered = time.monotonic(), 0
    while time.monotonic() - t0 < 1.0 and eng.rollout(8):
        pondered += 8
    torch.cuda.synchronize()
    ponder_s = time.monotonic() - t0
    ponder_note = f"{pondered} rollouts per tree in {ponder_s:.3f} s" + (", then the pool was full" if eng._pool_full() else "")
    stream = eng.send("analyze white 20")
    check(next(stream) == "= \n", f"{name}: analyze did not open its stream")
    tied = {"searched root, k=3": analyze_ticks(eng, stream, 3, name)}
    check("X" in ok("showboard") and "O" in ok("showboard"), f"{name}: showboard")
    check(re.fullmatch(r"[BW]\+\d+\.\d|0", ok("final_score")) is not None, f"{name}: final_score before the end")
    ok("play white pass", "")
    ok("play black pass", "")
    score = ok("final_score")
    referee = native.replay(eng._move_history, 5.5)  # an independent board, rebuilt from the moves
    check(eng.state.board[0].cpu().numpy().tolist() == referee.board.tolist(), f"{name}: final board differs from the referee's")
    want = referee.resolved_score()
    check(score == (f"B+{want}" if want > 0 else f"W+{-want}" if want < 0 else "0"),
          f"{name}: final_score {score} is not the resolved score {want}")
    history = list(eng._move_history)
    check(len(history) == 11, f"{name}: history {history}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "session.sgf")
        text = ok(f"printsgf {path}")
        check(text.count(";") == len(history) + 1, f"{name}: printsgf wrote {text!r}")
        ok("clear_board", "")
        # a fresh root (no child has a visit yet): the first ticks list
        # children of few, often equal, visits; then every child at once
        stream = eng.send("analyze black 20")
        check(next(stream) == "= \n", f"{name}: analyze did not open its stream")
        tied["fresh root, k=3"] = analyze_ticks(eng, stream, 3, name)
        stream = eng.analyze(20, k=NN)
        check(next(stream) == "= \n", f"{name}: analyze did not open its stream")
        tied[f"k={NN}"] = analyze_ticks(eng, stream, NN, name)
        ok(f"loadsgf {path}", "white")
    check(eng._move_history == history and eng._turn() == len(history), f"{name}: loadsgf replayed {eng._move_history}")
    log(
        f"engine ({name}): analyze order held against the host's stable order in "
        f"{ANALYZE_TICKS * len(tied)} ticks; ticks with tied visits among the listed children: "
        + ", ".join(f"{w} {n} of {ANALYZE_TICKS}" for w, n in tied.items())
    )
    per_gen = {k: sum(g[k] for g in gen_launches) / len(gen_launches) for k in gen_launches[0]}
    log(
        f"engine ({name}): genmove at -r {SERVE_ROLLOUTS} ms {[round(x, 1) for x in gen_ms]}; launches per genmove {per_gen}; "
        f"timed move -t 1: {timed:.3f} s (overrun {timed - 1.0:+.3f} s, chunk {1e3 * eng._chunk_s:.2f} ms) -> {vertex}; "
        f"pondering {pondered / ponder_s:.0f} rollouts/s per tree x {eng.forest} trees ({ponder_note}); final_score {score}"
    )
    ok("quit", "")
    check(eng.send("protocol_version") is None, f"{name}: the engine answered after quit")
    counts = dict(rollout.launches)
    check(all((n > 0) == fast for n in counts.values()), f"{name}: kernel launches of the session {counts}")
    return counts


def check_leaf_parallel_search(dev) -> None:
    """Phases 11 and 12: leaf-parallel search and simulation mode on the GPU
    against the CPU (tolerance 0)."""
    from bokego_tpu_torch.config import SearchConfig
    from bokego_tpu_torch.ops import rollout
    from bokego_tpu_torch.search import leafpar, mcts
    from tests.torch_fake_eval import fake_evaluator, onehot_evaluator, stones_evaluator

    rollout.reset_launches()
    roots = _random_roots(8, 12, seed=4)
    cfg = SearchConfig(expand_thresh=2, max_nodes=2048)
    n = 128
    for ev_name, ev in (("plain evaluation", fake_evaluator()), ("fused evaluation", stones_evaluator())):
        for k in (1, 4, 8):
            grown = []
            for where in (dev, "cpu"):
                t = mcts.init_trees(roots.map(lambda x: x.to(where)), ev, None, cfg)
                grown.append(leafpar.run_search_k(t, ev, None, cfg, n, k))
            gpu, cpu = grown
            _same_trees(gpu, cpu, f"leaf-parallel K={k}, {ev_name}")
            check(gpu.root_stats[:, 0].tolist() == [float(n)] * 8, f"leaf-parallel K={k}: root visits {gpu.root_stats[:, 0].tolist()}")
            check(int(gpu.n_nodes.min()) > 82, f"leaf-parallel K={k} did not expand below the root")
            check(not bool(gpu.pstats[:, :, 1].any()), f"leaf-parallel K={k} left a virtual loss in Wq")
            if k == 1:
                seq = mcts.init_trees(roots.map(lambda x: x.to(dev)), ev, None, cfg)
                seq = mcts.run_search(seq, ev, None, cfg, n)
                check(
                    torch.equal(seq.pstats, gpu.pstats) and torch.equal(seq.root_stats, gpu.root_stats)
                    and torch.equal(seq.value.nan_to_num(7.0), gpu.value.nan_to_num(7.0)),
                    f"leaf-parallel K=1 differs from run_search ({ev_name})",
                )
    log("leaf-parallel search: GPU equals CPU at K = 1, 4, 8 (B=8, 128 rollouts, plain and fused evaluation); K=1 equals run_search")

    ev = onehot_evaluator()
    sim_roots = _random_roots(4, 20, seed=5)
    # one komi per board, so that the playouts do not all end the same way
    sim_roots.komi = torch.tensor([-20.0, 0.5, 5.5, 30.0])
    for what, kw, k in (
        ("eval_every=1", dict(), 0), ("eval_every=2", dict(eval_every=2), 0), ("leaf-parallel K=4", dict(), 4),
    ):
        cfg = SearchConfig(expand_thresh=2, max_nodes=1024, no_sim=False, max_turns=60, **kw)
        grown = []
        for where in (dev, "cpu"):
            gen = torch.Generator(device=where).manual_seed(6)
            t = mcts.init_trees(sim_roots.map(lambda x: x.to(where)), ev, None, cfg)
            if k:
                grown.append(leafpar.run_search_k(t, ev, None, cfg, 24, k, gen=gen))
            else:
                grown.append(mcts.run_search(t, ev, None, cfg, 24, gen=gen))
        gpu, cpu = grown
        _same_trees(gpu, cpu, f"simulation mode, {what}")
        wq = gpu.root_stats[:, 1].tolist()
        check(all(abs(x) <= 24 for x in wq) and len(set(wq)) > 1, f"simulation mode, {what}: root Wq {wq}")
        check(bool(gpu.pstats[:, :, 1].any()), f"simulation mode, {what}: no reward reached an edge")
    check(rollout.launches == {"descend_backprop": 0, "write_rows": 0}, "leaf-parallel search or simulation mode launched a kernel")
    log("simulation mode (one-hot playout policy): GPU equals CPU at eval_every 1 and 2 and leaf-parallel at K=4 (B=4, 24 rollouts)")


def serve_search_mode(dev, params, flags: list[str], moves: int) -> None:
    """Phase 13: one served session with ``flags`` (leaf-parallel search or
    simulation mode) in process."""
    from bokego_tpu_torch import cli, native
    from bokego_tpu_torch.config import EngineConfig
    from bokego_tpu_torch.coords import squash
    from bokego_tpu_torch.gtp import engine as gtp_engine
    from bokego_tpu_torch.ops import rollout
    from bokego_tpu_torch.search import mcts

    name = " ".join(flags)
    args = cli.build_parser().parse_args(flags + ["--no-ponder"])
    scfg = cli.search_config(args, dev)
    k = scfg.leaf_batch
    check(not scfg.use_kernel and scfg.eval_every == 1, f"{name}: unexpected search config {scfg}")
    check(scfg.no_sim != args.simulate and k == (args.leaf_batch or 1), f"{name}: unexpected search config {scfg}")
    ecfg = EngineConfig(time_lim=None, n_rollouts=args.r, pondering=False, forest_size=args.forest)
    # count the net forwards: leaf evaluations with their batch, playout plies
    base = mcts.net_evaluator()
    eval_batches, plies = [], []

    def evaluate_fts(net_params, fts):
        eval_batches.append(fts.shape[0])
        return base.evaluate_fts(net_params, fts)

    def policy_probs(net_params, states):
        plies.append(states.board.shape[0])
        return base.policy_probs(net_params, states)

    eng = gtp_engine.GTPEngine(
        base._replace(evaluate_fts=evaluate_fts, policy_probs=policy_probs), params, scfg, ecfg, device=dev
    )
    eng.running = True
    t0 = time.monotonic()
    eng.warm_up()
    torch.cuda.synchronize()
    log(f"engine ({name}): warm-up {time.monotonic() - t0:.2f} s, chunk of 8 {1e3 * eng._chunk_s:.2f} ms")
    rollout.reset_launches()

    def ok(cmd, want=None):
        out = eng.send(cmd)
        check(out.startswith("= ") and out.endswith("\n\n"), f"{name}: {cmd!r} -> {out!r}")
        check(want is None or out[2:].strip() == want, f"{name}: {cmd!r} -> {out!r}, expected {want!r}")
        return out[2:].strip()

    chunks, searched = [], []
    run_chunk, rollout_n = eng._run_chunk, eng.rollout

    def recorded_chunk(n):
        chunks[-1].append(n)
        run_chunk(n)

    def recorded_rollout(n):
        """genmove's own search: the chunks it ran, each root's visit growth,
        the forwards it made, and whether the pool stopped it."""
        chunks.append([])
        before = eng.trees.root_stats[:, 0].clone()
        n_evals, n_plies = len(eval_batches), len(plies)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = rollout_n(n)
        torch.cuda.synchronize()
        searched.append(dict(
            s=time.monotonic() - t0, grown=(eng.trees.root_stats[:, 0] - before).tolist(), full=eng._pool_full(),
            evals=eval_batches[n_evals:], plies=len(plies) - n_plies,
        ))
        return out

    eng._run_chunk, eng.rollout = recorded_chunk, recorded_rollout
    for cmd in ("boardsize 9", "komi 5.5", "clear_board", "play black E5"):
        ok(cmd, "")
    gen_s = []
    for i in range(moves):
        referee = native.replay(eng._move_history, 5.5)
        rebuilds = eng.rebuilds
        torch.cuda.synchronize()
        t0 = time.monotonic()
        vertex = ok(f"genmove {'white' if i % 2 == 0 else 'black'}")
        torch.cuda.synchronize()
        gen_s.append(time.monotonic() - t0)
        check(re.fullmatch(r"[A-HJ][1-9]|PASS", vertex) is not None, f"{name}: genmove gave {vertex!r}")
        referee.play(squash(vertex))  # raises on an illegal move
        check(eng.state.board[0].cpu().numpy().tolist() == referee.board.tolist(), f"{name}: board differs from the referee's")
        check(eng.rebuilds == rebuilds, f"{name}: a genmove rebuilt the forest though the child was in the tree")
    check(re.fullmatch(r"[BW]\+\d+\.\d|0", ok("final_score")) is not None, f"{name}: final_score")
    check("X" in ok("showboard"), f"{name}: showboard")
    # Count mode's chunks (256 while 256 are left, then 8), each run as
    # ceil(chunk / K) steps of K rollouts: the roots grow by exactly that.
    full_chunks = [gtp_engine.BIG_CHUNK] * (args.r // gtp_engine.BIG_CHUNK)
    full_chunks += [gtp_engine.ROLLOUT_CHUNK] * -(-(args.r % gtp_engine.BIG_CHUNK) // gtp_engine.ROLLOUT_CHUNK)
    asked = sum(-(-c // k) * k for c in full_chunks)
    for ran, rec in zip(chunks, searched):
        check(ran == full_chunks or (rec["full"] and ran == full_chunks[: len(ran)]), f"{name}: chunks {ran}, expected {full_chunks}")
        want = float(sum(-(-c // k) * k for c in ran))
        check(rec["grown"] == [want] * eng.forest, f"{name}: root visits grew by {rec['grown']}, expected {want}")
        check(all(b == k * eng.forest for b in rec["evals"]), f"{name}: leaf evaluation batches {set(rec['evals'])}")
    check(chunks[0] == full_chunks and searched[0]["grown"][0] == asked, f"{name}: the first genmove ran {chunks[0]}")
    if args.simulate:
        playouts = sum(sum(-(-c // k) for c in ran) for ran in chunks)
        total_plies = sum(rec["plies"] for rec in searched)
        check(total_plies >= playouts, f"{name}: {total_plies} playout plies in {playouts} playouts")
        sim_note = f"; {playouts} playouts of {k * eng.forest} leaves, {total_plies / playouts:.1f} plies per playout"
    else:
        check(not plies, f"{name}: {len(plies)} playout plies without --simulate")
        sim_note = ""
    rate = [rec["grown"][0] / rec["s"] for rec in searched]
    log(
        f"engine ({name}): s/genmove {[round(x, 3) for x in gen_s]}; rollouts per tree and genmove "
        f"{[int(rec['grown'][0]) for rec in searched]} (asked {args.r}, as chunks of K={k}: {asked}); rollouts/s per tree "
        f"{[round(x, 1) for x in rate]} x {eng.forest} trees; leaf evaluations per genmove "
        f"{[len(rec['evals']) for rec in searched]} at batch {k * eng.forest}{sim_note}"
    )
    ok("quit", "")
    check(eng.send("protocol_version") is None, f"{name}: the engine answered after quit")
    check(rollout.launches == {"descend_backprop": 0, "write_rows": 0}, f"{name}: kernel launches {rollout.launches}")


def _timed_match(black_flags: str, white_flags: str, path: str) -> tuple[bool, float, list]:
    """``gtp_match`` of two engine processes on the card (``python -m
    bokego_tpu_torch.cli`` with the shipped nets) over PIPE_MOVES moves, with
    the native referee; returns whether black won, the match's seconds and
    both processes, each timed from its start to its first reply
    (``start_s``) and per ``genmove`` (``move_s``).  It swaps the harness's
    ``GTPProcess`` for a timed one while it runs, so no other match may run
    beside it."""
    from bokego_tpu_torch.gtp import process

    procs = []

    class Timed(process.GTPProcess):
        def __init__(self, label, cmd, verbose=False):
            t0 = time.monotonic()
            super().__init__(label, cmd, verbose)
            self.start_s, self.move_s = time.monotonic() - t0, []
            procs.append(self)

        def genmove(self, color):
            t0 = time.monotonic()
            vertex = super().genmove(color)
            self.move_s.append(time.monotonic() - t0)
            return vertex

    plain, process.GTPProcess = process.GTPProcess, Timed
    try:
        t0 = time.monotonic()
        won = process.gtp_match(f"{_ENGINE} {black_flags}", f"{_ENGINE} {white_flags}", sgf_path=path, max_moves=PIPE_MOVES)
        took = time.monotonic() - t0
    finally:
        process.GTPProcess = plain
    for proc in procs:
        check(proc.subproc.returncode == 0, f"{proc.id} engine process exited with {proc.subproc.returncode}")
    return won, took, procs


def serve_process(work: str) -> None:
    """Phase 10: the engine as a subprocess: one process through
    ``GTPProcess``, then ``gtp_match`` between two engine processes on the
    card, and a count-mode pair played twice."""
    from bokego_tpu_torch import native, sgf
    from bokego_tpu_torch.coords import squash
    from bokego_tpu_torch.gtp.process import GTPProcess, gtp_match

    flags, moves = "-r 64 --fast --forest 8", 4
    t0 = time.monotonic()
    proc = GTPProcess("count", f"{_ENGINE} {flags}")
    try:
        start_s = time.monotonic() - t0
        check(proc.name == "bokego-tpu-torch", f"process name {proc.name!r}")
        proc.boardsize(9), proc.komi(5.5), proc.clear_board()
        referee = native.NativeBoard(5.5)
        took = []
        for i in range(moves):
            t0 = time.monotonic()
            vertex = proc.genmove("black" if i % 2 == 0 else "white").upper()
            took.append(round(time.monotonic() - t0, 3))
            check(re.fullmatch(r"[A-HJ][1-9]|PASS", vertex) is not None, f"process genmove gave {vertex!r}")
            referee.play(squash(vertex))
        check(re.fullmatch(r"[BW]\+\d+\.\d|0", proc.final_score()) is not None, "process final_score")
        check("X" in proc.showboard(), "process showboard")
    finally:
        proc.close()
    check(proc.subproc.returncode == 0, f"engine process exited with {proc.subproc.returncode}")
    log(f"engine process ({flags}): started in {start_s:.1f} s, {moves} legal moves in {took} s each, exit code 0")

    # The match: the --fast engine (K1/K2 at B=8, levels=8) as black against
    # the timed default engine, both processes on the card, with the native
    # referee the session above played on.
    path = os.path.join(work, "match.sgf")
    won, took, procs = _timed_match("-r 64 --fast --forest 8", "-t 0.5", path)
    text = open(path).read()
    played, result = sgf.read_moves(path), sgf.read_result(path)
    check(0 < len(played) <= PIPE_MOVES, f"pipe match: {len(played)} moves read back")
    native.replay(played)  # raises on an illegal move
    check(result is not None and re.fullmatch(r"[BW]\+[\dR.]+|0", result) is not None, f"pipe match result {result!r}")
    check("F" not in result and "truncated" not in text, f"pipe match truncated: {result!r}")
    check(won == result.startswith("B"), f"pipe match returned {won} for {result!r}")
    sides = "; ".join(
        f"{p.id} started in {p.start_s:.2f} s, {statistics.mean(p.move_s):.3f} s/move over {len(p.move_s)}"
        for p in procs
    )
    log(f"pipe match (black -r 64 --fast --forest 8, white -t 0.5): {len(played)} moves, {result}, {took:.2f} s; {sides}")

    # The same count-mode pair twice, side by side: equal SGFs are not a
    # contract (cuDNN may choose other algorithms in another process), so
    # only printed.
    paths = [os.path.join(work, f"pair{i}.sgf") for i in range(2)]
    t0 = time.monotonic()
    with ThreadPoolExecutor(2) as pool:
        games = [pool.submit(gtp_match, f"{_ENGINE} -r 64", f"{_ENGINE} -r 64 --fast --forest 8", sgf_path=path,
                             max_moves=PIPE_MOVES) for path in paths]
        for game in games:
            game.result()
    texts = [open(path).read() for path in paths]
    log(f"count pair (black -r 64, white -r 64 --fast --forest 8), two games side by side in "
        f"{time.monotonic() - t0:.2f} s: {[sgf.read_result(path) for path in paths]}; the two SGFs are "
        f"{'equal' if texts[0] == texts[1] else 'NOT equal'}")


def serving_phases(dev, roots):
    """Phases 7-13; returns (records, launch counts) of K1/K2 on the --fast
    engine's path."""
    from bokego_tpu_torch.config import POLICY_WEIGHTS, VALUE_WEIGHTS
    from bokego_tpu_torch.models import nets

    params = {"policy": nets.load_policy(POLICY_WEIGHTS, device=dev), "value": nets.load_value(VALUE_WEIGHTS, device=dev)}
    records = check_serving_kernels(dev, params, roots)
    check_plain_search(dev)
    default_counts = serve_session(dev, params, fast=False)
    fast_counts = serve_session(dev, params, fast=True)
    log(f"served sessions: launches default {default_counts}, --fast {fast_counts}")
    check_leaf_parallel_search(dev)
    r = str(SERVE_ROLLOUTS)
    serve_search_mode(dev, params, ["-r", r, "--leaf-batch", "8"], moves=4)
    serve_search_mode(dev, params, ["-r", r, "--leaf-batch", "16", "--forest", str(SERVE_FOREST)], moves=4)
    serve_search_mode(dev, params, ["-r", str(SIM_ROLLOUTS), "--simulate"], moves=2)
    del params
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gtp_") as tmp:
        serve_process(tmp)
    return records, fast_counts


def _sl_step_gpu_vs_cpu(dev, kind: str, net, fts, targets) -> dict:
    """Phase 15: one SL step (train-mode BatchNorm, Adam) of the same net on
    the same batch on the GPU and on the CPU: the loss, every gradient and
    the updated running statistics, held by :func:`_same_sl_step`."""
    from bokego_tpu_torch.train import sl

    loss_fn = sl.value_loss if kind == "value" else sl.policy_loss
    out = []
    for d in (dev, torch.device("cpu")):
        n = copy.deepcopy(net).to(d).train()
        opt = sl.make_optimizer(n, 1e-3)
        loss = sl.train_step(n, opt, loss_fn, fts.to(d), targets.to(d))
        out.append(_sl_result(loss, n))
    return _same_sl_step(kind, *out, what="step")


def _sl_result(loss, net) -> tuple:
    """(loss, gradients, running statistics) of a net after an SL step, on the CPU."""
    return (float(loss), {k: p.grad.cpu() for k, p in net.named_parameters()},
            {k: v.cpu() for k, v in net.state_dict().items() if "running" in k})


def _same_sl_step(kind: str, gpu: tuple, cpu: tuple, what: str) -> dict:
    """A step's results on the GPU against the CPU.  cuDNN and the CPU sum in
    different orders, so the loss is held to rtol 1e-4, the statistics to
    rtol 1e-4 + atol 1e-5, and each gradient tensor to a relative error
    (Frobenius) of 1e-2: a ReLU whose input lies within rounding of 0 passes
    or blocks its gradient depending on that order.  The biases that feed a
    BatchNorm have a gradient of 0 in real arithmetic; theirs are held to
    1e-4 of the largest gradient norm instead."""
    (lg, gg, sg), (lc, gc, sc) = gpu, cpu
    check(abs(lg - lc) <= 1e-4 * abs(lc), f"SL {kind} {what} loss GPU {lg} vs CPU {lc}")
    bn_fed = {f"conv.{i}.bias" for i in range(0, 21, 3)} | {"lin1.bias"}
    scale = max(float(g.norm()) for g in gc.values())
    errs = {k: float((gg[k] - gc[k]).norm() / gc[k].norm().clamp(min=1e-30)) for k in gc if k not in bn_fed}
    noise = {k: float(gg[k].norm() + gc[k].norm()) / scale for k in gc if k in bn_fed}
    worst = max(errs, key=errs.get)
    log(f"SL {kind} {what}: gradient relative errors GPU vs CPU, largest {worst} {errs[worst]:.3g}, median "
        f"{sorted(errs.values())[len(errs) // 2]:.3g}; BatchNorm-fed biases at most {max(noise.values()):.3g} of the scale")
    check(errs[worst] <= 1e-2, f"SL {kind} {what} gradients GPU vs CPU: {worst} relative error {errs[worst]}")
    check(max(noise.values()) <= 1e-4, f"SL {kind} {what}: BatchNorm-fed bias gradients {noise}")
    worst = errs[worst]
    for k in sc:
        check(torch.allclose(sg[k], sc[k], rtol=1e-4, atol=1e-5), f"SL {kind} {what} {k} GPU vs CPU")
    return {"loss_gpu": lg, "loss_cpu": lc, "grad_rel_err": worst}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(dev, fn):
    torch.cuda.synchronize(dev)
    t0 = time.monotonic()
    out = fn()
    torch.cuda.synchronize(dev)
    return out, time.monotonic() - t0


def training_phases(dev) -> dict:
    """Phases 14-20: the training stack at full width (128-channel nets,
    the shipped ``policy_17.pt`` / ``value_r2.pt``); returns the figures."""
    import numpy as np

    from bokego_tpu_torch.config import POLICY_WEIGHTS, SearchConfig, VALUE_WEIGHTS
    from bokego_tpu_torch.env import rules
    from bokego_tpu_torch.models import nets
    from bokego_tpu_torch.ops import rollout
    from bokego_tpu_torch.train import alphazero as az
    from bokego_tpu_torch.train import data, gendata, genvals, reinforce, sl
    from tests.torch_fake_eval import fake_evaluator

    figures = {}
    policy = nets.load_policy(POLICY_WEIGHTS, device=dev)
    value = nets.load_value(VALUE_WEIGHTS, device=dev)
    rollout.reset_launches()
    work = tempfile.mkdtemp(prefix="chip_smoke_train_")

    # 14. gendata: self-play of the shipped policy into packed shards (x8 D4)
    gen = torch.Generator(device=dev).manual_seed(10)
    traj, dt = _timed(dev, lambda: gendata.generate(gen, policy, GEN_BATCH, max_turns=70))
    t0 = time.monotonic()
    packed = gendata.trajectory_to_packed(traj, augment=True)
    paths = data.save_shards(os.path.join(work, "sp"), packed, shard_size=131072)
    dt_pack = time.monotonic() - t0
    moves = int((traj.actions < 81).sum())
    check(len(packed) == 8 * moves and not bool(traj.final.invalid.any()), "gendata: packed size or illegal move")
    figures["gendata"] = dict(games=GEN_BATCH, plies=71, moves=moves, selfplay_s=dt, moves_per_s=moves / dt,
                              pack_s=dt_pack, packed_positions=len(packed))
    log(f"gendata: B={GEN_BATCH} max_turns=70: {moves} moves in {dt:.3f} s ({moves / dt:.1f} positions/s of "
        f"self-play); packed x8 into {len(paths)} shards of {len(packed)} positions in {dt_pack:.3f} s")

    # 15. one SL step, GPU vs CPU, policy and value, on the first B positions
    shards = data.ShardedDataset(paths)
    fts, moves_t = next(shards.batches(SL_BATCH, np.random.default_rng(0), device=dev))
    outcome = torch.where(rules.score(traj.final) > 0, 1.0, -1.0)  # black's result per game
    step_checks = {
        "policy": _sl_step_gpu_vs_cpu(dev, "policy", policy, fts, torch.as_tensor(moves_t, device=dev).long()),
        "value": _sl_step_gpu_vs_cpu(dev, "value", value, fts, torch.ones(SL_BATCH, device=dev)),
    }
    log(f"SL step GPU vs CPU (B={SL_BATCH}): {step_checks}")

    # 16. SL at B=SL_BATCH from the shards: the policy on the moves, the
    # value net on each game's outcome from the side to move
    n = SL_STEPS * SL_BATCH
    keep = (traj.actions < 81).cpu().numpy().reshape(-1)  # the packed positions, in (ply, game) order
    game = np.tile((np.arange(keep.size) % GEN_BATCH)[keep], 8)
    z = outcome.cpu().numpy()[game] * np.where(packed.turn == 0, 1.0, -1.0)
    subsets = {
        "policy": data.PackedDataset(packed.boards[:n], packed.ko[:n], packed.last[:n], packed.turn[:n],
                                     packed.targets[:n], False),
        "value": data.PackedDataset(packed.boards[:n], packed.ko[:n], packed.last[:n], packed.turn[:n],
                                    z[:n].astype(np.float32), True),
    }
    for kind, net0 in (("policy", policy), ("value", value)):
        net = copy.deepcopy(net0)
        state, dt = _timed(dev, lambda: sl.train(subsets[kind], net, kind=kind, batch_size=SL_BATCH, lr=1e-4,
                                                 log_every=SL_STEPS // 4, log_fn=log))
        check(len(state.losses) == 4 and all(np.isfinite(state.losses)), f"SL {kind}: losses {state.losses}")
        figures[f"sl_{kind}"] = dict(steps=SL_STEPS, batch=SL_BATCH, s=dt, ms_per_step=1e3 * dt / SL_STEPS,
                                     positions_per_s=n / dt, losses=state.losses, step_gpu_vs_cpu=step_checks[kind])
        log(f"SL {kind}: {SL_STEPS} steps at B={SL_BATCH} in {dt:.3f} s: {1e3 * dt / SL_STEPS:.3f} ms/step, "
            f"{n / dt:.1f} positions/s; losses {[round(x, 4) for x in state.losses]}")
        del net

    # 17. genvals: one batch of GEN_BATCH labelled positions, resolved labels
    gen = torch.Generator(device=dev).manual_seed(11)
    samples, dt = _timed(dev, lambda: genvals.generate(gen, policy, policy, GEN_BATCH))
    rows = genvals.samples_to_rows(samples)
    check(len(rows) > GEN_BATCH // 2 and {v for *_, v in rows} <= {0, 1}, f"genvals: {len(rows)} rows")
    figures["genvals"] = dict(batch=GEN_BATCH, samples=len(rows), s=dt, positions_per_s=len(rows) / dt)
    log(f"genvals: B={GEN_BATCH}: {len(rows)} labelled positions in {dt:.3f} s ({len(rows) / dt:.1f} positions/s)")

    # 18. one REINFORCE iteration (-b 16 --max-turns 70) against a pool copy
    net, opp = copy.deepcopy(policy), copy.deepcopy(policy)
    timings = []
    gen = torch.Generator(device=dev).manual_seed(12)
    res, dt = _timed(dev, lambda: reinforce.train_epoch(gen, net, opp, n_iters=1, batch_games=16, max_turns=70,
                                                        log_fn=log, timings=timings))
    check(len(res.winrates) == 2 and any(not torch.equal(a, b) for a, b in zip(net.parameters(), opp.parameters())),
          "REINFORCE: no update")
    figures["reinforce"] = dict(s_per_iteration=dt, colour_batches=timings)
    log(f"REINFORCE: one iteration (2 x 16 games, 70 turns) in {dt:.3f} s: {timings}")
    del net, opp

    # 19. AlphaZero trajectory GPU vs CPU (deterministic evaluator,
    # temperature 0, no noise), then one iteration at full width
    cfg = SearchConfig(expand_thresh=2, no_sim=True, max_nodes=128, noise_weight=0.0, max_turns=20)
    trajs = [az.selfplay_with_targets(torch.Generator(device=d).manual_seed(0), fake_evaluator(), None, cfg, 6, 8, 24,
                                      device=d) for d in (dev, "cpu")]
    for f in ("board", "turn", "ko", "last_move"):
        check(torch.equal(getattr(trajs[0].states, f).cpu(), getattr(trajs[1].states, f)), f"AZ trajectory {f} GPU vs CPU")
    check(torch.equal(trajs[0].dists.cpu(), trajs[1].dists) and torch.equal(trajs[0].live.cpu(), trajs[1].live),
          "AZ visit distributions GPU vs CPU")
    log("AZ trajectory (B=6, 8 moves, 24 rollouts, temperature 0, no noise): GPU equals CPU")
    pol, val = copy.deepcopy(policy), copy.deepcopy(value)
    timings = []
    state, dt = _timed(dev, lambda: az.train(0, pol, val, iters=1, batch=AZ_BATCH, n_moves=AZ_MOVES,
                                             n_rollouts=AZ_ROLLOUTS, log_fn=log, timings=timings))
    check(any(not torch.equal(a, b) for a, b in zip(pol.parameters(), policy.parameters())), "AZ: no policy update")
    figures["alphazero"] = dict(batch=AZ_BATCH, moves=AZ_MOVES, rollouts=AZ_ROLLOUTS, s_per_iteration=dt, **timings[0])
    log(f"AlphaZero: one iteration (B={AZ_BATCH}, {AZ_MOVES} moves, {AZ_ROLLOUTS} rollouts) in {dt:.3f} s: "
        f"self-play {timings[0]['selfplay_s']:.3f} s, update {timings[0]['update_s']:.3f} s")
    del pol, val, state

    counts = dict(rollout.launches)
    check(all(v == 0 for v in counts.values()), f"kernel launches on the training phases: {counts}")
    log(f"training phases: kernel launches {counts}")
    del policy, value
    torch.cuda.empty_cache()

    # 20. every training entry point once as a process, at a small size
    figures["clis"] = train_clis(work)
    return figures


def train_clis(work: str) -> dict:
    """Phase 20: ``python -m bokego_tpu_torch.bin.<name>`` on the GPU (the
    default device), each at a small size: in three waves of processes that
    run side by side, each wave reading what the waves before it wrote."""
    from bokego_tpu_torch.config import POLICY_WEIGHTS, VALUE_WEIGHTS

    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": root}
    waves = [
        [
            ("gen_policy_data", ["-n", "64", "--batch", "64", "--max-turns", "30", "-o", "cli", "--packed",
                                 "--policy", POLICY_WEIGHTS]),
            ("gen_policy_data", ["-n", "16", "--batch", "16", "--max-turns", "20", "-o", "cli.csv"]),
            ("genvals", ["-n", "1", "--batch", "1024", "--max-turns", "30", "--min-r", "10", "--max-r", "20",
                         "-o", "cli_v.csv", "--sl", POLICY_WEIGHTS]),
            ("selfplay", ["-e", "1", "-n", "1", "-b", "8", "--max-turns", "30", "-w", "cli_pool", "-f", "cli_rl.txt"]),
            ("alphazero", ["--iters", "1", "--batch", "4", "--moves", "6", "--rollouts", "16", "-o", "cli_az",
                           "--policy", POLICY_WEIGHTS, "--value", VALUE_WEIGHTS]),
        ],
        [
            ("process_data", ["cli.csv", "cli_shard", "--shards", "--shard-size", "4096"]),
            ("process_data", ["cli.csv", "cli.npz"]),
            ("train", ["-d", "cli-c000-00000.pshard.npz", "--kind", "policy", "--bs", "256", "--lr", "1e-4",
                       "-o", "cli_policy.pt"]),
            ("train", ["-d", "cli_v.csv", "--kind", "value", "--bs", "256", "--init-from-policy", POLICY_WEIGHTS,
                       "-o", "cli_value.pt"]),
            ("alphazero", ["--iters", "1", "--batch", "4", "--moves", "6", "--rollouts", "16", "-o", "cli_az",
                           "--resume"]),
        ],
        [
            ("train", ["-d", "cli.npz", "--kind", "policy", "--bs", "64", "-c", "cli_policy.pt", "-o", "cli_policy2.pt"]),
        ],
    ]
    took = {}
    for wave in waves:
        t0 = time.monotonic()
        procs = [
            (name, args, subprocess.Popen([sys.executable, "-m", f"bokego_tpu_torch.bin.{name}", *args], cwd=work,
                                          env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
            for name, args in wave
        ]
        for name, args, proc in procs:
            out, err = proc.communicate(timeout=300)
            dt = time.monotonic() - t0
            check(proc.returncode == 0, f"bin.{name} {args} exited {proc.returncode}: {err[-2000:]}")
            took.setdefault(name, []).append(round(dt, 2))
            log(f"bin.{name} {' '.join(args)}: exit 0, {dt:.1f} s into its wave of {len(wave)}; "
                f"last line: {out.strip().splitlines()[-1]!r}")
    check(os.path.exists(os.path.join(work, "cli_az_ckpt.pt")), "alphazero wrote no resume checkpoint")
    with open(os.path.join(work, "cli_az_iter.txt")) as f:
        check(f.read() == "2", "alphazero --resume did not continue at iteration 2")
    return took


def _sl_inputs(batch: int, seed: int):
    """Features of seeded random positions with a legal move and a +-1
    outcome per position, on the CPU: the dp SL steps' batch."""
    from bokego_tpu_torch.env import rules
    from bokego_tpu_torch.features import features_batch

    roots = _random_roots(batch, 20, seed)
    gen = torch.Generator().manual_seed(seed)
    moves = torch.multinomial(rules.legal_mask(roots)[:, :81].float(), 1, generator=gen)[:, 0]
    outcomes = torch.randint(0, 2, (batch,), generator=gen).float() * 2 - 1
    return features_batch(roots), {"policy": moves, "value": outcomes}


def _dp_sl_step(kind: str, state_dict, fts, targets, mesh) -> tuple:
    """One SL step of ``kind`` from ``state_dict`` on ``mesh``'s device: this
    rank's rows of the global batch, the dp step."""
    from bokego_tpu_torch.models import nets
    from bokego_tpu_torch.parallel import mesh as mesh_lib
    from bokego_tpu_torch.train import sl

    net = (nets.PolicyNet if kind == "policy" else nets.ValueNet)()
    net.load_state_dict(state_dict)
    net = net.to(mesh.device).train()
    loss = sl.train_step(
        net, sl.make_optimizer(net, 1e-3), sl.policy_loss if kind == "policy" else sl.value_loss,
        mesh_lib.shard_rows(fts.to(mesh.device), mesh), mesh_lib.shard_rows(targets.to(mesh.device), mesh), mesh,
    )
    return _sl_result(loss, net)


def _dp_rank(mesh, path: str) -> None:
    """Phases 23 and 25, on one rank: sharded self-play of the job's games
    with the deterministic evaluator at the bench configuration, then the dp
    SL step of the policy and of the value net on ``mesh``'s card and on the
    CPU (over gloo), and with the job's ``kernel_check`` rank 0's kernel
    records at its shapes; rank 0 saves the results to ``path + ".out"``."""
    import torch.distributed as dist

    from bokego_tpu_torch.config import BENCH_CONFIG
    from bokego_tpu_torch.device import fp32_only
    from bokego_tpu_torch.ops import rollout
    from bokego_tpu_torch.parallel.selfplay import selfplay_sharded
    from tests.torch_fake_eval import fake_evaluator

    fp32_only()
    job = torch.load(path, weights_only=True)
    rollout.reset_launches()
    _sync(mesh.device)
    t0 = time.monotonic()
    res = selfplay_sharded(mesh, None, fake_evaluator(), BENCH_CONFIG, job["batch"], job["moves"], BENCH_CONFIG.n_rollouts)
    _sync(mesh.device)
    out = {"selfplay": [res.actions.cpu(), res.scores.cpu(), *(t.cpu() for t in res.final.tensors())],
           "selfplay_s": time.monotonic() - t0, "launches": dict(rollout.launches)}
    cpu_group = mesh.group if dist.get_backend() == "gloo" else dist.new_group(backend="gloo")
    cpu_mesh = dataclasses.replace(mesh, device=torch.device("cpu"), group=cpu_group)
    for kind in ("policy", "value"):
        out[kind] = [_dp_sl_step(kind, job[f"{kind}_sd"], job["fts"], job[kind], m) for m in (mesh, cpu_mesh)]
    dist.barrier(group=cpu_group)
    if mesh.rank == 0:
        if job["kernel_check"]:
            # K1 and K2 against their plain versions at this rank's shapes
            # (B/k games, the bench pool and levels): the sharded path's
            # records, taken once the other rank has left the card
            per = job["batch"] // mesh.size
            roots = _random_roots(per, 20, seed=23).map(lambda x: x.to(mesh.device))
            out["records"] = check_kernels_at(
                mesh.device, fake_evaluator(), None, roots, ((per, BENCH_CONFIG.max_nodes, 200, False),),
                levels=BENCH_CONFIG.kernel_levels, record_at=(per, BENCH_CONFIG.max_nodes),
            )
        torch.save(out, path + ".out")


def _dp_pair(dev, backend: str | None, device, sl_inputs, state_dicts, want, kernel_check: bool = False) -> dict:
    """Two ranks of :func:`_dp_rank` (``device``, ``backend`` as
    ``mesh.spawn`` takes them): the sharded self-play equal to the
    unsharded ``want`` game for game, 51 K1 launches a move on each rank,
    and the dp SL step on the card within phase 15's bounds of the same
    2-rank step on the CPU.  With ``kernel_check``, the figures hold rank
    0's kernel records at its shapes (``records``)."""
    from bokego_tpu_torch.parallel import mesh as mesh_lib

    fts, targets = sl_inputs
    name = f"{backend or 'nccl'} 2 ranks on {device or 'cuda:0 and cuda:1'}"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
        path = os.path.join(tmp, "job.pt")
        torch.save({"fts": fts, **targets, **{f"{k}_sd": v for k, v in state_dicts.items()}, "batch": DP_BATCH,
                    "moves": DP_MOVES, "kernel_check": kernel_check}, path)
        t0 = time.monotonic()
        mesh_lib.spawn(_dp_rank, 2, path, device=device, backend=backend)
        spawn_s = time.monotonic() - t0
        out = torch.load(path + ".out", weights_only=True)
    actions, scores, *final = out["selfplay"]
    check(torch.equal(actions, want.actions.cpu()), f"{name}: sharded self-play actions differ from unsharded")
    check(torch.equal(scores, want.scores.cpu()), f"{name}: sharded scores differ from unsharded")
    for got, ref in zip(final, want.final.tensors()):
        check(torch.equal(got, ref.cpu()), f"{name}: sharded final states differ from unsharded")
    check(out["launches"]["descend_backprop"] == 51 * DP_MOVES, f"{name}: K1 launches on rank 0 {out['launches']}")
    check(out["launches"]["write_rows"] > 0, f"{name}: K2 never launched on rank 0")
    steps = {kind: _same_sl_step(kind, *out[kind], what=f"dp step, {name}") for kind in ("policy", "value")}
    log(f"data parallel ({name}): self-play B=2x{DP_BATCH // 2} x {DP_MOVES} moves equals unsharded B={DP_BATCH} "
        f"game for game ({1e3 * out['selfplay_s'] / DP_MOVES:.2f} ms/move on rank 0, launches {out['launches']}); "
        f"dp SL step on the card within phase 15's bounds of the CPU's; spawn and run {spawn_s:.1f} s")
    figures = dict(selfplay_ms_per_move_rank0=1e3 * out["selfplay_s"] / DP_MOVES, spawn_s=spawn_s, sl=steps,
                   launches_rank0=out["launches"])
    if kernel_check:
        figures["records"] = out["records"]
    return figures


def dp_phases(dev, params) -> tuple[dict, dict, dict]:
    """Phases 21-25 (data parallelism); returns the K1/K2 launch counts of
    the sharded path (rank 0 of phase 23), its kernel records (at rank 0's
    shapes) and the figures."""
    import torch.distributed as dist

    from bokego_tpu_torch.config import BENCH_BATCH as BATCH, BENCH_CONFIG as CFG
    from bokego_tpu_torch.config import POLICY_WEIGHTS, VALUE_WEIGHTS
    from bokego_tpu_torch.models import nets
    from bokego_tpu_torch.ops import rollout
    from bokego_tpu_torch.parallel import mesh as mesh_lib
    from bokego_tpu_torch.parallel.selfplay import selfplay, selfplay_sharded
    from bokego_tpu_torch.search import mcts
    from bokego_tpu_torch.train import sl
    from tests.torch_fake_eval import fake_evaluator

    figures = {}
    ev, fev = mcts.net_evaluator(), fake_evaluator()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pg_") as tmp:
        dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'rendezvous')}", world_size=1, rank=0)
        try:
            mesh = mesh_lib.get_mesh(1)
            check(mesh.device == torch.device("cuda", 0) and dist.get_backend() == "nccl", f"mesh {mesh}")
            # 21. the sharded main path at world 1: the real nets timed in
            # turns with the unsharded loop (unsharded, sharded, sharded,
            # unsharded), then the deterministic evaluator for equality
            runs = {
                "selfplay_sharded": lambda: selfplay_sharded(mesh, params, ev, CFG, BATCH, DP_MOVES, CFG.n_rollouts),
                "selfplay": lambda: selfplay(params, ev, CFG, BATCH, DP_MOVES, CFG.n_rollouts, device=dev),
            }
            ms, results = {name: [] for name in runs}, {}
            for name in ("selfplay", "selfplay_sharded", "selfplay_sharded", "selfplay"):
                torch.cuda.synchronize()
                rollout.reset_launches()
                t0 = time.monotonic()
                results[name] = runs[name]()
                torch.cuda.synchronize()
                ms[name].append(1e3 * (time.monotonic() - t0) / DP_MOVES)
                launched = dict(rollout.launches)
                check(launched["descend_backprop"] == 51 * DP_MOVES, f"{name}: K1 launches {launched}")
                check(launched["write_rows"] > 0, f"{name}: K2 never launched")
                if name == "selfplay_sharded":
                    counts = launched
            same_real = float((results["selfplay_sharded"].actions == results["selfplay"].actions).float().mean())
            got = selfplay_sharded(mesh, None, fev, CFG, BATCH, DP_MOVES, CFG.n_rollouts)
            want = selfplay(None, fev, CFG, BATCH, DP_MOVES, CFG.n_rollouts, device=dev)
            check(torch.equal(got.actions, want.actions) and torch.equal(got.scores, want.scores)
                  and all(torch.equal(a, b) for a, b in zip(got.final.tensors(), want.final.tensors())),
                  "NCCL world 1: sharded self-play differs from unsharded (deterministic evaluator)")
            figures["nccl_world1"] = dict(
                batch=BATCH, moves=DP_MOVES, ms_per_move_sharded=ms["selfplay_sharded"],
                ms_per_move_unsharded=ms["selfplay"], launches=counts, real_net_actions_equal_share=same_real,
            )
            log(f"data parallel (NCCL, world 1, cuda:0): selfplay_sharded B={BATCH} x {DP_MOVES} moves at the bench "
                f"config: ms/move {[round(x, 2) for x in ms['selfplay_sharded']]} (unsharded, before and after: "
                f"{[round(x, 2) for x in ms['selfplay']]}); launches {counts} (51 K1 a move); real nets: {same_real:.4f} "
                f"of the actions equal to unsharded; deterministic evaluator: equal move for move")
            # 22. the dp SL step at world 1 is train_step, bit for bit
            fts, targets = _sl_inputs(SL_BATCH, seed=21)
            state_dicts = {"policy": nets.load_policy(POLICY_WEIGHTS, device="cpu").state_dict(),
                           "value": nets.load_value(VALUE_WEIGHTS, device="cpu").state_dict()}
            deterministic = torch.backends.cudnn.deterministic
            torch.backends.cudnn.deterministic = True
            try:
                for kind in ("policy", "value"):
                    dp = _dp_sl_step(kind, state_dicts[kind], fts, targets[kind], mesh)
                    net = (nets.PolicyNet if kind == "policy" else nets.ValueNet)()
                    net.load_state_dict(state_dicts[kind])
                    net = net.to(dev).train()
                    loss = sl.train_step(net, sl.make_optimizer(net, 1e-3),
                                         sl.policy_loss if kind == "policy" else sl.value_loss,
                                         fts.to(dev), targets[kind].to(dev))
                    one = _sl_result(loss, net)
                    check(dp[0] == one[0] and all(torch.equal(dp[i][k], one[i][k]) for i in (1, 2) for k in one[i]),
                          f"dp SL {kind} step at world 1 differs from train_step")
            finally:
                torch.backends.cudnn.deterministic = deterministic
            log(f"data parallel (NCCL, world 1): the dp SL step (policy, value; B={SL_BATCH}) equals train_step bit for bit")
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()

    # 23. gloo, 2 ranks sharing cuda:0
    want = selfplay(None, fev, CFG, DP_BATCH, DP_MOVES, CFG.n_rollouts, device=dev)
    pair = _dp_pair(dev, "gloo", "cuda:0", (fts, targets), state_dicts, want, kernel_check=True)
    records = pair.pop("records")
    figures["gloo_2_ranks_cuda0"] = pair

    # 24. the dry run as a process
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-m", "bokego_tpu_torch.parallel.dryrun", "1"], capture_output=True,
                          text=True, timeout=300, env={**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))})
    lines = [line for line in proc.stdout.splitlines() if line.startswith("dryrun:")]
    check(proc.returncode == 0 and len(lines) == 3, f"dryrun 1 exited {proc.returncode}: {proc.stdout[-1000:]} {proc.stderr[-2000:]}")
    figures["dryrun_s"] = time.monotonic() - t0
    for line in lines:
        log(f"  {line}")
    log(f"dry run (python -m bokego_tpu_torch.parallel.dryrun 1): exit 0 in {figures['dryrun_s']:.1f} s")

    # 25. NCCL over two cards, where the machine has them
    if torch.cuda.device_count() >= 2:
        figures["nccl_2_cards"] = _dp_pair(dev, None, None, (fts, targets), state_dicts, want)
    else:
        log(f"data parallel over NCCL on two cards: not run, this machine has {torch.cuda.device_count()} GPU")
    return pair["launches_rank0"], records, figures


def _gate_curve(gen_n: int, wins: int, total: int) -> float:
    """M1's gate on one generation; returns its band."""
    w_tpu, n_tpu = CURVE_RECORDS[gen_n]
    p, p_tpu = wins / total, w_tpu / n_tpu
    band = CURVE_Z * (p_tpu * (1.0 - p_tpu) * (1.0 / n_tpu + 1.0 / total)) ** 0.5
    check(abs(p - p_tpu) <= band, f"policy curve gen {gen_n}: {p:.3f} outside {p_tpu:.3f} +- {band:.3f}")
    return band


def match_phases(dev) -> tuple[dict, dict, dict, dict]:
    """Phases 26-29 (M1-M4), the match harness (``bokego_tpu_torch.match``);
    returns the K1/K2 launch counts of the fidelity match and of the serving
    match, the kernel records at the fidelity match's shapes (B=8) and the
    figures."""
    from bokego_tpu_torch import cli
    from bokego_tpu_torch.config import POLICY_WEIGHTS, VALUE_WEIGHTS, SearchConfig
    from bokego_tpu_torch.coords import PASS
    from bokego_tpu_torch.env import rules
    from bokego_tpu_torch.match import common, config_match, fastmode_fidelity, policy_curve, serving_match
    from bokego_tpu_torch.match import weights_match
    from bokego_tpu_torch.models import nets
    from bokego_tpu_torch.ops import rollout
    from bokego_tpu_torch.search import mcts

    weights = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "weights")
    ev = mcts.net_evaluator(has_value=True)
    figures = {}

    # M1. the policy curve: generations 8 and 0 against policy_17, gated on the TPU record
    opp = nets.load_policy(POLICY_WEIGHTS, device=dev)
    rates = {}
    for gen_n, name in ((8, "rl8_policy.pt"), (0, "rl0_policy.pt")):
        mine = nets.load_policy(os.path.join(weights, name), device=dev)
        _sync(dev)
        t0 = time.monotonic()
        sides = policy_curve.generation(mine, opp, CURVE_GAMES, seed=11 + gen_n, device=dev)
        _sync(dev)
        dt = time.monotonic() - t0
        wins, total = policy_curve.wins_of(sides)
        for side in sides:
            check(bool(torch.isfinite(side.scores).all()), f"policy curve gen {gen_n}: non-finite scores")
            check(not bool(side.final.invalid.any()), f"policy curve gen {gen_n}: an illegal move")
            check(bool(rules.is_terminal(side.final, policy_curve.MAX_TURNS).all()), f"policy curve gen {gen_n}: unfinished")
        band = _gate_curve(gen_n, wins, total)
        rates[gen_n] = wins / total
        w_tpu, n_tpu = CURVE_RECORDS[gen_n]
        log(f"M1 {policy_curve.curve_line(gen_n, wins, total, dt)} | TPU record: gen {gen_n}: {w_tpu}/{n_tpu} = "
            f"{w_tpu / n_tpu:.3f}; gate +- {band:.3f} met")
        figures[f"curve_gen{gen_n}"] = dict(wins=wins, games=total, seconds=dt, band=band)
    check(rates[8] > rates[0], f"policy curve: gen 8 ({rates[8]:.3f}) does not beat gen 0 ({rates[0]:.3f})")
    del opp, mine, sides

    # M2. the anchor match, reduced: rl8 + value_own against policy_17 + value_r2
    pa = common.load_params(os.path.join(weights, "rl8_policy.pt"), os.path.join(weights, "value_own.pt"), dev)
    pb = common.load_params(POLICY_WEIGHTS, VALUE_WEIGHTS, dev)
    cfg = SearchConfig(expand_thresh=16, max_nodes=2048, no_sim=True)
    gen = torch.Generator(device=dev).manual_seed(7)
    _sync(dev)
    t0 = time.monotonic()
    wins, total, moves = 0, 0, []
    for a_is_black in (True, False):
        games = weights_match.play(gen, pa, pb, ev, ANCHOR_GAMES, cfg, ANCHOR_ROLLOUTS, a_is_black,
                                   resolved=True, device=dev)
        # a game ends by a pass (terminal) or runs every move to the cap
        check(torch.equal(games.done, (games.actions == 81).any(0)), "anchor: a game ended without a pass")
        check(bool((games.final.turn == weights_match.N_MOVES).all()), "anchor: a game stopped before the cap")
        check(bool(torch.isfinite(games.scores).all()), "anchor: non-finite scores")
        check(not bool(games.final.invalid.any()), "anchor: an illegal move")
        wins += int(games.won.sum())
        total += games.won.numel()
        moves += ((games.actions != 81).sum(0)).tolist()
    dt = time.monotonic() - t0
    p_hat = wins / total
    log(f"M2 anchor (rl8 + value_own vs policy_17 + value_r2, {ANCHOR_GAMES} a colour, expand_thresh 16, "
        f"max_nodes 2048, resolved): A won {wins}/{total} = {p_hat:.3f} +- {common.interval(p_hat, total):.3f} "
        f"({ANCHOR_ROLLOUTS} rollouts/move, {dt:.0f}s); moves before passing, a game: {moves}; not gated (TPU record at "
        f"400 rollouts, 16 a colour: 27/32 = 0.844 +- 0.126)")
    figures["anchor"] = dict(wins=wins, games=total, seconds=dt)
    del pa

    # M3. the fidelity match, reduced, and K1/K2 at its shapes
    params = pb
    # every move past the opening is searched by FAST in one of the two halves
    fast_moves = config_match.N_MOVES - common.OPEN_PLIES
    groups = mcts.rollout_groups(FIDELITY_ROLLOUTS, fastmode_fidelity.FAST.eval_every)
    check(max(n for n, _ in groups) == 8, f"fidelity: groups {groups}")
    gen = torch.Generator(device=dev).manual_seed(fastmode_fidelity.SEED)
    wins, total = 0, 0
    _sync(dev)
    rollout.reset_launches()
    t0 = time.monotonic()
    for fast_is_black in (True, False):
        games = config_match.play(gen, params, ev, FIDELITY_GAMES, fastmode_fidelity.FAST, fastmode_fidelity.EXACT,
                                  FIDELITY_ROLLOUTS, FIDELITY_ROLLOUTS, fast_is_black, device=dev)
        check(bool(torch.isfinite(games.scores).all()) and not bool(games.final.invalid.any()), "fidelity: bad finals")
        wins += int(games.won.sum())
        total += games.won.numel()
    _sync(dev)
    dt = time.monotonic() - t0
    fid_counts, fid_rollouts = dict(rollout.launches), rollout.kernel_rollouts
    check(fid_counts["descend_backprop"] == len(groups) * fast_moves,
          f"fidelity: K1 launches {fid_counts}, expected {len(groups)} x {fast_moves}")
    check(fid_rollouts == FIDELITY_ROLLOUTS * fast_moves, f"fidelity: K1 rollouts {fid_rollouts}")
    check(fid_counts["write_rows"] > 0, f"fidelity: K2 never launched {fid_counts}")
    pw = wins / total
    log(f"M3 fidelity ({FIDELITY_GAMES} a colour, {FIDELITY_ROLLOUTS} rollouts): fast winrate {pw:.3f} +/- "
        f"{common.interval(pw, total, 1e-9):.3f} (95% CI) over {total} games in {dt:.0f}s; FAST launches {fid_counts}, "
        f"{fid_rollouts} K1 rollouts = {len(groups)} launches x {fast_moves} searched moves, at most 8 rollouts a launch "
        f"(TPU record at 400 rollouts, 64 a colour: 0.586 +- 0.085)")
    figures["fidelity"] = dict(wins=wins, games=total, seconds=dt, launches=fid_counts, k1_rollouts=fid_rollouts,
                               launches_per_searched_move=len(groups))
    roots = _random_roots(64, 20, seed=8).map(lambda x: x.to(dev))
    fid_records = check_kernels_at(dev, ev, params, roots, ((FIDELITY_GAMES, 512, 200, False),), levels=6,
                                   record_at=(FIDELITY_GAMES, 512))
    check_kernels_at(dev, ev, params, roots, ((64, 512, 200, False),), levels=6, record_at=(64, 512))
    del roots

    # M4. the serving match: default against --fast --forest 8, timed
    def preset(flags):
        cfg = cli.search_config(cli.build_parser().parse_args(flags), dev)
        return {k: v for k, v in dataclasses.asdict(cfg).items() if k != "no_sim"}

    a = serving_match.make_engine(ev, params, preset([]), 1, MATCH_SECONDS, dev)
    b = serving_match.make_engine(ev, params, preset(["--fast"]), SERVE_FOREST, MATCH_SECONDS, dev)
    check(b.scfg.use_kernel and not a.scfg.use_kernel, "serving match: configurations")
    check(MATCH_OPENING % 2 == 0, "the opening leaves black to move")
    gen = torch.Generator(device=dev).manual_seed(11)
    _sync(dev)
    rollout.reset_launches()
    t0 = time.monotonic()
    results = []
    for g in range(MATCH_GAMES):
        opening = serving_match.sample_opening(gen, a, MATCH_OPENING)
        res = serving_match.play_game(a, b, g % 2 == 0, opening, lambda msg: log(f"M4{msg}"))
        check(res.how != "forfeit", f"serving match game {g + 1}: forfeit")
        ended = res.how == "resign" or len(res.moves) == serving_match.MAX_MOVES or res.moves[-2:] == [PASS, PASS]
        check(ended, f"serving match game {g + 1}: ended otherwise ({len(res.moves)} moves)")
        results.append(res)
        log(f"M4 game {g + 1}: A (default) as {'B' if g % 2 == 0 else 'W'} {'WON' if res.a_won else 'lost'} "
            f"({res.how}), {len(res.moves)} moves, genmove s mean {sum(res.seconds) / len(res.seconds):.3f} "
            f"max {max(res.seconds):.3f}")
    dt = time.monotonic() - t0
    sm_counts = dict(rollout.launches)
    check(sm_counts["descend_backprop"] > 0, f"serving match: the --fast side launched no K1 {sm_counts}")
    a_wins = sum(r.a_won for r in results)
    # B's genmoves: the opening has MATCH_OPENING plies, so the first generated move is black's
    b_moves = sum((len(r.seconds) + (g % 2 == 1)) // 2 for g, r in enumerate(results))
    log(f"M4 serving match: A winrate {a_wins / MATCH_GAMES:.3f} +/- "
        f"{common.interval(a_wins / MATCH_GAMES, MATCH_GAMES, 1e-9):.3f} over {MATCH_GAMES} games at "
        f"{MATCH_SECONDS}s/move ({dt:.0f}s); launches {sm_counts} over {b_moves} genmoves of the --fast side")
    figures["serving_match"] = dict(
        a_wins=a_wins, games=MATCH_GAMES, seconds=dt, launches=sm_counts, fast_genmoves=b_moves,
        moves=[len(r.moves) for r in results], how=[r.how for r in results],
        genmove_s_max=max(max(r.seconds) for r in results),
    )
    del a, b, params
    torch.cuda.empty_cache()
    return fid_counts, sm_counts, fid_records, figures


def tool_phases(dev, params) -> tuple[dict, dict, dict]:
    """Phases 30-31, the measurement tools; returns the K1/K2 launch counts
    of phase 30's move, the kernel records at its shapes and the figures."""
    from bokego_tpu_torch import mfu_report, sim_throughput
    from bokego_tpu_torch.config import BENCH_BATCH as BATCH, BENCH_CONFIG as CFG
    from bokego_tpu_torch.ops import rollout
    from bokego_tpu_torch.search import mcts

    # 30. the roofline report for one synchronised move at the bench configuration
    t0 = time.monotonic()
    rep = mfu_report.report(dev, BATCH, CFG.n_rollouts, CFG.eval_every, moves=1)
    counts = rep["counts"][0]
    groups = len(mcts.rollout_groups(CFG.n_rollouts, CFG.eval_every))
    check(rep["model_forwards"] == 51 and groups == 51, f"model {rep['model_forwards']} forwards, {groups} groups")
    # An eval step on which no tree has work skips its forward (as the JAX
    # package's lax.cond does), so a move runs at most the model's 51; each
    # forward's expansion is one K2 launch.
    for what, c in (("split move", rep["split_counts"]), ("timed move", counts)):
        n = len(c.forwards)
        check(1 <= n <= 51 and c.forwards == [BATCH] * n, f"mfu_report {what}: forwards {c.forwards} at B={BATCH}")
        check(c.launches["write_rows"] == n, f"mfu_report {what}: K2 launches {c.launches}, forwards {n}")
        check(c.k1_calls == 51 and c.launches["descend_backprop"] == 51,
              f"mfu_report {what}: K1 calls {c.k1_calls}, launches {c.launches}, expected 51")
        check(c.kernel_rollouts == CFG.n_rollouts, f"mfu_report {what}: K1 rollouts {c.kernel_rollouts}")
    n = len(counts.forwards)
    f_net = mfu_report.net_flops(mfu_report.CHANNELS, BATCH)
    check(rep["net_flops"] == f_net, f"forward FLOPs {rep['net_flops']}, net_flops {f_net}")
    check(rep["nominal_flops_counted"] == f_net[1],
          f"flop_counter on the card {rep['nominal_flops_counted']}, nominal net_flops {f_net[1]}")
    check(rep["move_flops"] == (n * f_net[0] + rep["k1_ops"], n * f_net[1] + rep["k1_ops"]),
          f"move FLOPs {rep['move_flops']} are not {n} forwards and K1's operations")
    check(rep["kernels"] and rep["conv_ms"] > 0, "no convolution kernel named")
    check(all(0 < t < 60e3 for t in [rep["forward_ms"], *rep["move_ms"], *rep["split"].values()]),
          f"times out of range: {rep['forward_ms']}, {rep['move_ms']}, {rep['split']}")
    roots = _random_roots(BATCH, 20, seed=9).map(lambda x: x.to(dev))
    records = check_kernels_at(dev, mcts.net_evaluator(), params, roots, ((BATCH, 512, 200, False),),
                               levels=CFG.kernel_levels, record_at=(BATCH, 512))
    del roots
    torch.cuda.empty_cache()
    figures = dict(
        mfu_report=dict(
            seconds=time.monotonic() - t0, forward_ms=rep["forward_ms"], move_ms=rep["move_ms"], split_ms=rep["split"],
            conv_ms=rep["conv_ms"], net_gflop=[f / 1e9 for f in f_net], move_tflop=[f / 1e12 for f in rep["move_flops"]],
            k1_bytes=rep["k1_bytes"], launches=counts.launches, forwards=n, conv_kernels=rep["kernels"],
        )
    )
    log(f"mfu_report: {len(rep['split_counts'].forwards)} and {n} forwards (as many K2 launches; model 51) and 51 K1 "
        f"launches a move, FLOPs as net_flops; K1/K2 bit for bit at B={BATCH}; {figures['mfu_report']['seconds']:.1f} s")

    # 31. batched simulation throughput, cut to SIM_TOOL_ROLLOUTS rollouts and SIM_RUNS timed run
    rollout.reset_launches()
    t0 = time.monotonic()
    res, rate = sim_throughput.run(dev, SIM_BATCH, SIM_TOOL_ROLLOUTS, SIM_PLIES, runs=SIM_RUNS)
    sim_counts = dict(rollout.launches)
    check(not any(sim_counts.values()), f"sim_throughput launched a kernel: {sim_counts}")
    check(bool((res.trees.root_stats[:, 0] == (SIM_RUNS + 1) * SIM_TOOL_ROLLOUTS).all()),
          "sim_throughput: root visits are not the runs' rollouts")
    check(rate is not None and rate > 0 and res.forwards[0] >= SIM_TOOL_ROLLOUTS, f"sim_throughput: rate {rate}")
    figures["sim_throughput"] = dict(
        batch=SIM_BATCH, rollouts=SIM_TOOL_ROLLOUTS, rollouts_per_s=rate, seconds=res.seconds,
        policy_forwards=res.forwards, wall_s=time.monotonic() - t0,
    )
    log(f"sim_throughput: every root's N grew by exactly {SIM_TOOL_ROLLOUTS} a run; launches {sim_counts}")
    return counts.launches, records, figures


def _bench_run(dev, batch: int, moves: int, dtype: str) -> tuple[dict, torch.Tensor]:
    """One in-process bench run (a warm-up move, then ``moves`` timed ones)
    with the launch counts read around it: 51 K1 launches a move, K2 on
    eval steps with work, legal moves only.  Returns its figures and the
    final boards (on the CPU)."""
    from bokego_tpu_torch import bench
    from bokego_tpu_torch.config import BENCH_CONFIG
    from bokego_tpu_torch.ops import rollout

    torch.cuda.synchronize()
    rollout.reset_launches()
    out, states, done = bench.run(dev, bench.Settings(batch, moves, BENCH_CONFIG.n_rollouts, BENCH_CONFIG, dtype))
    launches = dict(rollout.launches)
    what = f"bench B={batch} {dtype}"
    check(launches["descend_backprop"] == 51 * (moves + 1), f"{what}: K1 launches {launches}, expected 51 a move")
    check(launches["write_rows"] > 0, f"{what}: K2 never launched")
    check(out["value"] > 0 and not bool(states.invalid.any()), f"{what}: {out}")
    check(int(states.turn.min()) == moves, f"{what}: turns {states.turn.min()}..{states.turn.max()}")
    ms = 60e3 * batch / out["value"] / moves  # the line's value counts games of ``moves`` moves
    figures = dict(ms_per_move=ms, games_per_min_80_moves=batch * 60e3 / (80 * ms), launches=launches,
                   done=int(done.sum()))
    return figures, states.board.cpu()


def bench_phases(dev) -> tuple[dict, dict, dict, dict]:
    """Phases 32-36, the headline bench, its bf16 and batch variants and the
    serving-latency and scaling tools; returns the K1/K2 launch counts of
    the bench path (the first fp32 run of phase 33, B=1024) and of the
    B=4096 path, the kernel records at B=4096 and the figures."""
    from bokego_tpu_torch import bench, serving_latency
    from bokego_tpu_torch.config import BENCH_BATCH, BENCH_CONFIG, POLICY_WEIGHTS, VALUE_WEIGHTS
    from bokego_tpu_torch.models import nets
    from bokego_tpu_torch.ops import rollout
    from bokego_tpu_torch.search import mcts

    here = os.path.dirname(os.path.abspath(__file__))
    figures = {}

    # 32. the headline bench as a process at its full default
    env = {k: v for k, v in os.environ.items() if not k.startswith("BOKEGO_BENCH_")}
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-m", "bokego_tpu_torch.bench"], capture_output=True, text=True,
                          timeout=900, env={**env, "PYTHONPATH": here})
    seconds = time.monotonic() - t0
    lines = proc.stdout.strip().splitlines()
    check(proc.returncode == 0 and len(lines) == 1,
          f"bench exited {proc.returncode}: {proc.stdout[-2000:]} {proc.stderr[-3000:]}")
    line = json.loads(lines[0])
    check(set(line) == {"metric", "value", "unit", "vs_baseline"} and line["value"] > 0
          and line["vs_baseline"] is None and line["unit"] == "games/min/chip"
          and f"80 moves, batch {BENCH_BATCH}, fp32, device {torch.cuda.get_device_name(0)}" in line["metric"],
          f"bench line {lines[0]}")
    log(f"bench (python -m bokego_tpu_torch.bench): exit 0 in {seconds:.1f} s; its line:")
    log(f"  {lines[0]}")
    figures["bench"] = dict(line=line, process_s=seconds)

    # 33. the bf16 route: the evaluator on the card against the CPU, the two
    # routes, then bench moves in bf16 and fp32 in turns
    roots = _random_roots(256, 20, seed=33)
    cpu_nets = {
        "shipped": {"policy": nets.load_policy(POLICY_WEIGHTS, device="cpu"),
                    "value": nets.load_value(VALUE_WEIGHTS, device="cpu")},
        "bench random-init": bench.bench_nets("cpu", "fp32")[0],
    }
    ev16, ev32 = mcts.net_evaluator(dtype=torch.bfloat16), mcts.net_evaluator()
    errors = {}
    for name, on_cpu in cpu_nets.items():
        on_gpu = {k: copy.deepcopy(net).to(dev) for k, net in on_cpu.items()}
        stored = {k: copy.deepcopy(net).to(torch.bfloat16) for k, net in on_gpu.items()}
        p_cpu, v_cpu = ev16.evaluate(on_cpu, roots)
        p_gpu, v_gpu = ev16.evaluate(on_gpu, roots.map(lambda x: x.to(dev)))
        p_st, v_st = ev16.evaluate(stored, roots.map(lambda x: x.to(dev)))
        p_32, v_32 = ev32.evaluate(on_gpu, roots.map(lambda x: x.to(dev)))
        err = (float((p_gpu.cpu() - p_cpu).abs().max()), float((v_gpu.cpu() - v_cpu).abs().max()))
        check(max(err) <= BF16_TOL, f"bf16 evaluator ({name}): GPU vs CPU {err}, tolerance {BF16_TOL}")
        check(torch.equal(p_st, p_gpu) and torch.equal(v_st, v_gpu),
              f"bf16 evaluator ({name}): stored bf16 and per-call rounding differ on the card")
        check(p_gpu.dtype == v_gpu.dtype == torch.float32, f"bf16 evaluator ({name}): {p_gpu.dtype} out")
        off = (float((p_gpu - p_32).abs().max()), float((v_gpu - v_32).abs().max()))
        errors[name] = dict(gpu_vs_cpu=err, bf16_vs_fp32=off)
        log(f"bf16 evaluator ({name} nets, B=256): GPU vs CPU max abs diff probs {err[0]:.3g}, values "
            f"{err[1]:.3g} (tol {BF16_TOL}); stored bf16 equals per-call rounding bit for bit; bf16 vs fp32 "
            f"on the card {off[0]:.3g}, {off[1]:.3g}")
        del on_gpu, stored
    runs, boards = {"fp32": [], "bf16": []}, {"fp32": [], "bf16": []}
    for dtype in ("fp32", "bf16", "bf16", "fp32"):
        run, board = _bench_run(dev, BENCH_BATCH, BENCH_PAIR_MOVES, dtype)
        runs[dtype].append(run)
        boards[dtype].append(board)
    bench_counts = runs["fp32"][0]["launches"]

    def same_games(a, b) -> float:
        return float((a == b).all(-1).float().mean())

    kept = dict(fp32_vs_bf16=same_games(boards["fp32"][0], boards["bf16"][0]),
                fp32_vs_fp32=same_games(boards["fp32"][0], boards["fp32"][1]),
                bf16_vs_bf16=same_games(boards["bf16"][0], boards["bf16"][1]))
    figures["bf16"] = dict(evaluator=errors, runs=runs, same_final_boards=kept)
    log(f"bench B={BENCH_BATCH} x {BENCH_PAIR_MOVES} moves in turns (fp32, bf16, bf16, fp32): ms/move fp32 "
        f"{[round(r['ms_per_move'], 2) for r in runs['fp32']]}, bf16 {[round(r['ms_per_move'], 2) for r in runs['bf16']]}; "
        f"launches of the first fp32 run {bench_counts} (the warm-up move included); share of games with the "
        f"same board after {BENCH_PAIR_MOVES} moves: {kept}")

    # 34. the batch variant: 4096 games in process, peak memory, K1/K2 at B=4096
    torch.cuda.empty_cache()
    live = torch.cuda.memory_allocated()  # what earlier phases still hold
    torch.cuda.reset_peak_memory_stats()
    big = _bench_run(dev, BIG_BATCH, BIG_MOVES, "fp32")[0]
    big["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    big["peak_over_live_gib"] = (torch.cuda.max_memory_allocated() - live) / 2**30
    torch.cuda.empty_cache()
    roots = _random_roots(BIG_BATCH, 20, seed=34).map(lambda x: x.to(dev))
    params = bench.bench_nets(dev, "fp32")[0]
    big_records = check_kernels_at(dev, mcts.net_evaluator(), params, roots, ((BIG_BATCH, BENCH_CONFIG.max_nodes, 200, False),),
                                   levels=BENCH_CONFIG.kernel_levels, record_at=(BIG_BATCH, BENCH_CONFIG.max_nodes))
    del roots, params
    torch.cuda.empty_cache()
    per_move = {k: v / (BIG_MOVES + 1) for k, v in big["launches"].items()}
    figures["bench_b4096"] = big
    log(f"bench B={BIG_BATCH} x {BIG_MOVES} moves fp32: ms/move {big['ms_per_move']:.2f} "
        f"({big['games_per_min_80_moves']:.1f} games/min/chip for 80 such moves); launches a move {per_move}; "
        f"peak memory {big['peak_mem_gib']:.2f} GiB (max_memory_allocated), {big['peak_over_live_gib']:.2f} GiB "
        f"over what earlier phases hold")

    # 35. serving_latency: the default configuration and --forest 8
    rollout.reset_launches()
    latency = {}
    for forest in (1, 8):
        eng = serving_latency.make_engine(dev, LATENCY_SECONDS, False, forest, 1)
        res = serving_latency.measure(eng, LATENCY_SECONDS, 1)
        for path, ((grown, dt),) in res.items():
            check(grown > 0 and dt > 0, f"serving_latency forest {forest}, {path}: root visits grew by {grown}")
            latency[f"forest {forest}, {path}"] = dict(rollouts_per_s=grown / dt, visits=grown, seconds=dt)
            log(f"serving_latency (forest {forest}, --time {LATENCY_SECONDS}): {path}: {grown / dt:,.0f} rollouts/s "
                f"(root visits grew by {grown:.0f} in {dt:.3f} s)")
        del eng
    check(not any(rollout.launches.values()), f"serving_latency's default search launched a kernel: {rollout.launches}")
    figures["serving_latency"] = latency

    # 36. parallel.scaling over 2 gloo ranks sharing cuda:0
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "bokego_tpu_torch.parallel.scaling", "2", str(SCALING_K), "--device", "cuda:0",
         "--backend", "gloo"], capture_output=True, text=True, timeout=600, env={**env, "PYTHONPATH": here},
    )
    seconds = time.monotonic() - t0
    check(proc.returncode == 0 and "actions IDENTICAL, scores IDENTICAL" in proc.stdout,
          f"parallel.scaling exited {proc.returncode}: {proc.stdout[-2000:]} {proc.stderr[-3000:]}")
    for text in proc.stdout.strip().splitlines():
        log(f"  {text}")
    figures["scaling"] = dict(output=proc.stdout.strip().splitlines(), process_s=seconds)
    log(f"parallel.scaling 2 {SCALING_K} (gloo, 2 ranks on cuda:0): exit 0 in {seconds:.1f} s, actions and scores IDENTICAL")
    return bench_counts, big["launches"], big_records, figures


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.monotonic()
    dev = torch.device("cuda")
    from bokego_tpu_torch.device import fp32_only

    fp32_only()

    from bokego_tpu_torch.config import BENCH_BATCH as BATCH, BENCH_CONFIG as CFG, VALUE_WEIGHTS
    from bokego_tpu_torch.env import rules, state as st
    from bokego_tpu_torch.features import features_batch
    from bokego_tpu_torch.models import nets
    from bokego_tpu_torch.measure import card_line
    from bokego_tpu_torch.ops import build, rollout
    from bokego_tpu_torch.parallel.selfplay import selfplay
    from bokego_tpu_torch.search import mcts
    from bokego_tpu_torch.search.tree import C_WQ
    from tests.torch_fake_eval import fake_evaluator

    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    # 1. build
    t0 = time.monotonic()
    logs = build.build_all(force=True, verbose=True)
    log(f"build: {time.monotonic() - t0:.2f} s for {sorted(logs)}")
    for text in logs.values():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas: {line.strip()}")

    # Networks of the main path: seeded random-init policy, shipped value net.
    policy = nets.init_policy(128, seed=0, device=dev)
    value = nets.load_value(VALUE_WEIGHTS, device=dev)
    params = {"policy": policy, "value": value}
    ev = mcts.net_evaluator()
    records = {}

    # Positions of seeded random games: roots of the warm trees, net inputs.
    roots = st.new_game_batch(BATCH, device=dev)
    gen_moves = torch.Generator(device=dev).manual_seed(1)
    for _ in range(20):
        legal = rules.legal_mask(roots)[:, :81].float()
        roots = rules.step(roots, torch.multinomial(legal, 1, generator=gen_moves)[:, 0])

    # 2. K1 on warmed trees.  expand_thresh=0 and the top 8 children per
    # expansion let 400 rollouts grow trees several levels deep inside the
    # 512-node pool.  Two settings: the main path's (c=4, w=1) on the trees as
    # they are, and c=1, w=0.5 with random Wq, whose descents mostly reach
    # levels 3-6 and which exercises the (1-w)*Wq term.
    warm_cfg = dataclasses.replace(CFG, expand_thresh=0, eval_every=2, branch_num=8)
    trees = mcts.init_trees(roots, ev, params, warm_cfg)
    trees = mcts.run_search(trees, ev, params, warm_cfg, CFG.n_rollouts)
    pstats_wq = trees.pstats.clone()
    pstats_wq[:, :, C_WQ] = torch.randn(pstats_wq[:, :, C_WQ].shape, device=dev, generator=gen_moves)
    cases = {
        "main": (trees.pstats, dict(c=CFG.exploration_weight, w=1.0, use_value=True, levels=6)),
        "w0.5": (pstats_wq, dict(c=1.0, w=0.5, use_value=True, levels=6)),
    }
    k1_err, depths, singles = 0.0, {}, {}
    for name, (pstats, kw) in cases.items():
        p_fused, p_plain, p_single = pstats.clone(), pstats.clone(), pstats.clone()
        rs_fused, rs_plain, rs_single = (trees.root_stats.clone() for _ in range(3))
        res_f = rollout.descend_backprop(p_fused, trees.value, trees.root, rs_fused, rollouts=FUSED, **kw)
        res_p = rollout.descend_backprop_plain(p_plain, trees.value, trees.root, rs_plain, rollouts=FUSED, **kw)
        singles[name] = [
            rollout.descend_backprop(p_single, trees.value, trees.root, rs_single, **kw) for _ in range(FUSED)
        ]
        torch.cuda.synchronize()
        depths[name] = depth = rollout.unpack(singles[name][0]).depth
        for other, res, p, rs in (
            (f"plain version at {FUSED} rollouts", res_p, p_plain, rs_plain),
            (f"{FUSED} launches of one rollout", singles[name][-1], p_single, rs_single),
        ):
            check(torch.equal(res_f, res), f"K1 result differs from {other} ({name})")
            check(torch.equal(p_fused, p), f"K1 pstats differ from {other} ({name})")
            check(torch.equal(rs_fused, rs), f"K1 root stats differ from {other} ({name})")
            k1_err = max(
                k1_err, float((res_f - res).abs().max()), float((p_fused - p).abs().max()),
                float((rs_fused - rs).abs().max()),
            )
        check(torch.equal(rs_fused[:, 0], trees.root_stats[:, 0] + FUSED), f"K1 root visits ({name})")
        check(not torch.equal(p_fused, pstats), f"K1 wrote nothing ({name})")
        hist = torch.bincount(depth.long(), minlength=7).tolist()
        log(
            f"K1 {name} {kw}: {FUSED} fused rollouts equal the plain version and {FUSED} launches "
            f"bit for bit (tolerance 0); first rollout's depths 0..6: {hist}"
        )
        del p_fused, p_plain, p_single
    deep = int((depths["w0.5"] >= 3).sum())
    check(deep >= BATCH // 4, f"warm trees too shallow: {deep} of {BATCH} w0.5 descents reach depth 3")
    # Timing and bounds at the main path's setting, at 1 and at FUSED rollouts
    # a launch.  The bound counts the bytes the function needs (k1_work); the
    # wider count beside it is every loaded row at 6 planes x 128 lanes.
    kw, depth = cases["main"][1], depths["main"]
    rows_loaded = torch.clamp(depth + 1, max=kw["levels"]).sum().item()
    wide_bytes = rows_loaded * 6 * 128 * 4 + BATCH * (8 + 4 + 512) + depth.sum().item() * 8
    k1 = {}
    for n_roll, iters, plain_iters in ((1, 200, 20), (FUSED, 100, 5)):
        p_kernel, p_plain = trees.pstats.clone(), trees.pstats.clone()
        rs_kernel, rs_plain = trees.root_stats.clone(), trees.root_stats.clone()
        ms, eager = time_ms(
            lambda: rollout.descend_backprop(p_kernel, trees.value, trees.root, rs_kernel, rollouts=n_roll, **kw), iters
        )
        plain, plain_eager = time_ms(
            lambda: rollout.descend_backprop_plain(p_plain, trees.value, trees.root, rs_plain, rollouts=n_roll, **kw),
            plain_iters,
        )
        n_bytes, n_ops = k1_work(singles["main"][:n_roll], trees.parent, kw["levels"], planes=4)
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        k1[n_roll] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by)
        log(
            f"K1 descend_backprop rollouts/launch={n_roll}: B={BATCH} Nmax={warm_cfg.max_nodes} levels=6 "
            f"max_depth={int(depth.max())} mean_depth={depth.float().mean():.3f}; kernel_ms={ms:.5f} "
            f"({1e3 * ms / n_roll:.3f} us/rollout) plain_ms={plain:.5f} bound_ms={b_ms:.5f} ({b_by}, {n_bytes} B needed); "
            f"eager launches: kernel_ms={eager:.5f} plain_ms={plain_eager:.5f}"
        )
        del p_kernel, p_plain
    log(
        f"K1 wide count at 1 rollout (6 planes x 128 lanes of every loaded row): {wide_bytes} B, "
        f"bound_ms={bound_ms(wide_bytes, rows_loaded * 128 * 12)[0]:.5f}"
    )
    records["descend_backprop"] = dict(max_abs_err=k1_err, library_ms=None, rollouts_per_launch=FUSED, **k1[FUSED])

    # 3. K2 with masks all false, all true, mixed.
    gen = torch.Generator(device=dev).manual_seed(0)
    node = torch.randint(0, warm_cfg.max_nodes, (BATCH,), device=dev, generator=gen)
    rows = torch.randn((BATCH, 8, 128), device=dev, generator=gen)
    masks = {
        "none": torch.zeros(BATCH, dtype=torch.bool, device=dev),
        "all": torch.ones(BATCH, dtype=torch.bool, device=dev),
        "mixed": torch.rand(BATCH, device=dev, generator=gen) < 0.5,
    }
    base = trees.pstats
    k2_err = 0.0
    for name, mask in masks.items():
        pk, pp = base.clone(), base.clone()
        rollout.write_rows(pk, node, rows, mask)
        rollout.write_rows_plain(pp, node, rows, mask)
        torch.cuda.synchronize()
        k2_err = max(k2_err, float((pk - pp).abs().max()))
        check(torch.equal(pk, pp), f"K2 differs from plain (mask {name})")
        untouched = torch.ones(base.shape[:2], dtype=torch.bool, device=dev)
        untouched[torch.arange(BATCH, device=dev)[mask], node[mask]] = False
        check(torch.equal(pk[untouched], base[untouched]), f"K2 touched other rows (mask {name})")
        del pk, pp
    mask = masks["mixed"]
    b_idx = mask.nonzero().squeeze(1)
    n_idx, r_idx = node[b_idx], rows[b_idx]
    scratch = base.clone()
    k2_ms, k2_eager = time_ms(lambda: rollout.write_rows(scratch, node, rows, mask), 200)
    k2_plain, k2_plain_eager = time_ms(lambda: rollout.write_rows_plain(scratch, node, rows, mask), 50)
    k2_lib, k2_lib_eager = time_ms(lambda: scratch.__setitem__((b_idx, n_idx), r_idx), 200)
    n_masked = int(mask.sum())
    k2_bytes = n_masked * 2 * 8 * 128 * 4 + BATCH * (8 + 1)
    b_ms, b_by = bound_ms(k2_bytes, 0)
    records["write_rows"] = dict(
        max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain, bound_ms=b_ms, bound_by=b_by, library_ms=k2_lib
    )
    log(
        f"K2 write_rows: B={BATCH} Nmax={warm_cfg.max_nodes} masked={n_masked} exact, rows untouched; "
        f"kernel_ms={k2_ms:.5f} plain_ms={k2_plain:.5f} library_ms={k2_lib:.5f} bound_ms={b_ms:.5f}; "
        f"eager launches: kernel_ms={k2_eager:.5f} plain_ms={k2_plain_eager:.5f} library_ms={k2_lib_eager:.5f}"
    )
    del scratch, trees, base, singles

    # 4. nets on the GPU vs the CPU (TF32 off), on the random-game positions.
    fts = features_batch(roots)[:256]
    with torch.inference_mode():
        pol_cpu, val_cpu = copy.deepcopy(policy).cpu(), copy.deepcopy(value).cpu()
        pol_err = float((policy(fts).cpu() - pol_cpu(fts.cpu())).abs().max())
        val_err = float((value(fts).cpu() - val_cpu(fts.cpu())).abs().max())
    check(pol_err <= 1e-4 and val_err <= 1e-4, f"nets GPU vs CPU: {pol_err}, {val_err}")
    log(f"nets: GPU vs CPU max abs diff policy logits {pol_err:.3g}, value {val_err:.3g} (tol 1e-4)")

    # 5. small self-play, GPU vs CPU (plain versions), deterministic evaluator.
    small = dataclasses.replace(CFG, expand_thresh=3, max_nodes=256, eval_every=2)
    fev = fake_evaluator()
    r_gpu = selfplay(None, fev, small, 8, 3, 40, device=dev)
    r_cpu = selfplay(None, fev, small, 8, 3, 40, device="cpu")
    check(torch.equal(r_gpu.actions.cpu(), r_cpu.actions), "GPU vs CPU self-play actions")
    check(torch.equal(r_gpu.final.board.cpu(), r_cpu.final.board), "GPU vs CPU final boards")
    check(torch.equal(r_gpu.scores.cpu(), r_cpu.scores), "GPU vs CPU scores")
    log(f"reference: GPU self-play equals CPU self-play (B=8, 3 moves, 40 rollouts): {r_gpu.actions[:, 0].tolist()}")

    # 6. the main path.
    torch.cuda.synchronize()
    rollout.reset_launches()
    t0 = time.monotonic()
    res = selfplay(params, ev, CFG, BATCH, MOVES, CFG.n_rollouts, device=dev)
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    counts, k1_rollouts = dict(rollout.launches), rollout.kernel_rollouts
    check(all(n > 0 for n in counts.values()), f"a kernel of the main path never launched: {counts}")
    groups = mcts.rollout_groups(CFG.n_rollouts, CFG.eval_every)
    check(len(groups) == 51, f"{len(groups)} rollout groups a move, expected 51")
    check(counts["descend_backprop"] == 51 * MOVES, f"K1 launches {counts['descend_backprop']}, expected {51 * MOVES}")
    check(k1_rollouts == CFG.n_rollouts * MOVES, f"K1 rollouts {k1_rollouts}, expected {CFG.n_rollouts * MOVES}")
    check(res.actions.shape == (MOVES, BATCH), f"actions shape {tuple(res.actions.shape)}")
    check(not bool(res.final.invalid.any()), "an illegal move was played")
    check(bool(torch.isfinite(res.scores).all()), "non-finite scores")
    check(bool(((res.actions >= 0) & (res.actions <= 81)).all()), "action out of range")
    ms_move = dt * 1e3 / MOVES
    log(
        f"selfplay: B={BATCH} moves={MOVES} rollouts/move={CFG.n_rollouts} "
        f"ms/move={ms_move:.2f} rollouts/s={BATCH * CFG.n_rollouts / (ms_move / 1e3):.1f} "
        f"launches={counts} K1_rollouts={k1_rollouts} peak_mem_GiB={torch.cuda.max_memory_allocated() / 2**30:.2f}"
    )

    records_serving, serve_counts = serving_phases(dev, roots)
    del roots
    torch.cuda.empty_cache()
    train_figures = training_phases(dev)
    dp_counts, dp_records, dp_figures = dp_phases(dev, params)
    fid_counts, sm_counts, fid_records, match_figures = match_phases(dev)
    mfu_counts, mfu_records, tool_figures = tool_phases(dev, params)
    bench_counts, big_counts, big_records, bench_figures = bench_phases(dev)

    log(f"total: {time.monotonic() - t_start:.1f} s")

    log(card_line())
    replaces = {
        "descend_backprop": "bokego_tpu/ops/rollout.py:219",
        "write_rows": "bokego_tpu/ops/rollout.py:325",
    }
    kernels = [
        dict(
            name=name, route="cuda", source="bokego_tpu_torch/ops/csrc/rollout.cu",
            replaces=replaces[name], path=path, launches=launches[name], **recs[name],
        )
        for path, launches, recs in (
            ("selfplay", counts, records), ("gtp_engine_fast", serve_counts, records_serving),
            ("selfplay_sharded", dp_counts, dp_records), ("fastmode_fidelity", fid_counts, fid_records),
            ("serving_match", sm_counts, records_serving), ("mfu_report", mfu_counts, mfu_records),
            ("bench", bench_counts, records), ("bench_b4096", big_counts, big_records),
        )
        for name in ("descend_backprop", "write_rows")
    ]
    log(json.dumps({"training": train_figures}))
    log(json.dumps({"data_parallel": dp_figures}))
    log(json.dumps({"matches": match_figures}))
    log(json.dumps({"tools": tool_figures}))
    log(json.dumps({"bench": bench_figures}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
