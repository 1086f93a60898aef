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
 6. the main path: ``selfplay`` at the bench configuration (B=1024, 400
    rollouts/move, eval_every=8, kernel_levels=6, expand_thresh=100,
    max_nodes=512) with a seeded random-init 128-channel policy and the
    shipped ``data/weights/value_r2.pt`` for MOVES moves, launch counts read
    around it (51 K1 launches and 400 K1 rollouts a move); then PAIR_MOVES
    moves each of the search as it is (a launch per group of rollouts) and of
    a loop of ``search_step`` (a launch per rollout), in turns, for paired
    ms/move.

The last two lines of standard output are the kernels' JSON record and the
device line ``{"ok": true, "device": {...}}``; the line before them is
``nvidia-smi``'s name and power limit.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
FP32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
MOVES = 80  # self-play moves of the main path: most of the run's time on an H100
PAIR_MOVES = 5  # moves per turn of the paired grouped / per-rollout timing
FUSED = 8  # rollouts per launch in the K1 check: the main path's eval_every


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


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def k1_work(results, parent, levels: int, planes: int) -> tuple[int, int]:
    """Bytes and operations that the rollouts described by ``results`` (one
    kernel ``res`` per rollout, all from one call) need: every stats row
    walked through read once (81 actions of ``planes`` planes; the child
    plane alone for a leaf's row, read to find it childless), every updated
    edge written once (N, Wv), every leaf value read once, and per tree the
    root, the root stats in and out, one child-terminal float and the result
    row.  The paths are rebuilt from the leaves through ``parent``."""
    from bokego_tpu_torch.ops.rollout import unpack

    batch = parent.shape[0]
    ar = torch.arange(batch, device=parent.device)
    inner = torch.zeros_like(parent, dtype=torch.bool)
    leaf_rows, edges, leaves = inner.clone(), inner.clone(), inner.clone()
    walked = 0
    for res in results:
        kd = unpack(res)
        node, left = kd.leaf, kd.depth.clone()
        leaves[ar, node] = True
        early = kd.depth < levels
        leaf_rows[ar[early], node[early]] = True
        walked += int(kd.depth.sum())
        for _ in range(levels):
            on = left > 0
            edges[ar[on], node[on]] = True
            node = torch.where(on, parent[ar, node], node)
            inner[ar[on], node[on]] = True
            left -= 1
    n_bytes = (
        int(inner.sum()) * 81 * planes * 4 + int((leaf_rows & ~inner).sum()) * 81 * 4
        + int(edges.sum()) * 8 + int(leaves.sum()) * 4 + batch * (8 + 12 + 12 + 4 + 512)
    )
    return n_bytes, walked * 81 * 12


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.monotonic()
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from bokego_tpu_torch.config import BENCH_BATCH as BATCH, BENCH_CONFIG as CFG, VALUE_WEIGHTS
    from bokego_tpu_torch.env import rules, state as st
    from bokego_tpu_torch.features import features_batch
    from bokego_tpu_torch.models import nets
    from bokego_tpu_torch.ops import build, rollout
    from bokego_tpu_torch.parallel.selfplay import selfplay
    from bokego_tpu_torch.search import mcts
    from bokego_tpu_torch.search.tree import C_WQ, C_WV
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

    # Paired: the search as it is (a K1 launch per group of rollouts) and a
    # loop of search_step (a launch per rollout), in turns from the same
    # opening; both must play the same games.
    def stepped(t):
        for i in range(CFG.n_rollouts):
            t = mcts.search_step(t, ev, params, CFG, i)
        return t

    def play(run):
        states = st.new_game_batch(BATCH, device=dev)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(PAIR_MOVES):
            t = run(mcts.init_trees(states, ev, params, CFG))
            states = rules.step(states, mcts.choose_action(t))
        torch.cuda.synchronize()
        return (time.monotonic() - t0) * 1e3 / PAIR_MOVES, states

    def grouped(t):
        return mcts.run_search(t, ev, params, CFG, CFG.n_rollouts)

    turns = [("per_rollout", stepped), ("grouped", grouped), ("grouped", grouped), ("per_rollout", stepped)]
    pair_ms, finals = {"per_rollout": [], "grouped": []}, []
    for how, run in turns:
        ms, final = play(run)
        pair_ms[how].append(round(ms, 2))
        finals.append(final.board)
    check(all(torch.equal(finals[0], f) for f in finals[1:]), "grouped and per-rollout searches played different games")
    log(
        f"paired ms/move over {PAIR_MOVES} moves each, in turns (per_rollout, grouped, grouped, per_rollout): "
        f"grouped={pair_ms['grouped']} per_rollout={pair_ms['per_rollout']}; same games"
    )
    log(f"total: {time.monotonic() - t_start:.1f} s")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    log(smi.stdout.strip().splitlines()[0])
    replaces = {
        "descend_backprop": "bokego_tpu/ops/rollout.py:219",
        "write_rows": "bokego_tpu/ops/rollout.py:325",
    }
    kernels = [
        dict(
            name=name, route="cuda", source="bokego_tpu_torch/ops/csrc/rollout.cu",
            replaces=replaces[name], launches=counts[name], **records[name],
        )
        for name in ("descend_backprop", "write_rows")
    ]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
