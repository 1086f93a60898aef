"""GPU tests of the port: the CUDA kernels against their plain versions (K1
and K2 at the self-play and at the serving shapes, K3 and K4 on synthetic
trees up to the search's depth bound), GPU self-play, the non-kernel
search, leaf-parallel search and simulation mode (with the one-hot playout
policy, whose draws cannot matter) against their CPU runs, a short engine
session per configuration on the card, the profiler hooks, the program's
``sync.<site>`` spans against CUDA's sync debug mode, the residual
tower's trunk epilogue against its plain version and in the tower, and K5
``leaf_tables`` (the eval phase's board analysis) against its plain
version on seeded and crafted positions and in the search.
Marked ``cuda``; they skip without a GPU.  This file imports no JAX, so it
also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Comparisons are exact: the kernels are built without FMA contraction and
keep the plain versions' order of floating-point operations."""

import collections
import dataclasses
import warnings

import pytest
import torch

from bokego_tpu_torch import features
from bokego_tpu_torch.config import BENCH_CONFIG, EngineConfig, SearchConfig
from bokego_tpu_torch.env import rules, state as st
from bokego_tpu_torch.gtp.engine import GTPEngine
from bokego_tpu_torch.models import nets
from bokego_tpu_torch.ops import epilogue, rollout
from bokego_tpu_torch.parallel.selfplay import selfplay
from bokego_tpu_torch.search import leafpar, mcts, tree
from bokego_tpu_torch.search.tree import C_CHILD, C_N, C_PRIOR, C_WQ, C_WV
from bokego_tpu_torch.utils import metrics
from tests.torch_fake_eval import fake_evaluator, onehot_evaluator, stones_evaluator
from tests.torch_leaf_boards import crafted_positions, random_positions

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    return torch.device("cuda")


def _cfg(thresh: int) -> SearchConfig:
    return SearchConfig(
        expand_thresh=thresh, no_sim=True, max_turns=80, max_nodes=256,
        eval_every=2, kernel_levels=8, use_kernel=True,
    )


def _warm_trees(dev, thresh: int, rollouts: int, batch: int = 64):
    """Trees from seeded random-game roots, warmed by the port's search."""
    gen = torch.Generator(device=dev).manual_seed(thresh)
    roots = st.new_game_batch(batch, device=dev)
    for _ in range(12):
        legal = rules.legal_mask(roots)[:, :81].float()
        roots = rules.step(roots, torch.multinomial(legal, 1, generator=gen)[:, 0])
    ev = fake_evaluator()
    trees = mcts.init_trees(roots, ev, None, _cfg(thresh))
    return mcts.run_search(trees, ev, None, _cfg(thresh), rollouts)


def _k1_inputs(dev, trees, w: float):
    """(pstats, value) of warmed trees with some cached values knocked out."""
    value = trees.value.clone()
    value[torch.rand(value.shape, device=dev) < 0.3] = float("nan")
    pstats = trees.pstats.clone()
    if w != 1.0:  # the search leaves Wq at 0 (no simulations): give it values
        pstats[:, :, C_WQ] = torch.randn(pstats[:, :, C_WQ].shape, device=dev)
    return pstats, value


@pytest.mark.parametrize(
    "thresh,rollouts,levels,w", [(100, 150, 6, 1.0), (3, 60, 8, 1.0), (3, 60, 2, 1.0), (3, 60, 8, 0.5)]
)
def test_kernels_match_plain(dev, thresh, rollouts, levels, w):
    trees = _warm_trees(dev, thresh, rollouts)
    pstats, value = _k1_inputs(dev, trees, w)
    kw = dict(c=4.0, w=w, use_value=True, levels=levels)
    p_kernel, p_plain = pstats.clone(), pstats.clone()
    rs_kernel, rs_plain = trees.root_stats.clone(), trees.root_stats.clone()
    with metrics.recording() as rec:
        res_k = rollout.descend_backprop(p_kernel, value, trees.root, rs_kernel, **kw)
    res_p = rollout.descend_backprop_plain(p_plain, value, trees.root, rs_plain, **kw)
    torch.cuda.synchronize()
    assert torch.equal(res_k, res_p)
    assert torch.equal(p_kernel, p_plain)
    assert torch.equal(rs_kernel, rs_plain)
    assert torch.equal(res_k[:, 6], trees.root_stats[:, 0])
    batch, n_pool = trees.pstats.shape[:2]
    node = torch.randint(0, n_pool, (batch,), device=dev)
    rows = torch.randn(batch, 8, 128, device=dev)
    for mask in (torch.zeros(batch, dtype=torch.bool, device=dev),
                 torch.ones(batch, dtype=torch.bool, device=dev),
                 torch.rand(batch, device=dev) < 0.5):
        with metrics.recording() as rec_rows:
            rollout.write_rows(p_kernel, node, rows, mask)
        rollout.write_rows_plain(p_plain, node, rows, mask)
        torch.cuda.synchronize()
        assert torch.equal(p_kernel, p_plain)
        assert rec_rows.counters == {"ops.write_rows": 1}
    # each wrapper counts its launch; the plain versions called directly count nothing
    assert rec.counters == {"ops.descend_backprop": 1, "ops.descend_backprop.rollouts": 1}


@pytest.mark.parametrize("levels,w,use_value", [(6, 1.0, True), (8, 0.5, True), (2, 1.0, False)])
def test_fused_rollouts_match_plain_and_single_launches(dev, levels, w, use_value):
    """One launch of 8 rollouts against the plain version at 8 rollouts and
    against 8 launches of one rollout: everything bit for bit."""
    trees = _warm_trees(dev, 3, 60)
    pstats, value = _k1_inputs(dev, trees, w)
    kw = dict(c=4.0, w=w, use_value=use_value, levels=levels)
    p_fused, p_plain, p_single = pstats.clone(), pstats.clone(), pstats.clone()
    rs_fused, rs_plain, rs_single = (trees.root_stats.clone() for _ in range(3))
    with metrics.recording() as rec:
        res_f = rollout.descend_backprop(p_fused, value, trees.root, rs_fused, rollouts=8, **kw)
        assert (rec.counters["ops.descend_backprop"], rec.counters["ops.descend_backprop.rollouts"]) == (1, 8)
        res_p = rollout.descend_backprop_plain(p_plain, value, trees.root, rs_plain, rollouts=8, **kw)
        for _ in range(8):
            res_s = rollout.descend_backprop(p_single, value, trees.root, rs_single, **kw)
        torch.cuda.synchronize()
    assert (rec.counters["ops.descend_backprop"], rec.counters["ops.descend_backprop.rollouts"]) == (9, 16)
    for res, p, rs in ((res_p, p_plain, rs_plain), (res_s, p_single, rs_single)):
        assert torch.equal(res_f, res)
        assert torch.equal(p_fused, p)
        assert torch.equal(rs_fused, rs)
    assert torch.equal(rs_fused[:, 0], trees.root_stats[:, 0] + 8)
    assert not torch.equal(p_fused, pstats)


def test_selfplay_gpu_equals_cpu(dev):
    cfg = _cfg(3)
    with metrics.recording() as rec:
        r_gpu = selfplay(None, fake_evaluator(), cfg, 8, 3, 40, device=dev)
    n = rec.counters
    assert n["ops.write_rows"] == rec.phases["search.expand"].count > 0
    # the kernel path bypasses the non-kernel search's K3/K4
    assert n["ops.descend_path"] == n["ops.backprop_path"] == 0
    # 40 rollouts at eval_every=2: step 0, 19 pairs, one light step; 3 moves
    assert n["ops.descend_backprop"] == 3 * len(mcts.rollout_groups(40, cfg.eval_every)) == 63
    assert n["ops.descend_backprop.rollouts"] == 3 * 40
    r_cpu = selfplay(None, fake_evaluator(), cfg, 8, 3, 40, device="cpu")
    assert torch.equal(r_gpu.actions.cpu(), r_cpu.actions)
    assert torch.equal(r_gpu.final.board.cpu(), r_cpu.final.board)
    assert torch.equal(r_gpu.final.hash.cpu(), r_cpu.final.hash)
    assert torch.equal(r_gpu.scores.cpu(), r_cpu.scores)


def _serving_trees(dev, batch: int, n_pool: int, rollouts: int):
    """Trees of the serving shapes (levels=8), warmed by the port's search."""
    cfg = SearchConfig(
        expand_thresh=0, branch_num=8, max_nodes=n_pool, eval_every=2, kernel_levels=8, use_kernel=True,
    )
    gen = torch.Generator(device=dev).manual_seed(batch)
    roots = st.new_game_batch(batch, device=dev)
    for _ in range(12):
        legal = rules.legal_mask(roots)[:, :81].float()
        roots = rules.step(roots, torch.multinomial(legal, 1, generator=gen)[:, 0])
    ev = fake_evaluator()
    return mcts.run_search(mcts.init_trees(roots, ev, None, cfg), ev, None, cfg, rollouts)


@pytest.mark.parametrize("batch,n_pool", [(1, 512), (8, 512), (2, 65536)])
def test_kernels_match_plain_at_serving_shapes(dev, batch, n_pool):
    """K1 (1 and 8 rollouts a launch, levels=8) and K2 against their plain
    versions at the engine's batch sizes and at the big pool, bit for bit."""
    trees = _serving_trees(dev, batch, n_pool, 120)
    kw = dict(c=4.0, w=1.0, use_value=True, levels=8)
    for n_roll in (1, 8):
        p_k, p_p = trees.pstats.clone(), trees.pstats.clone()
        rs_k, rs_p = trees.root_stats.clone(), trees.root_stats.clone()
        res_k = rollout.descend_backprop(p_k, trees.value, trees.root, rs_k, rollouts=n_roll, **kw)
        res_p = rollout.descend_backprop_plain(p_p, trees.value, trees.root, rs_p, rollouts=n_roll, **kw)
        torch.cuda.synchronize()
        assert torch.equal(res_k, res_p) and torch.equal(p_k, p_p) and torch.equal(rs_k, rs_p)
        assert int(rollout.unpack(res_k).depth.max()) >= 2
    node = torch.full((batch,), n_pool - 1, device=dev)
    rows = torch.randn(batch, 8, 128, device=dev)
    mask = torch.arange(batch, device=dev) % 2 == 0
    rollout.write_rows(p_k, node, rows, mask)
    rollout.write_rows_plain(p_p, node, rows, mask)
    torch.cuda.synchronize()
    assert torch.equal(p_k, p_p)
    assert torch.equal(p_k[0, n_pool - 1], rows[0])


@pytest.mark.parametrize("eval_every", [1, 2])
def test_non_kernel_search_gpu_equals_cpu(dev, eval_every):
    """``run_search`` without the kernels, then the engine's re-root and a
    second search: the same trees on the GPU and on the CPU."""
    cfg = SearchConfig(expand_thresh=3, max_nodes=1024, eval_every=eval_every)
    ev = fake_evaluator()
    out, recs = [], []
    for where in (dev, "cpu"):
        with metrics.recording() as rec:
            roots = st.new_game_batch(4, device=where)
            roots = rules.play_moves(roots, torch.tensor([[40, 30, 20, 10], [41, 31, 21, 11]], device=where))
            t = mcts.run_search(mcts.init_trees(roots, ev, None, cfg), ev, None, cfg, 80)
            t, ok = mcts.advance_root(t, mcts.choose_action(t))
            assert bool(ok.all())
            t = mcts.expand_roots(tree.compact(t), ev, None, cfg)
            out.append(mcts.run_search(t, ev, None, cfg, 40))
        recs.append(rec)
    gpu, cpu = out
    for f in ("pstats", "root_stats", "n_nodes", "parent", "action", "expanded", "terminal", "root"):
        assert torch.equal(getattr(gpu, f).cpu(), getattr(cpu, f)), f
    assert torch.equal(gpu.value.cpu().nan_to_num(7.0), cpu.value.nan_to_num(7.0))
    # the GPU run's 120 rollouts: one K3 and one K4 launch each, no K1; one K2
    # launch an expansion, as many as the CPU run's; the CPU run launches nothing
    n = recs[0].counters
    assert (n["ops.descend_backprop"], n["ops.descend_path"], n["ops.backprop_path"]) == (0, 120, 120)
    assert n["ops.write_rows"] == recs[0].phases["search.expand"].count == recs[1].phases["search.expand"].count > 0
    assert not [k for k in recs[1].counters if k.startswith("ops.")]


TREE_FIELDS = ("pstats", "root_stats", "n_nodes", "parent", "action", "expanded", "terminal", "root")


def _assert_gpu_equals_cpu(gpu, cpu):
    for f in TREE_FIELDS:
        assert torch.equal(getattr(gpu, f).cpu(), getattr(cpu, f)), f
    assert torch.equal(gpu.value.cpu().nan_to_num(7.0), cpu.value.nan_to_num(7.0))


def _midgame_roots(where, batch=8):
    moves = torch.tensor([[40, 30, 20, 10, 50, 60, 41, 31][:batch], [42, 32, 22, 12, 52, 62, 43, 33][:batch]])
    return rules.play_moves(st.new_game_batch(batch, device=where), moves.to(where))


@pytest.mark.parametrize("K", [1, 4, 8])
@pytest.mark.parametrize("ev_fn", [fake_evaluator, stones_evaluator], ids=["fake", "stones_fused"])
def test_leaf_parallel_search_gpu_equals_cpu(dev, K, ev_fn):
    """``run_search_k`` without simulations: the same trees on the GPU and
    on the CPU (an edge shared by several paths takes their terms in the
    order of k on both), and K=1 the same as ``run_search``."""
    cfg = SearchConfig(expand_thresh=1, branch_num=8, max_nodes=1024)
    ev = ev_fn()
    out, recs = [], []
    for where in (dev, "cpu"):
        with metrics.recording() as rec:
            t = mcts.init_trees(_midgame_roots(where), ev, None, cfg)
            out.append(leafpar.run_search_k(t, ev, None, cfg, 96, K))
        recs.append(rec)
    _assert_gpu_equals_cpu(*out)
    assert out[0].root_stats[:, 0].tolist() == [96.0] * 8 and int(out[0].expanded.sum(1).min()) >= 4
    # K descents a step through K3 on the GPU; leafpar's own backprop, no K4;
    # one K2 launch an expansion, as many as the CPU run's; the CPU run
    # launches nothing
    n = recs[0].counters
    assert (n["ops.descend_backprop"], n["ops.descend_path"], n["ops.backprop_path"]) == (0, 96, 0)
    assert n["ops.write_rows"] == recs[0].phases["search.expand"].count == recs[1].phases["search.expand"].count > 0
    assert not [k for k in recs[1].counters if k.startswith("ops.")]
    if K == 1:
        with metrics.recording() as rec:
            seq = mcts.run_search(mcts.init_trees(_midgame_roots(dev), ev, None, cfg), ev, None, cfg, 96)
        assert torch.equal(seq.pstats, out[0].pstats) and torch.equal(seq.root_stats, out[0].root_stats)
        assert (rec.counters["ops.descend_path"], rec.counters["ops.backprop_path"]) == (96, 96)


@pytest.mark.parametrize("leaf_batch", [1, 4])
def test_simulation_mode_gpu_equals_cpu(dev, leaf_batch):
    """``no_sim=False`` with the one-hot playout policy (the CUDA and the CPU
    generator draw different streams, which a single point of mass hides)."""
    cfg = SearchConfig(expand_thresh=2, max_nodes=512, no_sim=False, max_turns=40)
    ev = onehot_evaluator()
    out = []
    for where in (dev, "cpu"):
        gen = torch.Generator(device=where).manual_seed(0)
        t = mcts.init_trees(_midgame_roots(where, 4), ev, None, cfg)
        if leaf_batch > 1:
            out.append(leafpar.run_search_k(t, ev, None, cfg, 16, leaf_batch, gen=gen))
        else:
            out.append(mcts.run_search(t, ev, None, cfg, 16, gen=gen))
    _assert_gpu_equals_cpu(*out)
    assert bool((out[0].root_stats[:, 1] != 0).any())


def test_profiler_hooks_on_the_card(dev, tmp_path):
    """``device_trace`` records device events, a span of the program's
    recorder is a ``user_annotation`` beside them, ``phase(block_on=...)``
    waits for the card."""
    import json
    import os

    m = metrics.Metrics()
    x = torch.ones(1 << 20, device=dev)
    with metrics.recording() as rec, metrics.device_trace(str(tmp_path)) as prof:
        with metrics.span("add"), m.phase("add", block_on={"x": x}):
            x += 1
    assert m.phases["add"].count == rec.phases["add"].count == 1 and float(x[0]) == 2.0
    with open(os.path.join(tmp_path, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "add" and e.get("cat") == "user_annotation" for e in events)
    assert any(e.get("cat") == "kernel" for e in events)
    assert any(e.self_device_time_total > 0 for e in prof.key_averages())


def _syncs_by_span(run, stacks: list | None = None):
    """``run()`` with the program's recorder on, under CUDA's sync debug
    mode: the innermost span open at each synchronisation it warns of, and
    the recorder; and where each synchronisation outside every span was.
    ``stacks``, where given, takes the names of all the spans open at each
    synchronisation, outermost first."""
    seen, outside = [], []
    rec = None

    def innermost():
        open_spans = [s[0] for s in rec.spans if s[2] == 0]
        if stacks is not None:
            stacks.append(open_spans)
        return open_spans[-1] if open_spans else None

    def show(message, category, filename, lineno, *args, **kwargs):
        if "called a synchronizing CUDA operation" in str(message):
            seen.append(innermost())
            if seen[-1] is None:
                outside.append(f"{filename}:{lineno}")

    with metrics.recording() as rec, warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return seen, rec, outside


@pytest.mark.parametrize("path", ["selfplay_move", "genmove"])
def test_sync_spans_count_every_sync_on_the_card(dev, path):
    """One batched move on the kernel path (the bench's search at B=64 with
    root noise, then the rules' step) and one served ``genmove`` (the
    engine's default search) with the nets on the card: CUDA's sync debug
    mode warns of as many synchronisations, site by site, as the
    ``sync.<site>`` spans count, and of none outside them."""
    params = {"policy": nets.init_policy(device=dev).eval(), "value": nets.init_value(device=dev).eval()}
    ev = mcts.net_evaluator()
    if path == "genmove":
        ecfg = EngineConfig(time_lim=None, n_rollouts=32, pondering=False)
        eng = GTPEngine(ev, params, SearchConfig(expand_thresh=2, max_nodes=512), ecfg, device=dev)
        eng.running = True
        for cmd in ("play black E5", "genmove white", "play black D4"):  # warm: tables, cuDNN
            assert eng.send(cmd).startswith("=")

        def run():
            assert eng.send("genmove white").startswith("=")
    else:
        cfg = dataclasses.replace(BENCH_CONFIG, n_rollouts=64, noise_weight=0.25, dirichlet_alpha=0.1)
        roots = _midgame_roots(dev)
        roots = roots.map(lambda x: x.repeat(8, *[1] * (x.dim() - 1)))
        gen = torch.Generator(device=dev).manual_seed(0)

        def run():
            actions, _ = mcts.search(roots, ev, params, cfg, gen=gen)
            rules.is_terminal(rules.step(roots, actions), cfg.max_turns)

        run()  # warm: the kernels' build and load, tables, cuDNN
    seen, rec, outside = _syncs_by_span(run)
    spans = {name: c.count for name, c in rec.phases.items() if name.startswith("sync.")}
    assert seen and collections.Counter(seen) == spans, (collections.Counter(seen), spans, outside)


def test_served_rollout_is_two_launches_and_one_read(dev):
    """A served ``genmove`` at ``eval_every=1`` (the engine's default search,
    the nets on the card): every rollout is one K3 and one K4 launch, and
    outside the evaluations the host reads the device once a rollout, the
    work flag; no descent level is read."""
    params = {"policy": nets.init_policy(device=dev).eval(), "value": nets.init_value(device=dev).eval()}
    ecfg = EngineConfig(time_lim=None, n_rollouts=32, pondering=False)
    eng = GTPEngine(mcts.net_evaluator(), params, SearchConfig(expand_thresh=2, max_nodes=512), ecfg, device=dev)
    eng.running = True
    for cmd in ("play black E5", "genmove white", "play black D4"):  # warm: tables, cuDNN, the kernels' build
        assert eng.send(cmd).startswith("=")
    stacks = []

    def run():
        assert eng.send("genmove white").startswith("=")

    seen, rec, outside = _syncs_by_span(run, stacks)
    n = int(rec.counters["search.rollouts"])
    c = rec.counters
    assert n == 32 == c["ops.descend_path"] == c["ops.backprop_path"] == rec.phases["search.descend"].count
    # no K1; one K2 launch an expansion
    assert c["ops.descend_backprop"] == 0 and c["ops.write_rows"] == rec.phases["search.expand"].count > 0
    in_rollouts = [
        s[-1] for s in stacks
        if "gtp.search" in s and "search.eval_and_expand" not in s and "search.init_trees" not in s
        and s[-1] != "sync.pool_full"  # once a chunk of 8, before it
    ]
    assert in_rollouts == ["sync.work_flag"] * n, (collections.Counter(in_rollouts), outside)
    assert "sync.descend_level" not in seen and "sync.descend_level" not in rec.phases


def _path_trees(dev, batch: int, n_pool: int, seed: int):
    """Synthetic search trees for K3/K4: every child has a higher slot than
    its parent (one to three higher, so that walks run deep), about 3 % of
    the nodes and every node past the pool's end are leaves, integer visit
    counts, random Wq/Wv and priors (some 0), a quarter of the rows with
    all valid children tied exactly, random terminal and expanded flags,
    values with NaNs and infinities, roots in the first eighth of the pool.
    Tree 0 is a chain of exact ties that runs past the depth bound to an
    unvalued node; where there are more trees, tree 1 is such a chain that
    ends at a leaf to expand at depth 40, and the last tree's root is a
    leaf."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    node = torch.arange(n_pool, device=dev)[None, :, None]
    child = node + 1 + (rand(batch, n_pool, 81) * 3).long()
    valid = (rand(batch, n_pool, 81) < 0.06) & (rand(batch, n_pool, 1) > 0.03) & (child < n_pool)
    nv = (rand(batch, n_pool, 81) * 12).floor()
    stats = {C_N: nv, C_WQ: (rand(batch, n_pool, 81) * 2 - 1) * nv, C_WV: (rand(batch, n_pool, 81) * 2 - 1) * nv,
             C_PRIOR: rand(batch, n_pool, 81) * (rand(batch, n_pool, 81) > 0.1)}
    tied = rand(batch, n_pool, 1) < 0.25
    for ch, x in stats.items():
        stats[ch] = torch.where(tied, x[:, :, :1].expand_as(x), x)
    # chains: node i ties between slot i + 1 (at a lower action) and slot i + 2
    lane = torch.arange(81, device=dev)
    chain = node[0, :, 0, None] + 1 + (lane[None, :] == 40)
    for b in range(min(batch, 2)):
        valid[b] = ((lane == 7) | (lane == 40))[None, :] & (chain < n_pool) & (node[0] < (n_pool, 40)[b])
        child[b] = chain
        for ch in stats:
            stats[ch][b] = stats[ch][b, :, :1].expand(-1, 81).clone()
        stats[C_N][b] = 5.0
    pstats = torch.zeros((batch, n_pool, 8, 128), device=dev)
    pstats[:, :, C_CHILD] = -1.0
    pstats[:, :, C_CHILD, :81] = torch.where(valid, child.float(), -1.0)
    for ch, x in stats.items():
        pstats[:, :, ch, :81] = x
    value = rand(batch, n_pool) * 2 - 1
    value[rand(batch, n_pool) < 0.3] = float("nan")
    value[rand(batch, n_pool) < 0.02] = float("inf")
    value[rand(batch, n_pool) < 0.02] = float("-inf")
    terminal = rand(batch, n_pool) < 0.1
    expanded = rand(batch, n_pool) < 0.3
    root = (rand(batch) * (n_pool // 8)).long()
    root_stats = torch.stack([(rand(batch) * 8).floor(), rand(batch) * 2 - 1, rand(batch) * 2 - 1], -1)
    root[: min(batch, 2)] = 0
    value[0, SearchConfig().max_depth - 1] = float("nan")
    if batch > 2:
        terminal[1, 40] = expanded[1, 40] = False
        root[-1], root_stats[-1, 0] = n_pool - 1, 0.0
    return pstats, value, terminal, expanded, root, root_stats


@pytest.mark.parametrize("sim", [False, True], ids=["no_sim", "sim"])
@pytest.mark.parametrize("use_value", [True, False], ids=["value", "no_value"])
@pytest.mark.parametrize("w", [1.0, 0.5])
@pytest.mark.parametrize("batch", [1, 8, 64, 1024])
def test_path_kernels_match_plain(dev, batch, w, use_value, sim):
    """K3 and K4 against their plain versions on the same tensors, bit for
    bit: the walk (leaf, depth, leaf's visits, the path over the plain
    version's levels, leaf and action 0 past them), ``need`` and the work
    flag, then ``pstats`` and ``root_stats`` after the backprop; walks past
    32 levels up to ``max_depth - 1``, exact score ties, a work flag that
    falls back to false in the next launch."""
    levels = SearchConfig().max_depth - 1
    pstats, value, terminal, expanded, root, root_stats = _path_trees(dev, batch, 256, batch + int(4 * w))
    kw = dict(c=1.5, w=w, levels=levels, expand_thresh=3)
    with metrics.recording() as rec:
        k = rollout.descend_path(pstats, value, terminal, expanded, root, root_stats, **kw)
    p = rollout.descend_path_plain(pstats, value, terminal, expanded, root, root_stats, **kw)
    torch.cuda.synchronize()
    width = p.rows.shape[1]
    for f in ("leaf", "depth", "leaf_n", "need", "work"):
        assert torch.equal(getattr(k, f), getattr(p, f)), f
    assert torch.equal(k.rows[:, :width], p.rows) and torch.equal(k.acts[:, :width], p.acts)
    assert torch.equal(k.rows[:, width:], k.leaf[:, None].expand(-1, levels - width))
    assert not bool(k.acts[:, width:].any())
    assert int(k.depth[0]) == levels and bool(k.work)  # tree 0 runs out of levels, through ties
    if batch > 2:
        assert k.depth[[1, -1]].tolist() == [40, 0] and k.need[[1, -1]].tolist() == [True, False]

    sim_reward = torch.where(torch.rand(batch, device=dev) < 0.5, 1.0, -1.0) if sim else None
    p_k, p_p = pstats.clone(), pstats.clone()
    rs_k, rs_p = root_stats.clone(), root_stats.clone()
    with metrics.recording() as rec_back:
        rollout.backprop_path(p_k, value, rs_k, k, sim_reward, use_value)
    rollout.backprop_path_plain(p_p, value, rs_p, p.leaf, p.rows, p.acts, p.depth, sim_reward, use_value)
    torch.cuda.synchronize()
    assert torch.equal(p_k, p_p) and torch.equal(rs_k, rs_p)
    assert torch.equal(rs_k[:, 0], root_stats[:, 0] + 1)
    assert (rec.counters, rec_back.counters) == ({"ops.descend_path": 1}, {"ops.backprop_path": 1})

    # nothing to do anywhere: every leaf valued and expanded
    calm = (value.nan_to_num(0.0), terminal, torch.ones_like(expanded), root, root_stats)
    k = rollout.descend_path(pstats, *calm, **kw)
    p = rollout.descend_path_plain(pstats, *calm, **kw)
    assert not bool(k.need.any()) and not bool(k.work) and not bool(p.work)


@pytest.mark.parametrize(
    "name", ["default", "fast_forest2", "leaf_batch4_forest2", "simulate"]
)
def test_engine_session_on_the_card(dev, name):
    """Ten commands answered on the card; the kernel configuration launches
    K1, the others K3 for every descent (and K4 for every rollout outside
    leaf-parallel search); every configuration lands each expansion's rows
    with one K2 launch."""
    fast = name == "fast_forest2"
    cfg = {
        "default": SearchConfig(expand_thresh=2, max_nodes=512),
        "fast_forest2": SearchConfig(expand_thresh=2, max_nodes=512, use_kernel=True, eval_every=8),
        "leaf_batch4_forest2": SearchConfig(expand_thresh=2, max_nodes=512, leaf_batch=4),
        "simulate": SearchConfig(expand_thresh=2, max_nodes=512, no_sim=False, max_turns=40),
    }[name]
    rollouts = 8 if name == "simulate" else 32
    ecfg = EngineConfig(time_lim=None, n_rollouts=rollouts, pondering=False, forest_size=2 if "forest2" in name else 1)
    eng = GTPEngine(fake_evaluator(), None, cfg, ecfg, device=dev)
    eng.running = True
    with metrics.recording() as rec:
        replies = [eng.send(c) for c in (
            "protocol_version", "boardsize 9", "clear_board", "play black E5", "genmove white",
            "genmove black", "undo", "play black E5", "showboard", "final_score",
        )]
    assert [r[0] for r in replies] == ["="] * 7 + ["?", "=", "="]
    assert replies[0] == "= 2\n\n" and replies[7] == "? illegal move\n\n"
    assert not bool(eng.state.invalid[0]) and eng._turn() == 2
    n = rec.counters
    assert (n["ops.descend_backprop"] > 0) == fast
    assert n["ops.write_rows"] == rec.phases["search.expand"].count > 0
    # every other configuration descends through K3; leaf-parallel search backs up on its own
    assert (n["ops.descend_path"] > 0) == (not fast)
    if name in ("default", "simulate"):
        assert n["ops.descend_path"] == n["ops.backprop_path"] == n["search.rollouts"]
    else:
        assert n["ops.backprop_path"] == 0


# ---------------------------------------------------------------------------
# The residual tower's trunk epilogue (ops/epilogue.py)


@pytest.mark.parametrize("residual", [False, True], ids=["bias_relu", "bias_residual_relu"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("batch,channels", [(1024, 256), (3, 16)])
def test_epilogue_kernel_matches_plain(dev, batch, channels, dtype, residual):
    gen = torch.Generator(device=dev).manual_seed(batch + channels)

    def activation():
        x = 2.0 * torch.randn((batch, 9, 9, channels), device=dev, generator=gen)
        return x.permute(0, 3, 1, 2).to(dtype)  # channels-last (B, C, 9, 9)

    y, bias = activation(), torch.randn(channels, device=dev, generator=gen).to(dtype)
    r = activation() if residual else None
    want = epilogue.bias_add_relu_plain(y.clone(), bias, r)
    with metrics.recording() as rec:
        got = epilogue.bias_add_relu(y, bias, r)
    torch.cuda.synchronize()
    assert got is y and rec.counters == {"ops.bias_add_relu": 1}
    assert torch.equal(y, want)
    assert bool((y == 0).any()) and bool((y > 0).any())  # both sides of the ReLU


def test_tower_forward_is_79_epilogue_launches_and_matches_the_unfused_one(dev, tmp_path):
    """One ``policy_value`` forward of the published-size tower at B=1024:
    79 epilogue launches (the stem and 78 trunk convolutions) and, in a
    traced forward, no elementwise kernel between its first and its last
    epilogue (the trace is read from its last forward: a profiler started
    late in a process can drop the first kernels of its window).  Its outputs, and
    those of the unfused route (``ResNetPV``'s own forward of the same
    folded weights), within the tower's bf16 limits (its cell's check) of
    the float32 reference, and within them of each other."""
    import json
    import os
    from pathlib import Path

    from bokego_tpu_torch.features import features_batch
    from bokego_tpu_torch.models import inference, resnet
    from benchmark.reference import agz as ref

    module = resnet.init_resnet(0, dev)
    net = module.inference()
    fts = features_batch(resnet.random_positions(256, (0, 20, 40, 60), 21, dev))
    assert fts.shape[0] == 1024
    with metrics.recording() as rec:
        probs, _ = inference.policy_value(net, fts)
    assert rec.counters["ops.bias_add_relu"] == 79
    assert bool(torch.isfinite(probs).all())
    with torch.inference_mode():
        fused = net(fts)
        unfused = resnet.ResNetPV.heads(net, resnet.ResNetPV.tower(net, fts))
        with metrics.device_trace(str(tmp_path)):
            for _ in range(3):
                net.tower(fts)
            torch.cuda.synchronize()
    fused, unfused = (tuple(t.float().cpu() for t in x) for x in (fused, unfused))
    want = ref.forward(module.state_dict(), fts.permute(0, 3, 1, 2), device=dev)
    limits = json.loads((Path(__file__).resolve().parents[1] / "benchmark/configs/selfplay-agz40-b1024.json").read_text())["check"]

    def gaps(a, b):
        logp = [torch.log_softmax(x[:, :81].float(), -1) for x in (a[0], b[0])]
        return float((logp[0] - logp[1]).abs().max()), float((a[1] - b[1]).abs().max())

    for what, (logp_gap, value_gap) in (
        ("fused vs float32", gaps(fused, want)), ("unfused vs float32", gaps(unfused, want)),
        ("fused vs unfused", gaps(fused, unfused)),
    ):
        assert logp_gap <= limits["logp_gap"] and value_gap <= limits["value_gap"], (what, logp_gap, value_gap)
    with open(os.path.join(tmp_path, "trace.json")) as f:
        events = sorted((e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"), key=lambda e: float(e["ts"]))
    kernels = [e["name"] for e in events]
    epi = [i for i, k in enumerate(kernels) if "bias_add_relu" in k]
    assert len(epi) >= 79, kernels
    trunk = kernels[epi[-79]:epi[-1] + 1]  # the last forward, stem epilogue to last epilogue
    assert sum("bias_add_relu" in k for k in trunk) == 79
    assert not [k for k in trunk if "elementwise" in k], trunk


# ---------------------------------------------------------------------------
# K5: the eval phase's board analysis (ops/leaf.py)


def _leaf_positions(batch: int, seed: int):
    """Seeded random games on the CPU, a quarter each stopped at ply 5, 30,
    55 and 80 (one game at ply 40 for B=1)."""
    if batch == 1:
        return random_positions(1, 40, seed, "cpu")
    parts = [random_positions(batch // 4, plies, seed + plies, "cpu") for plies in (5, 30, 55, 80)]
    return st.GoState(*(torch.cat(xs) for xs in zip(*(p.tensors() for p in parts))))


def _assert_leaf_tables_equal_plain(dev, s_cpu):
    """K5 through ``rules.leaf_analysis`` and ``features_batch`` on the card,
    one launch each, against the plain version on the CPU: every output bit
    for bit."""
    s = s_cpu.map(lambda x: x.to(dev))
    with metrics.recording() as rec:
        la = rules.leaf_analysis(s)
        planes_only = features.features_batch(s)
    assert rec.counters["ops.leaf_tables"] == 2 and "sync.group_pass" not in rec.phases
    plain, _ = rules._leaf_analysis(s_cpu)
    want_planes = features.features_from_tables(s_cpu, plain.mt)
    got = {
        "labels": la.mt.info.labels, "libs": la.mt.info.libs, "sizes": la.mt.info.sizes,
        "legal": la.mt.legal, "libs_after": la.mt.libs_after, "caps": la.mt.caps, "legal82": la.legal,
        "planes": la.planes, "planes_only": planes_only,
    }
    want = {
        "labels": plain.mt.info.labels, "libs": plain.mt.info.libs, "sizes": plain.mt.info.sizes,
        "legal": plain.mt.legal, "libs_after": plain.mt.libs_after, "caps": plain.mt.caps, "legal82": plain.legal,
        "planes": want_planes, "planes_only": want_planes,
    }
    for f in dataclasses.fields(st.GoState):
        got[f"children.{f.name}"] = getattr(la.children, f.name)
        want[f"children.{f.name}"] = getattr(plain.children, f.name)
    for name, x in got.items():
        assert x.device.type == "cuda" and x.dtype == want[name].dtype, name
        assert torch.equal(x.cpu(), want[name]), name


@pytest.mark.parametrize("batch", [1, 64, 1024])
def test_leaf_tables_match_plain(dev, batch):
    """K5 bit for bit against the plain version on seeded positions."""
    _assert_leaf_tables_equal_plain(dev, _leaf_positions(batch, seed=batch))


def test_leaf_tables_match_plain_on_crafted_boards(dev):
    """K5 on ``tests/torch_leaf_boards.CRAFTED``: the empty board, a snake
    chain across the board (the label loop's worst case), a move capturing
    two groups, a capture of eight, a ko before and after the take, a
    suicide point, a full board with one empty point for either side."""
    _assert_leaf_tables_equal_plain(dev, crafted_positions("cpu"))


def _group_passes_inside(rec, ancestor: str) -> int:
    """``sync.group_pass`` spans with ``ancestor`` among their enclosing spans."""
    spans, n = rec.spans, 0
    for s in spans:
        if s[0] != "sync.group_pass":
            continue
        parent = s[3]
        while parent >= 0 and spans[parent][0] != ancestor:
            parent = spans[parent][3]
        n += parent >= 0
    return n


@pytest.mark.parametrize("path", ["selfplay_move", "genmove"])
def test_leaf_tables_serve_every_eval_on_the_card(dev, path):
    """A batched kernel-path move (B=64, the bench's search with root noise)
    and a served ``genmove`` with the nets on the card: one K5 launch per
    eval step with work and per ``features_batch`` call, and no label pass
    (``sync.group_pass``) inside the eval phase."""
    params = {"policy": nets.init_policy(device=dev).eval(), "value": nets.init_value(device=dev).eval()}
    ev = mcts.net_evaluator()
    if path == "genmove":
        ecfg = EngineConfig(time_lim=None, n_rollouts=32, pondering=False)
        eng = GTPEngine(ev, params, SearchConfig(expand_thresh=2, max_nodes=512), ecfg, device=dev)
        eng.running = True
        assert eng.send("play black E5").startswith("=")

        def run():
            assert eng.send("genmove white").startswith("=")
    else:
        cfg = dataclasses.replace(BENCH_CONFIG, n_rollouts=64, noise_weight=0.25, dirichlet_alpha=0.1)
        roots = _midgame_roots(dev)
        roots = roots.map(lambda x: x.repeat(8, *[1] * (x.dim() - 1)))
        gen = torch.Generator(device=dev).manual_seed(0)

        def run():
            actions, _ = mcts.search(roots, ev, params, cfg, gen=gen)
            rules.is_terminal(rules.step(roots, actions), cfg.max_turns)

    with metrics.recording() as rec:
        run()
    ph = rec.phases
    evals = ph["search.eval_and_expand"].count
    assert evals > 0 and ph["features"].count > 0
    assert rec.counters["ops.leaf_tables"] == evals + ph["features"].count
    assert ph["rules.leaf_analysis"].count == evals
    assert _group_passes_inside(rec, "search.eval") == 0
    assert _group_passes_inside(rec, "search.eval_and_expand") == 0
