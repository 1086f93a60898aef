"""GPU tests of the port: the CUDA kernels against their plain versions, and
GPU self-play against CPU self-play.  Marked ``cuda``; they skip without a
GPU.  This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Comparisons are exact: the kernels are built without FMA contraction and
keep the plain versions' order of floating-point operations."""

import pytest
import torch

from bokego_tpu_torch.config import SearchConfig
from bokego_tpu_torch.env import rules, state as st
from bokego_tpu_torch.ops import rollout
from bokego_tpu_torch.parallel.selfplay import selfplay
from bokego_tpu_torch.search import mcts
from bokego_tpu_torch.search.tree import C_WQ
from tests.torch_fake_eval import fake_evaluator

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
    before = dict(rollout.launches)
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
        rollout.write_rows(p_kernel, node, rows, mask)
        rollout.write_rows_plain(p_plain, node, rows, mask)
        torch.cuda.synchronize()
        assert torch.equal(p_kernel, p_plain)
    assert rollout.launches["descend_backprop"] == before["descend_backprop"] + 1
    assert rollout.launches["write_rows"] == before["write_rows"] + 3


@pytest.mark.parametrize("levels,w,use_value", [(6, 1.0, True), (8, 0.5, True), (2, 1.0, False)])
def test_fused_rollouts_match_plain_and_single_launches(dev, levels, w, use_value):
    """One launch of 8 rollouts against the plain version at 8 rollouts and
    against 8 launches of one rollout: everything bit for bit."""
    trees = _warm_trees(dev, 3, 60)
    pstats, value = _k1_inputs(dev, trees, w)
    kw = dict(c=4.0, w=w, use_value=use_value, levels=levels)
    p_fused, p_plain, p_single = pstats.clone(), pstats.clone(), pstats.clone()
    rs_fused, rs_plain, rs_single = (trees.root_stats.clone() for _ in range(3))
    rollout.reset_launches()
    res_f = rollout.descend_backprop(p_fused, value, trees.root, rs_fused, rollouts=8, **kw)
    assert (rollout.launches["descend_backprop"], rollout.kernel_rollouts) == (1, 8)
    res_p = rollout.descend_backprop_plain(p_plain, value, trees.root, rs_plain, rollouts=8, **kw)
    for _ in range(8):
        res_s = rollout.descend_backprop(p_single, value, trees.root, rs_single, **kw)
    torch.cuda.synchronize()
    assert (rollout.launches["descend_backprop"], rollout.kernel_rollouts) == (9, 16)
    for res, p, rs in ((res_p, p_plain, rs_plain), (res_s, p_single, rs_single)):
        assert torch.equal(res_f, res)
        assert torch.equal(p_fused, p)
        assert torch.equal(rs_fused, rs)
    assert torch.equal(rs_fused[:, 0], trees.root_stats[:, 0] + 8)
    assert not torch.equal(p_fused, pstats)


def test_selfplay_gpu_equals_cpu(dev):
    cfg = _cfg(3)
    rollout.reset_launches()
    r_gpu = selfplay(None, fake_evaluator(), cfg, 8, 3, 40, device=dev)
    assert all(n > 0 for n in rollout.launches.values())
    # 40 rollouts at eval_every=2: step 0, 19 pairs, one light step; 3 moves
    assert rollout.launches["descend_backprop"] == 3 * len(mcts.rollout_groups(40, cfg.eval_every)) == 63
    assert rollout.kernel_rollouts == 3 * 40
    r_cpu = selfplay(None, fake_evaluator(), cfg, 8, 3, 40, device="cpu")
    assert torch.equal(r_gpu.actions.cpu(), r_cpu.actions)
    assert torch.equal(r_gpu.final.board.cpu(), r_cpu.final.board)
    assert torch.equal(r_gpu.final.hash.cpu(), r_cpu.final.hash)
    assert torch.equal(r_gpu.scores.cpu(), r_cpu.scores)
