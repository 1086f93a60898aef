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


@pytest.mark.parametrize(
    "thresh,rollouts,levels,w", [(100, 150, 6, 1.0), (3, 60, 8, 1.0), (3, 60, 2, 1.0), (3, 60, 8, 0.5)]
)
def test_kernels_match_plain(dev, thresh, rollouts, levels, w):
    trees = _warm_trees(dev, thresh, rollouts)
    value = trees.value.clone()
    value[torch.rand(value.shape, device=dev) < 0.3] = float("nan")
    pstats = trees.pstats.clone()
    if w != 1.0:  # the search leaves Wq at 0 (no simulations): give it values
        pstats[:, :, C_WQ] = torch.randn(pstats[:, :, C_WQ].shape, device=dev)
    kw = dict(c=4.0, w=w, use_value=True, levels=levels)
    p_kernel, p_plain = pstats.clone(), pstats.clone()
    before = dict(rollout.launches)
    res_k = rollout.descend_backprop(p_kernel, value, trees.root, **kw)
    res_p = rollout.descend_backprop_plain(p_plain, value, trees.root, **kw)
    torch.cuda.synchronize()
    assert torch.equal(res_k, res_p)
    assert torch.equal(p_kernel, p_plain)
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


def test_selfplay_gpu_equals_cpu(dev):
    cfg = _cfg(3)
    rollout.reset_launches()
    r_gpu = selfplay(None, fake_evaluator(), cfg, 8, 3, 40, device=dev)
    assert all(n > 0 for n in rollout.launches.values())
    r_cpu = selfplay(None, fake_evaluator(), cfg, 8, 3, 40, device="cpu")
    assert torch.equal(r_gpu.actions.cpu(), r_cpu.actions)
    assert torch.equal(r_gpu.final.board.cpu(), r_cpu.final.board)
    assert torch.equal(r_gpu.final.hash.cpu(), r_cpu.final.hash)
    assert torch.equal(r_gpu.scores.cpu(), r_cpu.scores)
