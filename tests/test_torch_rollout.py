"""Port parity: the rollout kernels' plain versions against the Pallas
kernels in interpret mode (the CUDA kernels are held against the plain
versions on the GPU in tests/test_torch_cuda.py).

All comparisons are exact: visit counts are integers, and the plain version
keeps the Pallas kernel's order of floating-point operations."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bokego_tpu.ops import rollout as jrollout
from bokego_tpu_torch.config import SearchConfig
from bokego_tpu_torch.ops import rollout as trollout
from bokego_tpu_torch.search import mcts as tmcts
from tests.torch_fake_eval import fake_evaluator
from tests.torch_port_util import random_positions, to_port

K1_CASES = {
    # name: (expand_thresh, rollouts, w, use_value, levels, randomise Wq)
    "thresh100": (100, 150, 1.0, True, 6, False),
    "thresh3": (3, 60, 1.0, True, 8, False),
    "thresh3_mixed_w": (3, 60, 0.5, True, 6, True),
    "thresh3_no_value_level_bound": (3, 60, 1.0, False, 2, False),
}


def _warm_inputs(thresh: int, rollouts: int, seed: int, randomise_wq: bool):
    """Trees warmed by the port's own kernel-path search (fake evaluator,
    as tests/test_rollout_kernel.py warms them), with some cached values
    knocked out to NaN; returns numpy (pstats, value, root)."""
    cfg = SearchConfig(
        expand_thresh=thresh, no_sim=True, max_nodes=256, max_turns=80,
        eval_every=2, kernel_levels=8, use_kernel=True,
    )
    ev = fake_evaluator()
    trees = tmcts.init_trees(to_port(random_positions(seed, 8, 10)), ev, None, cfg)
    trees = tmcts.run_search(trees, ev, None, cfg, rollouts)
    rng = np.random.default_rng(seed)
    pstats = trees.pstats.numpy().copy()
    value = trees.value.numpy().copy()
    value[rng.random(value.shape) < 0.3] = np.nan
    if randomise_wq:
        wq = rng.normal(0.0, 3.0, pstats[:, :, 1].shape).astype(np.float32)
        pstats[:, :, 1] = np.where(pstats[:, :, 0] > 0, wq, 0.0)
    return pstats, value, trees.root.numpy().astype(np.int32)


def _root_stats(seed: int, batch: int) -> np.ndarray:
    """Seeded root stats (N, Wq, Wv): integer counts, fractional Wv."""
    rng = np.random.default_rng(seed)
    rs = np.zeros((batch, 3), np.float32)
    rs[:, 0] = rng.integers(0, 200, batch)
    rs[:, 2] = rng.normal(0.0, 3.0, batch)
    return rs


@pytest.mark.parametrize("case", list(K1_CASES))
def test_descend_backprop_plain_matches_pallas(case):
    thresh, rollouts, w, use_value, levels, rand_wq = K1_CASES[case]
    pstats, value, root = _warm_inputs(thresh, rollouts, 7, rand_wq)
    want_p, want = jrollout.descend_backprop(
        jnp.asarray(pstats), jnp.asarray(value), jnp.asarray(root),
        c=4.0, w=w, use_value=use_value, levels=levels, tb=8, interpret=True,
    )
    got_p = torch.from_numpy(pstats.copy())
    root_stats = _root_stats(7, len(root))
    res = trollout.descend_backprop(
        got_p, torch.from_numpy(value), torch.from_numpy(root).long(), torch.from_numpy(root_stats.copy()),
        c=4.0, w=w, use_value=use_value, levels=levels,
    )
    got = trollout.unpack(res)
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got.root_n.numpy(), root_stats[:, 0])
    assert not (res[:, 7:] != 0).any()
    if thresh == 3 and not rand_wq:
        assert int(got.depth.max()) >= 2  # descents go below the root's children
    assert (got_p.numpy() != pstats).any()  # the backprop wrote in place


@pytest.mark.parametrize("w", [1.0, 0.5])
@pytest.mark.parametrize("rollouts", [1, 3, 8])
def test_fused_rollouts_plain_match_sequential_pallas(rollouts, w):
    """``rollouts`` rollouts in one call against as many calls of the Pallas
    kernel, each followed by the JAX search's root update
    (``bokego_tpu/search/mcts.py::_search_step_kernel``)."""
    pstats, value, root = _warm_inputs(3, 60, 9, w != 1.0)
    root_stats = _root_stats(9, len(root))
    kw = dict(c=4.0, w=w, use_value=True, levels=6)
    jp, jrs = jnp.asarray(pstats), jnp.asarray(root_stats)
    for _ in range(rollouts):
        jp, kd = jrollout.descend_backprop(
            jp, jnp.asarray(value), jnp.asarray(root), tb=8, interpret=True, **kw
        )
        root_sign = jnp.where(kd.depth % 2 == 0, 1.0, -1.0)
        root_upd = jnp.stack(
            [jnp.ones_like(root_sign), jnp.zeros_like(root_sign), root_sign * kd.leaf_val], axis=-1
        )
        old_root_n = jrs[..., 0]
        jrs = jrs + root_upd
    got_p, got_rs = torch.from_numpy(pstats.copy()), torch.from_numpy(root_stats.copy())
    res = trollout.descend_backprop(
        got_p, torch.from_numpy(value), torch.from_numpy(root).long(), got_rs, rollouts=rollouts, **kw
    )
    got = trollout.unpack(res)
    for f in kd._fields:  # the last rollout's
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(kd, f)), err_msg=f)
    np.testing.assert_array_equal(got.root_n.numpy(), np.asarray(old_root_n))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(got_rs.numpy(), np.asarray(jrs))
    assert float(got_rs[:, 0].sum()) == root_stats[:, 0].sum() + rollouts * len(root)


@pytest.mark.parametrize("mask_kind", ["none", "all", "mixed"])
def test_write_rows_plain_matches_pallas(mask_kind):
    rng = np.random.default_rng(11)
    b, n = 8, 16
    pstats = rng.normal(size=(b, n, 8, 128)).astype(np.float32)
    node = rng.integers(0, n, b).astype(np.int32)
    rows = rng.normal(size=(b, 8, 128)).astype(np.float32)
    mask = {"none": np.zeros(b, bool), "all": np.ones(b, bool), "mixed": rng.random(b) < 0.5}[mask_kind]
    want = np.asarray(jrollout.write_rows(
        jnp.asarray(pstats), jnp.asarray(node), jnp.asarray(rows), jnp.asarray(mask),
        tb=8, interpret=True,
    ))
    got = torch.from_numpy(pstats.copy())
    trollout.write_rows(got, torch.from_numpy(node).long(), torch.from_numpy(rows), torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)
    written = np.zeros((b, n), bool)
    written[np.arange(b), node] = mask
    np.testing.assert_array_equal(got.numpy()[~written], pstats[~written])  # bit-identical


def test_wrappers_check_inputs():
    p = torch.zeros(2, 4, 8, 128)
    with pytest.raises(ValueError, match="shape"):
        trollout.write_rows(torch.zeros(2, 4, 8, 64), torch.zeros(2, dtype=torch.int64), torch.zeros(2, 8, 64), torch.zeros(2, dtype=torch.bool))
    with pytest.raises(TypeError, match="dtype"):
        trollout.write_rows(p, torch.zeros(2, dtype=torch.int64), torch.zeros(2, 8, 128), torch.zeros(2))
    rs = torch.zeros(2, 3)
    with pytest.raises(TypeError, match="root: dtype"):
        trollout.descend_backprop(p, torch.zeros(2, 4), torch.zeros(2, dtype=torch.int32), rs, c=4.0, w=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        trollout.descend_backprop(p, torch.zeros(4, 2).t(), torch.zeros(2, dtype=torch.int64), rs, c=4.0, w=1.0)
    with pytest.raises(ValueError, match="root_stats: shape"):
        trollout.descend_backprop(p, torch.zeros(2, 4), torch.zeros(2, dtype=torch.int64), torch.zeros(2, 4), c=4.0, w=1.0)
    with pytest.raises(ValueError, match="rollouts=0"):
        trollout.descend_backprop(p, torch.zeros(2, 4), torch.zeros(2, dtype=torch.int64), rs, c=4.0, w=1.0, rollouts=0)
