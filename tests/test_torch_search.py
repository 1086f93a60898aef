"""Port parity of the search and self-play against the JAX package, with the
deterministic fake evaluator and no root noise: the kernel path against the
JAX kernel path (Pallas in interpret mode), the non-kernel path against the
JAX non-kernel path and against the port's own kernel path.  Exact: every
tree array, chosen action, final board and score is equal (XLA on the CPU
does not contract the PUCT score into fused multiply-adds here, so no stat
differs in the last place and no tolerance is needed)."""

import numpy as np
import pytest

import jax

from bokego_tpu.config import SearchConfig as JConfig
from bokego_tpu.search import mcts as jmcts
from bokego_tpu.parallel.selfplay import selfplay as jselfplay
from bokego_tpu_torch.config import SearchConfig as TConfig
from bokego_tpu_torch.ops import rollout as trollout
from bokego_tpu_torch.parallel.selfplay import selfplay as tselfplay
from bokego_tpu_torch.search import mcts as tmcts
from bokego_tpu_torch.utils import metrics
from tests.test_mcts import fake_evaluator as jax_fake_evaluator
from tests.torch_fake_eval import fake_evaluator
from tests.torch_port_util import assert_states_equal, random_positions, to_port

BASE = dict(
    no_sim=True, max_turns=80, max_nodes=256, eval_every=2, kernel_block=4,
    kernel_levels=6, use_kernel=True,
)
TREE_FIELDS = ("pstats", "root_stats", "n_nodes", "parent", "action", "value", "expanded", "terminal", "root")


def test_search_matches_jax_kernel_path():
    """``search`` from random midgame roots (one of them terminal)."""
    cfg = dict(BASE, expand_thresh=3)
    js = random_positions(21, 8, 14, pass_prob=0.05)
    n = 100
    jev = jax_fake_evaluator()
    jt = jmcts.init_trees(jax.random.PRNGKey(0), js, jev, None, JConfig(**cfg))
    jt = jax.jit(lambda t: jmcts.run_search(jax.random.PRNGKey(0), t, jev, None, JConfig(**cfg), n))(jt)
    ja = np.asarray(jax.vmap(jmcts.choose_action)(jt))

    with metrics.recording() as rec:
        ta, tt = tmcts.search(to_port(js), fake_evaluator(), None, TConfig(**cfg), n)
    for f in TREE_FIELDS:
        np.testing.assert_array_equal(getattr(tt, f).numpy(), np.asarray(getattr(jt, f)), err_msg=f)
    assert_states_equal(jt.nodes, tt.nodes, fields=("board", "ko", "turn", "last_move"))
    np.testing.assert_array_equal(ta.numpy(), ja)
    assert int(tt.n_nodes.max()) > 82  # the search expanded below the root
    # CPU tensors take the plain versions: no kernel launch.  One K1 call a
    # rollout group, expansions, and no K3/K4 descent
    assert not [k for k in rec.counters if k.startswith("ops.")]
    assert rec.phases["search.k1"].count == len(tmcts.rollout_groups(n, cfg["eval_every"])) == 51
    assert rec.counters["search.rollouts"] == n
    assert rec.phases["search.expand"].count > 1 and "search.descend" not in rec.phases


@pytest.mark.parametrize(
    "n_rollouts,eval_every", [(100, 2), (21, 8), (5, 8), (7, 1), (0, 8)]
)
def test_grouped_run_search_matches_steps_and_jax(n_rollouts, eval_every):
    """``run_search`` (one kernel call per run of steps that ends on an eval
    step) against a loop of ``search_step`` and against the JAX kernel path."""
    cfg = dict(BASE, expand_thresh=3, eval_every=eval_every)
    js = random_positions(23, 8, 14, pass_prob=0.05)
    jev = jax_fake_evaluator()
    jt = jmcts.init_trees(jax.random.PRNGKey(0), js, jev, None, JConfig(**cfg))
    jt = jax.jit(lambda t: jmcts.run_search(jax.random.PRNGKey(0), t, jev, None, JConfig(**cfg), n_rollouts))(jt)

    tcfg, tev = TConfig(**cfg), fake_evaluator()
    grouped = tmcts.run_search(tmcts.init_trees(to_port(js), tev, None, tcfg), tev, None, tcfg, n_rollouts)
    stepped = tmcts.init_trees(to_port(js), tev, None, tcfg)
    for i in range(n_rollouts):
        stepped = tmcts.search_step(stepped, tev, None, tcfg, i)
    for f in TREE_FIELDS:
        np.testing.assert_array_equal(getattr(grouped, f).numpy(), getattr(stepped, f).numpy(), err_msg=f)
        np.testing.assert_array_equal(getattr(grouped, f).numpy(), np.asarray(getattr(jt, f)), err_msg=f)
    assert_states_equal(jt.nodes, grouped.nodes, fields=("board", "ko", "turn", "last_move"))
    np.testing.assert_array_equal(
        tmcts.choose_action(grouped).numpy(), np.asarray(jax.vmap(jmcts.choose_action)(jt))
    )
    np.testing.assert_array_equal(grouped.root_stats[:, 0].numpy(), np.full(8, n_rollouts, np.float32))


@pytest.mark.parametrize(
    "n_rollouts,eval_every,want",
    [
        (400, 8, [(1, True)] + [(8, True)] * 49 + [(7, False)]),
        (21, 8, [(1, True), (8, True), (8, True), (4, False)]),
        (5, 8, [(1, True), (4, False)]),
        (17, 8, [(1, True), (8, True), (8, True)]),
        (3, 1, [(1, True)] * 3),
        (0, 8, []),
    ],
)
def test_rollout_groups(n_rollouts, eval_every, want):
    """Every group but a tail ends on an eval step; the lengths add up."""
    groups = tmcts.rollout_groups(n_rollouts, eval_every)
    assert groups == want
    assert sum(n for n, _ in groups) == n_rollouts


def test_selfplay_matches_jax_kernel_path():
    cfg = dict(BASE, expand_thresh=3)
    batch, n_moves, n_rollouts = 8, 3, 24
    jr = jselfplay(jax.random.PRNGKey(0), None, jax_fake_evaluator(), JConfig(**cfg), batch, n_moves, n_rollouts)
    tr = tselfplay(None, fake_evaluator(), TConfig(**cfg), batch, n_moves, n_rollouts, device="cpu")
    np.testing.assert_array_equal(tr.actions.numpy(), np.asarray(jr.actions))
    assert_states_equal(jr.final, tr.final)
    np.testing.assert_array_equal(tr.scores.numpy(), np.asarray(jr.scores))
    assert not tr.final.invalid.any()


PLAIN = dict(no_sim=True, max_turns=80, max_nodes=256, use_kernel=False)


@pytest.mark.parametrize(
    "eval_every,expand_thresh,n_rollouts",
    [(1, 3, 60), (1, 0, 40), (1, 100, 120), (2, 3, 60), (2, 10, 61)],
)
def test_non_kernel_search_matches_jax(eval_every, expand_thresh, n_rollouts):
    """``run_search`` without the kernels, both orderings: evaluate then
    backprop at ``eval_every == 1``, backprop then evaluate above."""
    cfg = dict(PLAIN, eval_every=eval_every, expand_thresh=expand_thresh)
    js = random_positions(24, 6, 14, pass_prob=0.05)
    jev = jax_fake_evaluator()
    jt = jmcts.init_trees(jax.random.PRNGKey(0), js, jev, None, JConfig(**cfg))
    jt = jax.jit(lambda t: jmcts.run_search(jax.random.PRNGKey(0), t, jev, None, JConfig(**cfg), n_rollouts))(jt)

    ta, tt = tmcts.search(to_port(js), fake_evaluator(), None, TConfig(**cfg), n_rollouts)
    for f in TREE_FIELDS:
        np.testing.assert_array_equal(getattr(tt, f).numpy(), np.asarray(getattr(jt, f)), err_msg=f)
    assert_states_equal(jt.nodes, tt.nodes, fields=("board", "ko", "turn", "last_move"))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(jax.vmap(jmcts.choose_action)(jt)))
    np.testing.assert_array_equal(tt.root_stats[:, 0].numpy(), np.full(6, n_rollouts, np.float32))
    if expand_thresh < 100:
        assert int(tt.n_nodes.max()) > 82  # the search expanded below the root


@pytest.mark.parametrize("expand_thresh", [3, 10])
def test_non_kernel_search_matches_kernel_path(expand_thresh):
    """At ``eval_every=2`` both of the port's paths backprop before they
    evaluate: same trees, step by step and through ``run_search``."""
    ts = to_port(random_positions(25, 6, 14, pass_prob=0.05))
    tev = fake_evaluator()
    plain_cfg = TConfig(**dict(PLAIN, eval_every=2, expand_thresh=expand_thresh))
    kernel_cfg = TConfig(**dict(BASE, kernel_levels=8, expand_thresh=expand_thresh))
    plain = tmcts.run_search(tmcts.init_trees(ts, tev, None, plain_cfg), tev, None, plain_cfg, 60)
    kernel = tmcts.run_search(tmcts.init_trees(ts, tev, None, kernel_cfg), tev, None, kernel_cfg, 60)
    stepped = tmcts.init_trees(ts, tev, None, plain_cfg)
    for i in range(60):
        stepped = tmcts.search_step(stepped, tev, None, plain_cfg, i)
    for f in TREE_FIELDS:
        np.testing.assert_array_equal(getattr(plain, f).numpy(), getattr(kernel, f).numpy(), err_msg=f)
        np.testing.assert_array_equal(getattr(plain, f).numpy(), getattr(stepped, f).numpy(), err_msg=f)
    assert int(plain.n_nodes.max()) > 82


@pytest.mark.parametrize(
    "cfg",
    [dict(BASE, no_sim=False), dict(PLAIN, leaf_batch=4)],
    ids=["simulation_mode", "leaf_parallel"],
)
def test_unported_paths_raise(cfg):
    """No search path is left that raises ``NotImplementedError``: simulation
    mode (through the non-kernel path even where the kernels are asked for,
    as in the JAX package) and a configuration with ``leaf_batch`` run
    through ``init_trees``, ``search_step`` and ``run_search`` and count
    their rollouts.  What still raises is what cannot run at all: simulation
    mode without a generator.  Root noise runs as before."""
    import torch

    ts = to_port(random_positions(22, 2, 4))
    tcfg = TConfig(**dict(cfg, max_turns=12))
    gen = torch.Generator().manual_seed(0)
    with metrics.recording() as rec:
        trees = tmcts.init_trees(ts, fake_evaluator(), None, tcfg)
        trees = tmcts.search_step(trees, fake_evaluator(), None, tcfg, gen=gen)
        trees = tmcts.run_search(trees, fake_evaluator(), None, tcfg, 4, gen=gen)
    assert trees.root_stats[:, 0].tolist() == [5.0, 5.0]
    # CPU tensors: no kernel launch.  Both run the non-kernel search: one
    # descent and one backprop a rollout, no K1
    assert not [k for k in rec.counters if k.startswith("ops.")]
    assert rec.phases["search.descend"].count == rec.phases["search.backprop"].count == 5
    assert rec.phases["search.expand"].count > 0 and "search.k1" not in rec.phases
    if not tcfg.no_sim:
        assert bool((trees.root_stats[:, 1] != 0).all())  # five playouts of +-1 each
        with pytest.raises(ValueError, match="Generator"):
            tmcts.run_search(trees, fake_evaluator(), None, tcfg, 1)
    plain = TConfig(**dict(PLAIN, noise_weight=0.25))
    trees = tmcts.init_trees(ts, fake_evaluator(), None, plain, gen=torch.Generator().manual_seed(0))
    trees = tmcts.search_step(trees, fake_evaluator(), None, plain)
    assert trees.root_stats[:, 0].tolist() == [1.0, 1.0]


def _grown_trees(expand_thresh: int, eval_every: int, rollouts: int = 30):
    """Non-kernel trees grown from random midgame roots; at ``eval_every > 1``
    some leaves are still unvalued."""
    cfg = TConfig(**dict(PLAIN, eval_every=eval_every, expand_thresh=expand_thresh))
    ts = to_port(random_positions(26, 6, 14, pass_prob=0.05))
    ev = fake_evaluator()
    return tmcts.run_search(tmcts.init_trees(ts, ev, None, cfg), ev, None, cfg, rollouts), cfg


@pytest.mark.parametrize("use_value", [True, False])
@pytest.mark.parametrize("w", [1.0, 0.5])
def test_path_wrappers_take_the_plain_versions_on_the_cpu(w, use_value):
    """``descend_path`` and ``backprop_path`` on CPU tensors are their plain
    versions, and launch nothing."""
    import torch

    trees, cfg = _grown_trees(1, 2, 40)
    trees.pstats[:, :, 1] = torch.randn(trees.pstats[:, :, 1].shape, generator=torch.Generator().manual_seed(0))
    args = (trees.pstats, trees.value, trees.terminal, trees.expanded, trees.root, trees.root_stats)
    kw = dict(c=cfg.exploration_weight, w=w, levels=cfg.max_depth - 1, expand_thresh=cfg.expand_thresh)
    with metrics.recording() as rec:
        got, want = trollout.descend_path(*args, **kw), trollout.descend_path_plain(*args, **kw)
        for f in trollout.PathDescent._fields:
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        assert int(got.depth.max()) >= (2 if w == 1.0 else 1)  # random Wq steers toward fresh edges
        reward = torch.tensor([1.0, -1.0] * 3)
        p_got, p_want = trees.pstats.clone(), trees.pstats.clone()
        rs_got, rs_want = trees.root_stats.clone(), trees.root_stats.clone()
        trollout.backprop_path(p_got, trees.value, rs_got, got, reward, use_value)
        trollout.backprop_path_plain(p_want, trees.value, rs_want, *want[:3], want.depth, reward, use_value)
    assert torch.equal(p_got, p_want) and torch.equal(rs_got, rs_want)
    assert not torch.equal(p_got, trees.pstats)
    assert rec.counters == {}


@pytest.mark.parametrize("expand_thresh,eval_every", [(0, 1), (3, 2), (10, 2), (100, 1)])
def test_descent_need_and_work_are_the_step_expression(expand_thresh, eval_every):
    """``_descend_batch``'s ``need`` and work flag on a grown tree equal the
    expression ``_search_step_plain`` computed from the descent before
    they moved into it: the leaf's visits (the root's own at depth 0) above
    ``expand_thresh``, not terminal, not expanded; the flag ``need`` or an
    unvalued leaf in any tree."""
    import torch

    from bokego_tpu_torch.search.tree import take_rows

    trees, cfg = _grown_trees(expand_thresh, eval_every)
    flags = set()
    for i in range(12):
        desc = tmcts._descend_batch(trees, cfg, 1.0)
        leaf_visits = torch.where(desc.depth > 0, desc.leaf_n, trees.root_stats[:, 0])
        need = (
            (leaf_visits > cfg.expand_thresh)
            & ~take_rows(trees.terminal, desc.leaf)
            & ~take_rows(trees.expanded, desc.leaf)
        )
        assert torch.equal(desc.need, need)
        assert bool(desc.work) == bool(need.any() | take_rows(trees.value, desc.leaf).isnan().any())
        flags.add(bool(desc.work))
        trees = tmcts.search_step(trees, fake_evaluator(), None, cfg, i)
    if expand_thresh == 100:
        assert flags == {False}  # valued leaves below the threshold: nothing to do
    elif expand_thresh == 0:
        assert flags == {True}
