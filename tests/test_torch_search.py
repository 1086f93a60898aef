"""Port parity of the whole slice: the kernel-path search and self-play
against the JAX package's kernel path (Pallas in interpret mode), with the
deterministic fake evaluator and no root noise.  Exact: every tree array,
chosen action, final board and score is equal."""

import warnings

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

    trollout.reset_launches()
    ta, tt = tmcts.search(to_port(js), fake_evaluator(), None, TConfig(**cfg), n)
    for f in TREE_FIELDS:
        np.testing.assert_array_equal(getattr(tt, f).numpy(), np.asarray(getattr(jt, f)), err_msg=f)
    assert_states_equal(jt.nodes, tt.nodes, fields=("board", "ko", "turn", "last_move"))
    np.testing.assert_array_equal(ta.numpy(), ja)
    assert int(tt.n_nodes.max()) > 82  # the search expanded below the root
    # CPU tensors take the plain versions: no kernel launches
    assert trollout.launches == {"descend_backprop": 0, "write_rows": 0}


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


@pytest.mark.parametrize(
    "cfg",
    [dict(BASE, use_kernel=False), dict(BASE, no_sim=False)],
    ids=["non_kernel_path", "simulation_mode"],
)
def test_unported_paths_raise(cfg):
    """Paths outside this slice raise instead of falling back."""
    ts = to_port(random_positions(22, 2, 4))
    trees = tmcts.init_trees(ts, fake_evaluator(), None, TConfig(**cfg))
    with pytest.raises(NotImplementedError):
        tmcts.search_step(trees, fake_evaluator(), None, TConfig(**cfg))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        noisy = TConfig(**dict(BASE, noise_weight=0.25))
    with pytest.raises(NotImplementedError):
        tmcts.init_trees(ts, fake_evaluator(), None, noisy)
