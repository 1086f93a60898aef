"""The port's leaf-parallel search (``search/leafpar.py``).

``K = 1`` is the port's sequential search bit for bit; without simulations
the search draws no random number at any K, so it is held against
``bokego_tpu.search.leafpar`` array for array.  Tolerance 0 on every tree
array: N and the child, value and node-count arrays are integers or copies,
and Wq/Wv take the same float32 terms in the same order in both packages
(an edge that several paths share adds them path by path, k = 0..K-1, as
do the roots' own sums), so they round alike.  Then the
invariants of ``tests/test_leafpar.py`` at a small size, the virtual loss
netting out exactly, and simulation mode with the one-hot playout policy
against the JAX package."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bokego_tpu.config import SearchConfig as JConfig
from bokego_tpu.search import leafpar as jleafpar
from bokego_tpu.search import mcts as jmcts
from bokego_tpu_torch.config import SearchConfig as TConfig
from bokego_tpu_torch.coords import NN
from bokego_tpu_torch.search import leafpar, mcts
from bokego_tpu_torch.search import tree as tr
from tests.test_leafpar import _stones_eval as jax_stones_evaluator
from tests.test_mcts import fake_evaluator as jax_fake_evaluator
from tests.test_torch_playout import jax_onehot_evaluator
from tests.torch_fake_eval import fake_evaluator, onehot_evaluator, stones_evaluator
from tests.torch_port_util import assert_states_equal, random_positions, to_port

TREE_FIELDS = ("pstats", "root_stats", "n_nodes", "parent", "action", "value", "expanded", "terminal", "root")
CFG = dict(expand_thresh=3, max_nodes=256, no_sim=True, noise_weight=0.0)
EVALUATORS = {
    "fake": (fake_evaluator, jax_fake_evaluator),
    "stones_fused": (stones_evaluator, jax_stones_evaluator),
}


def _assert_trees_equal(a, b):
    for f in TREE_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("ev_name", list(EVALUATORS))
def test_k1_matches_sequential_bitwise(ev_name):
    """K=1 (virtual loss forced to 0) is ``mcts.search_step`` exactly, on the
    plain and on the fused (``evaluate_fts``) evaluation path."""
    ev = EVALUATORS[ev_name][0]()
    cfg = TConfig(**CFG)
    ts = to_port(random_positions(51, 3, 16))
    seq = mcts.run_search(mcts.init_trees(ts, ev, None, cfg), ev, None, cfg, 40)
    par = leafpar.run_search_k(mcts.init_trees(ts, ev, None, cfg), ev, None, cfg, 40, 1, vl=1.0)
    _assert_trees_equal(seq, par)
    assert int(par.n_nodes.max()) > 82
    for x, y in zip(seq.nodes.tensors(), par.nodes.tensors()):
        assert torch.equal(x, y)


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("K", [4, 8])
@pytest.mark.parametrize("ev_name", list(EVALUATORS))
def test_no_sim_search_matches_jax(ev_name, K, batch):
    """``run_search_k`` without simulations against the JAX package, array
    for array (tolerance 0), from midgame roots."""
    tev_fn, jev_fn = EVALUATORS[ev_name]
    n = 48
    # the top 8 children only: 48 rollouts grow several levels inside the pool
    cfg_kw = dict(CFG, expand_thresh=1, branch_num=8)
    js = random_positions(52, batch, 14, pass_prob=0.05)
    jev = jev_fn()
    jt = jmcts.init_trees(jax.random.PRNGKey(0), js, jev, None, JConfig(**cfg_kw))
    jt = jax.jit(lambda t: jleafpar.run_search_k(jax.random.PRNGKey(1), t, jev, None, JConfig(**cfg_kw), n, K))(jt)

    tev, cfg = tev_fn(), TConfig(**cfg_kw)
    tt = leafpar.run_search_k(mcts.init_trees(to_port(js), tev, None, cfg), tev, None, cfg, n, K)
    _assert_trees_equal(tt, jt)
    assert_states_equal(jt.nodes, tt.nodes, fields=("board", "ko", "turn", "last_move"))
    np.testing.assert_array_equal(
        mcts.choose_action(tt).numpy(), np.asarray(jax.vmap(jmcts.choose_action)(jt))
    )
    assert int(tt.expanded.sum(1).min()) >= 4  # leaves were expanded below every root


def test_rollout_count_rounds_up_to_whole_steps():
    """``ceil(n / K)`` steps of K, as in the JAX package: 10 rollouts at K=4
    are 12."""
    js = random_positions(53, 2, 10)
    jev, tev = jax_fake_evaluator(), fake_evaluator()
    jt = jmcts.init_trees(jax.random.PRNGKey(0), js, jev, None, JConfig(**CFG))
    jt = jax.jit(lambda t: jleafpar.run_search_k(jax.random.PRNGKey(1), t, jev, None, JConfig(**CFG), 10, 4))(jt)
    cfg = TConfig(**CFG)
    tt = leafpar.run_search_k(mcts.init_trees(to_port(js), tev, None, cfg), tev, None, cfg, 10, 4)
    assert tt.root_stats[:, 0].tolist() == [12.0, 12.0]
    _assert_trees_equal(tt, jt)


@pytest.mark.parametrize("K", [4, 8])
@pytest.mark.parametrize("ev_name", list(EVALUATORS))
def test_k_parallel_invariants(ev_name, K):
    """K>1: the virtual losses net out exactly and the trees stay consistent."""
    n = 64
    ev, cfg = EVALUATORS[ev_name][0](), TConfig(**CFG)
    ts = to_port(random_positions(54, 2, 16))
    t = leafpar.run_search_k(mcts.init_trees(ts, ev, None, cfg), ev, None, cfg, n, K)
    assert t.root_stats[:, 0].tolist() == [float(n)] * 2  # every rollout counted once at the root
    for b in range(2):
        pstats = t.pstats[b].numpy()
        nplane = pstats[:, tr.C_N, :NN]
        np.testing.assert_array_equal(nplane, np.round(nplane))  # no residue of a virtual visit
        assert nplane.min() >= 0
        child = pstats[:, tr.C_CHILD, :NN].astype(np.int64)
        root = int(t.root[b])
        # a descent from an expanded root always steps into a child
        assert nplane[root][child[root] >= 0].sum() == n
        # no simulations: Wq is back at exactly 0 everywhere
        assert not pstats[:, tr.C_WQ, :NN].any()
        visited = np.zeros(t.capacity, bool)
        visited[root] = True
        visited[child[(child >= 0) & (nplane > 0)]] = True
        assert np.isfinite(t.value[b].numpy()[visited]).all()
        # |Wv| <= N * max|value| (0.8 for both evaluators)
        assert np.all(np.abs(pstats[:, tr.C_WV, :NN]) <= nplane * 0.8 + 1e-5)
        alloc = int(t.n_nodes[b])
        assert np.all(child[child >= 0] < alloc)
        parents = np.nonzero(child >= 0)[0]
        assert np.all(child[child >= 0] > parents)  # children allocate after their parents


@pytest.mark.parametrize("vl", [1.0, 0.5])
def test_vloss_then_backprop_with_no_real_update_restores_pstats(vl):
    """``_apply_vloss`` for K descents, then ``_backprop_k`` with no real
    reward or value: what is left is one visit per traversed edge.  N (less
    those visits), Wq (0 before) and every untouched plane come back
    exactly; Wv within 1e-5 absolute, because ``(x + vl) - vl`` rounds where
    ``x + vl`` needs a larger exponent than ``x`` (one ulp of a float32 of
    the size of a Wv here, at most about 30, is 2e-6)."""
    ev, cfg = fake_evaluator(), TConfig(**CFG)
    ts = to_port(random_positions(55, 3, 16))
    trees = mcts.run_search(mcts.init_trees(ts, ev, None, cfg), ev, None, cfg, 30)
    before = trees.pstats.clone()
    root_before = trees.root_stats.clone()
    singles = []
    for _ in range(4):
        d = mcts._descend_batch(trees, cfg, 1.0)
        leafpar._apply_vloss(trees, d, vl)
        singles.append(d)
    descs = leafpar._stack_descents(singles)
    assert not torch.equal(trees.pstats, before)  # the losses are visible to the next descent
    assert torch.equal(trees.root_stats, root_before)  # the roots take none
    # the descents diverged: not all four reach the same leaf
    assert len({tuple(d.leaf.tolist()) for d in singles}) > 1
    leafpar._backprop_k(trees, descs, None, vl, use_value=False)
    visits = torch.zeros_like(before)  # one visit per traversed edge, in the N plane
    n_only = torch.tensor([1.0, 0.0, 0.0])[None, :, None, None] * leafpar._used_levels(descs)[:, None]
    leafpar._accumulate(visits, leafpar._edge_offsets(visits, descs), n_only)
    assert not bool(visits[:, :, tr.C_WQ].any() | visits[:, :, tr.C_WV].any())
    assert int(visits.sum()) == int(descs.depth.sum()) > 0
    exact = [c for c in range(tr.CH_PAD) if c != tr.C_WV]
    assert torch.equal((trees.pstats - visits)[:, :, exact], before[:, :, exact])
    np.testing.assert_allclose(
        trees.pstats[:, :, tr.C_WV].numpy(), before[:, :, tr.C_WV].numpy(), rtol=0, atol=1e-5
    )
    assert trees.root_stats[:, 0].tolist() == (root_before[:, 0] + 4).tolist()
    assert torch.equal(trees.root_stats[:, 1:], root_before[:, 1:])


def test_step_without_work_nets_out_and_skips_the_evaluation():
    """A step on which every leaf is valued and none may expand runs no
    evaluation, and still removes its virtual losses."""
    calls = []
    base = fake_evaluator()

    def counted(params, states):
        calls.append(states.board.shape[0])
        return base.evaluate(params, states)

    ev = base._replace(evaluate=counted)
    cfg = TConfig(**dict(CFG, expand_thresh=100))
    ts = to_port(random_positions(56, 2, 12))
    trees = mcts.init_trees(ts, ev, None, cfg)
    trees = leafpar.run_search_k(trees, ev, None, cfg, 400, 4)
    assert calls[0] == 2 and set(calls[1:]) == {8}  # init, then K*B leaves a forward
    n_evals = len(calls)
    assert n_evals < 60  # 81 children a root: most steps reach valued leaves only
    trees = leafpar.search_step_k(trees, ev, None, cfg, 4)
    nplane = trees.pstats[:, :, tr.C_N, :NN]
    assert torch.equal(nplane, nplane.round())
    assert not bool(trees.pstats[:, :, tr.C_WQ].any())
    assert trees.root_stats[:, 0].tolist() == [404.0, 404.0]


def test_eval_every_must_be_one():
    cfg = TConfig(**dict(CFG, eval_every=2))
    with pytest.raises(ValueError, match="eval_every"):
        leafpar.search_step_k(None, fake_evaluator(), None, cfg, 4)
    with pytest.raises(ValueError, match="eval_every"):
        TConfig(leaf_batch=4, eval_every=2)
    with pytest.raises(ValueError, match="non-kernel"):
        TConfig(leaf_batch=4, use_kernel=True)


@pytest.mark.parametrize("K,batch", [(4, 2), (1, 2)])
def test_simulation_mode_matches_jax(K, batch):
    """``no_sim=False`` leaf-parallel search with the one-hot playout policy
    (all K*B leaves played out in one batch), array for array."""
    cfg = dict(expand_thresh=2, max_nodes=256, no_sim=False, value_net_weight=0.5, max_turns=40, noise_weight=0.0)
    n = 16
    js = random_positions(57, batch, 14, pass_prob=0.05).replace(komi=jnp.asarray([-20.0, 30.0][:batch], jnp.float32))
    jev = jax_onehot_evaluator()
    jt = jmcts.init_trees(jax.random.PRNGKey(0), js, jev, None, JConfig(**cfg))
    jt = jax.jit(lambda t: jleafpar.run_search_k(jax.random.PRNGKey(2), t, jev, None, JConfig(**cfg), n, K))(jt)
    tev, tcfg = onehot_evaluator(), TConfig(**cfg)
    tt = mcts.init_trees(to_port(js), tev, None, tcfg)
    tt = leafpar.run_search_k(tt, tev, None, tcfg, n, K, gen=torch.Generator().manual_seed(0))
    _assert_trees_equal(tt, jt)
    assert tt.root_stats[:, 0].tolist() == [float(n)] * batch
    assert len(set(tt.root_stats[:, 1].tolist())) > 1 and float(tt.pstats[:, :, tr.C_WQ].abs().sum()) > 0
