"""Port parity of the serving search helpers against the JAX package:
``compact``, ``reachable_from_root``, ``advance_root``, ``expand_roots``,
``pv_walk``, the root-noise mixing and ``root_winrate``, array for array
(tolerance 0) on trees grown by the JAX non-kernel search with the
deterministic evaluator; the Dirichlet draw is tested for shape, sum and
seed reproducibility (its bits are torch's own)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bokego_tpu.config import SearchConfig as JConfig
from bokego_tpu.search import mcts as jmcts
from bokego_tpu.search import tree as jtree
from bokego_tpu_torch.config import SearchConfig as TConfig
from bokego_tpu_torch.ops import rollout as trollout
from bokego_tpu_torch.search import mcts as tmcts
from bokego_tpu_torch.search import tree as ttree
from tests.test_mcts import fake_evaluator as jax_fake_evaluator
from tests.torch_fake_eval import fake_evaluator
from tests.torch_port_util import assert_states_equal, random_positions, to_port

CFG = dict(no_sim=True, max_turns=80, max_nodes=1024, expand_thresh=2, use_kernel=False)
TREE_FIELDS = ("pstats", "root_stats", "n_nodes", "parent", "action", "value", "expanded", "terminal", "root")
BATCH = 4


def tree_to_port(jt) -> ttree.Tree:
    """A batched JAX Tree -> the port's Tree on the CPU (indices as int64)."""

    def conv(x):
        x = np.array(x)
        return torch.from_numpy(x.astype(np.int64) if x.dtype == np.int32 else x)

    return ttree.Tree(nodes=to_port(jt.nodes), **{f: conv(getattr(jt, f)) for f in TREE_FIELDS})


def assert_trees_equal(jt, tt, nodes=True):
    for f in TREE_FIELDS:
        np.testing.assert_array_equal(getattr(tt, f).numpy(), np.asarray(getattr(jt, f)), err_msg=f)
    if nodes:
        assert_states_equal(jt.nodes, tt.nodes, fields=("board", "ko", "turn", "last_move", "komi", "invalid"))


@pytest.fixture(scope="module")
def grown():
    """JAX trees after 120 rollouts from random midgame roots."""
    js = random_positions(31, BATCH, 12)
    jev, cfg = jax_fake_evaluator(), JConfig(**CFG)
    jt = jmcts.init_trees(jax.random.PRNGKey(0), js, jev, None, cfg)
    jt = jax.jit(lambda t: jmcts.run_search(jax.random.PRNGKey(0), t, jev, None, cfg, 120))(jt)
    return jt, np.asarray(jax.vmap(jmcts.choose_action)(jt))


def test_advance_compact_expand_match_jax(grown):
    """The engine's re-root sequence, step by step, then a second search on
    the compacted trees; one tree advances by an action with no child."""
    jt, best = grown
    actions = best.copy()
    actions[1] = 81  # a pass: no such child, the tree keeps its root
    jev, tev = jax_fake_evaluator(), fake_evaluator()
    jcfg, tcfg = JConfig(**CFG), TConfig(**CFG)
    tt = tree_to_port(jt)

    ja, jok = jmcts.advance_root(jt, jnp.asarray(actions, jnp.int32))
    ta, tok = tmcts.advance_root(tt, torch.from_numpy(actions.astype(np.int64)))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert tok.tolist() == [True, False, True, True]
    assert_trees_equal(ja, ta)

    np.testing.assert_array_equal(
        ttree.reachable_from_root(ta).numpy(), np.asarray(jax.vmap(jtree.reachable_from_root)(ja))
    )
    jc, tc = jax.vmap(jtree.compact)(ja), ttree.compact(ta)
    assert_trees_equal(jc, tc)
    assert tc.root.tolist() == [0] * BATCH
    assert bool((tc.n_nodes[tok] < ta.n_nodes[tok]).all())  # slots were freed
    assert bool((tc.n_nodes[tok] > 1).all())  # and a subtree was kept

    je = jmcts.expand_roots(jc, jev, None, jcfg)
    te = tmcts.expand_roots(tc, tev, None, tcfg)
    assert_trees_equal(je, te)

    j2 = jax.jit(lambda t: jmcts.run_search(jax.random.PRNGKey(1), t, jev, None, jcfg, 30))(je)
    t2 = tmcts.run_search(te, tev, None, tcfg, 30)
    assert_trees_equal(j2, t2, nodes=False)
    np.testing.assert_array_equal(
        tmcts.choose_action(t2).numpy(), np.asarray(jax.vmap(jmcts.choose_action)(j2))
    )


def test_compact_leaves_choices_unchanged():
    """A search continued with and without compaction chooses the same:
    only slot numbers move (a pool with room for both)."""
    tev, tcfg = fake_evaluator(), TConfig(**dict(CFG, max_nodes=4096))
    ts = to_port(random_positions(35, BATCH, 12))

    def grow():
        trees = tmcts.run_search(tmcts.init_trees(ts, tev, None, tcfg), tev, None, tcfg, 80)
        return tmcts.advance_root(trees, tmcts.choose_action(trees))[0]

    plain, packed = grow(), ttree.compact(grow())
    assert not torch.equal(plain.root, packed.root)
    plain = tmcts.run_search(tmcts.expand_roots(plain, tev, None, tcfg), tev, None, tcfg, 40)
    packed = tmcts.run_search(tmcts.expand_roots(packed, tev, None, tcfg), tev, None, tcfg, 40)
    rows_a = ttree.take_rows(plain.pstats, plain.root)
    rows_b = ttree.take_rows(packed.pstats, packed.root)
    for ch in (ttree.C_N, ttree.C_WV, ttree.C_PRIOR):
        assert torch.equal(rows_a[:, ch], rows_b[:, ch])
    assert torch.equal(tmcts.choose_action(plain), tmcts.choose_action(packed))
    assert torch.equal(plain.root_stats, packed.root_stats)
    assert int(packed.n_nodes.max()) < int(plain.n_nodes.min())


def test_pv_walk_matches_jax(grown):
    jt, _ = grown
    tt = tree_to_port(jt)
    for index in (0, 2):
        row = np.asarray(jt.pstats)[index, int(jt.root[index])]
        acts = np.argsort(-row[jtree.C_N, :81], kind="stable")[:3]
        one = jax.tree.map(lambda x: x[index], jt)
        want = np.asarray(jmcts.pv_walk(one, jnp.asarray(acts, jnp.int32), depth=8))
        got = tmcts.pv_walk(tt, torch.from_numpy(acts), depth=8, index=index).numpy()
        np.testing.assert_array_equal(got, want)
        assert (got[:, 0] >= 0).any()  # some line goes below the root's child


@pytest.mark.parametrize("weight", [0.25, 1.0])
def test_root_noise_mixing_matches_jax(grown, weight, monkeypatch):
    """The same numpy noise through both packages' mixing: ``init_trees``
    and ``add_root_noise`` (the JAX draw is replaced by the given noise)."""
    jt, _ = grown
    rng = np.random.default_rng(5)
    noise = rng.dirichlet(np.full(81, 0.1), BATCH).astype(np.float32)
    monkeypatch.setattr(jax.random, "dirichlet", lambda *a, **k: jnp.asarray(noise))
    jn = jmcts.add_root_noise(jt, jax.random.PRNGKey(0), weight, 0.1)
    tn = tmcts.add_root_noise(tree_to_port(jt), torch.from_numpy(noise), weight)
    assert_trees_equal(jn, tn, nodes=False)
    assert not np.array_equal(np.asarray(jn.pstats), np.asarray(jt.pstats))

    js = random_positions(32, BATCH, 10)
    cfg = dict(CFG, noise_weight=weight)
    ji = jmcts.init_trees(jax.random.PRNGKey(0), js, jax_fake_evaluator(), None, JConfig(**cfg))
    ti = tmcts.init_trees(to_port(js), fake_evaluator(), None, TConfig(**cfg), noise=torch.from_numpy(noise))
    assert_trees_equal(ji, ti)


def test_dirichlet_draw():
    """Shape, sum, support and seed reproducibility of the port's draw, and
    that ``init_trees`` / ``search`` take it from the generator."""
    def gen(seed):
        return torch.Generator().manual_seed(seed)

    a = tmcts.dirichlet_noise(gen(3), 16, 0.1, "cpu")
    assert a.shape == (16, 81) and a.dtype == torch.float32
    np.testing.assert_allclose(a.sum(-1).numpy(), 1.0, atol=1e-5)
    assert bool((a >= 0).all()) and float(a.max(-1).values.mean()) > 0.2  # alpha=0.1 is spiky
    assert torch.equal(a, tmcts.dirichlet_noise(gen(3), 16, 0.1, "cpu"))
    assert not torch.equal(a, tmcts.dirichlet_noise(gen(4), 16, 0.1, "cpu"))

    ts = to_port(random_positions(33, 2, 6))
    cfg = TConfig(**dict(CFG, noise_weight=0.25))
    t1 = tmcts.init_trees(ts, fake_evaluator(), None, cfg, gen=gen(7))
    t2 = tmcts.init_trees(ts, fake_evaluator(), None, cfg, gen=gen(7))
    clean = tmcts.init_trees(ts, fake_evaluator(), None, TConfig(**CFG))
    assert torch.equal(t1.pstats, t2.pstats) and not torch.equal(t1.pstats, clean.pstats)
    with pytest.raises(ValueError):
        tmcts.init_trees(ts, fake_evaluator(), None, cfg)
    actions, _ = tmcts.search(ts, fake_evaluator(), None, cfg, 10, gen=gen(7))
    assert actions.shape == (2,)


def test_root_winrate_matches_jax(grown):
    jt, _ = grown
    tt = tree_to_port(jt)
    for w in (1.0, 0.5):
        want = np.asarray(jax.vmap(lambda t: jmcts.root_winrate(t, w))(jt))
        np.testing.assert_array_equal(tmcts.root_winrate(tt, w).numpy(), want)
    empty = dataclasses.replace(tt, root_stats=torch.zeros_like(tt.root_stats))
    assert tmcts.root_winrate(empty, 1.0).tolist() == [0.0] * BATCH


def test_expand_matches_jax():
    """The search's expansion, ``expand_core`` and then ``rollout.write_rows``
    (its plain version on CPU tensors), with a top-k branch limit and one
    refused expansion."""
    js = random_positions(34, BATCH, 8)
    rng = np.random.default_rng(6)
    probs = rng.dirichlet(np.ones(81), BATCH).astype(np.float32)
    need = np.array([True, True, False, True])
    jt = jax.vmap(lambda s: jtree.empty_tree(s, 128, 80))(js)
    node = jnp.zeros(BATCH, jnp.int32)
    jt = jax.vmap(lambda t, n, p, nd: jtree.expand(t, n, p, nd, 5, 80))(jt, node, jnp.asarray(probs), jnp.asarray(need))
    tt = ttree.empty_tree(to_port(js), 128, 80)
    root = torch.zeros(BATCH, dtype=torch.int64)
    tt, rows, did = ttree.expand_core(tt, root, torch.from_numpy(probs), torch.from_numpy(need), 5, 80)
    trollout.write_rows(tt.pstats, root, rows, did)
    assert_trees_equal(jt, tt)
    counts = tt.n_nodes.tolist()  # at most the top 5, fewer where one is illegal
    assert counts[2] == 1 and all(2 <= c <= 6 for c in counts[:2] + counts[3:])
