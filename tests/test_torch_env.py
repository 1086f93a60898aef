"""Port parity: copied tables, rules and features against the JAX package.

Every comparison here is exact (integers, booleans, hash bit patterns and
feature planes, which hold small integers in float32)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bokego_tpu import coords as jcoords
from bokego_tpu import features as jfeatures
from bokego_tpu.env import rules as jrules
from bokego_tpu.env import state as jst
from bokego_tpu.env import zobrist as jzobrist
from bokego_tpu_torch import coords as tcoords
from bokego_tpu_torch import features as tfeatures
from bokego_tpu_torch.env import rules as trules
from bokego_tpu_torch.env import state as tst
from bokego_tpu_torch.env import zobrist as tzobrist
from tests.torch_port_util import (
    _jlegal,
    _jstep,
    assert_states_equal,
    random_actions,
    random_positions,
    to_port,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_jscore = jax.jit(jrules.score_batch)
_jgroups = jax.jit(jrules.group_info_batch)
_jleaf = jax.jit(jrules.leaf_analysis_batch)
_jchild = jax.jit(jax.vmap(lambda s: jrules.child_states(s, with_hash=False)))
_jchild_hash = jax.jit(jax.vmap(jrules.child_states))
_jfts = jax.jit(jfeatures.features_batch)
_jfts_tables = jax.jit(
    lambda s: jax.vmap(jfeatures.features_from_tables)(s, jrules.leaf_analysis_batch(s).mt)
)


@pytest.mark.parametrize(
    "name", ["NEIGHBORS", "DIAGONALS", "NN", "N", "PASS_ACTION", "NUM_ACTIONS", "EMPTY", "BLACK", "WHITE"]
)
def test_coords_copy_equals_original(name):
    np.testing.assert_array_equal(getattr(tcoords, name), getattr(jcoords, name))


def test_zobrist_copy_equals_original():
    np.testing.assert_array_equal(tzobrist.TABLE, jzobrist.TABLE)
    np.testing.assert_array_equal(tzobrist.FLIP, jzobrist.FLIP)
    rng = np.random.default_rng(0)
    board = rng.integers(0, 3, 81).astype(np.int8)
    for ko, turn in ((-1, 0), (40, 7)):
        np.testing.assert_array_equal(
            tzobrist.full_hash_np(board, ko, turn), jzobrist.full_hash_np(board, ko, turn)
        )


def test_board_string_roundtrip():
    s = "X.O" * 27
    js = jst.from_board_string(s, ko=4, turn=3, last_move=-1)
    ts = tst.from_board_string(s, ko=4, turn=3, last_move=-1, device="cpu")
    assert tst.to_board_string(ts) == jst.to_board_string(js) == s
    assert_states_equal(jax.tree.map(lambda x: x[None], js), ts)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_step_fuzz_matches_jax(seed):
    """Random games (legal moves, passes and some illegal actions) stepped in
    lockstep: boards, ko, turn, last move, invalid and hash bits agree after
    every step, as do group facts, scores and terminality."""
    rng = np.random.default_rng(100 + seed)
    js = jst.new_game_batch(16)
    ts = tst.new_game_batch(16, device="cpu")
    for ply in range(70):
        legal = np.asarray(_jlegal(js))
        np.testing.assert_array_equal(trules.legal_mask(ts).numpy(), legal)
        a = random_actions(rng, legal, pass_prob=0.03, wild_prob=0.1)
        js = _jstep(js, jnp.asarray(a))
        ts = trules.step(ts, torch.from_numpy(a))
        assert_states_equal(js, ts)
        if ply % 10 == 9:
            jg, tg = _jgroups(js.board), trules.group_info(ts.board)
            for a_, b_ in zip(jg, tg):
                np.testing.assert_array_equal(np.asarray(a_), b_.numpy())
            np.testing.assert_array_equal(np.asarray(_jscore(js)), trules.score(ts).numpy())
            for max_turns in (10, 80):
                np.testing.assert_array_equal(
                    np.asarray(jrules.is_terminal_batch(js, max_turns)),
                    trules.is_terminal(ts, max_turns).numpy(),
                )
    assert np.asarray(js.invalid).any()  # the wild actions hit illegal points


@pytest.mark.parametrize("seed,n_moves", [(3, 20), (4, 55)])
def test_leaf_analysis_and_child_states_match_jax(seed, n_moves):
    js = random_positions(seed, 8, n_moves, pass_prob=0.05)
    ts = to_port(js)
    jl, tl = _jleaf(js), trules.leaf_analysis(ts)
    for f in ("legal", "libs_after", "caps"):
        np.testing.assert_array_equal(np.asarray(getattr(jl.mt, f)), getattr(tl.mt, f).numpy())
    np.testing.assert_array_equal(np.asarray(jl.legal), tl.legal.numpy())
    assert_states_equal(jl.children, tl.children)
    jc, jlegal = _jchild(js)
    tc, tlegal = trules.child_states(ts, with_hash=False)
    np.testing.assert_array_equal(np.asarray(jlegal), tlegal.numpy())
    assert_states_equal(jc, tc)


@pytest.mark.parametrize("seed,n_moves", [(3, 20), (4, 55)])
def test_child_states_with_hash_match_jax_and_step(seed, n_moves):
    """``child_states`` with hashes (the default, as in the JAX package):
    every field of every legal successor equals the JAX package's and what
    ``step`` gives for that action; the rest is as without hashes."""
    js = random_positions(seed, 8, n_moves, pass_prob=0.05)
    ts = to_port(js)
    jc, jlegal = _jchild_hash(js)
    tc, tlegal = trules.child_states(ts)
    legal = np.asarray(jlegal)
    np.testing.assert_array_equal(legal, tlegal.numpy())
    assert legal[:, :81].sum() > 100
    np.testing.assert_array_equal(
        tc.hash.numpy().astype(np.uint32)[legal], np.asarray(jc.hash)[legal]
    )
    plain, _ = trules.child_states(ts, with_hash=False)
    for f in ("board", "ko", "turn", "last_move", "komi", "invalid"):
        assert torch.equal(getattr(tc, f), getattr(plain, f)), f
    assert not bool(plain.hash.any())
    for a in range(82):
        stepped = trules.step(ts, torch.full((8,), a))
        ok = tlegal[:, a]
        for f in ("board", "ko", "turn", "last_move", "hash"):
            assert torch.equal(getattr(stepped, f)[ok], getattr(tc, f)[:, a][ok]), (f, a)


@pytest.mark.parametrize("seed,n_moves", [(5, 0), (6, 25), (7, 60)])
def test_features_bit_exact(seed, n_moves):
    js = random_positions(seed, 8, n_moves, pass_prob=0.05)
    ts = to_port(js)
    np.testing.assert_array_equal(np.asarray(_jfts(js)), tfeatures.features_batch(ts).numpy())
    mt = trules.leaf_analysis(ts).mt
    np.testing.assert_array_equal(
        np.asarray(_jfts_tables(js)), tfeatures.features_from_tables(ts, mt).numpy()
    )


def test_import_leaves_jax_out():
    """Importing every port module pulls in neither jax nor bokego_tpu (a
    subprocess: this test process has jax loaded by conftest)."""
    code = (
        "import sys\n"
        "import bokego_tpu_torch, bokego_tpu_torch.parallel.selfplay, "
        "bokego_tpu_torch.models.convert, bokego_tpu_torch.ops.build, "
        "bokego_tpu_torch.cli, bokego_tpu_torch.gtp.engine, bokego_tpu_torch.gtp.process, "
        "bokego_tpu_torch.search.leafpar, bokego_tpu_torch.env.scoring, bokego_tpu_torch.measure, "
        "bokego_tpu_torch.gnugo, bokego_tpu_torch.utils.metrics, bokego_tpu_torch.mfu_report, "
        "bokego_tpu_torch.sim_throughput, bokego_tpu_torch.bench_game, chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'bokego_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr


def test_entry_points_raise_without_gpu(monkeypatch):
    """Without ``device="cpu"`` the entry points want the GPU and raise when
    there is none; nothing falls back to the CPU."""
    from bokego_tpu_torch.config import SearchConfig
    from bokego_tpu_torch.models.nets import init_value
    from bokego_tpu_torch.parallel.selfplay import selfplay

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tst.new_game_batch(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_value(16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        selfplay(None, None, SearchConfig(), batch=2, n_moves=1, n_rollouts=1)
    assert tst.new_game_batch(2, device="cpu").board.device.type == "cpu"
