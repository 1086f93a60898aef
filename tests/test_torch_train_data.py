"""The port's training data against ``bokego_tpu.train.data`` and the data
generators' host-side conversions: everything exact (tolerance 0).

D4 maps for all 8 symmetries; the same seed gives the same batches (order,
augmentation, features, targets) from ``GoDataset``, ``PackedDataset`` and
``ShardedDataset``; ``rows_to_features`` / ``load_csv`` / ``pack_csv``
equal the JAX package's; a shard written by either package loads in the
other; ``trajectory_to_rows`` / ``trajectory_to_packed`` / ``write_csv``
and genvals' rows and csv equal the JAX package's on the same trajectory."""

import glob
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bokego_tpu.search import playout as jpo
from bokego_tpu.train import data as jdata
from bokego_tpu.train import gendata as jgendata
from bokego_tpu.train import genvals as jgenvals
from bokego_tpu_torch.coords import NN
from bokego_tpu_torch.search.playout import Trajectory
from bokego_tpu_torch.train import data as tdata
from bokego_tpu_torch.train import gendata, genvals
from tests.torch_port_util import random_positions, to_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _packed(seed: int, n: int, kind: str = "policy"):
    """Packed arrays of seeded random positions, with some ko points and
    positions after a pass, and random targets."""
    js = random_positions(seed, n, 12 + seed % 7, pass_prob=0.08)
    rng = np.random.default_rng(seed)
    targets = (rng.integers(0, NN, n).astype(np.int32) if kind == "policy"
               else rng.choice([-1.0, 1.0], n).astype(np.float32))
    return dict(
        boards=np.asarray(js.board).astype(np.uint8), ko=np.asarray(js.ko).astype(np.int16),
        last=np.asarray(js.last_move).astype(np.int16), turn=(np.asarray(js.turn) % 2).astype(np.int8),
        targets=targets, is_value=kind == "value",
    )


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _assert_same_batches(jbatches, tbatches):
    jb, tb = list(jbatches), list(tbatches)
    assert len(jb) == len(tb) > 0
    for (jf, jt), (tf, tt) in zip(jb, tb):
        np.testing.assert_array_equal(_np(tf), _np(jf))
        np.testing.assert_array_equal(_np(tt), _np(jt))


@pytest.mark.parametrize("k", range(8))
def test_d4_maps_equal_jax(k):
    rng = np.random.default_rng(k)
    planes = rng.normal(size=(3, 9, 9, 5)).astype(np.float32)
    boards = rng.integers(0, 3, (4, NN)).astype(np.uint8)
    moves = np.array([-1, 0, 8, 40, 72, 80, 13])
    np.testing.assert_array_equal(tdata.d4_apply_planes(planes, k), jdata.d4_apply_planes(planes, k))
    np.testing.assert_array_equal(tdata.d4_apply_boards(boards, k), jdata.d4_apply_boards(boards, k))
    np.testing.assert_array_equal(tdata.d4_apply_moves(moves, k), jdata.d4_apply_moves(moves, k))
    s = "".join(".XO"[v] for v in boards[0])
    assert tdata.d4_board_string(s, k) == jgenvals._d4_board(s, k)
    # the move map is the plane map on a one-hot plane
    one_hot = np.zeros((9, 9, 1))
    one_hot[13 // 9, 13 % 9, 0] = 1
    moved = tdata.d4_apply_planes(one_hot, k)[..., 0].reshape(-1)
    assert int(np.argmax(moved)) == int(tdata.d4_apply_moves(13, k))


def test_go_dataset_batches_equal_jax():
    rng = np.random.default_rng(0)
    fts = rng.normal(size=(37, 9, 9, 27)).astype(np.float32)
    moves = rng.integers(0, NN, 37).astype(np.int32)
    _assert_same_batches(
        jdata.GoDataset(fts, moves, False).batches(8, np.random.default_rng(3)),
        tdata.GoDataset(fts, moves, False).batches(8, np.random.default_rng(3)),
    )
    vals = rng.choice([-1.0, 1.0], 37).astype(np.float32)
    _assert_same_batches(
        jdata.GoDataset(fts, vals, True).batches(8, np.random.default_rng(4), augment=False),
        tdata.GoDataset(fts, vals, True).batches(8, np.random.default_rng(4), augment=False),
    )


@pytest.mark.parametrize("kind", ["policy", "value"])
def test_packed_dataset_batches_equal_jax(kind):
    """Order, D4 draw, features computed on the device, targets."""
    arrays = _packed(1, 45, kind)
    _assert_same_batches(
        jdata.PackedDataset(**arrays).batches(8, np.random.default_rng(5)),
        tdata.PackedDataset(**arrays).batches(8, np.random.default_rng(5), device="cpu"),
    )


def test_shards_cross_load_and_sharded_batches_equal_jax(tmp_path):
    """Shards written by either package load in the other, and a
    ``ShardedDataset`` over them gives the JAX package's batches."""
    arrays = _packed(2, 50)
    jpaths = jdata.save_shards(str(tmp_path / "j"), jdata.PackedDataset(**arrays), shard_size=16)
    tpaths = tdata.save_shards(str(tmp_path / "t"), tdata.PackedDataset(**arrays), shard_size=16)
    assert [os.path.basename(p)[1:] for p in jpaths] == [os.path.basename(p)[1:] for p in tpaths]
    for jp, tp in zip(jpaths, tpaths):
        for a, b in ((jdata.load_shard(tp), tdata.load_shard(jp)), (jdata.load_shard(jp), tdata.load_shard(tp))):
            for f in ("boards", "ko", "last", "turn", "targets"):
                np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
                assert getattr(b, f).dtype == getattr(a, f).dtype
            assert a.is_value == b.is_value
    jds, tds = jdata.ShardedDataset(tpaths), tdata.ShardedDataset(jpaths)
    assert len(jds) == len(tds) == 50 and tds.is_value is False
    _assert_same_batches(jds.batches(8, np.random.default_rng(6)), tds.batches(8, np.random.default_rng(6), device="cpu"))
    streamed = tdata.load_streaming(str(tmp_path / "t-*.pshard.npz"))
    assert isinstance(streamed, tdata.ShardedDataset) and len(streamed) == 50
    assert isinstance(tdata.load_streaming(tpaths[0]), tdata.PackedDataset)


def _policy_csv(path, seed=3, n=40):
    """A policy csv from JAX rows: ko points, passes (last = -1) and the
    JAX package's own writer, x8."""
    js = random_positions(seed, n, 15, pass_prob=0.1)
    boards = np.asarray(js.board)
    rows = []
    for b in range(n):
        last = int(js.last_move[b])
        ko = int(js.ko[b])
        if b % 5 == 0:  # a ko point on an empty point, as a capture leaves it
            ko = int(np.flatnonzero(boards[b] == 0)[b % 7])
        rows.append(("".join(".XO"[v] for v in boards[b]), None if ko < 0 else ko, last if last < NN else -1, b % NN))
    jgendata.write_csv(path, rows, augment=True)
    return rows


def test_rows_to_features_and_load_csv_equal_jax(tmp_path):
    path = str(tmp_path / "p.csv")
    rows = _policy_csv(path)
    assert any(r[2] == -1 for r in rows) and any(r[1] is not None for r in rows)
    triples = [r[:3] for r in rows]
    np.testing.assert_array_equal(tdata.rows_to_features(triples, chunk=16, device="cpu"), jdata.rows_to_features(triples))
    j, t = jdata.load_csv(path), tdata.load_csv(path, device="cpu")
    np.testing.assert_array_equal(t.features, j.features)
    np.testing.assert_array_equal(t.targets, j.targets)
    assert t.is_value == j.is_value is False
    jp, tp = jdata.pack_csv(path), tdata.pack_csv(path)
    for f in ("boards", "ko", "last", "turn", "targets"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f))
    # streaming pack: the same shards
    jpaths = jdata.pack_csv_to_shards(path, str(tmp_path / "js"), shard_size=64)
    tpaths = tdata.pack_csv_to_shards(path, str(tmp_path / "ts"), shard_size=64)
    assert len(tpaths) == len(jpaths) == 5
    for jp_, tp_ in zip(jpaths, tpaths):
        a, b = jdata.load_shard(jp_), tdata.load_shard(tp_)
        for f in ("boards", "ko", "last", "turn", "targets"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f))


def test_value_csv_and_npz_round_trip_equal_jax(tmp_path):
    js = random_positions(4, 12, 20)
    rng = np.random.default_rng(4)
    samples = jgenvals.ValueSamples(
        board=js.board, ko=js.ko, move=jnp.asarray(rng.integers(0, NN, 12), jnp.int32),
        val=jnp.asarray(rng.integers(0, 2, 12), jnp.int32), ok=jnp.asarray(rng.random(12) < 0.8),
    )
    port = genvals.ValueSamples(*(torch.from_numpy(np.asarray(x).astype(np.int64 if np.asarray(x).dtype != bool else bool))
                                  for x in samples))
    rows = genvals.samples_to_rows(port)
    assert rows == jgenvals.samples_to_rows(samples)
    jpath, tpath = str(tmp_path / "j.csv"), str(tmp_path / "t.csv")
    jgenvals.write_csv(jpath, rows)
    genvals.write_csv(tpath, rows)
    assert open(tpath).read() == open(jpath).read()
    j, t = jdata.load_csv(jpath), tdata.load_csv(tpath, device="cpu")
    assert t.is_value and j.is_value
    np.testing.assert_array_equal(t.features, j.features)
    np.testing.assert_array_equal(t.targets, j.targets)
    tdata.save_npz(str(tmp_path / "t.npz"), t)
    back = jdata.load_npz(str(tmp_path / "t.npz"))
    np.testing.assert_array_equal(back.features, j.features)
    np.testing.assert_array_equal(tdata.load_npz(str(tmp_path / "t.npz")).targets, j.targets)


def _jax_trajectory(seed: int, batch: int, steps: int):
    uniform = lambda s: jnp.full((s.turn.shape[0], NN), 1.0 / NN)  # noqa: E731
    js = random_positions(seed, batch, 6, pass_prob=0.1)
    return jax.jit(lambda s: jpo.playout(jax.random.PRNGKey(seed), uniform, uniform, s, num_steps=steps, max_turns=30))(js)


def test_trajectory_conversions_equal_jax(tmp_path):
    """Rows, packed datasets (x1 and x8) and the policy csv from the same
    trajectory, the JAX one carried over to the port's types."""
    jtraj = _jax_trajectory(5, 6, 28)
    ttraj = Trajectory(states=to_port(jtraj.states), actions=torch.from_numpy(np.asarray(jtraj.actions, np.int64)),
                       final=to_port(jtraj.final))
    assert (np.asarray(jtraj.actions) == NN).any() and (np.asarray(jtraj.states.last_move) == NN).any()
    rows = gendata.trajectory_to_rows(ttraj)
    assert rows == jgendata.trajectory_to_rows(jtraj) and len(rows) > 50
    for augment in (False, True):
        a, b = jgendata.trajectory_to_packed(jtraj, augment), gendata.trajectory_to_packed(ttraj, augment)
        for f in ("boards", "ko", "last", "turn", "targets"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
            assert getattr(b, f).dtype == getattr(a, f).dtype, f
    jpath, tpath = str(tmp_path / "j.csv"), str(tmp_path / "t.csv")
    jgendata.write_csv(jpath, rows)
    gendata.write_csv(tpath, rows)
    assert open(tpath).read() == open(jpath).read()


_MODULES = sorted(
    glob.glob(os.path.join(REPO, "bokego_tpu_torch", "train", "*.py"))
    + glob.glob(os.path.join(REPO, "bokego_tpu_torch", "bin", "*.py"))
)


@pytest.mark.parametrize("path", _MODULES, ids=os.path.basename)
def test_training_modules_import_no_jax(path):
    src = open(path).read()
    assert not re.search(r"^\s*(import|from)\s+(jax|flax|optax|orbax)\b", src, re.M), path
    assert not re.search(r"^\s*(import|from)\s+bokego_tpu(\.|\s|$)", src, re.M), path


def test_training_stack_imports_with_jax_blocked():
    """Importing every training module works where jax cannot be imported."""
    mods = ["bokego_tpu_torch.train." + m for m in ("data", "checkpoints", "sl", "gendata", "genvals", "reinforce", "alphazero")]
    mods += ["bokego_tpu_torch.bin." + m for m in ("train", "process_data", "gen_policy_data", "genvals", "selfplay", "alphazero")]
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'optax', 'orbax', 'bokego_tpu'): sys.modules[m] = None\n"
        f"import importlib\nfor m in {mods!r}: importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'bokego_tpu.')) for k in sys.modules if sys.modules[k])\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, env={**os.environ, "PYTHONPATH": REPO})
