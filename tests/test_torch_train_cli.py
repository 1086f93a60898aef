"""The port's checkpoints, opponent pool and training entry points
(``python -m bokego_tpu_torch.bin.*``) on the CPU at tiny sizes: the
AlphaZero CLI as a subprocess, the others through their ``main(argv)`` in
this process (one torch start-up fewer each)."""

import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bokego_tpu_torch.models import nets
from bokego_tpu_torch.train import checkpoints, data, sl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_checkpoint_round_trip_in_reference_layout(tmp_path):
    net = nets.init_policy(16, seed=3, device="cpu")
    opt = sl.make_optimizer(net, 1e-3, 1e-4)
    path = str(tmp_path / "sub" / "p.pt")
    checkpoints.save_variables(path, net, opt, {"epoch": 4})
    ckpt = checkpoints.load_checkpoint(path)
    assert set(ckpt) == {"model_state_dict", "optimizer_state_dict", "epoch"} and ckpt["epoch"] == 4
    back = nets.load_policy(path, device="cpu")  # the serving path's loader reads it
    for k, v in net.state_dict().items():
        assert torch.equal(back.state_dict()[k], v)
    assert torch.equal(nets.from_state_dict("policy", ckpt, "cpu").conv[0].weight, net.conv[0].weight)
    assert os.listdir(tmp_path / "sub") == ["p.pt"]  # no temporary left behind


def test_crash_between_write_and_replace_keeps_the_old_file(tmp_path, monkeypatch):
    path = str(tmp_path / "v.pt")
    first = nets.init_value(8, seed=1, device="cpu")
    checkpoints.save_variables(path, first)

    def crash(src, dst):
        raise OSError("crash before the rename")

    monkeypatch.setattr(checkpoints.os, "replace", crash)
    with pytest.raises(OSError, match="crash"):
        checkpoints.save_variables(path, nets.init_value(8, seed=2, device="cpu"))
    monkeypatch.undo()
    assert os.listdir(tmp_path) == ["v.pt"]
    kept = nets.load_value(path, device="cpu")
    assert torch.equal(kept.lin1.weight, first.lin1.weight)


def test_pool_numbering_and_sampling(tmp_path):
    pool = str(tmp_path / "pool")
    assert checkpoints.pool_ids(pool) == [] and checkpoints.latest_policy(pool) is None
    with pytest.raises(FileNotFoundError):
        checkpoints.sample_opponent(pool, np.random.default_rng(0))
    ns = [checkpoints.save_next_policy(pool, nets.init_policy(8, seed=s, device="cpu")) for s in range(3)]
    assert ns == [0, 1, 2] and sorted(os.listdir(pool)) == ["policy_0.pt", "policy_1.pt", "policy_2.pt"]
    open(os.path.join(pool, "policy_x.pt"), "w").close()  # not a pool member
    assert checkpoints.pool_ids(pool) == [0, 1, 2]
    n, ckpt = checkpoints.latest_policy(pool)
    assert n == 2 and torch.equal(ckpt["model_state_dict"]["conv.0.weight"],
                                  nets.init_policy(8, seed=2, device="cpu").conv[0].weight)
    drawn = {checkpoints.sample_opponent(pool, np.random.default_rng(s))[0] for s in range(20)}
    assert drawn == {0, 1, 2}


def test_orbax_checkpoints_raise_with_the_export_route(tmp_path):
    os.makedirs(tmp_path / "policy_3")
    with pytest.raises(ValueError, match="export_policy_torch"):
        checkpoints.pool_ids(str(tmp_path))
    with pytest.raises(ValueError, match="orbax"):
        checkpoints.load_checkpoint(str(tmp_path / "policy_3"))
    with pytest.raises(ValueError, match="export_policy_torch"):
        checkpoints.pool_ids(os.path.join(REPO, "data", "weights", "rl_pool"))


def _subprocess(args, cwd, device="cpu"):
    cmd = [sys.executable, "-m", *args] + (["--device", device] if device else [])
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": REPO})


def _ok(proc):
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


@pytest.fixture
def cli(tmp_path, monkeypatch, capsys):
    """Run ``python -m <module> <args> --device cpu`` in this process, in
    ``tmp_path``; returns its standard output."""
    monkeypatch.chdir(tmp_path)

    def run(args, device="cpu"):
        capsys.readouterr()
        importlib.import_module(args[0]).main(list(args[1:]) + (["--device", device] if device else []))
        return capsys.readouterr().out

    return run


def test_policy_data_pipeline_clis(tmp_path, cli):
    """gen_policy_data (csv and packed), process_data (npz and shards),
    train on each form, and a resumed run."""
    cli(["bokego_tpu_torch.bin.gen_policy_data", "-n", "2", "--batch", "2", "--max-turns", "8", "-o", "sp", "--packed"])
    out = cli(["bokego_tpu_torch.bin.gen_policy_data", "-n", "2", "--batch", "2", "--max-turns", "8", "-o", "sp.csv"])
    assert "2/2 games" in out
    n_rows = len(open(tmp_path / "sp.csv").read().splitlines()) - 1
    assert n_rows > 0 and n_rows % 8 == 0
    out = cli(["bokego_tpu_torch.bin.process_data", "sp.csv", "sp.npz"])
    assert f"{n_rows} positions (moves)" in out
    os.makedirs(tmp_path / "sh")
    cli(["bokego_tpu_torch.bin.process_data", "sp.csv", "sh/x", "--shards", "--shard-size", "40"])
    assert len(data.load_streaming(str(tmp_path / "sh"))) == n_rows
    out = cli(["bokego_tpu_torch.bin.train", "-d", "sp-c000-00000.pshard.npz", "--kind", "policy", "--bs", "8",
               "--lr", "1e-3", "-o", "p.pt"])
    assert "Saved p.pt (epoch 1)" in out
    out = cli(["bokego_tpu_torch.bin.train", "-d", "sh/*.pshard.npz", "--kind", "policy", "--bs", "8",
               "-c", "p.pt", "-o", "p2.pt"])
    assert "Saved p2.pt (epoch 2)" in out
    ckpt = checkpoints.load_checkpoint(str(tmp_path / "p2.pt"))
    assert ckpt["epoch"] == 2 and ckpt["optimizer_state_dict"]["state"]
    cli(["bokego_tpu_torch.bin.train", "-d", "sp.npz", "--kind", "policy", "--bs", "8", "-o", "p3.pt",
         "--weight-decay", "1e-4"])
    assert open(tmp_path / "stats.txt").read().count("Epoch:") == 3


def test_value_data_and_training_clis(tmp_path, cli):
    checkpoints.save_variables(str(tmp_path / "pol.pt"), nets.init_policy(seed=5, device="cpu"))
    assert cli(["bokego_tpu_torch.bin.genvals", "-n", "0", "-o", "v.csv"]) == ""
    # -n counts thousands of positions: one batch of 1000 short games fills it
    out = cli(["bokego_tpu_torch.bin.genvals", "-n", "1", "-o", "v.csv", "--batch", "1000", "--max-turns", "4",
               "--min-r", "1", "--max-r", "3", "--raw-tt-labels", "--sl", "pol.pt", "--no-augment"])
    assert out.startswith("1000/1000 positions")
    lines = open(tmp_path / "v.csv").read().splitlines()
    assert lines[0] == "board,ko,last,val" and len(lines) == 1001
    out = cli(["bokego_tpu_torch.bin.train", "-d", "v.csv", "--kind", "value", "--bs", "250",
               "--init-from-policy", "pol.pt", "-o", "v.pt"])
    assert "Saved v.pt (epoch 1)" in out
    value = nets.load_value(str(tmp_path / "v.pt"), device="cpu")
    assert not torch.equal(value.conv[0].weight, nets.init_value(device="cpu").conv[0].weight)


def test_selfplay_cli_grows_the_pool(tmp_path, cli):
    out = cli(["bokego_tpu_torch.bin.selfplay", "-e", "2", "-n", "1", "-b", "2", "--max-turns", "6", "-w", "pool",
               "-f", "rl.txt"])
    assert "Empty pool: seeding policy_0" in out and "Saved policy_2" in out
    assert checkpoints.pool_ids(str(tmp_path / "pool")) == [0, 1, 2]
    stats = open(tmp_path / "rl.txt").read().splitlines()
    assert stats[0] == "Policy 0 vs. Policy 0" and stats[1] == "Batch Size: 2, Iterations: 1" and len(stats) == 6
    out = cli(["bokego_tpu_torch.bin.selfplay", "-e", "1", "-n", "1", "-b", "2", "--max-turns", "4", "-w", "pool",
               "-f", "rl.txt"])
    assert "Opponent pool size: 2" in out and "Saved policy_3" in out


def test_default_pool_ignores_the_shipped_weights(tmp_path, cli):
    """The ``bin/selfplay`` pool logic on a copy of ``data/weights``'s layout
    (the shipped ``policy_17.pt`` and the other exports, orbax directories
    beside them): no file there is a generation, so the run seeds
    ``policy_0`` from a fresh init as the JAX CLI does and leaves the shipped
    files alone."""
    import shutil

    src = os.path.join(REPO, "data", "weights")
    weights = tmp_path / "data" / "weights"
    os.makedirs(weights)
    for name in os.listdir(src):
        if os.path.isdir(os.path.join(src, name)):
            os.makedirs(weights / name)  # an orbax directory's name only
        else:
            shutil.copy(os.path.join(src, name), weights / name)
    assert "policy_17.pt" in os.listdir(weights) and checkpoints.pool_ids(str(weights)) == []
    shipped = sorted(os.listdir(weights))
    out = cli(["bokego_tpu_torch.bin.selfplay", "-e", "1", "-n", "1", "-b", "2", "--max-turns", "4"])
    assert "Empty pool: seeding policy_0" in out and "Saved policy_1" in out
    assert checkpoints.pool_ids(str(weights)) == [0, 1]
    assert sorted(os.listdir(weights)) == sorted(shipped + ["policy_0.pt", "policy_1.pt"])
    assert checkpoints.load_checkpoint(str(weights / "policy_17.pt")).keys() == {"model_state_dict"}


def _digest(path) -> bytes:
    import hashlib

    return hashlib.sha256(open(path, "rb").read()).digest()


def test_pool_never_writes_over_a_shipped_policy(tmp_path, cli):
    """Generation 17 of a pool beside a copy of the shipped ``policy_17.pt``
    raises and names the file, which stays as it was; ``bin/selfplay``
    refuses before it plays a game when its epochs would reach it."""
    import shutil

    weights = str(tmp_path / "weights")
    os.makedirs(weights)
    shipped = os.path.join(weights, "policy_17.pt")
    shutil.copy(os.path.join(REPO, "data", "weights", "policy_17.pt"), shipped)
    before = _digest(shipped)
    with pytest.raises(FileExistsError, match="policy_17.pt"):
        cli(["bokego_tpu_torch.bin.selfplay", "-e", "17", "-n", "1", "-b", "2", "--max-turns", "4", "-w", weights])
    assert os.listdir(weights) == ["policy_17.pt"]  # nothing seeded or played
    net = nets.init_policy(8, seed=0, device="cpu")
    assert [checkpoints.save_next_policy(weights, net) for _ in range(17)] == list(range(17))
    with pytest.raises(FileExistsError, match="policy_17.pt is not generation 17"):
        checkpoints.save_next_policy(weights, net)
    assert checkpoints.pool_ids(weights) == list(range(17)) and _digest(shipped) == before
    assert checkpoints.load_checkpoint(shipped).keys() == {"model_state_dict"}


def test_pool_written_without_the_generation_key_is_kept(tmp_path):
    """A pool whose files hold no ``pool_generation`` (the layout before the
    key) counts no generation, and its files are never overwritten."""
    pool = str(tmp_path / "pool")
    for n in range(2):
        checkpoints.save_variables(checkpoints.pool_path(pool, n), nets.init_policy(8, seed=n, device="cpu"))
    before = [_digest(checkpoints.pool_path(pool, n)) for n in range(2)]
    assert checkpoints.pool_ids(pool) == [] and checkpoints.latest_policy(pool) is None
    with pytest.raises(FileExistsError, match="policy_0.pt is not generation 0"):
        checkpoints.save_next_policy(pool, nets.init_policy(8, seed=5, device="cpu"))
    assert [_digest(checkpoints.pool_path(pool, n)) for n in range(2)] == before
    assert sorted(os.listdir(pool)) == ["policy_0.pt", "policy_1.pt"]


def test_alphazero_cli_checkpoints_and_resumes(tmp_path):
    cwd = str(tmp_path)
    args = ["bokego_tpu_torch.bin.alphazero", "--iters", "1", "--batch", "2", "--moves", "3", "--rollouts", "4", "-o", "az"]
    out = _ok(_subprocess(args, cwd))
    assert "az iter 1:" in out and "checkpointed az_* at iter 1" in out
    assert sorted(f for f in os.listdir(tmp_path) if f.startswith("az")) == [
        "az_ckpt.pt", "az_iter.txt", "az_policy.pt", "az_value.pt"]
    first = checkpoints.load_checkpoint(str(tmp_path / "az_ckpt.pt"))
    assert first["iter"] == 1
    out = _ok(_subprocess(args + ["--resume"], cwd))
    assert "resuming from az_ckpt.pt at iter 1" in out and "az iter 2:" in out
    second = checkpoints.load_checkpoint(str(tmp_path / "az_ckpt.pt"))
    assert second["iter"] == 2 and open(tmp_path / "az_iter.txt").read() == "2"
    assert not torch.equal(second["policy"]["conv.0.weight"], first["policy"]["conv.0.weight"])
    assert torch.equal(checkpoints.load_checkpoint(str(tmp_path / "az_policy.pt"))["model_state_dict"]["conv.0.weight"],
                       second["policy"]["conv.0.weight"])
    # the split layout resumes too, from its iteration file
    os.remove(tmp_path / "az_ckpt.pt")
    out = _ok(_subprocess(args + ["--resume"], cwd))
    assert "resuming from az_* at iter 2" in out and "az iter 3:" in out


@pytest.mark.parametrize("name", ["train", "process_data", "gen_policy_data", "genvals", "selfplay", "alphazero"])
def test_clis_raise_without_a_gpu(name, tmp_path, cli, monkeypatch):
    """``--device`` defaults to cuda, which raises without a GPU instead of
    falling back to the CPU, before anything is written."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    extra = {"train": ["-d", "x.csv"], "process_data": ["x.csv", "y.npz"], "gen_policy_data": ["-o", "x.csv"],
             "genvals": ["-o", "x.csv"]}.get(name, [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli([f"bokego_tpu_torch.bin.{name}", *extra], device=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli([f"bokego_tpu_torch.bin.{name}", *extra], device="cuda")
    assert os.listdir(tmp_path) == []
