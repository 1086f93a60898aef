"""The port's data parallelism (``bokego_tpu_torch/parallel/mesh.py``,
``selfplay_sharded``, ``search_sharded``, the dp steps of SL, REINFORCE and
AlphaZero, the dry run) on the CPU: gloo, ranks spawned as processes.

The JAX references run in this process on the 8 virtual CPU devices of
``tests/conftest.py``, as ``tests/test_parallel.py`` runs them.  The ranks
run ``tests/torch_dp_workers.py`` (jax-free): one spawn per mesh size runs
every case of that size, rank 0 writing its results to ``tmp_path``.

Self-play and search are held exactly (tolerance 0) against the JAX
package's sharded run and the port's unsharded one.  The SL dp step is held
against ``bokego_tpu.train.sl.make_train_step(..., n_devices=k)`` step by
step along the JAX trajectory at full width, at the SL tests' rtol 1e-4 /
atol 1e-5, as ``tests/test_torch_train_sl.py`` holds the single-device step
(and for its reason): the loss, the running statistics, and the weights of
the port's Adam fed the mean of the JAX shards' gradients against the JAX
step's own.  The averaged gradients themselves are held against the mean of
the port's own single-device shard gradients, not against the JAX ones: at
4 to 16 rows a shard, the float32 gradient of a full-width net is not
determined to 1e-5 by the weights (the JAX package's and the port's differ
from a float64 evaluation of the same shards by up to 3e-4 beyond that
tolerance, in different elements)."""

import copy
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
import optax
from jax import shard_map
from jax.sharding import PartitionSpec as P

from bokego_tpu.config import SearchConfig as JConfig
from bokego_tpu.models import inference as jinference
from bokego_tpu.models import nets as jnets
from bokego_tpu.parallel import mesh as jmesh
from bokego_tpu.parallel.selfplay import selfplay_sharded as jselfplay_sharded
from bokego_tpu.search import mcts as jmcts
from bokego_tpu.train import reinforce as jreinforce
from bokego_tpu.train import sl as jsl
from bokego_tpu_torch.config import SearchConfig
from bokego_tpu_torch.models import convert, nets
from bokego_tpu_torch.parallel import dryrun, mesh as mesh_lib
from bokego_tpu_torch.parallel.selfplay import selfplay
from bokego_tpu_torch.search import mcts
from bokego_tpu_torch.train import alphazero as az
from bokego_tpu_torch.train import data as tdata
from bokego_tpu_torch.train import sl
from tests import torch_dp_workers
from tests.test_mcts import fake_evaluator as jax_fake_evaluator
from tests.test_torch_train_rl import jax_onehot_probs
from tests.test_torch_train_sl import _positions
from tests.torch_fake_eval import fake_evaluator
from tests.torch_port_util import assert_states_equal, random_positions, to_port

pytestmark = pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 virtual devices")

RTOL, ATOL = 1e-4, 1e-5
SL_B, SL_LR = 32, 1e-3
SELFPLAY = dict(no_sim=True, max_turns=8, max_nodes=128, eval_every=2, kernel_block=4, kernel_levels=6,
                use_kernel=True, expand_thresh=2)
SELFPLAY_RUN = dict(batch=16, n_moves=4, n_rollouts=12)
SEARCH = dict(SELFPLAY, max_turns=80, max_nodes=256, expand_thresh=3)
SEARCH_ROLLOUTS = 40
AZ_CFG = dict(expand_thresh=2, no_sim=True, max_nodes=128, noise_weight=0.25, max_turns=6)
AZ_RUN = dict(batch=8, n_moves=6, n_rollouts=10, temp_moves=4)


def _run(tmp_path, k: int, jobs: dict) -> dict:
    """Every job on k spawned gloo ranks on the CPU; rank 0's results."""
    path = str(tmp_path / f"jobs_{k}.pt")
    torch.save(jobs, path)
    mesh_lib.spawn(torch_dp_workers.run_jobs, k, path, device="cpu")
    return torch.load(path + ".out", weights_only=False)


def _roots():
    return random_positions(31, 16, 14, pass_prob=0.05)


# -- the JAX references and the port's unsharded runs ------------------------


def _jax_selfplay(k):
    return jselfplay_sharded(jmesh.get_mesh(k), jax.random.PRNGKey(0), None, jax_fake_evaluator(),
                             JConfig(**SELFPLAY), **SELFPLAY_RUN)


def _jax_search(k):
    m = jmesh.get_mesh(k)
    cfg, jev = JConfig(**SEARCH), jax_fake_evaluator()
    with jax.set_mesh(m):
        return jax.jit(lambda r, s: jmcts.search(r, s, jev, None, cfg, SEARCH_ROLLOUTS))(
            jax.random.PRNGKey(0), jmesh.shard_batch(m, _roots()))


_SL_STEPS = {}


def _jax_sl_step(kind, k):
    if (kind, k) not in _SL_STEPS:
        net = jnets.ValueNet() if kind == "value" else jnets.PolicyNet()
        loss_fn = jsl.make_value_loss(net) if kind == "value" else jsl.make_policy_loss(net)
        _SL_STEPS[kind, k] = jsl.make_train_step(loss_fn, optax.adam(SL_LR), n_devices=k)
    return _SL_STEPS[kind, k]


_SHARD_GRADS = {}


def _jax_shard_grads(kind, k, params, stats, fts, targets):
    """The mean over the k shards of each shard's gradient (what the JAX dp
    step ``pmean``s before its update)."""
    if (kind, k) not in _SHARD_GRADS:
        net = jnets.ValueNet() if kind == "value" else jnets.PolicyNet()
        loss_fn = jsl.make_value_loss(net) if kind == "value" else jsl.make_policy_loss(net)

        def shard(params, stats, f, t):
            (_, _), g = jax.value_and_grad(loss_fn, has_aux=True)(params, stats, f, t)
            return jax.lax.pmean(g, "dp")

        _SHARD_GRADS[kind, k] = jax.jit(shard_map(
            shard, mesh=jmesh.get_mesh(k), in_specs=(P(), P(), P("dp"), P("dp")), out_specs=P(), check_vma=False))
    return _SHARD_GRADS[kind, k](params, stats, fts, targets)


def _port_shard_grads(kind, k, variables, fts, targets):
    """The mean over the k shards of each shard's gradient, by the port's
    single-device loss in this process."""
    net = _net(kind, variables).train()
    loss_fn = sl.policy_loss if kind == "policy" else sl.value_loss
    per, mean = fts.shape[0] // k, {}
    for r in range(k):
        net.zero_grad()
        t = torch.from_numpy(targets[r * per:(r + 1) * per])
        loss_fn(net, torch.from_numpy(fts[r * per:(r + 1) * per]), t.long() if kind == "policy" else t).backward()
        for name, p in net.named_parameters():
            mean[name] = mean.get(name, 0) + p.grad / k
    return mean


def _sd(tree):
    return convert._tensors(convert._net_sd(jax.tree.map(np.asarray, tree), None))


def _net(kind, variables):
    net = (nets.PolicyNet if kind == "policy" else nets.ValueNet)()
    net.load_state_dict(convert.from_flax(jax.tree.map(np.asarray, variables)))
    return net


def _close(got: dict, want: dict, what: str):
    for key, v in want.items():
        if not key.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[key].detach().numpy(), v.numpy(), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what} {key}")


def _sl_cases(kind: str):
    """Two global batches and the JAX trajectory of two dp steps from a
    seeded init, for every mesh size: ``{k: [(vars, opt_state, fts,
    targets, next_vars, loss), ...]}``, plus the jobs of the port's steps."""
    packed, fts, moves, vals = _positions(40 if kind == "policy" else 41, 2 * SL_B)
    targets = moves if kind == "policy" else vals
    init = jnets.init_policy if kind == "policy" else jnets.init_value
    v0 = jax.tree.map(np.asarray, init(jax.random.PRNGKey(5)))
    tx = optax.adam(SL_LR)
    cases, jobs = {}, {}
    for k in (2, 8):
        variables, opt_state, steps = v0, tx.init(v0["params"]), []
        for i in range(2):
            f, t = fts[i * SL_B:(i + 1) * SL_B], targets[i * SL_B:(i + 1) * SL_B]
            new_vars, new_opt, loss = _jax_sl_step(kind, k)(variables, opt_state, jnp.asarray(f), jnp.asarray(t))
            steps.append((variables, opt_state, f, t, jax.tree.map(np.asarray, new_vars), float(loss)))
            resume = None if i == 0 else convert.adam_from_optax(opt_state, _net(kind, variables))
            jobs.setdefault(k, {})[f"sl_{kind}_{i}"] = ("sl_step", dict(
                kind=kind, state_dict=convert.from_flax(jax.tree.map(np.asarray, variables)), opt_state=resume,
                fts=torch.from_numpy(f), targets=torch.from_numpy(t), lr=SL_LR))
            variables, opt_state = new_vars, new_opt
        cases[k] = steps
    return cases, jobs


def _az_trajectory():
    """A trajectory of diverse games (root noise, temperature) whose shards
    have different numbers of live moves."""
    gen = torch.Generator().manual_seed(3)
    traj = az.selfplay_with_targets(gen, fake_evaluator(), None, SearchConfig(**AZ_CFG), 4, 8, 10, temperature=1.0,
                                    device="cpu")
    live = traj.live.clone()
    live[3:, 0] = False
    live[5:, 1] = False
    return traj._replace(live=live)


def _rl_trajectories():
    """Two JAX one-hot-policy trajectories (one per rank) with rewards of
    both signs."""
    out = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jinference, "policy_probs", jax_onehot_probs)
        for rank, opponent in enumerate((7, 3)):
            jtraj, _ = jreinforce.play_games(jax.random.PRNGKey(rank), 0, opponent, batch=4, max_turns=10,
                                             train_as_black=True)
            rewards = np.where((np.arange(4) + rank) % 3 == 0, 1.0, -1.0).astype(np.float32)
            out.append((jtraj, rewards))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One spawn per mesh size, every case of that size in it."""
    tmp = tmp_path_factory.mktemp("dp")
    roots = to_port(_roots())
    jobs = {k: {
        "collectives": ("collectives", {}),
        "selfplay": ("selfplay", dict(cfg=SELFPLAY, **SELFPLAY_RUN)),
        "search": ("search", dict(cfg=SEARCH, roots=roots.tensors(), n_rollouts=SEARCH_ROLLOUTS, seed=0)),
        "search_noise": ("search", dict(cfg=dict(SEARCH, noise_weight=0.25), roots=roots.tensors(),
                                        n_rollouts=SEARCH_ROLLOUTS, seed=9)),
        "az_selfplay": ("az_selfplay", dict(cfg=AZ_CFG, seed=4, **AZ_RUN)),
    } for k in (2, 8)}
    sl_cases = {}
    for kind in ("policy", "value"):
        sl_cases[kind], sl_jobs = _sl_cases(kind)
        for k in (2, 8):
            jobs[k].update(sl_jobs[k])
    # a copy: the optimizer steps on the moments it loaded in place
    jobs[2]["sl_policy_1_skew"] = ("sl_step", dict(copy.deepcopy(jobs[2]["sl_policy_1"][1]), skew=True))
    traj = _az_trajectory()
    policy, value = nets.PolicyNet(8), nets.ValueNet(8)
    jobs[2]["az"] = ("az_step", dict(channels=8, policy_sd=policy.state_dict(), value_sd=value.state_dict(),
                                     traj=(traj.states.tensors(), traj.dists, traj.live, traj.final.tensors()),
                                     lr=1e-3))
    rl = _rl_trajectories()
    pvars = jax.tree.map(np.asarray, jnets.init_policy(jax.random.PRNGKey(11)))
    jobs[2]["reinforce"] = ("reinforce_step", dict(
        policy_sd=convert.from_flax(pvars), lr=1e-3, parity=0,
        trajs=[(to_port(t.states).tensors(), torch.from_numpy(np.asarray(t.actions, np.int64)),
                to_port(t.final).tensors()) for t, _ in rl],
        rewards=[torch.from_numpy(r) for _, r in rl]))
    out = {k: _run(tmp, k, jobs[k]) for k in (2, 8)}
    return dict(out=out, sl=sl_cases, az=(traj, policy, value), rl=(rl, pvars))


@pytest.mark.parametrize("k", [2, 8])
def test_collectives_place_rows_as_p_dp(runs, k):
    got = runs["out"][k]["collectives"]
    ranks = torch.arange(k, dtype=torch.int8)
    assert torch.equal(got["cols"], ranks.repeat_interleave(2).expand(3, 2 * k))
    assert torch.equal(got["rows"], ranks.repeat_interleave(3)[:, None].expand(3 * k, 2))
    assert got["flags"].dtype == torch.bool
    assert got["flags"].tolist() == [x for r in range(k) for x in (r % 2 == 0, True)]
    x = torch.arange(4 * k, dtype=torch.float32).reshape(2 * k, 2)
    assert torch.equal(got["shard"], x[:2]) and torch.equal(got["shard_cols"], x.T[:, :2])
    assert torch.equal(got["regathered"], x)
    assert got["pmean"].tolist() == [(k - 1) / 2, 1.0] and got["psum"].tolist() == [k * (k - 1) // 2]
    assert got["replicated"].tolist() == [7.0]


@pytest.mark.parametrize("k", [2, 8])
def test_selfplay_sharded_matches_jax_and_unsharded(runs, k):
    got = runs["out"][k]["selfplay"]
    assert got["same"]
    jres = _jax_selfplay(k)
    tres = selfplay(None, fake_evaluator(), SearchConfig(**SELFPLAY), device="cpu", **SELFPLAY_RUN)
    for want in (np.asarray(jres.actions), tres.actions.numpy()):
        np.testing.assert_array_equal(got["actions"].numpy(), want)
    np.testing.assert_array_equal(got["scores"].numpy(), np.asarray(jres.scores))
    final = type(tres.final)(*got["final"])
    assert_states_equal(jres.final, final)
    for a, b in zip(final.tensors(), tres.final.tensors()):
        assert torch.equal(a, b)
    assert got["actions"].shape == (SELFPLAY_RUN["n_moves"], SELFPLAY_RUN["batch"])


@pytest.mark.parametrize("k", [2, 8])
def test_search_sharded_matches_jax_and_unsharded(runs, k):
    got = runs["out"][k]["search"]
    jactions, jtrees = _jax_search(k)
    np.testing.assert_array_equal(got["actions"].numpy(), np.asarray(jactions))
    for f in torch_dp_workers.TREE_FIELDS:
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(getattr(jtrees, f)), err_msg=f)
    assert len(set(got["actions"].tolist())) > 1  # the roots differ, and so do the moves
    # root noise: drawn at the global shape from the shared generator, rows kept
    got = runs["out"][k]["search_noise"]
    actions, trees = mcts.search(to_port(_roots()), fake_evaluator(), None,
                                 SearchConfig(**dict(SEARCH, noise_weight=0.25)), SEARCH_ROLLOUTS,
                                 gen=torch.Generator().manual_seed(9))
    assert torch.equal(got["actions"], actions)
    for f in torch_dp_workers.TREE_FIELDS:
        assert torch.equal(got[f].nan_to_num(7.0), getattr(trees, f).nan_to_num(7.0)), f
    assert not torch.equal(got["pstats"], runs["out"][k]["search"]["pstats"])


@pytest.mark.parametrize("kind", ["policy", "value"])
@pytest.mark.parametrize("k", [2, 8])
def test_sl_dp_steps_match_jax(runs, kind, k):
    for i, (variables, opt_state, fts, targets, new_vars, loss) in enumerate(runs["sl"][kind][k]):
        got = runs["out"][k][f"sl_{kind}_{i}"]
        assert got["same"] and int(got["logs"]) == 2  # rank 0 alone logged: the step's loss, the epoch
        np.testing.assert_allclose(got["loss"], [loss], rtol=RTOL, atol=ATOL)
        want = convert.from_flax(new_vars)
        _close(got["state"], {key: v for key, v in want.items() if "running" in key}, f"k={k} step {i + 1}")
        _close(got["grads"], _port_shard_grads(kind, k, variables, fts, targets), f"k={k} step {i + 1} gradient")
        grads = _sd(_jax_shard_grads(kind, k, variables["params"], variables["batch_stats"], jnp.asarray(fts),
                                     jnp.asarray(targets)))
        # the port's optimizer fed the JAX gradients lands on the JAX step's weights
        net = _net(kind, variables)
        opt = sl.make_optimizer(net, SL_LR)
        if i:
            sl.load_optimizer_state(opt, convert.adam_from_optax(opt_state, net))
        for name, p in net.named_parameters():
            p.grad = grads[name].clone()
        opt.step()
        _close(dict(net.named_parameters()), _sd(new_vars["params"]), f"k={k} step {i + 1} update")


def test_sl_dp_train_starts_every_rank_from_rank_0(runs):
    """Ranks handed other weights and Adam moments than rank 0's end the
    step on rank 0's run, bit for bit: ``train`` broadcasts the net and the
    optimizer state before its first step."""
    got, want = runs["out"][2]["sl_policy_1_skew"], runs["out"][2]["sl_policy_1"]
    assert got["same"] and got["loss"] == want["loss"]
    for key, v in want["state"].items():
        assert torch.equal(got["state"][key], v), key


@pytest.mark.parametrize("kind", ["policy", "value"])
def test_dataset_batches_featurise_a_ranks_rows_only(kind):
    """``batches(rows=)`` yields exactly those rows of each global batch, as
    the whole batch is drawn, augmentation included: a rank featurises its
    share alone."""
    packed, fts, moves, vals = _positions(43, 48)
    ds = (tdata.PackedDataset(**packed, targets=moves, is_value=False) if kind == "policy"
          else tdata.GoDataset(fts, vals, True))
    whole = list(ds.batches(16, np.random.default_rng(1), device="cpu"))
    mesh = mesh_lib.Mesh(rank=1, size=4, group=None, device=torch.device("cpu"))
    part = list(ds.batches(16, np.random.default_rng(1), device="cpu", rows=mesh_lib.shard_slice(16, mesh)))
    assert len(part) == len(whole) == 3
    for (f, t), (wf, wt) in zip(part, whole):
        np.testing.assert_array_equal(np.asarray(f), np.asarray(wf)[4:8])
        np.testing.assert_array_equal(t, wt[4:8])


def test_sl_dp_step_normalises_each_shard(runs):
    """The guard: the k=2 step's running variance is not the one-device
    step's on the same global batch (as it would be under SyncBatchNorm):
    each shard normalised by its own statistics."""
    variables, _, fts, targets, _, _ = runs["sl"]["policy"][2][0]
    net = _net("policy", variables).train()
    sl.train_step(net, sl.make_optimizer(net, SL_LR), sl.policy_loss, torch.from_numpy(fts),
                  torch.from_numpy(targets).long())
    one = {key: v for key, v in net.state_dict().items() if key.endswith("running_var")}
    two = runs["out"][2]["sl_policy_0"]["state"]
    assert any(not np.allclose(two[key].numpy(), v.numpy(), rtol=RTOL, atol=ATOL) for key, v in one.items())


def test_az_dp_step_normalises_globally(runs):
    """k=2 with unequal numbers of live moves in the two shards: the same
    losses and gradients as the unsharded step (per-shard means would
    differ), and the same weights on both ranks after the update."""
    traj, policy, value = runs["az"]
    got = runs["out"][2]["az"]
    assert got["same"] and got["live"] == int(traj.live[:, :2].sum()) != int(traj.live[:, 2:].sum())
    pol, val = nets.PolicyNet(8), nets.ValueNet(8)
    pol.load_state_dict(policy.state_dict())
    val.load_state_dict(value.state_dict())
    pl, vl = az.az_step(az.make_state(pol, val, 1e-3), traj)
    np.testing.assert_allclose([float(got["pl"]), float(got["vl"])], [float(pl), float(vl)], rtol=RTOL, atol=ATOL)
    grads = {f"{kind}.{n}": p.grad for kind, net in (("policy", pol), ("value", val)) for n, p in net.named_parameters()}
    _close(got["grads"], grads, "AZ gradient")
    # averaging the shards' own means is another loss
    halves = [traj._replace(states=traj.states.map(lambda x: x[:, s]), dists=traj.dists[:, s], live=traj.live[:, s],
                            final=traj.final.map(lambda x: x[s])) for s in (slice(0, 2), slice(2, 4))]
    means = [az.az_losses(pol, val, h)[0].item() for h in halves]
    assert abs(sum(means) / 2 - float(got["pl"])) > 1e-3


@pytest.mark.parametrize("k", [2, 8])
def test_az_selfplay_sharded_matches_unsharded(runs, k):
    """Root noise and temperature sampling drawn at the global shape, each
    rank keeping its rows: the sharded AlphaZero games are the unsharded
    run's, game for game."""
    got = runs["out"][k]["az_selfplay"]
    want = az.selfplay_with_targets(torch.Generator().manual_seed(4), fake_evaluator(), None, SearchConfig(**AZ_CFG),
                                    temperature=1.0, device="cpu", **AZ_RUN)
    for a, b in zip(got["states"], want.states.tensors()):
        assert torch.equal(a, b)
    for a, b in zip(got["final"], want.final.tensors()):
        assert torch.equal(a, b)
    assert torch.equal(got["dists"], want.dists) and torch.equal(got["live"], want.live)
    assert len({tuple(b.tolist()) for b in want.final.board}) > 1  # the games differ


_JAX_REINFORCE = jax.jit(jax.value_and_grad(jreinforce.reinforce_loss))


def test_reinforce_dp_step_matches_jax(runs):
    """Each rank's own games: the averaged loss and gradients of the JAX
    loss over the same two trajectories."""
    rl, pvars = runs["rl"]
    got = runs["out"][2]["reinforce"]
    assert got["same"]
    refs = [_JAX_REINFORCE(pvars["params"], pvars["batch_stats"], t, jnp.asarray(r), jnp.int32(0)) for t, r in rl]
    np.testing.assert_allclose(float(got["loss"]), np.mean([float(loss) for loss, _ in refs]), rtol=RTOL, atol=ATOL)
    grads = jax.tree.map(lambda a, b: (a + b) / 2, refs[0][1], refs[1][1])
    _close(got["grads"], _sd(grads), "REINFORCE gradient")


def test_dryrun_multichip_cpu(capfd):
    dryrun.dryrun_multichip(2, device="cpu")
    lines = [line for line in capfd.readouterr().out.splitlines() if line.startswith("dryrun:")]
    assert [line.split(",")[0].split(" ok")[0] for line in lines] == [
        "dryrun: REINFORCE dp step on 2 devices", "dryrun: sharded MCTS search", "dryrun: sharded AZ step"]
    assert all("nan" not in line for line in lines)


def test_mesh_refuses_what_it_cannot_place(tmp_path, monkeypatch):
    """Too few GPUs raise (never a move to the CPU or to gloo), NCCL never
    shares a card, and a batch the ranks do not divide raises."""
    with pytest.raises(RuntimeError, match="spawn"):
        mesh_lib.get_mesh(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 ranks need 2 GPUs"):
        mesh_lib.spawn(torch_dp_workers.run_jobs, 2, "unused")
    with pytest.raises(ValueError, match="backend='gloo'"):
        mesh_lib.spawn(torch_dp_workers.run_jobs, 2, "unused", device="cuda:0")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        mesh_lib.spawn(torch_dp_workers.run_jobs, 2, "unused", device="cpu", backend="nccl")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_lib.spawn(torch_dp_workers.run_jobs, 1, "unused", device="cuda:0", backend="gloo")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}", world_size=1, rank=0)
    try:
        with pytest.raises(RuntimeError, match="1 ranks need 1 GPUs"):
            mesh_lib.get_mesh(1)
        with pytest.raises(ValueError, match="2 ranks"):
            mesh_lib.get_mesh(2, device="cpu")
        with pytest.raises(ValueError, match="runs gloo"):
            mesh_lib.get_mesh(1, device="cpu", backend="nccl")
        m = mesh_lib.get_mesh(1, device="cpu")
        assert (m.rank, m.size, m.device) == (0, 1, torch.device("cpu"))
    finally:
        dist.destroy_process_group()
    three = dataclasses.replace(m, size=3)
    with pytest.raises(ValueError, match="does not split over 3 ranks"):
        mesh_lib.shard_rows(torch.zeros(8), three)
    assert mesh_lib.shard_rows(torch.arange(9), dataclasses.replace(three, rank=2)).tolist() == [6, 7, 8]
