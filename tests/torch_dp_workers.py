"""Rank workers of ``tests/test_torch_parallel.py``, jax-free: the spawned
ranks import this module and never jax.  The test writes a job file of
named jobs (inputs as tensors), ``run_jobs`` runs them all on every rank of
one spawn, and rank 0 writes the results beside the job file."""

from __future__ import annotations

import torch

from bokego_tpu_torch.config import SearchConfig
from bokego_tpu_torch.env.state import GoState
from bokego_tpu_torch.models import nets
from bokego_tpu_torch.parallel import mesh as mesh_lib
from bokego_tpu_torch.parallel.selfplay import search_sharded, selfplay_sharded
from bokego_tpu_torch.search import playout as po
from bokego_tpu_torch.train import alphazero as az
from bokego_tpu_torch.train import reinforce, sl
from tests.torch_fake_eval import fake_evaluator

TREE_FIELDS = ("pstats", "root_stats", "n_nodes", "parent", "action", "value", "expanded", "terminal", "root")


def identical_on_ranks(tensors, mesh) -> bool:
    """Whether every rank holds the same values (bit for bit)."""
    flat = torch.cat([t.detach().reshape(-1).double() for t in tensors])
    rows = mesh_lib.gather_rows(flat[None], mesh)
    return bool(torch.equal(rows, rows[:1].expand_as(rows)))


def collectives(mesh):
    """Row placement, dtypes and the reductions on rank-dependent data."""
    r, k = mesh.rank, mesh.size
    mine = torch.full((3, 2), r, dtype=torch.int8)
    flags = torch.tensor([r % 2 == 0, True])
    x = torch.arange(4 * k, dtype=torch.float32).reshape(2 * k, 2)
    vals = [torch.tensor([float(r), 1.0]), torch.tensor([r], dtype=torch.int64)]
    mesh_lib.pmean(vals[:1], mesh)
    mesh_lib.psum(vals[1:], mesh)
    replicated = mesh_lib.replicate(torch.tensor([float(r + 7)]), mesh)
    return dict(
        cols=mesh_lib.gather_rows(mine, mesh, dim=1), rows=mesh_lib.gather_rows(mine, mesh),
        flags=mesh_lib.gather_rows(flags, mesh), shard=mesh_lib.shard_rows(x, mesh),
        shard_cols=mesh_lib.shard_rows(x.T, mesh, dim=1), regathered=mesh_lib.gather_rows(mesh_lib.shard_rows(x, mesh), mesh),
        pmean=vals[0], psum=vals[1], replicated=replicated,
    )


def selfplay(mesh, cfg, batch, n_moves, n_rollouts):
    res = selfplay_sharded(mesh, None, fake_evaluator(), SearchConfig(**cfg), batch, n_moves, n_rollouts)
    return dict(actions=res.actions, scores=res.scores, final=res.final.tensors(),
                same=identical_on_ranks([res.actions, res.scores, *res.final.tensors()], mesh))


def search(mesh, cfg, roots, n_rollouts, seed):
    gen = torch.Generator().manual_seed(seed)
    actions, trees = search_sharded(mesh, GoState(*roots), fake_evaluator(), None, SearchConfig(**cfg), n_rollouts, gen)
    return dict(actions=actions, **{f: mesh_lib.gather_rows(getattr(trees, f), mesh) for f in TREE_FIELDS})


class _OneBatch:
    def __init__(self, fts, targets):
        self.fts, self.targets = fts, targets

    def batches(self, batch_size, rng, augment=True, device=None, rows=None):
        yield self.fts[rows], self.targets[rows]


def sl_step(mesh, kind, state_dict, opt_state, fts, targets, lr, skew=False):
    """One step of ``sl.train(n_devices=k)`` on the global batch (a resumed
    run when ``opt_state`` is given).  ``skew``: every rank but 0 starts
    from other weights and moments, which ``train`` must replace by rank
    0's."""
    net = (nets.PolicyNet if kind == "policy" else nets.ValueNet)()
    net.load_state_dict(state_dict)
    if skew and mesh.rank:
        for t in net.state_dict().values():
            t.add_(1)
        opt_state = {"state": {i: {name: v + 1 for name, v in s.items()} for i, s in opt_state["state"].items()}}
    logs = []
    state = sl.train(_OneBatch(fts, targets), net, kind=kind, batch_size=fts.shape[0], lr=lr, n_devices=mesh.size,
                     opt_state=opt_state, log_every=1, log_fn=logs.append)
    params = dict(net.named_parameters())
    return dict(
        loss=state.losses, logs=mesh_lib.psum(torch.tensor([len(logs)]), mesh), state=net.state_dict(),
        grads={n: p.grad for n, p in params.items()},
        same=identical_on_ranks([*params.values(), *sl.running_stats(net)], mesh),
    )


def az_step(mesh, channels, policy_sd, value_sd, traj, lr):
    """One AlphaZero step on this rank's rows of a global trajectory."""
    policy, value = nets.PolicyNet(channels), nets.ValueNet(channels)
    policy.load_state_dict(policy_sd)
    value.load_state_dict(value_sd)
    states, dists, live, final = traj
    local = az.AZTrajectory(
        states=mesh_lib.shard_rows(GoState(*states), mesh, dim=1), dists=mesh_lib.shard_rows(dists, mesh, dim=1),
        live=mesh_lib.shard_rows(live, mesh, dim=1), final=mesh_lib.shard_rows(GoState(*final), mesh),
    )
    state = az.make_state(policy, value, lr)
    pl, vl = az.az_step(state, local, mesh)
    params = {f"{kind}.{n}": p for kind, net in (("policy", policy), ("value", value)) for n, p in net.named_parameters()}
    return dict(pl=pl, vl=vl, live=int(local.live.sum()), grads={n: p.grad for n, p in params.items()},
                same=identical_on_ranks(params.values(), mesh))


def az_selfplay(mesh, cfg, batch, n_moves, n_rollouts, seed, temp_moves):
    """A sharded AlphaZero trajectory with root noise and temperature
    sampling, gathered into global order."""
    gen = torch.Generator().manual_seed(seed)
    traj = az.selfplay_with_targets(gen, fake_evaluator(), None, SearchConfig(**cfg), batch, n_moves, n_rollouts,
                                    temperature=1.0, temp_moves=temp_moves, mesh=mesh)
    return dict(states=[mesh_lib.gather_rows(t, mesh, dim=1) for t in traj.states.tensors()],
                dists=mesh_lib.gather_rows(traj.dists, mesh, dim=1), live=mesh_lib.gather_rows(traj.live, mesh, dim=1),
                final=mesh_lib.gather_rows(traj.final, mesh).tensors())


def reinforce_step(mesh, policy_sd, trajs, rewards, parity, lr):
    """One REINFORCE dp step, rank r on the r-th trajectory."""
    net = nets.PolicyNet()
    net.load_state_dict(policy_sd)
    states, actions, final = trajs[mesh.rank]
    traj = po.Trajectory(states=GoState(*states), actions=actions, final=GoState(*final))
    loss = reinforce.update(net, reinforce.make_optimizer(net, lr), traj, rewards[mesh.rank], parity, mesh)
    params = dict(net.named_parameters())
    return dict(loss=loss, grads={n: p.grad for n, p in params.items()}, same=identical_on_ranks(params.values(), mesh))


JOBS = dict(collectives=collectives, selfplay=selfplay, search=search, sl_step=sl_step, az_step=az_step,
            az_selfplay=az_selfplay, reinforce_step=reinforce_step)


def run_jobs(mesh, job_path: str) -> None:
    """Run every job of ``job_path`` (``{name: (worker, kwargs)}``) on this
    rank; rank 0 saves ``{name: result}`` to ``job_path + ".out"``."""
    torch.set_num_threads(1)
    jobs = torch.load(job_path, weights_only=False)
    out = {name: JOBS[worker](mesh, **kwargs) for name, (worker, kwargs) in jobs.items()}
    if mesh.rank == 0:
        torch.save(out, job_path + ".out")

