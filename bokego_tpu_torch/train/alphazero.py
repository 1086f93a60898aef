"""AlphaZero-style training (counterpart of ``bokego_tpu/train/alphazero.py``):
self-play with a full PUCT search per move, the normalised root visit
counts as policy targets and the final Tromp-Taylor outcome as value
targets.

The JAX package runs the moves in one ``lax.scan``; here they are a host
loop over moves, each a fresh ``init_trees`` (root noise drawn from the
caller's ``torch.Generator``) and ``run_search`` on the non-kernel path
(``use_kernel=False``, as the JAX trainer's default ``SearchConfig``).
Both nets stay in ``eval()`` mode throughout: the updates take gradients
through the running BatchNorm statistics and leave them unchanged, as the
JAX package's ``train=False``.

Sharded over a data-parallel mesh (``mesh=``), each rank plays its rows of
the global batch and the step keeps the JAX package's global
normalisation (a plain ``jit`` under GSPMD there): the losses divide by the
live moves of the whole batch, so each rank's loss is its share of the
global mean and the shares and gradients are summed over the ranks, not
averaged (per-shard means would weigh a shard's moves by its own count).
"""

from __future__ import annotations

import time
from typing import Any, NamedTuple

import numpy as np
import torch

from bokego_tpu_torch.config import SearchConfig
from bokego_tpu_torch.coords import NN, PASS_ACTION
from bokego_tpu_torch.env import rules, state as st
from bokego_tpu_torch.env.state import GoState
from bokego_tpu_torch.features import features_batch
from bokego_tpu_torch.models.nets import PolicyNet, ValueNet
from bokego_tpu_torch.parallel import mesh as mesh_lib
from bokego_tpu_torch.search import mcts
from bokego_tpu_torch.search.tree import C_N, take_rows


class AZTrajectory(NamedTuple):
    states: GoState  # (T, B, ...): the position before each move
    dists: torch.Tensor  # (T, B, 81): normalised root visit counts
    live: torch.Tensor  # (T, B): the game was still running at this move
    final: GoState  # (B, ...)


def gumbel(gen: torch.Generator, batch: int, device) -> torch.Tensor:
    """``(batch, 81)`` standard Gumbel draws from ``gen`` (on ``device``)."""
    u = torch.rand((batch, NN), generator=gen, device=device)
    return -torch.log(-torch.log(u))


def _sample_by_visits(noise: torch.Tensor, visits: torch.Tensor, temperature: float) -> torch.Tensor:
    """An action per row with probability proportional to
    ``visits ** (1 / temperature)`` over the visited points, by the Gumbel
    maximum with ``noise`` (:func:`gumbel`, as ``jax.random.categorical``
    samples): each row reads its own noise row only, so a sharded run that
    keeps its rows of the global draw samples as the unsharded run does.
    PASS where no point has a visit."""
    logits = torch.log(visits.clamp(min=1e-9)) / temperature
    logits = torch.where(visits > 0, logits, -torch.inf)
    actions = torch.argmax(logits + noise, dim=-1)
    return torch.where(visits.sum(1) > 0, actions, PASS_ACTION)


def selfplay_with_targets(
    gen: torch.Generator,
    ev: mcts.Evaluator,
    params,
    cfg: SearchConfig,
    batch: int,
    n_moves: int,
    n_rollouts: int,
    temperature: float = 0.0,
    temp_moves: int | None = None,
    device=None,
    mesh: mesh_lib.Mesh | None = None,
) -> AZTrajectory:
    """Play ``batch`` games of ``n_moves`` moves on ``device`` with a full
    search per move, recording the targets.

    ``temperature`` 0 plays the most-visited move; above 0 it samples by
    visits ** (1 / temperature), for the first ``temp_moves`` plies only
    when that is set (greedy after).

    With a ``mesh``, ``batch`` is global and this rank plays and returns its
    rows on ``mesh.device``.  The root noise and the sampling noise are
    drawn at the global shape from ``gen`` (seeded alike on every rank) and
    each rank keeps its rows, so the sharded games are the unsharded run's,
    game for game."""
    rows = batch if mesh is None else mesh_lib.shard_size(batch, mesh)
    s = st.new_game_batch(rows, device=device if mesh is None else mesh.device)
    dev = s.board.device
    done = torch.zeros(rows, dtype=torch.bool, device=dev)
    states, dists, live = [], [], []
    for i in range(n_moves):
        noise = None
        if cfg.noise_weight > 0:
            noise = mesh_lib.draw_rows(lambda n: mcts.dirichlet_noise(gen, n, cfg.dirichlet_alpha, dev), batch, mesh)
        trees = mcts.init_trees(s, ev, params, cfg, noise=noise)
        trees = mcts.run_search(trees, ev, params, cfg, n_rollouts, gen=gen)
        visits = take_rows(trees.pstats, trees.root)[:, C_N, :NN]
        dist = visits / visits.sum(1, keepdim=True).clamp(min=1.0)
        if temperature > 0 and (temp_moves is None or i < temp_moves):
            actions = _sample_by_visits(mesh_lib.draw_rows(lambda n: gumbel(gen, n, dev), batch, mesh), visits, temperature)
        else:
            actions = mcts.choose_action(trees)
        actions = torch.where(done, PASS_ACTION, actions)
        states.append(s)
        dists.append(dist)
        live.append(~done)
        s = rules.step(s, actions)
        done = done | rules.is_terminal(s, cfg.max_turns)
    stacked = GoState(*(torch.stack(xs) for xs in zip(*(x.tensors() for x in states))))
    return AZTrajectory(states=stacked, dists=torch.stack(dists), live=torch.stack(live), final=s)


def az_losses(
    policy: PolicyNet, value: ValueNet, traj: AZTrajectory, mesh: mesh_lib.Mesh | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """(policy cross-entropy against the visit distributions, value MSE
    against the outcomes), masked to live moves.  The value targets the
    side to move: ``z_t = outcome * (-1)^t``.  With a ``mesh``, ``traj`` is
    this rank's rows and the losses are its shares of the global means
    (divided by the live moves of every rank)."""
    T, B = traj.live.shape
    flat = traj.states.map(lambda x: x.reshape((T * B,) + x.shape[2:]))
    fts = features_batch(flat)
    logp = torch.log_softmax(policy(fts).reshape(T, B, NN), dim=-1)
    values = value(fts).reshape(T, B)

    ce = -(traj.dists * logp).sum(-1)  # (T, B)
    mask = traj.live.float()
    n = mask.sum()
    if mesh is not None:
        mesh_lib.psum(n, mesh)
    n = n.clamp(min=1.0)
    policy_loss = (ce * mask).sum() / n

    outcome = torch.where(rules.score(traj.final) > 0, 1.0, -1.0)  # (B,)
    parity = torch.where(torch.arange(T, device=mask.device)[:, None] % 2 == 0, 1.0, -1.0)
    value_loss = (((values - outcome[None, :] * parity) ** 2) * mask).sum() / n
    return policy_loss, value_loss


class AZState(NamedTuple):
    policy: PolicyNet
    value: ValueNet
    policy_opt: torch.optim.Optimizer
    value_opt: torch.optim.Optimizer


def make_state(policy: PolicyNet, value: ValueNet, lr: float) -> AZState:
    """Both nets with ``optax.adamw(lr)``'s twin each (weight decay 1e-4)."""

    def adamw(net):
        return torch.optim.AdamW(net.parameters(), lr=lr, weight_decay=1e-4, eps=1e-8)

    return AZState(policy.eval(), value.eval(), adamw(policy), adamw(value))


def az_step(
    state: AZState, traj: AZTrajectory, mesh: mesh_lib.Mesh | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """One AdamW update of each net on its own loss (in place); returns the
    two losses, detached.  The policy loss does not depend on the value net
    nor the value loss on the policy, so one forward of each serves both.
    With a ``mesh``, the ranks' loss shares and gradients are summed before
    the updates, which every rank then takes alike (module docstring)."""
    state.policy_opt.zero_grad(set_to_none=True)
    state.value_opt.zero_grad(set_to_none=True)
    pl, vl = az_losses(state.policy, state.value, traj, mesh)
    (pl + vl).backward()
    pl, vl = pl.detach(), vl.detach()
    if mesh is not None:
        nets = (state.policy, state.value)
        mesh_lib.psum([pl, vl, *(p.grad for net in nets for p in net.parameters())], mesh)
    state.policy_opt.step()
    state.value_opt.step()
    return pl, vl


def default_config(n_moves: int) -> SearchConfig:
    """The JAX trainer's search: non-kernel, no simulations, 512 nodes."""
    return SearchConfig(
        expand_thresh=8, no_sim=True, max_nodes=512, noise_weight=0.25, max_turns=min(80, n_moves + 2)
    )


def iteration_seed(seed: int, it: int) -> int:
    """The generator seed of iteration ``it``: a resumed run draws fresh
    games (the JAX package's ``fold_in(rng, it)``)."""
    return int(np.random.SeedSequence([seed, it]).generate_state(1)[0])


def train(
    seed: int,
    policy: PolicyNet,
    value: ValueNet,
    *,
    iters: int = 4,
    batch: int = 64,
    n_moves: int = 80,
    n_rollouts: int = 64,
    cfg: SearchConfig | None = None,
    lr: float = 1e-3,
    temperature: float = 1.0,
    temp_moves: int | None = 12,
    updates_per_iter: int = 1,
    start_iter: int = 0,
    checkpoint_fn=None,
    log_fn=print,
    timings: list[dict[str, Any]] | None = None,
) -> AZState:
    """The closed loop: search self-play, then ``updates_per_iter`` updates
    on that trajectory, per iteration; ``checkpoint_fn(it, state)`` after
    each.  The optimizers start fresh (the JAX trainer does too).  With
    ``timings`` given, each iteration appends its synchronised
    ``{"selfplay_s", "update_s"}``."""
    cfg = default_config(n_moves) if cfg is None else cfg
    dev = next(policy.parameters()).device
    ev = mcts.net_evaluator(has_value=True)
    state = make_state(policy, value, lr)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for it in range(start_iter, start_iter + iters):
        gen = torch.Generator(device=dev).manual_seed(iteration_seed(seed, it))
        t0 = time.monotonic()
        traj = selfplay_with_targets(
            gen, ev, {"policy": state.policy, "value": state.value}, cfg, batch, n_moves, n_rollouts,
            temperature, temp_moves, device=dev,
        )
        sync()
        t1 = time.monotonic()
        for _ in range(updates_per_iter):
            pl, vl = az_step(state, traj)
        sync()
        if timings is not None:
            timings.append({"selfplay_s": t1 - t0, "update_s": time.monotonic() - t1})
        wins = float((rules.score(traj.final) > 0).float().mean())
        log_fn(f"az iter {it + 1}: policy_ce {float(pl):.3f} value_mse {float(vl):.3f} black_winrate {wins:.2f}")
        if checkpoint_fn is not None:
            checkpoint_fn(it + 1, state)
    return state
