"""REINFORCE policy-gradient self-play training (counterpart of
``bokego_tpu/train/reinforce.py``).

The trained policy plays a batch of games as black and a batch as white
against an opponent from the pool; rewards are the +-1 Tromp-Taylor
outcomes; the loss sums log pi(a|s) over every move of the trained colour
in every game, times the game's reward; one synchronous AdamW step
(``weight_decay=1e-4``, optax's default) per colour batch.

The playouts draw their moves under ``torch.inference_mode`` (the
``inference.policy_probs`` forward); the loss runs its own forward over
the recorded states with autograd on, the net in ``eval()`` mode (running
BatchNorm statistics, as the JAX package's ``train=False``).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from bokego_tpu_torch.coords import NN
from bokego_tpu_torch.env import state as st
from bokego_tpu_torch.features import features_batch
from bokego_tpu_torch.models.nets import PolicyNet
from bokego_tpu_torch.parallel import mesh as mesh_lib
from bokego_tpu_torch.search import playout as po
from bokego_tpu_torch.train.gendata import probs_fn


def play_games(
    gen: torch.Generator,
    train_net: PolicyNet,
    opp_net: PolicyNet,
    batch: int,
    max_turns: int,
    train_as_black: bool,
) -> tuple[po.Trajectory, torch.Tensor]:
    """One batch of games: (trajectory, +-1 rewards of the trained policy)."""
    dev = next(train_net.parameters()).device
    even = probs_fn(train_net if train_as_black else opp_net)
    odd = probs_fn(opp_net if train_as_black else train_net)
    traj = po.playout(
        gen, even, odd, st.new_game_batch(batch, device=dev), num_steps=max_turns + 1, max_turns=max_turns
    )
    r_black = po.rewards(traj.final)
    return traj, (r_black if train_as_black else -r_black)


def reinforce_loss(net: PolicyNet, traj: po.Trajectory, rewards: torch.Tensor, train_parity: int) -> torch.Tensor:
    """``-(1/B) sum_b R_b sum_t log pi(a_tb | s_tb)`` over the trained
    colour's real moves (steps of parity ``train_parity``, actions < 81)."""
    T, B = traj.actions.shape
    flat = traj.states.map(lambda x: x.reshape((T * B,) + x.shape[2:]))
    logp = torch.log_softmax(net(features_batch(flat)), dim=-1).reshape(T, B, NN)
    actions = traj.actions
    steps = torch.arange(T, device=actions.device)[:, None]
    mask = (steps % 2 == train_parity) & (actions < NN)
    chosen = logp.gather(-1, actions.clamp(max=NN - 1)[..., None])[..., 0]
    per_game = torch.where(mask, chosen, 0.0).sum(0)  # (B,)
    return -torch.mean(per_game * rewards)


def make_optimizer(net: PolicyNet, lr: float) -> torch.optim.Optimizer:
    """``optax.adamw(lr)``: weight decay 1e-4 on every parameter, eps 1e-8."""
    return torch.optim.AdamW(net.parameters(), lr=lr, weight_decay=1e-4, eps=1e-8)


def update(
    net: PolicyNet, optimizer, traj: po.Trajectory, rewards: torch.Tensor, train_parity: int,
    mesh: mesh_lib.Mesh | None = None,
) -> torch.Tensor:
    """One AdamW step on one colour batch; returns the loss, detached.  With
    a ``mesh`` (the JAX package's dp step) ``traj`` is this rank's own games
    and the loss and gradients are averaged over the ranks (``pmean``)
    before the step, which every rank then takes alike."""
    net.eval()
    optimizer.zero_grad(set_to_none=True)
    loss = reinforce_loss(net, traj, rewards, train_parity)
    loss.backward()
    loss = loss.detach()
    if mesh is not None:
        mesh_lib.pmean([loss, *(p.grad for p in net.parameters())], mesh)
    optimizer.step()
    return loss


@dataclasses.dataclass
class ReinforceResult:
    net: PolicyNet
    optimizer: torch.optim.Optimizer
    winrates: list[float]


def train_epoch(
    gen: torch.Generator,
    net: PolicyNet,
    opp_net: PolicyNet,
    *,
    n_iters: int = 64,
    batch_games: int = 16,
    max_turns: int = 70,
    lr: float = 1e-5,
    optimizer: torch.optim.Optimizer | None = None,
    log_fn=print,
    stats: list[float] | None = None,
    timings: list[dict[str, float]] | None = None,
) -> ReinforceResult:
    """One epoch of REINFORCE against a fixed opponent: each iteration plays
    ``batch_games`` as black, updates, plays ``batch_games`` as white,
    updates.  ``net`` trains in place.  With ``timings`` given, each colour
    batch appends its synchronised ``{"selfplay_s", "update_s"}``."""
    if optimizer is None:
        optimizer = make_optimizer(net, lr)
    winrates = stats if stats is not None else []
    for it in range(n_iters):
        for as_black in (True, False):
            t0 = time.monotonic()
            traj, rewards = play_games(gen, net, opp_net, batch_games, max_turns, as_black)
            won = float((rewards > 0).float().mean())  # a read: the games are done
            t1 = time.monotonic()
            update(net, optimizer, traj, rewards, 0 if as_black else 1)
            winrates.append(won)
            if timings is not None:
                if rewards.is_cuda:
                    torch.cuda.synchronize(rewards.device)
                timings.append({"selfplay_s": t1 - t0, "update_s": time.monotonic() - t1})
        if (it + 1) % 10 == 0:
            log_fn(f"iter {it + 1}: winrate {np.mean(winrates[-20:]):.2f}")
    return ReinforceResult(net=net, optimizer=optimizer, winrates=winrates)
