"""Supervised training of the policy and value nets (counterpart of
``bokego_tpu/train/sl.py``): cross-entropy on moves for the policy, MSE on
game outcomes for the value net, the nets in ``train()`` mode (BatchNorm on
batch statistics, running averages updated with Flax's semantics).

The optimizer is the JAX package's: ``optax.adam(lr)`` without weight decay
and ``optax.adamw(lr, weight_decay=wd)`` with it, both ``eps=1e-8``; the
decay applies to every parameter (one group), BatchNorm scales and biases
included.  Torch's own ``AdamW`` default decay (1e-2) is never used.

Data parallel (``n_devices > 1``, the JAX package's ``shard_map`` step):
one process per rank (``parallel.mesh.spawn``), each with its rows of every
global batch.  BatchNorm normalises each shard by its own batch statistics;
then the gradients, the loss and the updated running statistics are
averaged over the ranks (``pmean``) and Adam steps alike on every rank.
That is neither ``SyncBatchNorm`` (global statistics) nor DDP's default
(``broadcast_buffers`` copies rank 0's running statistics).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from bokego_tpu_torch.models.nets import PolicyNet, ValueNet
from bokego_tpu_torch.parallel import mesh as mesh_lib


@dataclasses.dataclass
class TrainState:
    net: PolicyNet | ValueNet
    optimizer: torch.optim.Optimizer
    epoch: int = 0
    losses: list[float] = dataclasses.field(default_factory=list)  # every logged loss


def policy_loss(net: PolicyNet, fts: torch.Tensor, moves: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of the logits against the integer moves."""
    return F.cross_entropy(net(fts), moves)


def value_loss(net: ValueNet, fts: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Mean squared error of the value against the outcomes."""
    return torch.mean((net(fts)[:, 0] - vals) ** 2)


def make_optimizer(net: torch.nn.Module, lr: float, weight_decay: float = 0.0) -> torch.optim.Optimizer:
    """``optax.adam(lr)``, or ``optax.adamw(lr, weight_decay)`` when the
    decay is not 0."""
    if weight_decay:
        return torch.optim.AdamW(net.parameters(), lr=lr, weight_decay=weight_decay, eps=1e-8)
    return torch.optim.Adam(net.parameters(), lr=lr, eps=1e-8)


def load_optimizer_state(optimizer: torch.optim.Optimizer, opt_state: dict) -> None:
    """Restore the moments and steps of ``opt_state`` (a state dict, or the
    ``{"state": ...}`` of ``convert.adam_from_optax``) and keep the
    optimizer's own hyperparameters, as the JAX package restores an optax
    state under the optimizer that the current flags build."""
    sd = optimizer.state_dict()
    sd["state"] = opt_state["state"]
    optimizer.load_state_dict(sd)


def _on(x, dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A batch array (numpy, possibly a negative-stride D4 view, or a
    tensor) on ``dev`` as ``dtype``."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(dev, dtype)


def running_stats(net: torch.nn.Module) -> list[torch.Tensor]:
    """The BatchNorm running means and variances of ``net``."""
    return [b for name, b in net.named_buffers() if name.endswith(("running_mean", "running_var"))]


def train_step(
    net, optimizer, loss_fn, fts: torch.Tensor, targets: torch.Tensor, mesh: mesh_lib.Mesh | None = None
) -> torch.Tensor:
    """One SGD step on one batch; returns the loss, detached, on the device.
    With a ``mesh``, ``fts`` and ``targets`` are this rank's rows and the
    loss, the gradients and the running statistics are averaged over the
    ranks before the step (module docstring)."""
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(net, fts, targets)
    loss.backward()
    loss = loss.detach()
    if mesh is not None:
        mesh_lib.pmean([loss, *running_stats(net), *(p.grad for p in net.parameters())], mesh)
    optimizer.step()
    return loss


def train(
    dataset,
    net: PolicyNet | ValueNet,
    *,
    kind: str = "value",
    epochs: int = 1,
    batch_size: int = 32,
    lr: float = 1e-2,
    weight_decay: float = 0.0,
    n_devices: int = 1,
    seed: int = 0,
    opt_state: dict | None = None,
    start_epoch: int = 0,
    log_every: int = 100,
    log_fn: Callable[[str], None] = print,
    stats_path: str | None = None,
) -> TrainState:
    """The epoch loop: loss logs every ``log_every`` steps, a stats file
    appended per epoch, timing per epoch.  ``net`` trains in place on its own
    device and is left in ``eval()`` mode.

    With ``n_devices = k > 1`` this runs in each of k ranks' processes
    (``parallel.mesh.spawn``; without a process group of k it raises): the
    net and the optimizer state are broadcast from rank 0, every rank draws
    the same global batches from ``seed`` and featurises only its rows of
    each (``batch_size`` is the global batch; the dataset's ``batches`` takes
    ``rows=``) and takes the data-parallel step; only rank 0 logs and writes
    the stats file."""
    dev = next(net.parameters()).device
    mesh = mesh_lib.get_mesh(n_devices, device=dev) if n_devices > 1 else None
    shard = {}
    if mesh is not None:
        shard = {"rows": mesh_lib.shard_slice(batch_size, mesh)}
        if mesh.rank != 0:
            log_fn, stats_path = (lambda _: None), None
    loss_fn = value_loss if kind == "value" else policy_loss
    target_dtype = torch.float32 if kind == "value" else torch.int64
    optimizer = make_optimizer(net, lr, weight_decay)
    if opt_state is not None:
        load_optimizer_state(optimizer, opt_state)
    if mesh is not None:
        # one replicated starting point, as the JAX step's replicated params
        # and optimizer state: averaged gradients keep ranks together, they
        # do not bring them together
        mesh_lib.replicate([net, list(optimizer.state.values())], mesh)

    rng = np.random.default_rng(seed)
    logged: list[float] = []
    epoch = start_epoch
    t_all = time.monotonic()
    total_steps = 0
    net.train()
    for _ in range(epochs):
        t0 = time.monotonic()
        losses, count = [], 0
        # the running loss stays on the device between logs: a read per
        # step would synchronise every step
        running = torch.zeros((), device=dev)
        for fts, targets in dataset.batches(batch_size, rng, device=dev, **shard):
            fts, targets = _on(fts, dev, torch.float32), _on(targets, dev, target_dtype)
            running = running + train_step(net, optimizer, loss_fn, fts, targets, mesh)
            count += 1
            if count % log_every == 0:
                r = float(running)
                log_fn(f"epoch {epoch + 1} step {count}: loss {r:.4f}")
                losses.append(r)
                running = torch.zeros((), device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        epoch += 1
        total_steps += count
        dt = time.monotonic() - t0
        log_fn(
            f"epoch {epoch} done in {dt:.1f}s ({count} steps, "
            f"{1e3 * dt / max(count, 1):.1f} ms/step, {count * batch_size / dt:,.0f} positions/s)"
        )
        if stats_path:
            with open(stats_path, "a+") as f:
                f.write(f"Epoch: {epoch}\n")
                f.write(",".join(f"{x:.3f}" for x in losses) + "\n")
        logged += losses
    net.eval()
    dt_all = time.monotonic() - t_all
    if total_steps and epochs > 1:
        log_fn(f"{epochs} epochs in {dt_all:.1f}s: {total_steps * batch_size / dt_all:,.0f} positions/s overall")
    return TrainState(net=net, optimizer=optimizer, epoch=epoch, losses=logged)
