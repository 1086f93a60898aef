"""The data-parallel mesh over ``torch.distributed`` (counterpart of
``bokego_tpu/parallel/mesh.py``).

The JAX package shards every batch dimension over a 1-D ``('dp',)`` mesh
of devices in one program and lets GSPMD insert the collectives, the net
parameters replicated.  Here every rank is a process that owns one device
and one slice of the batch: row ``i`` of a global batch of ``B`` belongs to
rank ``i // (B / k)``, as ``P("dp")`` places it, and the collectives are
explicit: :func:`replicate` (a broadcast from rank 0), :func:`pmean` and
:func:`psum` (one ``all_reduce`` of all the tensors flattened together) and
:func:`gather_rows` (the rows back in global order on every rank).

Backends: NCCL serves CUDA tensors, gloo the CPU.  By default rank ``r``
runs on ``cuda:r`` over NCCL, and too few GPUs raise: nothing moves to the
CPU or to gloo on its own.  NCCL refuses two ranks on one card, so sharing
a card (``device="cuda:0"``) is an explicit ``backend="gloo"`` choice;
torch's gloo backend carries CUDA tensors through ``broadcast`` and
``all_reduce`` only, which is why :func:`gather_rows` is an ``all_reduce``
into a zeroed global buffer and not an ``all_gather``.

:func:`spawn` starts the ranks (``torch.multiprocessing`` with the
``spawn`` start method, which CUDA needs) and hands each its :class:`Mesh`.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Callable

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the 1-D ``('dp',)`` mesh."""

    rank: int
    size: int
    group: Any  # the process group (None only for a mesh built by hand, without collectives)
    device: torch.device


def rank_device(rank: int, n: int, device=None) -> torch.device:
    """The device of ``rank`` among ``n``: ``cuda:rank`` when ``device`` is
    ``None`` or ``"cuda"`` (raising when there are fewer GPUs than ranks),
    else ``device`` itself for every rank (``"cpu"``, or one card that the
    ranks share)."""
    if device is None or torch.device(device) == torch.device("cuda"):
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count < n:
            raise RuntimeError(
                f"{n} ranks need {n} GPUs (one each) and this machine has {count}; pass device='cpu' "
                "for gloo on the CPU, or one card for every rank with backend='gloo'"
            )
        return torch.device("cuda", rank)
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass device='cpu' to run on the CPU")
    return dev


def get_mesh(n_devices: int | None = None, device=None, backend: str | None = None) -> Mesh:
    """This rank's mesh over the initialised default process group (of
    ``n_devices`` ranks when given), on :func:`rank_device`'s device.
    ``backend``, when given, must be the group's.  A CUDA device over gloo
    is taken only from a group that was started with gloo on purpose."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no process group: a data-parallel run needs one process per rank; start them with "
            "bokego_tpu_torch.parallel.mesh.spawn"
        )
    size, rank, have = dist.get_world_size(), dist.get_rank(), dist.get_backend()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a mesh of {n_devices} devices needs a process group of {n_devices} ranks, not {size}")
    if backend is not None and backend != have:
        raise ValueError(f"the process group runs {have}, not {backend}")
    dev = rank_device(rank, size, device)
    if have == "nccl" and dev.type != "cuda":
        raise ValueError(f"NCCL carries CUDA tensors only, not {dev}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(rank=rank, size=size, group=dist.group.WORLD, device=dev)


def shard_size(batch: int, mesh: Mesh) -> int:
    """Rows per rank of a global batch of ``batch``; raises unless the
    ranks divide it."""
    if batch % mesh.size:
        raise ValueError(f"a batch of {batch} does not split over {mesh.size} ranks")
    return batch // mesh.size


def shard_slice(batch: int, mesh: Mesh) -> slice:
    """This rank's rows of a global batch of ``batch``: ``rank * B/k`` to
    ``(rank + 1) * B/k``."""
    per = shard_size(batch, mesh)
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_rows(x, mesh: Mesh, dim: int = 0):
    """This rank's rows (:func:`shard_slice`) of a global batch (a tensor,
    or an object with a ``map`` over its tensors such as ``GoState``) along
    ``dim``, as a contiguous copy."""
    if hasattr(x, "map"):
        return x.map(lambda t: shard_rows(t, mesh, dim))
    rows = shard_slice(x.shape[dim], mesh)
    return x.narrow(dim, rows.start, rows.stop - rows.start).clone(memory_format=torch.contiguous_format)


def draw_rows(draw: Callable[[int], torch.Tensor], batch: int, mesh: Mesh | None):
    """This rank's rows of ``draw(batch)``, a random draw at the global
    batch's shape from a generator seeded alike on every rank: every rank
    draws the whole tensor and keeps its rows, so the sharded run's draws
    are the unsharded run's.  Without a mesh, the whole draw."""
    full = draw(batch)
    return full if mesh is None else shard_rows(full, mesh)


def gather_rows(x, mesh: Mesh, dim: int = 0):
    """Every rank's rows along ``dim`` in global order, on every rank (an
    ``all_reduce`` of a zeroed global buffer that holds this rank's rows:
    exact, integers and booleans included)."""
    if hasattr(x, "map"):
        return x.map(lambda t: gather_rows(t, mesh, dim))
    wire = torch.uint8 if x.dtype == torch.bool else x.dtype
    shape = list(x.shape)
    per = shape[dim]
    shape[dim] = per * mesh.size
    out = torch.zeros(shape, dtype=wire, device=x.device)
    out.narrow(dim, mesh.rank * per, per).copy_(x)
    dist.all_reduce(out, group=mesh.group)
    return out.to(x.dtype)


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors of a tensor, a module (parameters and buffers), or a
    dict, list or tuple of them; ``None`` holds none."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.state_dict().values())
    if isinstance(tree, dict):
        tree = list(tree.values())
    return [t for x in tree for t in _tensors(x)]


def replicate(tree, mesh: Mesh):
    """Broadcast a module's parameters and buffers, or tensors (an
    optimizer's ``state`` too), from rank 0 to every rank, in place; returns
    ``tree``.  A tensor off the mesh's device (Adam's step count lives on
    the CPU) travels through a copy on it."""
    for t in _tensors(tree):
        wire = t.data if t.device == mesh.device else t.data.to(mesh.device)
        dist.broadcast(wire, src=0, group=mesh.group)
        if wire is not t.data:
            t.data.copy_(wire)
    return tree


def psum(tensors, mesh: Mesh, mean: bool = False):
    """Sum (``mean``: and divide by the ranks, as ``lax.pmean``) tensors
    over the ranks in place, with one ``all_reduce`` per dtype of all of
    them flattened together; returns ``tensors``."""
    flat_list = _tensors(tensors)
    for dtype in dict.fromkeys(t.dtype for t in flat_list):
        group = [t for t in flat_list if t.dtype == dtype]
        flat = torch.cat([t.detach().reshape(-1) for t in group])
        dist.all_reduce(flat, group=mesh.group)
        if mean:
            flat.div_(mesh.size)
        offset = 0
        for t in group:
            t.detach().copy_(flat[offset : offset + t.numel()].view_as(t))
            offset += t.numel()
    return tensors


def pmean(tensors, mesh: Mesh):
    """``lax.pmean`` over the ranks, in place: the sum divided by the ranks."""
    return psum(tensors, mesh, mean=True)


def _run(rank: int, fn: Callable, n: int, device, backend: str, init_method: str, args: tuple) -> None:
    dev = rank_device(rank, n, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, world_size=n, rank=rank)
    try:
        fn(get_mesh(n, device, backend), *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, n: int, *args, device=None, backend: str | None = None, init_method: str | None = None) -> None:
    """Run ``fn(mesh, *args)`` in ``n`` new processes, one per rank, in a
    process group of ``n``, and wait for all of them (a rank's exception
    raises here).  ``device`` as in :func:`rank_device`; ``backend`` NCCL for
    CUDA and gloo for the CPU unless given; ``init_method`` a rendezvous file
    in a new temporary directory unless given.  ``fn`` must be importable
    by the children (a module-level function)."""
    import torch.multiprocessing as mp

    dev = rank_device(0, n, device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"NCCL carries CUDA tensors only, not {dev}")
    if backend == "nccl" and n > 1 and device is not None and torch.device(device).index is not None:
        raise ValueError(f"NCCL needs one GPU per rank: {n} ranks on {device} need backend='gloo'")
    with tempfile.TemporaryDirectory(prefix="bokego_dp_") as tmp:
        init_method = init_method or f"file://{os.path.join(tmp, 'rendezvous')}"
        mp.start_processes(
            _run, args=(fn, n, device, backend, init_method, args), nprocs=n, join=True, start_method="spawn"
        )
