"""Phase timers, throughput counters and profiler hooks (counterpart of
``bokego_tpu/utils/metrics.py``).

``Counter`` and ``Metrics`` are host-side and behave as in the JAX package.
What touches the device follows torch: ``Metrics.phase(block_on=...)``
synchronises the CUDA devices of the tensors it is given before it reads
the clock, :func:`device_trace` records a ``torch.profiler`` trace, and
:func:`annotate` opens an NVTX range on a machine with a GPU and is a no-op
context without one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from collections import defaultdict

import torch


@dataclasses.dataclass
class Counter:
    total: float = 0.0
    count: int = 0

    def add(self, dt: float, n: int = 1):
        self.total += dt
        self.count += n

    @property
    def rate(self) -> float:
        """events / second."""
        return self.count / self.total if self.total > 0 else 0.0

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


def _tensors(tree):
    """The tensors of a nest of tensors, dataclasses, dicts and sequences."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def block_until_ready(tree) -> None:
    """Wait for the device work behind every CUDA tensor of ``tree`` (torch
    queues kernels and returns; CPU tensors are ready when a call returns)."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)


class Metrics:
    """Named phase timers and throughput counters.

    Usage::

        m = Metrics()
        with m.phase("rollout", n=batch, block_on=trees):
            trees = step(...)
        print(m.report())
    """

    def __init__(self):
        self.phases: dict[str, Counter] = defaultdict(Counter)
        self.counters: dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def phase(self, name: str, n: int = 1, block_on=None):
        """Time a phase; ``n`` = units of work (rollouts, games, ...).

        Pass ``block_on`` (a tensor, or a nest of tensors such as a ``Tree``
        that the phase updates in place) to include the device time:
        without it only the enqueue is timed.
        """
        t0 = time.monotonic()
        yield
        if block_on is not None:
            block_until_ready(block_on)
        self.phases[name].add(time.monotonic() - t0, n)

    def count(self, name: str, n: float = 1):
        self.counters[name] += n

    def rollouts_per_sec(self, phase: str = "rollout") -> float:
        return self.phases[phase].rate

    def games_per_min(self, phase: str = "game") -> float:
        return self.phases[phase].rate * 60.0

    def report(self) -> str:
        lines = []
        for name, c in sorted(self.phases.items()):
            lines.append(
                f"{name}: {c.count} in {c.total:.2f}s "
                f"({c.rate:.1f}/s, {c.mean * 1000:.2f} ms each)"
            )
        for name, v in sorted(self.counters.items()):
            lines.append(f"{name}: {v:g}")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Record a ``torch.profiler`` trace of the block (host, and the GPU
    where there is one) and write it as ``log_dir/trace.json`` (Chrome trace
    format: Perfetto and ``chrome://tracing`` read it)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named region inside a trace: an NVTX range where there is a GPU, a
    no-op context otherwise."""
    if torch.cuda.is_available():
        return torch.cuda.nvtx.range(name)
    return contextlib.nullcontext()
