"""Phase timers, throughput counters and profiler hooks (counterpart of
``bokego_tpu/utils/metrics.py``).

``Counter`` and ``Metrics`` are host-side and behave as in the JAX package.
What touches the device follows torch: ``Metrics.phase(block_on=...)``
synchronises the CUDA devices of the tensors it is given before it reads
the clock, and :func:`device_trace` records a ``torch.profiler`` trace.

The program's own tracing: :func:`span` and :func:`count`, placed at the
layer boundaries of the search, the rules, the features, the nets and the
GTP engine, record into the :class:`Recorder` that :func:`enable` (or the
block :func:`recording`) turns on.  Off (the default), a span is one shared
no-op context and a count one global test.  On, a span records its name,
host start and end (``time.perf_counter_ns``), its enclosing span and its
request; each name's count, total and self time are folded from those
records when the recorder is read.  While ``torch.profiler`` records, a
span also opens ``torch.profiler.record_function(name)``, so that it is a
``user_annotation`` event on the trace's own clock beside the kernels.  No
span synchronises: device time comes from the trace.  Each ``sync.<site>``
span wraps exactly one host read of a device value, so its count is that
site's host synchronisations and its time the host's wait there.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from collections import defaultdict

import torch
import torch.autograd.profiler as _autograd_profiler


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


NEXT = object()  # span(request=NEXT): number the span as the recorder's next request


class Recorder(Metrics):
    """What the program's spans and counts recorded while it was on.

    ``spans`` lists every span as ``[name, start_ns, end_ns, parent,
    request]``, ``parent`` the list index of the enclosing span (-1 at the
    top); ``counters`` holds the counts.  Folded from the spans when the
    recorder is turned off or read (:meth:`snapshot`): ``phases[name]``,
    each name's count and total seconds, and ``self_s[name]``, its total
    less the time its child spans took.  A span does no more than append
    and close its record, so that the on path stays cheap."""

    def __init__(self):
        super().__init__()
        self.spans: list[list] = []
        self.self_s: dict[str, float] = defaultdict(float)
        self._open: list[_Span] = []  # the open spans, outermost first
        self._frames: list[_Span] = []  # one reusable span per depth
        self._requests = 0

    def fold(self):
        """Count, total and self time of each span name, over closed spans."""
        children = [0] * len(self.spans)
        for _, start, end, parent, _ in self.spans:
            if end and parent >= 0:
                children[parent] += end - start
        self.phases.clear()
        self.self_s.clear()
        for (name, start, end, _, _), inner in zip(self.spans, children):
            if end:
                self.phases[name].add((end - start) * 1e-9)
                self.self_s[name] += (end - start - inner) * 1e-9

    def snapshot(self) -> dict:
        """Each span name's ``count``, ``total_s`` and ``self_s``, and the
        counters, as plain data."""
        self.fold()
        return {
            "spans": {
                name: {"count": c.count, "total_s": c.total, "self_s": self.self_s[name]}
                for name, c in self.phases.items()
            },
            "counters": dict(self.counters),
        }


class _Span:
    """The span open at one depth; spans nest, so one object per depth
    serves every span opened there (entered as soon as it is made)."""

    __slots__ = ("rec", "name", "request", "index", "annotation")

    def __init__(self, rec: Recorder):
        self.rec = rec

    def __enter__(self):
        rec = self.rec
        parent = rec._open[-1] if rec._open else None
        if self.request is NEXT:
            self.request = rec._requests
            rec._requests += 1
        elif self.request is None and parent is not None:
            self.request = parent.request
        self.index = len(rec.spans)
        self.annotation = None
        # torch.profiler's own flag: a module global, cheaper than asking
        # the profiler through torch.autograd._profiler_enabled()
        if _autograd_profiler._is_profiler_enabled:
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        rec._open.append(self)
        rec.spans.append([self.name, time.perf_counter_ns(), 0, -1 if parent is None else parent.index, self.request])
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        rec = self.rec
        rec._open.pop()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        rec.spans[self.index][2] = end
        return False


_OFF = contextlib.nullcontext()
_recorder: Recorder | None = None  # where spans are recorded
_counting: Recorder | None = None  # the recorder on, whose counters take the counts


def span(name: str, request=None):
    """A context that records ``name`` as a span while a recorder is on,
    and the shared no-op context otherwise.  ``request`` identifies the
    request the span serves (``NEXT``: a new number); without one the span
    takes its enclosing span's."""
    rec = _recorder
    if rec is None:
        return _OFF
    depth = len(rec._open)
    if depth == len(rec._frames):
        rec._frames.append(_Span(rec))
    frame = rec._frames[depth]
    frame.name, frame.request = name, request
    return frame


def count(name: str, n: float = 1):
    """Add ``n`` to the counter ``name`` while a recorder is on."""
    rec = _counting
    if rec is not None:
        rec.counters[name] += n


def enable(spans: bool = True) -> Recorder:
    """Turn recording on into a fresh :class:`Recorder`, its counts and with
    ``spans`` its spans (without, a timed run carries no span's cost);
    returns it."""
    global _recorder, _counting
    _counting = Recorder()
    _recorder = _counting if spans else None
    return _counting


def disable() -> Recorder | None:
    """Turn recording off; returns the recorder that was on, folded."""
    global _recorder, _counting
    rec, _recorder, _counting = _counting, None, None
    if rec is not None:
        rec.fold()
    return rec


@contextlib.contextmanager
def recording(spans: bool = True):
    """Record the block's counts, and with ``spans`` its spans, into a fresh
    recorder that it yields; without ``spans`` span recording stays as it
    was.  On exit, also on an error, the recording that was on before is
    back, the block's counts added to its own."""
    global _recorder, _counting
    before = _recorder, _counting
    rec = Recorder()
    _counting = rec
    if spans:
        _recorder = rec
    try:
        yield rec
    finally:
        _recorder, _counting = before
        rec.fold()
        if _counting is not None:
            for name, n in rec.counters.items():
                _counting.counters[name] += n
