"""Spans and counters over the program's functions, found by name.

A hook is named ``"module:attr"`` or ``"module:Class.attr"``; installing
it replaces that attribute with a wrapper, so every caller that looks the
function up through its module or class at call time passes through it.
The program's files are not edited.  A name that no longer resolves is
reported as missing and left alone: the metrics that need it read nothing.

The wrapper counts calls and batch rows (the first argument with a
``shape``) into the current :class:`Segment`.  Its mode decides the rest:
``"count"`` adds nothing else, ``"time"`` brackets the call with device
synchronisations and host clock reads (a span), ``"annotate"`` opens a
``torch.profiler.record_function`` of the function's name.
"""

from __future__ import annotations

import collections
import contextlib
import importlib
import time

import torch


class Segment:
    """What the hooks saw over one stretch of a run."""

    def __init__(self, name: str):
        self.name = name
        self.units = 0  # moves or genmoves played in the segment
        self.seconds = 0.0  # host-clock length of the segment
        self.calls = collections.Counter()
        self.rows = collections.Counter()
        self.span_s = collections.Counter()  # total time in spans of a hook
        self.top_s = collections.Counter()  # time in spans opened with no span open
        self.inside_s = collections.Counter()  # (outer, inner) -> inner's time within outer
        self.trace = None  # a trace.Summary when the segment was profiled


def resolve(spec: str):
    """``(owner, attr)`` that ``spec`` names, or ``None``."""
    mod_name, _, path = spec.partition(":")
    try:
        owner = importlib.import_module(mod_name)
    except ImportError:
        return None
    *outer, attr = path.split(".")
    for part in outer:
        owner = getattr(owner, part, None)
        if owner is None:
            return None
    return (owner, attr) if callable(getattr(owner, attr, None)) else None


def _rows(args) -> int:
    for a in args:
        shape = getattr(a, "shape", None)
        if shape is not None and len(shape) > 0:
            return int(shape[0])
    return 0


class Hooks:
    """Installed wrappers over a set of named functions."""

    def __init__(self, specs, sync):
        self.sync = sync
        self.mode = "count"
        self.segment = Segment("none")
        self.missing = set()
        self._stack: list[str] = []
        self._saved = []
        for spec in sorted(set(specs)):
            where = resolve(spec)
            if where is None:
                self.missing.add(spec)
                continue
            owner, attr = where
            fn = owner.__dict__[attr] if attr in getattr(owner, "__dict__", {}) else getattr(owner, attr)
            self._saved.append((owner, attr, fn))
            setattr(owner, attr, self._wrap(spec, fn))

    def _wrap(self, spec: str, fn):
        label = spec.rpartition(":")[2]

        def wrapped(*args, **kwargs):
            seg = self.segment
            seg.calls[spec] += 1
            seg.rows[spec] += _rows(args)
            if self.mode == "annotate":
                with torch.profiler.record_function(label):
                    return fn(*args, **kwargs)
            if self.mode != "time":
                return fn(*args, **kwargs)
            top = not self._stack
            self.sync()
            t0 = time.perf_counter()
            self._stack.append(spec)
            try:
                return fn(*args, **kwargs)
            finally:
                self.sync()
                dt = time.perf_counter() - t0
                self._stack.pop()
                seg.span_s[spec] += dt
                if top:
                    seg.top_s[spec] += dt
                for outer in set(self._stack):
                    seg.inside_s[(outer, spec)] += dt

        return wrapped

    @contextlib.contextmanager
    def segment_of(self, segment: Segment, mode: str):
        """Route the hooks into ``segment`` in ``mode`` while open."""
        self.segment, self.mode = segment, mode
        try:
            yield segment
        finally:
            self.segment, self.mode = Segment("none"), "count"

    def remove(self):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved = []
