"""The device's side of a traced segment, from ``torch.profiler``.

The segment runs under the profiler (CPU and CUDA activities); its Chrome
trace is read once and deleted.  Device activity is every kernel, copy and
memset: ``busy_s`` is the union of their intervals, ``window_s`` the
segment's host-clock length.  Each kernel is tied to the host operator that
launched it through the trace's ``External id``.  An idle gap of the device
is put down to what the host was doing when it began: the innermost
annotation open then (the hooks' ``record_function`` names), else the
innermost host operator, else ``host``.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10
NAME_CHARS = 120


@dataclasses.dataclass
class Summary:
    busy_s: float
    window_s: float
    kernel_s: dict  # kernel name -> device seconds
    op_kernel_s: dict  # launching host operator -> its kernels' device seconds
    gaps: list  # [(what the host did, idle seconds)], longest first

    def kernels_matching(self, word: str) -> float:
        return sum(s for name, s in self.kernel_s.items() if word in name)

    def ops_matching(self, word: str) -> float:
        return sum(s for name, s in self.op_kernel_s.items() if word in name)

    def breakdown(self) -> dict:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:TOP]
        return {
            "device_ops": [[name[:NAME_CHARS], s] for name, s in ops],
            "idle_gaps": [[name[:NAME_CHARS], s] for name, s in self.gaps[:TOP]],
        }


def _union(intervals):
    """Merged ``[start, end]`` intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost_at(events, times):
    """For each of the sorted ``times``, the name of the innermost of
    ``events`` (``(start, end, name)``, nested as host calls are) open then,
    or ``None``: a sweep with a stack of open events."""
    events = sorted(events, key=lambda e: (e[0], -e[1]))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(events) and events[i][0] <= t:
            while stack and stack[-1][1] <= events[i][0]:
                stack.pop()
            stack.append(events[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def summarize(trace: dict, window_s: float) -> Summary:
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    ops = {}
    annotations, host_ops = [], []
    for e in events:
        cat = e.get("cat", "")
        span = (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e.get("name", "?"))
        if cat == "cpu_op":
            ext = e.get("args", {}).get("External id")
            if ext is not None:
                ops[ext] = e.get("name", "?")
            host_ops.append(span)
        elif cat == "user_annotation":
            annotations.append(span)
    kernel_s = collections.Counter()
    op_kernel_s = collections.Counter()
    device = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        start, dur = float(e["ts"]), float(e.get("dur", 0.0))
        device.append((start, start + dur))
        kernel_s[e.get("name", "?")] += dur / 1e6
        op = ops.get(e.get("args", {}).get("External id"), "unattributed")
        op_kernel_s[op] += dur / 1e6
    busy = _union(device)
    busy_s = sum(e - s for s, e in busy) / 1e6
    gaps = collections.Counter()
    if busy and host_ops:
        start = min(s for s, _, _ in host_ops)
        edges = [(start, busy[0][0])] + [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
        edges = [(s, e) for s, e in edges if e > s]
        starts = [s for s, _ in edges]
        by_annotation = _innermost_at(annotations, starts)
        by_op = _innermost_at(host_ops, starts)
        for (s, e), ann, op in zip(edges, by_annotation, by_op):
            gaps[ann or op or "host"] += (e - s) / 1e6
    return Summary(
        busy_s=busy_s,
        window_s=window_s,
        kernel_s=dict(kernel_s),
        op_kernel_s=dict(op_kernel_s),
        gaps=sorted(gaps.items(), key=lambda kv: -kv[1]),
    )


def profiled(run, device: torch.device):
    """Run ``run()`` under ``torch.profiler``; returns its trace's
    :class:`Summary` and what ``run()`` returned."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        result = run()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    return summarize(trace, window_s), result
