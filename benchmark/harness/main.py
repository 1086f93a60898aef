"""One run of one cell: set-up, the measured window, the traced segments,
the check, and the result line.

The window runs for ``--seconds`` and ends at the first move or request
boundary after that.  With ``--trace 1`` the window runs with counting
hooks (calls and rows, no synchronisation), then a fresh start runs a
segment under spans (each hooked call bracketed by device
synchronisations) and a segment under ``torch.profiler``; the per-layer
metrics are read from the three.  The check runs after the window and the
segments, once the device's peak memory has been read and the program's
state freed.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from benchmark.harness import cell as cell_mod
from benchmark.harness import check as chk
from benchmark.harness import flops, hooks, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "bokego_tpu")  # compared by whole top-level names


class Run:
    """What an entry needs of the run: the cell, the device, the seed, the
    checkout's paths, the set-up clock."""

    def __init__(self, args, cell: cell_mod.Cell, device: torch.device, t_start: float):
        self.args, self.cell, self.device, self.seed = args, cell, device, args.seed
        self.t_start = t_start
        self.setup = {}
        self._last = t_start

    def path(self, rel: str) -> Path:
        return cell_mod.ROOT / rel

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def mark(self, what: str):
        """Close one part of the set-up, timed since the last mark."""
        self.sync()
        now = time.perf_counter()
        self.setup[what] = now - self._last
        self._last = now


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


class Reading:
    """What a per-layer metric's reader gets: the window's counts, the
    spans' segment and the profiled segment, the nets' FLOPs, the peaks."""

    def __init__(self, window, spans, profile, nets):
        self.window, self.spans, self.profile = window, spans, profile
        self.peak_fp32 = flops.PEAK_FP32_FLOPS
        self.flops_per_row = flops.forward_flops(nets)
        self.conv_flops_per_row = flops.forward_flops(nets, convs_only=True)


def _metric_hooks(metric) -> list[str]:
    return list(getattr(metric.reader, "HOOKS", ()))


def run(args, t_start: float) -> int:
    cell = cell_mod.load(args.workload)
    if args.device is None:
        if not torch.cuda.is_available():
            print("no CUDA device: the benchmark runs only on a GPU", file=sys.stderr)
            return 3
        if torch.cuda.device_count() < cell.chips:
            print(f"{torch.cuda.device_count()} CUDA devices, the cell asks for {cell.chips}", file=sys.stderr)
            return 3
    device = torch.device(args.device or "cuda:0")

    import bokego_tpu_torch
    from bokego_tpu_torch import device as program_device

    where = Path(bokego_tpu_torch.__file__).absolute()
    if cell_mod.ROOT not in where.parents:
        print(f"the program was imported from {where}, outside the checkout {cell_mod.ROOT}", file=sys.stderr)
        return 4
    if device.type == "cuda":
        torch.cuda.init()
        torch.zeros(1, device=device)
    setup_run = Run(args, cell, device, t_start)
    setup_run.mark("import_and_context")
    program_device.fp32_only()  # the configurations state fp32 with TF32 off
    if args.control == "tf32":
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
    if device.type == "cuda":
        from bokego_tpu_torch.ops import build

        build.build_all()
        setup_run.mark("nvcc")

    entry = cell.entry(setup_run)
    entry.warm_up()
    setup_run.mark("warm_up")
    setup_s = time.perf_counter() - t_start

    specs = [s for m in cell.per_layer for s in _metric_hooks(m)] if args.trace else []
    hk = hooks.Hooks(specs, setup_run.sync) if args.trace else None
    window = hooks.Segment("window")
    entry.start_window()
    if hk:
        with hk.segment_of(window, "count"):
            window.units, window.seconds = entry.play(seconds=args.seconds)
    else:
        window.units, window.seconds = entry.play(seconds=args.seconds)
    e2e = entry.end_to_end(window.units, window.seconds)
    attempted, failed = entry.attempted_failed()
    spans = profile = None
    if hk:
        traffic = cell.traffic
        spans = hooks.Segment("spans")
        entry.segment_start()
        with hk.segment_of(spans, "time"):
            spans.units, spans.seconds = entry.play(units=traffic["span_units"])
        profile = hooks.Segment("profile")
        entry.segment_start()
        with hk.segment_of(profile, "annotate"):
            profile.trace, (profile.units, profile.seconds) = trace.profiled(
                lambda: entry.play(units=traffic["profile_units"]), device
            )
        hk.remove()

    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    entry.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
    for m in cell.end_to_end:
        if m.name in e2e:
            metrics[m.name] = {"value": e2e[m.name], "unit": m.unit}
    missing = []
    if args.trace:
        metrics = {}
        reading = Reading(window, spans, profile, cell.config["nets"])
        for m in cell.per_layer:
            value = None
            if not (set(_metric_hooks(m)) & hk.missing):
                value = m.reader.read(reading)
            if value is None:
                missing.append(m.name)
            else:
                metrics[m.name] = {"value": value, "unit": m.unit}

    c = chk.Check()
    t_check = time.perf_counter()
    entry.check(c)
    check_s = time.perf_counter() - t_check

    line = {
        "correct": c.ok,
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else "cpu",
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": 1,
            "memory_peak_bytes": memory_peak,
        },
    }
    if args.trace:
        line["device"]["busy_s"] = profile.trace.busy_s
        line["device"]["window_s"] = profile.trace.window_s
        line["breakdown"] = profile.trace.breakdown()
        line["missing"] = missing
    line["setup_split"] = setup_run.setup
    line["check_s"] = check_s
    if args.control:
        line["control"] = args.control
    line["check"] = c.line()

    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 5
    print(f"card: {power_line() if device.type == 'cuda' else 'cpu'}; peak fp32 {flops.PEAK_FP32_FLOPS:.3g} FLOP/s", file=sys.stderr)
    print("setup split (s): " + json.dumps(setup_run.setup), file=sys.stderr)
    c.print()
    print(json.dumps(line), flush=True)
    return 0
