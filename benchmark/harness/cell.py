"""A cell's files, found by the names in ``BENCHMARK.json``.

``configs/<config>.json`` holds a configuration, ``traffic/<mix>.json`` a
traffic mix, ``metrics/<metric>.py`` a per-layer metric's reader and
``entries/<entry>.py`` the driver of a kind of traffic (its class
``Entry``), all under the benchmark's directory.  A configuration names its
entry (``"entry"``), and a mix the entry it is for (``"kind"``).  A cell
reports the end-to-end metrics whose ``workloads`` name it (or that have no
``workloads``), and the per-layer metrics chosen the same way.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
_SAFE = re.compile(r"[^A-Za-z0-9_]")
_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    reader: object = None  # the module of a per-layer metric


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    end_to_end: list[Metric]
    per_layer: list[Metric]
    entry: type = None  # the class ``Entry`` of ``entries/<entry>.py``


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _module(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of the benchmark (names may hold dots)."""
    if not _NAME.fullmatch(name):
        raise ValueError(f"not a name: {name!r}")
    path = BENCH_DIR / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{_SAFE.sub('_', name)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_metric_reader(name: str):
    return _module("metrics", name)


def load_entry(name: str) -> type:
    return _module("entries", name).Entry


def load(workload: str) -> Cell:
    """The cell ``workload`` of ``BENCHMARK.json`` with its files; raises
    ``KeyError`` for a cell that the file does not name."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[workload]
    config = json.loads((BENCH_DIR / "configs" / f"{w['config']}.json").read_text())
    traffic = json.loads((BENCH_DIR / "traffic" / f"{w['traffic']}.json").read_text())
    if traffic["kind"] != config["entry"]:
        raise ValueError(f"traffic {w['traffic']!r} is for {traffic['kind']!r}, not {config['entry']!r}")
    e2e = [Metric(m["name"], m["unit"]) for m in bench["end_to_end"] if _applies(m, workload)]
    per_layer = []
    for m in bench["per_layer"]:
        if m.get("moves") in {x.name for x in e2e} and _applies(m, workload):
            per_layer.append(Metric(m["name"], m["unit"], load_metric_reader(m["name"])))
    return Cell(
        name=workload,
        chips=int(w["chips"]),
        config_name=w["config"],
        traffic_name=w["traffic"],
        config=config,
        traffic=traffic,
        end_to_end=e2e,
        per_layer=per_layer,
        entry=load_entry(config["entry"]),
    )
