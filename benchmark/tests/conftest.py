"""Test helpers for the benchmark's harness: runs of a cell on the CPU at a
tiny size, in a subprocess or in this process."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SEED = 3000000019  # above 2**31, as the check's seeds are
TINY = ["--device", "cpu", "--batch", "4", "--rollouts", "8", "--seconds", "2"]
CELLS = ("selfplay-b1024.newgames", "gtp-r100.game")


def run_cli(args, cwd=ROOT, env=None):
    """``python benchmark/run.py ARGS`` from ``cwd``: (exit code, stdout, stderr)."""
    e = dict(os.environ, OMP_NUM_THREADS="2")
    e.pop("PYTHONPATH", None)
    e.update(env or {})
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", *args], cwd=cwd, env=e, capture_output=True, text=True, timeout=300
    )
    return p.returncode, p.stdout, p.stderr


def last_line(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])


def run_here(capsys, args) -> tuple[int, dict | None]:
    """The harness in this process (for faults planted with monkeypatch)."""
    from benchmark import run

    rc = run.main(list(args))
    out = capsys.readouterr().out
    return rc, (last_line(out) if out.strip() else None)


@pytest.fixture
def bench_copy(tmp_path):
    """A checkout in ``tmp_path``: copies of ``BENCHMARK.json`` and
    ``benchmark/``, links to the program and its weights."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    for name in ("bokego_tpu_torch", "data"):
        os.symlink(ROOT / name, tmp_path / name)
    return tmp_path


@pytest.fixture
def cuda_device():
    """Skips a test where there is no CUDA device."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
