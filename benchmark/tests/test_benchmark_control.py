"""The control on the card: the program run with TF32 on, the precision
below the configurations' float32, must come out not correct, and the
sound run at the same size correct.  A size a test run holds: B=64, 16
rollouts, 3 s; the cell's own size is measured by ``run.py --control
tf32`` (``PERF.md``)."""

from __future__ import annotations

import pytest

from benchmark.tests.conftest import CELLS, SEED, last_line, run_cli

SMALL = ["--batch", "64", "--rollouts", "16", "--seconds", "3"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_tf32_control_fails_and_the_sound_run_passes(cell, cuda_device):
    for control, expect in (("tf32", False), (None, True)):
        args = ["--workload", cell, "--seed", str(SEED), *SMALL] + (["--control", control] if control else [])
        rc, out, err = run_cli(args)
        assert rc == 0, err[-3000:]
        line = last_line(out)
        assert line["correct"] is expect, line["check"]
        if control:
            assert line["check"]["prob_gap"]["value"] > line["check"]["prob_gap"]["limit"]
