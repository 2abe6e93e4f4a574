"""On the card: one short run of each cell through ``chipbench/run.py``,
and, through ``chipbench/readings.py``, the control and each planted
fault a cell can have, at the cell's own size.

    python -m pytest -q -m chip chipbench/tests/test_chipbench_chip.py

They skip without a CUDA device (decided in the ``chip`` fixture).
"""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from chipbench import faults

from .conftest import ROOT

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


def run_json(*args) -> dict:
    return json.loads(_run(*args).strip().splitlines()[-1])


def run_lines(*args) -> list:
    """The JSON lines of one ``chipbench/readings.py`` process."""
    out = _run("chipbench/readings.py", *args)
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def _run(*args) -> str:
    p = subprocess.run([sys.executable, *args], cwd=ROOT,
                       capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    return p.stdout


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(chip, cell):
    r = run_json("chipbench/run.py", "--workload", cell, "--seed",
                 "2147483659", "--seconds", "5", "--trace", "0")
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["failed"] == 0


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(chip, cell):
    """The reference in FP8 in the program's place, judged by the
    harness's own comparison against the cell's limits, is not correct."""
    r = run_lines("--workload", cell, "--seeds", "2147483671",
                  "--control-seeds", "2147483671", "--seconds", "2")[0]
    assert r["control_correct"] is False, (r["control"], r["checks"])


FAULT_CELLS = {"granite-3-2b.train": (faults.TRAIN, "2"),
               "grok-1.decode": (faults.SERVE, "2"),
               "grok-1.prefill": (faults.SERVE, "8")}
_planted: dict = {}


def planted_runs(cell) -> dict:
    """One process a cell: a run with each of its faults planted, at the
    cell's own size (the prefill's window holds the 16 calls it
    follows)."""
    if cell not in _planted:
        names, seconds = FAULT_CELLS[cell]
        lines = run_lines("--workload", cell, "--seeds", "2147483693",
                          "--faults", ",".join(names), "--seconds", seconds)
        _planted[cell] = {r["fault"]: r for r in lines}
    return _planted[cell]


@pytest.mark.chip
@pytest.mark.parametrize("cell,fault", [
    (c, f) for c, (names, _) in FAULT_CELLS.items() for f in names])
def test_planted_fault_fails_on_the_card(chip, cell, fault):
    r = planted_runs(cell)[fault]
    assert not r["correct"], r["checks"]
