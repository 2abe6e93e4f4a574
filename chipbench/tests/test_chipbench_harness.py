"""The harness on the CPU at a small size: the result line's shape, the
correctness check passing a sound run and failing each planted fault,
and the control failing its limits."""
from __future__ import annotations

import json
import math

import pytest

from chipbench import faults, harness

from .conftest import SEED, TINY_LIMITS


@pytest.mark.parametrize("cell", ["tiny.train", "tiny.serve"])
def test_result_line_shape(tiny_runs, cell):
    r = tiny_runs[cell]
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "checks"
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert json.loads(json.dumps(r)) == r
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    assert set(r["checks"]) == set(TINY_LIMITS[cell])
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("cell,metrics", [
    ("tiny.train", {"setup_s", "train_tokens_per_s"}),
    ("tiny.serve", {"setup_s", "serve_tokens_per_s", "ttft_ms_p95"})])
def test_end_to_end_metrics_of_a_cell(tiny_runs, cell, metrics):
    assert set(tiny_runs[cell]["metrics"]) == metrics


@pytest.mark.parametrize("cell", ["tiny.train", "tiny.serve"])
def test_sound_run_is_correct(tiny_runs, cell):
    r = tiny_runs[cell]
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("cell", ["tiny.train", "tiny.serve"])
def test_control_fails_a_limit(tiny_runs, cell):
    """The reference in FP8, put in the program's place, fails at least
    one of the cell's numbers."""
    r = tiny_runs[cell]
    ctrl = r["control_numbers"]
    assert any(ctrl[k] > lim for k, lim in TINY_LIMITS[cell].items()), ctrl
    assert r["control_correct"] is False


@pytest.mark.parametrize("cell,fault", [("tiny.train", f)
                                        for f in faults.TRAIN]
                         + [("tiny.serve", f) for f in faults.SERVE])
def test_planted_fault_is_not_correct(tiny_root, cell, fault):
    with faults.planted(fault):
        r = harness.run_cell(cell, SEED + 1, 0.3, False, root=tiny_root,
                             device="cpu")
    assert not r["correct"], r["checks"]


def test_traced_run_on_cpu_reads_no_device_metric(tiny_root):
    """Without a device trace the device readers stay silent, and never
    read 0."""
    r = harness.run_cell("tiny.serve", SEED + 2, 0.3, True, root=tiny_root,
                         device="cpu")
    assert "idle_share.serve" not in r["metrics"]
    assert "kernel_roofline.serve" not in r["metrics"]
    assert r["metrics"]["mfu.serve"]["value"] > 0
    assert r["metrics"]["tpot_ms_p95"]["value"] > 0
    assert r["device"]["busy_s"] == 0.0 and "breakdown" not in r
