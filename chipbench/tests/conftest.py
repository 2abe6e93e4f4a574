"""Shared fixtures of the benchmark's CPU tests.

    PYTHONPATH=src python -m pytest -q chipbench/tests

Tests marked ``chip`` need a CUDA device and skip without one (decided
inside a fixture, never at import).  ``tiny_root`` is a copy of the
benchmark with two small cells added by new files alone: ``tiny.train``
(a 2-layer dense model) and ``tiny.serve`` (a 2-layer MoE), each with its
configuration, traffic and limits files and its entries in the copy's
``BENCHMARK.json``.
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
        "head_dim": 16, "d_ff": 128, "vocab_size": 512}
# set from CPU readings of the tiny cells over eight to ten seeds, the
# program's largest against the control's least: loss gap 1.6e-4 /
# 9.7e-4, gradient 1.4e-3 / 4.3e-3, change 7.2e-4 / 2.1e-3; served tokens'
# mean gap without the widest 1% 1e-4 / 5.6e-3, share more than 0.05
# below the best 0.0078 / 0.051
TINY_LIMITS = {"tiny.train": {"loss_gap": 4e-4, "grad_gap": 2.5e-3,
                              "change_gap": 1.2e-3},
               "tiny.serve": {"gap_mean_trim1": 0.002,
                              "share_over_0.05": 0.025}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA device (skips without one)")


@pytest.fixture
def chip():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark runs on the H100")


def add_tiny_cells(root: Path) -> None:
    """Add the two small cells to the benchmark at ``root`` by new files
    and new ``BENCHMARK.json`` entries only."""
    bench = root / "chipbench"
    spec = json.loads((root / "BENCHMARK.json").read_text())
    for name, src, extra in (
            ("tiny-dense", "granite-3-2b", {}),
            ("tiny-moe", "grok-1", {"n_experts": 4, "top_k": 2})):
        cfg = json.loads((bench / "configs" / f"{src}.json").read_text())
        cfg["name"] = name
        cfg["run"].update(TINY, **extra)
        (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        spec["configs"].append({"name": name, "source": cfg["source"],
                                "file": f"chipbench/configs/{name}.json",
                                "reduced": [], "why": "CPU test size"})
    (bench / "traffic" / "train-tiny.json").write_text(json.dumps(
        {"kind": "train", "global_batch": 4, "seq_len": 32,
         "microbatches": 2, "reference_steps": 3,
         "reference_rows": 2}))
    (bench / "traffic" / "serve-tiny.json").write_text(json.dumps(
        {"kind": "serve", "batch": 8, "prompt_len": 16, "new_tokens": 8,
         "sample_calls": 4, "reference_tokens": 512}))
    spec["workloads"] += [
        {"name": "tiny.train", "config": "tiny-dense",
         "traffic": "train-tiny", "chips": 1, "why": "CPU test size"},
        {"name": "tiny.serve", "config": "tiny-moe",
         "traffic": "serve-tiny", "chips": 1, "why": "CPU test size"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            kind = "train" if any(w.endswith(".train")
                                  for w in m["workloads"]) else "serve"
            m["workloads"].append(f"tiny.{kind}")
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    for cell, lim in TINY_LIMITS.items():
        (bench / "limits" / f"{cell}.json").write_text(
            json.dumps({"limits": lim}))


def copy_benchmark(dst: Path) -> Path:
    """``BENCHMARK.json`` and ``chipbench/`` copied to ``dst``."""
    shutil.copytree(ROOT / "chipbench", dst / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    root = copy_benchmark(tmp_path_factory.mktemp("bench"))
    add_tiny_cells(root)
    return root


SEED = 987654321987   # more than 32 signed bits hold


@pytest.fixture(scope="session")
def tiny_runs(tiny_root):
    """One CPU run of each tiny cell, the control read too."""
    from chipbench import harness
    return {w: harness.run_cell(w, SEED, 0.5, False, root=tiny_root,
                                device="cpu", control=True)
            for w in ("tiny.train", "tiny.serve")}
