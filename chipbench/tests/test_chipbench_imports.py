"""What the harness loads: no module whose top-level name is ``jax``,
``jaxlib``, ``flax``, ``repro`` (the JAX package, whose name the port's
``repro_torch`` begins with) or ``benchmarks``; and the exit codes of a
run that cannot measure."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from chipbench import harness

from .conftest import ROOT


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    assert "repro" not in harness.forbidden_modules() or \
        "repro" in {m.split(".")[0] for m in sys.modules}
    monkeypatch.setitem(sys.modules, "jax", sys)
    monkeypatch.setitem(sys.modules, "repro.models", sys)
    found = harness.forbidden_modules()
    assert "jax" in found and "repro" in found


def test_run_loads_neither_jax_nor_the_jax_package(tiny_root):
    """A whole tiny run in a fresh interpreter, then its modules."""
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from chipbench import harness\n"
        f"r = harness.run_cell('tiny.serve', 5, 0.2, False, "
        f"root={str(tiny_root)!r}, device='cpu')\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    top = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def test_no_card_exits_without_result():
    """Where no CUDA device is visible, run.py exits 3 and prints no
    result line."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    p = subprocess.run([sys.executable, "chipbench/run.py", "--workload",
                        "grok-1.decode", "--seed", "3", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 3 and p.stdout == ""


def test_jax_package_loaded_after_the_window_exits_4(tiny_root, tmp_path):
    """A metric reader, loaded after the window closes, that imports a
    module whose top-level name is ``repro``: ``run.py`` exits 4, names
    it on standard error and prints no result line."""
    root = tmp_path / "bench"
    shutil.copytree(tiny_root, root)
    (root / "stub" / "repro").mkdir(parents=True)
    (root / "stub" / "repro" / "__init__.py").write_text("")
    (root / "chipbench" / "metrics" / "leaky.py").write_text(
        "import sys\n"
        f"sys.path.insert(0, {str(root / 'stub')!r})\n"
        "import repro  # noqa: F401\n\n\n"
        "def read(run):\n    return 1.0\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["end_to_end"].append(
        {"name": "leaky", "unit": "s", "better": "lower", "bound": 0.25,
         "source": "host_clock", "workloads": ["tiny.serve"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    code = (
        "import argparse, sys\n"
        f"sys.path[:0] = [{str(root)!r}, {str(ROOT / 'src')!r}]\n"
        "from chipbench import run\n"
        "args = argparse.Namespace(workload='tiny.serve', seed=5, "
        "seconds=0.2, trace=0)\n"
        "sys.exit(run.measure(args, device='cpu'))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=root)
    assert p.returncode == 4, p.stderr[-2000:]
    assert p.stdout == ""
    assert "repro" in p.stderr.strip().splitlines()[-1]
