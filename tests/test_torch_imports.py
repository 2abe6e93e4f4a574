"""The port stands alone: nothing under ``src/repro_torch/``, in
``chip_smoke.py`` or in ``tools/`` imports JAX or the reference package
``repro``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            names.append(str(node.args[0].value))
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_or_reference_import(path):
    bad = [n for n in _imported_modules(path)
           if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_serve_entry_point_loads_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = ("import sys, repro_torch.launch.serve, repro_torch.weights; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   cwd=ROOT, timeout=120)


def test_paper_entry_point_loads_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = ("import sys, repro_torch.launch.paper, repro_torch.sweep; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   cwd=ROOT, timeout=120)


def test_scale_and_sparse_load_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = ("import sys, repro_torch.scale, repro_torch.core.sparse; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   cwd=ROOT, timeout=120)


def test_lint_and_trace_load_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = ("import sys, repro_torch.core.lint, repro_torch.core.defuse, "
            "repro_torch.core.trace, repro_torch.core.export.perfetto; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   cwd=ROOT, timeout=120)


@pytest.mark.parametrize("modules", [
    "repro_torch.core.op_cost, repro_torch.core.roofline",
    "repro_torch.core.report_cache, repro_torch.core.export.csv_exporter, "
    "repro_torch.core.export.html_exporter, "
    "repro_torch.core.export.json_exporter",
    "repro_torch.cli, repro_torch.__main__",
])
def test_front_end_loads_without_jax(modules):
    """The roofline, the exporters, the report cache, the sweep engine and
    the command line, each imported alone in a fresh interpreter."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = (f"import sys, {modules}; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   cwd=ROOT, timeout=120)


def test_train_entry_point_loads_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = ("import sys, repro_torch.launch.train, repro_torch.checkpoint, "
            "repro_torch.optim; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   cwd=ROOT, timeout=120)
