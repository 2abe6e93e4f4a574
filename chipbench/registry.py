"""Finding a cell's parts by name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration
and traffic mix and lists the metrics.  Everything else sits in files of
its own, found by name, so that a later change adds a configuration, a
traffic mix, a metric or a kind of traffic by adding files:

* ``chipbench/configs/<config>.json`` (the entry's ``file``): the sizes
  as run, under ``run``, beside the source's own keys;
* ``chipbench/traffic/<traffic>.json``: the mix's parameters, its
  ``kind`` naming its loop ``chipbench/loops/<kind>.py``;
* ``chipbench/metrics/<metric>.py``: a ``read(run)`` for each metric;
* ``chipbench/limits/<cell>.json``: the numbers the correctness check
  compares and their limits.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


class Registry:
    def __init__(self, root: Path | None = None):
        self.root = Path(root) if root else HERE.parent
        self.bench_dir = self.root / "chipbench"
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in self.spec['workloads']]}")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads(
            (self.bench_dir / "traffic" / f"{name}.json").read_text())

    def limits(self, cell: str) -> dict:
        path = self.bench_dir / "limits" / f"{cell}.json"
        return json.loads(path.read_text())["limits"] if path.is_file() \
            else {}

    def metrics(self, cell: str, section: str) -> list:
        """The entries of ``end_to_end`` or ``per_layer`` this cell
        reports: those without ``workloads``, and those that name it."""
        return [m for m in self.spec[section]
                if "workloads" not in m or cell in m["workloads"]]

    def reader(self, metric: str):
        return _load(self.bench_dir / "metrics" / f"{metric}.py",
                     f"chipbench_metric_{metric}")

    def loop(self, kind: str):
        return _load(self.bench_dir / "loops" / f"{kind}.py",
                     f"chipbench_loop_{kind}")


def _load(path: Path, modname: str):
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(
        modname.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
