"""Finding a cell's parts by name, the shape the benchmark file must
have, and adding a configuration, a traffic mix and a metric by new files
alone."""
from __future__ import annotations

import hashlib
import json
import re
import shutil

import pytest

from chipbench import harness
from chipbench.registry import Registry

from .conftest import ROOT, SEED, add_tiny_cells, copy_benchmark

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
# widths: hidden, intermediate, latent, state and projection sizes, head
# sizes, expansion factors, experts per token, keys ending _dim or _rank
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|proj|head_size|"
                    r"key_size|emb_size|ffn_size|widening|expansion|"
                    r"selected_experts|per_tok|_dim$|_rank$)")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "chipbench/run.py"]
    assert SPEC["paths"] == ["chipbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_keys():
    seen = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("chipbench/")
        assert len(c["reduced"]) <= 16
        assert not any(WIDTHS.search(k) for k in c["reduced"]), c["reduced"]
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in seen
        seen.add(m["name"])
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in e2e
    setup = [m for m in SPEC["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] == 0.25 and "workloads" not in setup[0]


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_finds_its_parts(cell):
    reg = Registry(ROOT)
    w = reg.cell(cell)
    cfg = reg.config(w["config"])
    traffic = reg.traffic(w["traffic"])
    assert reg.loop(traffic["kind"]).Loop
    assert reg.limits(cell)
    e2e = [m["name"] for m in reg.metrics(cell, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = reg.metrics(cell, "per_layer")
    assert per_layer
    for m in reg.metrics(cell, "end_to_end") + per_layer:
        assert callable(reg.reader(m["name"]).read)
    # a per-layer metric moves an end-to-end metric this cell reports
    for m in per_layer:
        assert m["moves"] in e2e
    entry = next(c for c in SPEC["configs"] if c["name"] == w["config"])
    assert cfg["reduced"] == entry["reduced"]
    assert cfg["source"] == entry["source"]
    for key in cfg["reduced"]:
        assert key in cfg and key in cfg["published"]
        assert cfg[key] != cfg["published"][key]


def test_unknown_names_are_refused():
    reg = Registry(ROOT)
    with pytest.raises(KeyError):
        reg.cell("no-such-cell")
    with pytest.raises(KeyError):
        reg.config("no-such-config")
    with pytest.raises(FileNotFoundError):
        reg.reader("no_such_metric")
    with pytest.raises(FileNotFoundError):
        reg.traffic("no-such-mix")


def test_files_are_named_from_name_characters():
    for path in (ROOT / "chipbench").rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def _digests(root):
    return {p.relative_to(root).as_posix():
            hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "chipbench").rglob("*.*"))
            if "__pycache__" not in p.parts}


def test_adding_cells_config_traffic_and_metric_takes_new_files_only(
        tmp_path):
    """On a copy: two configurations, two traffic mixes, two cells, their
    limits and a new per-layer metric, added by new files and new
    ``BENCHMARK.json`` entries; no file the benchmark had is edited, and
    the new cell reports the new metric."""
    root = copy_benchmark(tmp_path)
    before = _digests(root)
    add_tiny_cells(root)
    (root / "chipbench" / "metrics" / "units_in_window.py").write_text(
        "def read(run):\n    return float(len(run.units))\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append(
        {"name": "units_in_window", "unit": "calls", "better": "higher",
         "source": "program_counter", "layer": "serve loop",
         "moves": "serve_tokens_per_s", "workloads": ["tiny.serve"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _digests(root)
    assert all(after[k] == v for k, v in before.items())
    assert len(after) > len(before)
    r = harness.run_cell("tiny.serve", SEED, 0.3, True, root=root,
                         device="cpu")
    assert r["metrics"]["units_in_window"]["value"] >= 1
    assert r["correct"]


def test_lone_benchmark_directory_exits_without_result(tmp_path):
    """A directory holding only BENCHMARK.json and chipbench/ has no port:
    the run exits non-zero and prints nothing on standard output."""
    import subprocess
    import sys
    root = copy_benchmark(tmp_path)
    shutil.rmtree(root / "chipbench" / "tests")
    p = subprocess.run([sys.executable, "chipbench/run.py", "--workload",
                        "grok-1.decode", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=root, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
