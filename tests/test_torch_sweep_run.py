"""The port's sweep engine (``repro_torch.sweep.run_sweep``, the cache and
``--jobs``) on CPU meshes, against the reference's where the two capture
the same program.

One cold sweep of every config on 4x2 and 2x2x2 with two algorithms runs
once per test process; a warm sweep over its cache must capture nothing,
and a cold sweep on four threads must give the same reports, in the same
order, with the same exports.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from repro import sweep as ref_sweep
from repro_torch import scale, sweep
from repro_torch.core import export
from repro_torch.core.report_cache import ReportCache, cache_key
from torch_fixtures import mesh_4x2

CONFIGS = ["paper", "gnmt", "resnet", "serve"]
MESHES = ["4x2", "2x2x2"]
ALGORITHMS = ["ring", "hierarchical"]

# each cell's calls and payload bytes by kind on a CPU mesh (ring):
# (config, mesh) -> {kind: (calls, payload bytes)}.  The paper applications
# issue plain collectives (no DTensor): their all-reduces are the 1 MiB
# buckets plus the loss average, GNMT's all-gathers its startup broadcast
# and metrics gather, on the replica group (data, or pod x data).  The
# serve cell is DTensor's plan on a CPU mesh (all-gather + chunk where a
# cuda mesh issues all-to-alls; ROADMAP queue 3 items 6 and 9).
CELL_TABLE = {
    ("paper", "4x2"): {"all-reduce": (4, 4202504)},
    ("paper", "2x2x2"): {"all-reduce": (4, 4202504)},
    ("gnmt", "4x2"): {"all-gather": (17, 13271168),
                      "all-reduce": (8, 13271040)},
    ("gnmt", "2x2x2"): {"all-gather": (17, 13271168),
                        "all-reduce": (8, 13271040)},
    ("resnet", "4x2"): {"all-reduce": (17, 89746728)},
    ("resnet", "2x2x2"): {"all-reduce": (17, 89746728)},
    ("serve", "4x2"): {"all-gather": (90, 2168960),
                       "all-reduce": (26, 313344),
                       "reduce-scatter": (18, 65536)},
    ("serve", "2x2x2"): {"all-gather": (90, 2638912),
                         "all-reduce": (26, 156672),
                         "reduce-scatter": (6, 24576)},
}

_RUNS: dict = {}


def _sweep(tag: str, tmp_root: Path, jobs: int = 1, use_cache=True):
    """One sweep of every cell into the cache ``tmp_root/<tag>`` (memoized
    per tag for the test process)."""
    if tag not in _RUNS:
        mesh_4x2()
        logs: list = []
        res = sweep.run_sweep(
            CONFIGS, MESHES, ALGORITHMS,
            cache=ReportCache(str(tmp_root / tag.split("+")[0])),
            use_cache=use_cache, jobs=jobs, device="cpu", log=logs.append)
        _RUNS[tag] = res, logs
    return _RUNS[tag]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("sweeps")


def _table(rep) -> dict:
    return {k: (r["calls"], r["payload_bytes"])
            for k, r in rep.compiled_summary.items()}


def test_cold_sweep_captures_each_cell_once(root):
    res, logs = _sweep("a", root)
    assert not res.failures
    assert res.captures == len(CONFIGS) * len(MESHES) and res.cache_hits == 0
    assert [(r.meta["config"], r.meta["mesh"], r.algorithm)
            for r in res.reports] == [(c, m, a) for c in CONFIGS
                                      for m in MESHES for a in ALGORITHMS]
    assert [r.meta["source"] for r in res.reports] == \
        ["captured", "derived"] * len(CONFIGS) * len(MESHES)
    assert sum("[sweep] capture " in line for line in logs) == 8
    got = {(r.meta["config"], r.meta["mesh"]): _table(r)
           for r in res.reports if r.algorithm == "ring"}
    assert got == CELL_TABLE


def test_serve_cell_is_two_phases_with_counted_cost(root):
    res, _ = _sweep("a", root)
    rep = next(r for r in res.reports if r.meta["config"] == "serve")
    assert rep.phase_names() == ["prefill", "decode"]
    assert set(rep.cost) == {"flops", "bytes accessed"}
    assert rep.cost["flops"] > 0


@pytest.mark.parametrize("name,spec", [("paper", "4x2"), ("paper", "2x2x2"),
                                       ("gnmt", "4x2"), ("resnet", "4x2")])
def test_paper_cells_issue_what_the_reference_traces(name, spec, root):
    """The application-issued (traced) collectives of each paper cell equal
    the reference's traced events of the same cell; GNMT's scanned step
    traces its all-reduces once, the port's loop issues them every step."""
    res, _ = _sweep("a", root)
    rep = next(r for r in res.reports if r.meta["config"] == name
               and r.meta["mesh"] == spec and r.algorithm == "ring")
    rmesh = ref_sweep.build_mesh(spec)
    ref = ref_sweep._monitor_cell(
        ref_sweep.available_configs()[name].build(rmesh), rmesh, name,
        "ring")
    want = {k: (r["calls"], r["payload_bytes"])
            for k, r in ref.traced_summary.items()}
    if name == "gnmt":
        calls, nbytes = want["AllReduce"]
        want["AllReduce"] = (4 * calls, 4 * nbytes)
    assert {k: (r["calls"], r["payload_bytes"])
            for k, r in rep.traced_summary.items()} == want


def test_warm_sweep_is_all_cache_hits(root):
    cold, _ = _sweep("a", root)
    warm, logs = _sweep("a+warm", root)
    assert warm.captures == 0
    assert warm.cache_hits == len(cold.reports) == 16
    assert sum("[cache] hit" in line for line in logs) == 16
    assert all(r.meta["source"] == "cache" for r in warm.reports)
    for a, b in zip(cold.reports, warm.reports):
        assert (a.name, a.algorithm, a.meta["config"], a.meta["mesh"]) == \
            (b.name, b.algorithm, b.meta["config"], b.meta["mesh"])
        assert a.compiled_summary == b.compiled_summary
        assert np.array_equal(a.matrix, b.matrix)
        assert a.cost == b.cost
        for ph in a.phase_names():
            assert a.view(phase=ph).summary == b.view(phase=ph).summary


def _exports(res, out: Path) -> dict:
    return export.export_comparison(res.reports, str(out), stem="sweep")


def _untimed(path: str):
    """A JSON export (comparison document, timeline) without its capture
    wall-clock seconds, the one thing two runs cannot share."""
    def strip(x):
        if isinstance(x, dict):
            return {k: strip(v) for k, v in x.items()
                    if k != "trace_seconds"}
        if isinstance(x, list):
            return [strip(v) for v in x]
        return x
    return strip(json.loads(Path(path).read_text()))


def test_jobs_4_equals_jobs_1(root):
    """Four threads, a cold cache of their own: the same reports in the
    same order, CSV and HTML byte for byte, the JSON document and the
    timeline (which embeds each report) equal but for the capture
    wall-clock seconds."""
    one, _ = _sweep("a", root)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)          # switch threads often
    try:
        four, _ = _sweep("b", root, jobs=4)
    finally:
        sys.setswitchinterval(interval)
    assert four.captures == one.captures and not four.failures
    a, b = _exports(one, root / "x1"), _exports(four, root / "x4")
    for fmt in ("csv", "html"):
        assert Path(a[fmt]).read_bytes() == Path(b[fmt]).read_bytes(), fmt
    for fmt in ("json", "perfetto"):
        assert _untimed(a[fmt]) == _untimed(b[fmt]), fmt
    for x, y in zip(one.reports, four.reports):
        assert [f.to_dict() for f in x.lint()] == \
            [f.to_dict() for f in y.lint()]
        assert x.cost == y.cost


def test_sibling_entry_derives_without_capture(tmp_path):
    mesh_4x2()
    cache = ReportCache(str(tmp_path))
    first = sweep.run_sweep(["paper"], ["4x2"], ["ring"], cache=cache,
                            device="cpu", log=lambda m: None)
    assert first.captures == 1
    logs: list = []
    res = sweep.run_sweep(["paper"], ["4x2"], ["tree"], cache=cache,
                          device="cpu", log=logs.append)
    assert (res.captures, res.cache_hits) == (0, 0)
    assert any("sibling hit" in line for line in logs)
    (rep,) = res.reports
    assert rep.algorithm == "tree" and rep.meta["source"] == "derived"
    assert rep.compiled_summary == first.reports[0].view("tree").summary
    key = cache_key("paper/v2:d=256,bucket=1,pod-dp", "4x2:data,model",
                    "tree", device="cpu")
    assert cache.get(key).algorithm == "tree"
    # the device is in the key: a cuda sweep finds none of these entries
    assert cache.get(cache_key("paper/v2:d=256,bucket=1,pod-dp",
                               "4x2:data,model", "ring",
                               device="cuda")) is None


def test_failed_cell_is_reported_and_the_rest_finish(tmp_path):
    mesh_4x2()
    res = sweep.run_sweep(["paper"], ["4x2", "16"], ["ring"],
                          cache=ReportCache(str(tmp_path)), device="cpu",
                          log=lambda m: None)
    assert [r.meta["mesh"] for r in res.reports] == ["4x2"]
    assert [f["mesh"] for f in res.failures] == ["16"]
    assert "16-rank mesh" in res.failures[0]["error"]


def test_usage_errors():
    with pytest.raises(KeyError, match="unknown config"):
        sweep.run_sweep(["nope"], device="cpu")
    with pytest.raises(ValueError):
        sweep.run_sweep(["paper"], algorithms=["bogus"], device="cpu")
    assert sweep.resolve_jobs("3") == 3 and sweep.resolve_jobs(0) == 1
    assert sweep.resolve_jobs("auto") >= 1
    with pytest.raises(ValueError):
        sweep.resolve_jobs("many")


def test_summary_table_columns(root):
    res, _ = _sweep("a", root)
    plain = res.summary_table().splitlines()
    assert plain[0].split(" | ")[0].strip() == "config"
    assert len(plain) == 2 + len(res.reports)
    full = res.summary_table(by_link=True, by_phase=True, lint=True)
    header = [h.strip() for h in full.splitlines()[0].split("|")]
    assert header == ["config", "mesh", "algorithm", "phase", "devices",
                      "collective calls", "wire bytes", "collective ms",
                      "dominant primitive", "busiest link", "link ms",
                      "overlap ms", "lint findings", "lint savings ms",
                      "source"]
    # one row a phase: serve's two phases on every binding
    assert len(full.splitlines()) == 2 + len(res.reports) + 4


def test_scale_curve_runs_over_the_sweep(root):
    mesh_4x2()
    res, points = sweep.run_scale_curve(
        ["serve"], ["4x2"], ["ring"], device_counts=[256, 1024],
        cache=ReportCache(str(root / "a")), device="cpu", log=lambda m: None)
    assert res.captures == 0 and res.cache_hits == 1
    want = scale.scale_curve(res.reports, (256, 1024))
    strip = lambda p: {k: v for k, v in p.row().items() if k != "build_ms"}
    assert [strip(p) for p in points] == [strip(p) for p in want]


def test_monitor_cell_takes_captures_and_op_transform():
    """A builder's ``op_transform`` reaches every capture (an entry's own
    wins), and ``captures`` become the session's phases in order -- the
    reference's ``_monitor_cell`` contract (``moe-skew`` injects its
    per-rank byte vectors this way)."""
    import dataclasses

    import torch
    from torch.distributed._functional_collectives import all_reduce

    mesh = mesh_4x2()
    group = mesh.get_group("data")

    def step(x):
        return all_reduce(x, "sum", group)

    def tag(name):
        return lambda op: dataclasses.replace(op, op_name=name)

    def build(m):
        x = torch.empty(4, 8)
        return {"op_transform": tag("built"), "captures": [
            {"phase": "one", "fn": step, "args": (x,)},
            {"phase": "two", "name": "second", "fn": step, "args": (x,),
             "op_transform": tag("own")}]}

    rep = sweep._monitor_cell(build, mesh, "cell")
    assert rep.phase_names() == ["one", "two"]
    assert [(op.phase, op.op_name) for op in rep.compiled_ops] == \
        [("one", "built"), ("two", "own")]
    single = sweep._monitor_cell(
        lambda m: {"fn": step, "args": (torch.empty(4, 8),),
                   "op_transform": tag("single")}, mesh, "cell")
    assert [(op.phase, op.op_name) for op in single.compiled_ops] == \
        [("main", "single")]
