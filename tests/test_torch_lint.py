"""The port's lint (``repro_torch.core.lint``) against the reference's.

The four op-stream rules are pure functions of the op stream: the committed
fixtures' ops and the reference tests' hand-built streams (bucketing runs,
pod-spanning rings, DCN permutes, skewed byte vectors) go through both
``lint_ops`` under no topology, one pod and two pods, and every finding's
``to_dict()`` must be equal, floats exact.  A hypothesis property does the
same over random streams.

The three def-use rules walk HLO text in the reference and a capture's
dispatch-recorded def-use graph in the port: each of the reference tests'
six hand-written modules has a torch program of the same structure,
captured on the fake process group, whose findings must equal the
reference's on the HLO (rule, severity, modeled seconds).

The lint section of a saved report cross-loads both ways.
"""
import json
import warnings
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from hypothesis import given, settings
from hypothesis import strategies as st

import test_lint as ref_cases
from repro.core import lint as ref_lint
from repro.core import reporter as ref_reporter
from repro.core.events import CollectiveOp as RefOp
from repro.core.events import Shape as RefShape
from repro.core.export import serialize as ref_ser
from repro.core.topology import MeshTopology as RefTopo
from repro_torch.core import MonitorSession, monitor_fn
from repro_torch.core import lint
from repro_torch.core import reporter
from repro_torch.core.export import serialize as ser
from repro_torch.core.topology import MeshTopology
from torch_fixtures import mesh_4x2

FIXTURES = Path(__file__).parent / "fixtures"
# 8-device meshes: (axis names, sizes); None is no topology
TOPOS = {
    "none": None,
    "flat_8": (("data",), (8,)),
    "1pod_4x2": (("data", "model"), (4, 2)),
    "2pod_2x4": (("pod", "data"), (2, 4)),
    "2pod_2x2x2": (("pod", "data", "model"), (2, 2, 2)),
}
ALGORITHMS = ("ring", "tree", "hierarchical")


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


def _topos(name):
    if TOPOS[name] is None:
        return None, None
    names, sizes = TOPOS[name]
    return (RefTopo(axis_names=names, axis_sizes=sizes),
            MeshTopology(axis_names=names, axis_sizes=sizes))


def _port_ops(ref_ops):
    return [ser.op_from_dict(ref_ser.op_to_dict(op)) for op in ref_ops]


def _dicts(findings):
    return [f.to_dict() for f in findings]


# ---------------------------------------------------------------------------
# the reference tests' op streams, and the fixtures'
# ---------------------------------------------------------------------------
_FIXTURE_OPS: dict = {}


def _fixture_ops(name):
    if name not in _FIXTURE_OPS:
        d = json.loads((FIXTURES / f"{name}_report.json").read_text())
        _FIXTURE_OPS[name] = ref_ser.report_from_dict(d).compiled_ops
    return _FIXTURE_OPS[name]


def _streams():
    ar, permute, a2a = ref_cases._ar, ref_cases._permute, ref_cases._a2a
    skewed = ref_cases._skewed_vec
    return {
        "latency_bound_run": [ar(f"%ar.{i}", dims=(8,)) for i in range(4)],
        "bandwidth_bound_run": [ar(f"%ar.{i}") for i in range(4)],
        "groups_break_run": [ar("%ar.0", dims=(8,), groups=[[0, 1, 2, 3]]),
                             ar("%ar.1", dims=(8,), groups=[[4, 5, 6, 7]])],
        "mixed_run": [ar("%ar.0", dims=(8,)), ar("%ar.1", dims=(16,)),
                      permute([(0, 1)], "%cp.9"), ar("%ar.2", dims=(8,)),
                      ar("%ar.3", dims=(8,), weight=3.0)],
        "pod_spanning_ring": [ar("%ar.0")],
        "packable_permute": [permute([(0, 4), (4, 0), (1, 5), (5, 1)])],
        "unpackable_permute": [permute([(i, (i + 1) % 8)
                                        for i in range(8)])],
        "intra_pod_permute": [permute([(0, 1), (1, 0), (4, 5), (5, 4)])],
        "hot_rank_a2a": [a2a("%a2a.0", vec=skewed(16384.0))],
        "balanced_a2a": [a2a("%a2a.0", vec=[2048.0] * 8)],
        "scalar_a2a": [a2a("%a2a.0")],
        "mild_skew_a2a": [a2a("%a2a.0", vec=[1.5 * 2048.0] + [
            (16384.0 - 1.5 * 2048.0) / 7] * 7)],
        "weighted_skew_a2a": [a2a("%a2a.0", vec=skewed(16384.0),
                                  weight=16.0)],
        "serve_fixture": _fixture_ops("serve"),
        "translation_fixture": _fixture_ops("translation"),
    }


STREAMS = sorted(_streams())


def test_registry_equals_reference():
    """All seven rules, in the reference's order, with its severities and
    titles."""
    assert [(r.rule_id, r.severity, r.title) for r in lint.RULES] == \
        [(r.rule_id, r.severity, r.title) for r in ref_lint.RULES]
    assert lint.SEVERITIES == ref_lint.SEVERITIES
    assert lint._SKEW_THRESHOLD == ref_lint._SKEW_THRESHOLD


@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("topo", sorted(TOPOS))
@pytest.mark.parametrize("stream", STREAMS)
def test_op_stream_rules_equal_reference(stream, topo, algorithm):
    ref_ops = _streams()[stream]
    rtopo, ptopo = _topos(topo)
    want = ref_lint.lint_ops(ref_ops, topo=rtopo, algorithm=algorithm)
    got = lint.lint_ops(_port_ops(ref_ops), topo=ptopo, algorithm=algorithm)
    assert _dicts(got) == _dicts(want)


def test_streams_exercise_every_op_stream_rule():
    """The shared streams are not vacuous: each op-stream rule fires on at
    least one of them in the reference."""
    fired = set()
    for ops in _streams().values():
        for topo in TOPOS:
            fired |= {f.rule_id for f in ref_lint.lint_ops(
                ops, topo=_topos(topo)[0])}
    assert {"small-ar-bucketing", "flat-ring-multipod", "dcn-permute",
            "skewed-a2a"} <= fired


def test_finding_helpers_equal_reference():
    fs = [lint.LintFinding("r", "warn", ["a"], "p", "m", 1.0, 2.0, "f", 3.0),
          lint.LintFinding("r", "error", [], "", "")]
    assert lint.max_severity([]) is None
    assert lint.max_severity(fs) == "error"
    for f in fs:
        assert lint.LintFinding.from_dict(json.loads(
            json.dumps(f.to_dict()))) == f
        assert ref_lint.LintFinding.from_dict(f.to_dict()).to_dict() == \
            f.to_dict()
    assert [lint.severity_rank(s) for s in lint.SEVERITIES] == [0, 1, 2]


# ---------------------------------------------------------------------------
# hypothesis: random op streams through both packages
# ---------------------------------------------------------------------------
_GROUPS = ([[0, 1, 2, 3, 4, 5, 6, 7]], [[0, 1, 2, 3], [4, 5, 6, 7]],
           [[0, 4], [1, 5], [2, 6], [3, 7]], [[0, 1], [2, 3], [4, 5],
                                               [6, 7]])


@st.composite
def _op(draw, i):
    kind = draw(st.sampled_from(("all-reduce", "all-reduce", "all-gather",
                                 "reduce-scatter", "all-to-all",
                                 "collective-permute")))
    elems = draw(st.sampled_from((1, 8, 64, 4096, 262144, 1 << 20)))
    weight = draw(st.sampled_from((1.0, 1.0, 4.0)))
    phase = draw(st.sampled_from(("", "fwd", "bwd")))
    if kind == "collective-permute":
        pairs = draw(st.lists(st.tuples(st.integers(0, 7),
                                        st.integers(0, 7)),
                              min_size=1, max_size=6))
        return RefOp(kind=kind, name=f"%op.{i}",
                     result_shapes=[RefShape("f32", (elems,))],
                     replica_groups=[], source_target_pairs=pairs,
                     weight=weight, phase=phase)
    groups = draw(st.sampled_from(_GROUPS))
    vec = None
    if kind == "all-to-all" and draw(st.booleans()):
        n = len(groups[0])
        vec = [float(draw(st.integers(0, 4096))) for _ in range(n)]
    return RefOp(kind=kind, name=f"%op.{i}",
                 result_shapes=[RefShape(draw(st.sampled_from(
                     ("f32", "bf16"))), (elems,))],
                 replica_groups=[list(g) for g in groups], weight=weight,
                 phase=phase, bytes_per_rank_vec=vec)


@st.composite
def _stream(draw):
    n = draw(st.integers(1, 8))
    return [draw(_op(i)) for i in range(n)]


@settings(max_examples=60, deadline=None)
@given(ops=_stream(), topo=st.sampled_from(sorted(TOPOS)),
       algorithm=st.sampled_from(ALGORITHMS))
def test_random_streams_equal_reference(ops, topo, algorithm):
    rtopo, ptopo = _topos(topo)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = ref_lint.lint_ops(ops, topo=rtopo, algorithm=algorithm)
        got = lint.lint_ops(_port_ops(ops), topo=ptopo, algorithm=algorithm)
    assert _dicts(got) == _dicts(want)
    for f in got:
        assert 0.0 <= f.est_savings_s <= f.est_current_s
        assert f.est_dcn_bytes_saved >= 0.0
    ranks = [-lint.severity_rank(f.severity) for f in got]
    assert ranks == sorted(ranks)          # errors first


# ---------------------------------------------------------------------------
# the def-use rules: the reference's HLO cases as torch programs
# ---------------------------------------------------------------------------
def _world():
    mesh_4x2()
    return dist.group.WORLD


def _ag_slice(x):
    return funcol.all_gather_tensor(x, 0, _world())[0:16]


def _ag_used(x):
    return -funcol.all_gather_tensor(x, 0, _world())


def _dup(x):
    return (funcol.all_reduce(x, "sum", _world()),
            funcol.all_reduce(x, "sum", _world()))


def _no_dup(x, y):
    return (funcol.all_reduce(x, "sum", _world()),
            funcol.all_reduce(y, "sum", _world()))


def _dtype(x):
    return funcol.all_reduce(x.float(), "sum", _world()).bfloat16()


def _dtype_ok(x):
    return -funcol.all_reduce(x, "sum", _world())


F32, BF16 = torch.float32, torch.bfloat16
# reference HLO case -> (torch program, its inputs, the rule it is about,
# whether that rule fires)
DEFUSE_CASES = {
    "HLO_AG_SLICE": (_ag_slice, [((128, 64), F32)], "allgather-then-slice",
                     True),
    "HLO_AG_USED": (_ag_used, [((128, 64), F32)], "allgather-then-slice",
                    False),
    "HLO_DUP": (_dup, [((64,), F32)], "redundant-collective", True),
    "HLO_NO_DUP": (_no_dup, [((64,), F32), ((64,), F32)],
                   "redundant-collective", False),
    "HLO_DTYPE": (_dtype, [((4096,), BF16)], "wire-dtype-waste", True),
    "HLO_DTYPE_OK": (_dtype_ok, [((4096,), F32)], "wire-dtype-waste",
                     False),
}


def _capture(fn, inputs):
    sess = MonitorSession(mesh=mesh_4x2(), name="case")
    with sess.fake_mode:
        xs = [torch.empty(shape, dtype=dt) for shape, dt in inputs]
    sess.capture(fn, *xs)
    return sess.report()


def _priced(findings):
    return [(f.rule_id, f.severity, f.est_savings_s, f.est_current_s,
             f.est_dcn_bytes_saved) for f in findings]


@pytest.mark.parametrize("topo", ["none", "flat_8", "2pod_2x4"])
@pytest.mark.parametrize("case", sorted(DEFUSE_CASES))
def test_defuse_rules_equal_reference_on_hlo(case, topo):
    fn, inputs, rule, fires = DEFUSE_CASES[case]
    rep = _capture(fn, inputs)
    ref_ops, texts = ref_cases._hlo_case(getattr(ref_cases, case))
    rtopo, ptopo = _topos(topo)
    want = ref_lint.lint_ops(ref_ops, topo=rtopo, hlo_texts=texts)
    got = lint.lint_ops(rep.compiled_ops, topo=ptopo,
                        graphs=rep._defuse_graphs)
    assert _priced(got) == _priced(want)
    assert any(f.rule_id == rule for f in got) == fires


@pytest.mark.parametrize("case", sorted(DEFUSE_CASES))
def test_monitor_fn_lint_has_defuse_findings(case):
    """``monitor_fn`` is a one-capture session: its report's lint runs the
    def-use rules too, as the reference's ``monitor_fn(...).lint()`` does."""
    fn, inputs, rule, fires = DEFUSE_CASES[case]
    mesh = mesh_4x2()
    sess = MonitorSession(mesh=mesh)
    with sess.fake_mode:
        xs = [torch.empty(shape, dtype=dt) for shape, dt in inputs]
    rep = monitor_fn(fn, *xs, mesh=mesh, name=case)
    assert len(rep._defuse_graphs) == 1
    assert _priced(rep.lint()) == _priced(_capture(fn, inputs).lint())
    assert any(f.rule_id == rule for f in rep.lint()) == fires


def test_inplace_write_makes_a_new_value():
    """Two in-place all-reduces of one tensor are not redundant: the first
    writes the tensor, so the second reads another value (the record is SSA,
    as the reference's HLO)."""
    def twice(x):
        dist.all_reduce(x, group=_world())
        dist.all_reduce(x, group=_world())
        return x

    def write_between(x, y):
        a = funcol.all_reduce(x, "sum", _world())
        x.add_(y)
        b = funcol.all_reduce(x, "sum", _world())
        return a, b

    for fn, inputs in ((twice, [((64,), F32)]),
                       (write_between, [((64,), F32), ((64,), F32)])):
        rep = _capture(fn, inputs)
        assert len(rep.compiled_ops) == 2
        assert not [f for f in rep.lint() if f.rule_id ==
                    "redundant-collective"]


def test_dropped_parts_and_regroups():
    """A gather kept in full through split + cat (``all_gather_tensor`` on
    dim 1) is a layout change, not a slice; a gather of which one chunk is
    kept is flagged, priced on the kept bytes only."""
    def gather_dim1(x):
        return funcol.all_gather_tensor(x, 1, _world()) * 2

    def keep_one_chunk(x):
        return torch.chunk(funcol.all_gather_tensor(x, 0, _world()), 8)[3]

    rep = _capture(gather_dim1, [((16, 4), F32)])
    assert not rep.lint()
    rep = _capture(keep_one_chunk, [((16, 4), F32)])
    (f,) = rep.lint()
    assert f.rule_id == "allgather-then-slice"
    assert f"keeping {16 * 4 * 4} B" in f.message


def test_phase_view_lints_only_its_ops():
    sess = MonitorSession(mesh=mesh_4x2(), name="two")
    with sess.fake_mode:
        x = torch.empty(64)
    fn = DEFUSE_CASES["HLO_DUP"][0]
    with sess.phase("a"):
        sess.capture(fn, x)
    with sess.phase("b"):
        sess.capture(_dtype_ok, x)
    # the two captures' op names coincide (all_reduce.0): a graph finds its
    # own capture's ops, never the other phase's
    assert [f.phase for f in sess.view(phase="a").lint()
            if f.rule_id == "redundant-collective"] == ["a"]
    assert not [f for f in sess.view(phase="b").lint()
                if f.rule_id == "redundant-collective"]
    rep = sess.report()
    assert rep.view().lint() is rep.view().lint()            # memoized
    assert _dicts(rep.lint()) == _dicts(sess.view().lint())


# ---------------------------------------------------------------------------
# the lint section: schema v7, both ways
# ---------------------------------------------------------------------------
def _lint_report():
    """The DUP case on a 2-pod topology: an error and a warning."""
    rep = _capture(*DEFUSE_CASES["HLO_DUP"][:2])
    rep.topo = MeshTopology(axis_names=("pod", "data"), axis_sizes=(2, 4))
    rep._views = {}
    return rep


def test_lint_section_port_to_reference(tmp_path):
    rep = _lint_report()
    findings = rep.lint()
    assert {f.rule_id for f in findings} >= {"redundant-collective",
                                             "flat-ring-multipod"}
    p = tmp_path / "r.json"
    rep.save(str(p), include_lint=True)
    d = json.loads(p.read_text())
    assert d["lint"] == _dicts(findings)
    back = ref_ser.report_from_dict(d)
    assert _dicts(back.lint()) == _dicts(findings)
    # the port's own load serves them too, without the graphs
    mine = ser.report_from_dict(d)
    assert not getattr(mine, "_defuse_graphs", None)
    assert _dicts(mine.lint()) == _dicts(findings)
    assert mine.lint_table() == rep.lint_table()
    rep.save(str(p))
    assert "lint" not in json.loads(p.read_text())


@pytest.mark.parametrize("fixture", ["serve", "translation"])
def test_lint_section_reference_to_port(fixture, tmp_path):
    d = json.loads((FIXTURES / f"{fixture}_report.json").read_text())
    # the committed file's own section (the reference's findings on its
    # capture, def-use rules included) loads into the port as is
    assert "lint" in d
    assert _dicts(ser.report_from_dict(d).lint()) == \
        _dicts(ref_ser.report_from_dict(d).lint()) == d["lint"]
    # re-bound to two pods without the section, both packages find the
    # same; the reference's file of those findings loads into the port
    d = {k: v for k, v in d.items() if k != "lint"}
    ref = ref_ser.report_from_dict(d)
    ref.topo = RefTopo(axis_names=("pod", "data", "model"),
                       axis_sizes=(2, 2, 2))
    fresh = ser.report_from_dict(d)
    fresh.topo = MeshTopology(axis_names=("pod", "data", "model"),
                              axis_sizes=(2, 2, 2))
    want = _dicts(ref.lint())
    assert _dicts(fresh.lint()) == want
    assert want or fixture == "serve"      # serve stays clean on 2 pods
    p = tmp_path / "r.json"
    ref.save(str(p), include_lint=True)
    port = ser.report_from_dict(json.loads(p.read_text()))
    assert _dicts(port.lint()) == want
    assert reporter.lint_table(port.lint(), title="t") == \
        ref_reporter.lint_table(ref.lint(), title="t")
    assert reporter.lint_table([]) == ref_reporter.lint_table([])
