"""The port's trace ingestion (``repro_torch.core.trace``) and Perfetto
exporter against the reference's, and its ``torch.profiler`` frontend.

The reference's own cases (``tests/test_trace.py``, ``tests/test_compare.py``)
run through both packages on the same files: normalization, every JSONL /
nvprof / Perfetto case, the malformed inputs (both raise
``TraceParseError`` with the same message, naming the same line, row or
event) and sniffing.  The committed fixtures import into equal ops, bitwise
equal matrices and equal ``compare`` results; the port's Perfetto export
re-imports bitwise in both packages.

The torch frontend reads a trace made here by a world-size-1 gloo group in
a subprocess (the fake process group of the test worker stays untouched),
and hand-written Chrome traces of what NCCL records on the card: a linked
``ncclDevKernel_*``, a device-side annotation, ``record_param_comms``.
"""
import importlib
import json
import os
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol

from repro.core import CommReport as RefReport
from repro.core import trace as ref_trace
from repro.core.export import perfetto as ref_perfetto
from repro.core.export import serialize as ref_ser
from repro.core.trace import normalize as ref_norm
from repro_torch.core import CommReport, MonitorSession
from repro_torch.core import trace
from repro_torch.core.export import perfetto
from repro_torch.core.export import serialize as ser
from repro_torch.core.trace import normalize as norm
from torch_fixtures import mesh_4x2

# the packages export the ``compare`` function under the submodule's name
ref_compare = importlib.import_module("repro.core.trace.compare")
cmp = importlib.import_module("repro_torch.core.trace.compare")

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures"
SERVE_CSV = str(FIXTURES / "serve_trace.csv")
SERVE_REPORT = str(FIXTURES / "serve_report.json")
TRANSLATION_TRACE = str(FIXTURES / "translation_trace.json")
TRANSLATION_REPORT = str(FIXTURES / "translation_report.json")


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def _import_dict(imp):
    return {
        "name": imp.name, "num_devices": imp.num_devices,
        "ops": [ser.op_to_dict(op) for op in imp.ops],
        "host_transfers": [ser.transfer_to_dict(t)
                           for t in imp.host_transfers],
        "topo": ser.topo_to_dict(imp.topo), "algorithm": imp.algorithm,
        "phases": [ser.phase_to_dict(p) for p in imp.phases],
        "sparse": imp.sparse, "meta": imp.meta,
    }


def _both(path, **opts):
    """Both packages' imports of ``path``, which must be equal."""
    ref = ref_trace.load_trace(path, **opts)
    got = trace.load_trace(path, **opts)
    assert _import_dict(got) == _import_dict(ref)
    return got


def _both_raise(path, match, **opts):
    """Both packages refuse ``path`` with the same message."""
    with pytest.raises(ref_trace.TraceParseError, match=match) as want:
        ref_trace.load_trace(path, **opts)
    with pytest.raises(trace.TraceParseError, match=match) as got:
        trace.load_trace(path, **opts)
    assert str(got.value) == str(want.value)
    assert (got.value.path, got.value.record) == \
        (want.value.path, want.value.record)
    return str(got.value)


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("raw,kind", [
    ("ncclAllReduceRingLLKernel_sum_f32(...)", "all-reduce"),
    ("all-reduce.17", "all-reduce"),
    ("psum", "all-reduce"),
    ("CrossReplicaSum", "all-reduce"),
    ("ncclAllGatherRingLLKernel_f32", "all-gather"),
    ("reduce-scatter.2", "reduce-scatter"),
    ("ragged-all-to-all.1", "ragged-all-to-all"),
    ("all-to-all.9", "all-to-all"),
    ("collective-permute.3", "collective-permute"),
    ("ppermute", "collective-permute"),
    ("ncclBroadcastRingLLKernel_f32", "collective-broadcast"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "all-reduce"),
    ("_c10d_functional::all_gather_into_tensor", "all-gather"),
    ("fusion.123", None),
    ("gemm_kernel", None),
])
def test_collective_kind(raw, kind):
    assert norm.collective_kind(raw) == ref_norm.collective_kind(raw) == kind
    assert norm._KIND_ALIASES == ref_norm._KIND_ALIASES


@pytest.mark.parametrize("label,dev", [
    ("Tesla V100-SXM2-16GB (3)", 3), ("/device:TPU:5", 5), ("GPU 2", 2),
    ("gpu7", 7), ("4", 4), (6, 6), ("NVIDIA H100 80GB HBM3 (1)", 1),
])
def test_device_map_parses_labels(label, dev):
    assert norm.DeviceMap(8).resolve(label) == \
        ref_norm.DeviceMap(8).resolve(label) == dev


@pytest.mark.parametrize("mapping,label,match", [
    (None, "GPU 7", "out of range"),
    (None, "mystery accelerator", "cannot map device"),
    (None, True, "bad device id"),
])
def test_device_map_errors_equal_reference(mapping, label, match):
    with pytest.raises(ref_trace.TraceParseError, match=match) as want:
        ref_norm.DeviceMap(4, mapping).resolve(label, record="row 3")
    with pytest.raises(trace.TraceParseError, match=match) as got:
        norm.DeviceMap(4, mapping).resolve(label, record="row 3")
    assert str(got.value) == str(want.value)


def test_device_map_explicit_mapping_and_clocks():
    dm = norm.DeviceMap(8, {"mystery accelerator": 5})
    assert dm.resolve("mystery accelerator") == 5 and dm.seen == {5}
    ts = {0: [10.0, 12.0], 1: [3.0, 20.0]}
    for mode in ("global", "per-device"):
        assert norm.align_clocks(ts, mode) == ref_norm.align_clocks(ts, mode)
    assert norm.align_clocks(ts, "global") == {0: 3.0, 1: 3.0}
    with pytest.raises(ValueError, match="clock-align"):
        norm.align_clocks(ts, "sideways")


@pytest.mark.parametrize("kind", [
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-broadcast", "ragged-all-to-all", "collective-permute"])
def test_measured_op_payload_roundtrips_exactly(kind):
    for payload in (1, 7, 4096, 1 << 20, (1 << 20) + 3):
        kw = dict(payload_bytes=payload, groups=[[0, 1, 2, 3]],
                  measured_s=1e-3, name="x", weight=2.0, phase="p")
        op = norm.measured_op(kind, **kw)
        assert op.payload_bytes == payload, (kind, payload)
        assert op.measured_s == 1e-3
        assert ser.op_to_dict(op) == \
            ref_ser.op_to_dict(ref_norm.measured_op(kind, **kw))


# ---------------------------------------------------------------------------
# the reference's frontend cases, through both packages
# ---------------------------------------------------------------------------
def _jsonl(tmp_path, records):
    return _write(tmp_path, "t.jsonl",
                  "\n".join(r if isinstance(r, str) else json.dumps(r)
                            for r in records))


def test_jsonl_parse_equal(tmp_path):
    path = _jsonl(tmp_path, [
        {"trace": {"name": "run1", "num_devices": 4, "time_unit": "us"}},
        {"kind": "all-reduce", "device": 0, "ts": 0, "dur": 250.0,
         "bytes": 4096, "corr": 7, "phase": "fwd"},
        {"kind": "all-reduce", "device": 1, "ts": 0, "dur": 300.0,
         "bytes": 4096, "corr": 7, "phase": "fwd"},
        {"kind": "all-gather", "name": "ag.1", "device": 0, "ts": 400,
         "dur": 100.0, "bytes": 1024, "group": [0, 1, 2, 3]},
        {"kind": "ppermute", "dur": 5.0, "bytes": 64, "group": [0, 1, 2]},
        {"kind": "h2d", "device": 2, "bytes": 512},
    ])
    assert trace.sniff_format(path) == "jsonl"
    imp = _both(path)
    assert [op.kind for op in imp.ops] == ["all-reduce", "all-gather",
                                           "collective-permute"]
    assert imp.ops[0].replica_groups == [[0, 1]]
    rep = imp.report()
    assert rep.matrix.sum() > 0
    assert rep.measured_seconds() == pytest.approx(300e-6 + 100e-6 + 5e-6)


@pytest.mark.parametrize("records,match", [
    (['{"kind": "all-reduce", "dur": 1.0, "bytes": 4096}',
      '{"kind": "all-gather", "dur": 0.5, "by'], "line 2"),
    ([{"trace": {"num_devices": 4}},
      {"kind": "all-reduce", "device": 9, "dur": 1.0, "bytes": 64}],
     "line 2"),
    ([{"kind": "all-reduce", "device": 0, "ts": -5.0, "dur": 1.0,
       "bytes": 64}], "line 1"),
    ([{"kind": "all-reduce", "dur": -1.0, "bytes": 64}],
     "'dur' is negative"),
    ([{"kind": "all-reduce", "device": 0, "ts": 0.0, "dur": 10.0,
       "bytes": 64},
      {"kind": "all-gather", "device": 0, "ts": 5.0, "dur": 10.0,
       "bytes": 64}], "overlapping events on device 0"),
    ([{"kind": "all-reduce", "dur": 1.0}], "'bytes'"),
    ([{"kind": "warp-drive", "dur": 1.0, "bytes": 64}],
     "unknown collective"),
    ([{"trace": {"time_unit": "fortnight"}},
      {"kind": "all-reduce", "dur": 1.0, "bytes": 64}], "time_unit"),
    ([{"kind": "all-reduce", "dur": "slow", "bytes": 64}],
     "not a number"),
])
def test_jsonl_malformed_equal(tmp_path, records, match):
    _both_raise(_jsonl(tmp_path, records), match)


_CSV_HEADER = ('"Start","Duration","Size","SrcDev","DstDev","Device",'
               '"Name","Correlation_ID"')


def _csv(tmp_path, rows, units="s,ms,MB,,,,,", header=_CSV_HEADER):
    lines = ["==123== NVPROF is profiling process 123", header]
    if units:
        lines.append(units)
    lines.extend(rows)
    return _write(tmp_path, "t.csv", "\n".join(lines) + "\n")


_DEV = "Tesla V100-SXM2-16GB ({})"


@pytest.mark.parametrize("rows,units,opts", [
    ([f'0.0,2.{r},4.0,,,"{_DEV.format(r)}",'
      f'"ncclAllReduceRingLLKernel_sum_f32(...)",55' for r in range(4)],
     "s,ms,MB,,,,,", {}),
    (['0.0,2.0,4.0,,,"GPU 0","ncclAllGather",9'], "", {"num_devices": 2}),
    ([f'0.0,1.0,2.0,"{_DEV.format(s)}","{_DEV.format(d)}",,'
      f'"[CUDA memcpy PtoP]",77'
      for s, d in ((0, 1), (1, 2), (2, 3), (3, 0))], "s,ms,MB,,,,,", {}),
    (['0.0,0.1,1.0,,,"GPU 0","[CUDA memcpy HtoD]",1',
      '0.2,0.1,2.0,,,"GPU 0","[CUDA memcpy DtoH]",2'], "s,ms,MB,,,,,",
     {"num_devices": 1}),
    (['0.0,9.0,,,,"GPU 0","volta_sgemm_128x64_nn",3',
      '1.0,2.0,4.0,,,"GPU 0","ncclAllReduce",5'], "s,ms,MB,,,,,",
     {"num_devices": 1}),
    (['0.0,2.0,4.0,,,"GPU 0","ncclAllReduce",',
      '0.0,3.0,4.0,,,"GPU 1","ncclAllReduce",'], "s,us,KB,,,,,", {}),
], ids=["clustering", "default_units", "ptop", "host", "compute_skipped",
        "occurrence_clusters"])
def test_nvprof_equal(tmp_path, rows, units, opts):
    path = _csv(tmp_path, rows, units=units)
    assert trace.sniff_format(path) == "nvprof"
    _both(path, **opts)


def test_nvprof_malformed_equal(tmp_path):
    msg = _both_raise(_csv(tmp_path, ['0.0,2.0,"GPU 0","ncclAllReduce",5'],
                           units="s,ms,,,",
                           header='"Start","Duration","Device","Name",'
                                  '"Correlation_ID"'), "no byte column")
    assert "ncclAllReduce" in msg
    _both_raise(_csv(tmp_path, ['0.0,-2.0,4.0,,,"GPU 0","ncclAllReduce",5']),
                "negative duration")
    _both_raise(_write(tmp_path, "b.csv", "==1== banner only\n"),
                "no CSV rows", fmt="nvprof")
    _both_raise(_csv(tmp_path, ['0.0,1.0,2.0,,"GPU 1",,'
                                '"[CUDA memcpy PtoP]",7']),
                "PtoP memcpy without src/dst")
    _both_raise(_csv(tmp_path, ['0.0,1.0,2.0,,,"GPU 9","ncclAllReduce",5']),
                "out of range", num_devices=4)


def _perfetto(tmp_path, events, name="t.json"):
    return _write(tmp_path, name, json.dumps(
        {"traceEvents": events, "displayTimeUnit": "ms"}))


def _procs(n):
    return [{"name": "process_name", "ph": "M", "pid": p, "tid": 0,
             "args": {"name": f"/device:TPU:{p}"}} for p in range(n)]


def test_perfetto_generic_equal(tmp_path):
    evs = _procs(2) + [
        {"name": "all-reduce.1", "ph": "X", "pid": 0, "tid": 1, "ts": 10,
         "dur": 250, "args": {"bytes_accessed": 4096, "device": 0,
                              "group": [0, 1]}},
        {"name": "all-reduce.1", "ph": "X", "pid": 1, "tid": 1, "ts": 12,
         "dur": 260, "args": {"bytes": 4096}},
        {"name": "fusion.7", "ph": "X", "pid": 0, "tid": 1, "ts": 300,
         "dur": 50, "args": {}},
        {"name": "collective-permute.2", "ph": "X", "pid": 0, "tid": 1,
         "ts": 400, "dur": 5, "args": {"size": 64, "phase": "fwd"}},
    ]
    path = _perfetto(tmp_path, evs)
    assert trace.sniff_format(path) == "perfetto"
    imp = _both(path, num_devices=2)
    assert [op.kind for op in imp.ops] == ["all-reduce",
                                           "collective-permute"]
    _both(path, num_devices=2, pid=1)


@pytest.mark.parametrize("text,match,opts", [
    ('{"traceEvents": [{"name": "all-reduce.1", "ph"',
     "truncated or invalid JSON", {"fmt": "perfetto"}),
    (json.dumps({"traceEvents": [{"name": "all-reduce.1", "ph": "X",
                                  "pid": 0, "tid": 0, "ts": 0, "dur": 10,
                                  "args": {}}]}), "no byte annotation", {}),
    (json.dumps({"traceEvents": [{"name": "all-reduce.1", "ph": "X",
                                  "pid": 0, "tid": 0, "ts": -4, "dur": 10,
                                  "args": {"bytes": 64}}]}),
     "negative timestamp", {}),
    (json.dumps({"traceEvents": [{"name": "all-reduce.1", "ph": "X",
                                  "pid": 3, "tid": 0, "ts": 0, "dur": 1,
                                  "args": {"bytes": 64}}]}),
     "pid 9 not in trace", {"pid": 9}),
    (json.dumps({"traceEvents": 7}), "no traceEvents", {}),
    (json.dumps("a string"), "expected a trace object", {"fmt": "perfetto"}),
], ids=["truncated", "no_bytes", "negative_ts", "unknown_pid",
        "no_events", "not_a_trace"])
def test_perfetto_malformed_equal(tmp_path, text, match, opts):
    _both_raise(_write(tmp_path, "t.json", text), match, **opts)


def test_registry():
    assert trace.FORMATS == ("nvprof", "torch", "perfetto", "jsonl")
    assert set(ref_trace.FORMATS) < set(trace.FORMATS)
    assert trace.source_for("torch") is trace.TorchProfilerSource
    with pytest.raises(ValueError, match="valid formats"):
        trace.source_for("vtune")
    with pytest.raises(FileNotFoundError):
        trace.load_trace("/nonexistent/trace.json")


def test_unsniffable_file(tmp_path):
    path = _write(tmp_path, "t.bin", "\x00\x01\x02 not a trace")
    assert trace.sniff_format(path) is ref_trace.sniff_format(path) is None
    with pytest.raises(trace.TraceParseError, match="pass fmt=") as ei:
        trace.load_trace(path)
    assert str(list(trace.FORMATS)) in str(ei.value)


# ---------------------------------------------------------------------------
# the committed fixtures, compare, and the exporter's round trip
# ---------------------------------------------------------------------------
def _assert_reports_equal(got, want):
    assert got.num_devices == want.num_devices
    assert np.array_equal(np.asarray(got.matrix), np.asarray(want.matrix))
    assert set(got.per_primitive) == set(want.per_primitive)
    for kind, mat in want.per_primitive.items():
        assert np.array_equal(np.asarray(got.per_primitive[kind]),
                              np.asarray(mat)), kind


@pytest.mark.parametrize("path", [SERVE_CSV, TRANSLATION_TRACE])
def test_fixture_imports_equal_reference(path):
    imp = _both(path)
    ref = ref_trace.load_trace(path).report()
    rep = imp.report()
    _assert_reports_equal(rep, ref)
    assert rep.compiled_summary == ref.compiled_summary
    assert rep.trace_meta == ref.trace_meta
    assert rep.measured_seconds() == ref.measured_seconds()
    for phase in rep.phase_names():
        assert rep.measured_seconds(phase) == ref.measured_seconds(phase)


def test_translation_fixture_reimports_bitwise():
    imp = trace.load_trace(TRANSLATION_TRACE)
    assert imp.meta["exact_reimport"] is True
    _assert_reports_equal(imp.report(), CommReport.load(TRANSLATION_REPORT))
    assert all(op.measured_s > 0 for op in imp.ops)


def test_compare_serve_gate_equals_reference():
    got = trace.load_trace(SERVE_CSV).report().compare(
        CommReport.load(SERVE_REPORT))
    want = ref_trace.load_trace(SERVE_CSV).report().compare(
        RefReport.load(SERVE_REPORT))
    assert got.to_dict() == want.to_dict()
    assert got.table("t") == want.table("t")
    s = got.stats()
    assert s["unmatched_measured"] == s["unmatched_modeled"] == 0
    assert 0 < s["max_rel_err"] < 0.15


def test_compare_own_model_equals_reference():
    got = trace.load_trace(TRANSLATION_TRACE).report().compare()
    want = ref_trace.load_trace(TRANSLATION_TRACE).report().compare()
    assert got.to_dict() == want.to_dict()
    assert got.max_rel_err() < 1e-3


def _measured(mod, spec, num_devices=8):
    ops = [mod.measured_op(kind, payload_bytes=nbytes,
                           groups=[list(range(num_devices))], name=opname,
                           measured_s=sec, phase=phase)
           for (opname, kind, nbytes, sec, phase) in spec]
    base = trace.base if mod is norm else ref_trace.base
    return base.TraceImport(name="measured", num_devices=num_devices,
                            ops=ops).report()


def _compare_both(spec, model=True):
    got_model = CommReport.load(SERVE_REPORT) if model else None
    want_model = RefReport.load(SERVE_REPORT) if model else None
    try:
        want = ref_compare.compare(_measured(ref_norm, spec), want_model)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            cmp.compare(_measured(norm, spec), got_model)
        assert str(got.value) == str(e)
        return None
    got = cmp.compare(_measured(norm, spec), got_model)
    assert got.to_dict() == want.to_dict()
    return got


def test_compare_matching_equals_reference():
    model = CommReport.load(SERVE_REPORT)
    view = model.view()
    secs = dict(zip([(op.phase, op.name) for op in view.ops],
                    view.op_seconds()))
    picks = [op for op in view.ops if op.kind == "all-reduce"][:2]
    # exact (phase, name) first, listed in reverse
    res = _compare_both([(op.name, op.kind, op.payload_bytes,
                          secs[(op.phase, op.name)] * 1.05, op.phase)
                         for op in reversed(picks)])
    assert {(r.phase, r.name) for r in res.rows} == \
        {(op.phase, op.name) for op in picks}
    # per-kind FIFO, unmatched counts, and the refusals
    a2a = [op for op in view.ops if op.kind == "all-to-all"][:2]
    res = _compare_both([(f"ncclAllToAll.r{j}", "all-to-all",
                          op.payload_bytes, 1e-3, "")
                         for j, op in enumerate(a2a)])
    assert res.unmatched_measured == 0
    res = _compare_both([("x.1", "all-gather", 1024, 1e-3, ""),
                         ("y.1", "all-reduce", 1024, 1e-3, "")])
    assert res.unmatched_measured == 1
    assert _compare_both([("x.1", "all-gather", 1024, 1e-3, "")]) is None
    assert _compare_both([("x.1", "all-gather", 1024, 1e-3, "")],
                         model=False) is None
    with pytest.raises(ValueError, match="no measured ops"):
        cmp.compare(model, model)


@pytest.mark.parametrize("nbytes", [0, 64 * 1024 - 1, 64 * 1024,
                                    (1 << 20) - 1, 1 << 20, (16 << 20) - 1,
                                    16 << 20, 1 << 30])
def test_size_classes_equal_reference(nbytes):
    assert cmp.SIZE_CLASSES == ref_compare.SIZE_CLASSES
    assert cmp.size_class(nbytes) == ref_compare.size_class(nbytes)


def test_row_math_equals_reference():
    spec = [("ar.1", "all-reduce", "fwd", 1024, 1.0e-3, 1.1e-3),
            ("ar.2", "all-reduce", "bwd", 2 << 20, 2.0e-3, 1.9e-3),
            ("ag.1", "all-gather", "fwd", 512, 0.5e-3, 0.5e-3),
            ("a", "all-reduce", "", 1, None, 1.0),
            ("b", "all-reduce", "", 1, 1.0, 0.0)]
    got = cmp.CompareResult(rows=[cmp.CompareRow(*r) for r in spec],
                            measured_label="m", modeled_label="M")
    want = ref_compare.CompareResult(
        rows=[ref_compare.CompareRow(*r) for r in spec],
        measured_label="m", modeled_label="M")
    assert got.to_dict() == want.to_dict()
    assert got.table("hdr") == want.table("hdr")
    assert got.by_size_class() == want.by_size_class()


def _port_capture():
    """A two-phase capture on the fake 4x2 mesh: an all-reduce over
    ``data``, an all-gather over ``model``, an all-to-all over the world."""
    mesh = mesh_4x2()
    sess = MonitorSession(mesh=mesh, name="two-phase")
    with sess.fake_mode:
        x = torch.empty(64, 32)

    def fwd(x):
        y = funcol.all_reduce(x, "sum", mesh.get_group("data"))
        return funcol.all_gather_tensor(y, 0, mesh.get_group("model"))

    def bwd(x):
        return funcol.all_to_all_single(x, None, None, dist.group.WORLD)

    with sess.phase("fwd"):
        sess.capture(fwd, x)
    with sess.phase("bwd"):
        sess.capture(bwd, x)
    return sess.report()


@pytest.mark.parametrize("source", ["capture", "serve_fixture",
                                    "imported_csv"])
def test_perfetto_export_reimports_bitwise_in_both(source, tmp_path):
    if source == "capture":
        rep = _port_capture()
    elif source == "serve_fixture":
        rep = CommReport.load(SERVE_REPORT)
    else:
        rep = trace.load_trace(SERVE_CSV).report()
    path = perfetto.export_perfetto(rep, str(tmp_path / "t.trace.json"))
    assert trace.sniff_format(path) == "perfetto"
    for mod in (trace, ref_trace):
        imp = mod.load_trace(path)
        assert imp.meta["exact_reimport"] is True
        _assert_reports_equal(imp.report(), rep)
    assert _import_dict(trace.load_trace(path)) == \
        _import_dict(ref_trace.load_trace(path))


def test_perfetto_events_equal_reference():
    """The exporter itself: the same report gives the reference's events
    (the document's ``generator`` names the package)."""
    for path in (SERVE_REPORT, TRANSLATION_REPORT):
        got = perfetto.chrome_trace(CommReport.load(path))
        want = ref_perfetto.chrome_trace(RefReport.load(path))
        assert got["traceEvents"] == want["traceEvents"]
        assert got["otherData"]["generator"] == \
            "repro_torch.core.export.perfetto"


def test_measured_report_cross_loads(tmp_path):
    rep = trace.load_trace(SERVE_CSV).report()
    p = str(tmp_path / "imported.json")
    rep.save(p)
    for load in (CommReport.load, RefReport.load):
        back = load(p)
        assert back.trace_meta["source"] == "nvprof"
        assert [op.measured_s for op in back.compiled_ops] == \
            [op.measured_s for op in rep.compiled_ops]
        assert np.array_equal(np.asarray(back.matrix),
                              np.asarray(rep.matrix))
    ref = ref_trace.load_trace(SERVE_CSV).report()
    ref.save(p)
    assert CommReport.load(p).measured_seconds() == ref.measured_seconds()
    assert _port_capture().measured_seconds() is None


# ---------------------------------------------------------------------------
# the torch.profiler frontend
# ---------------------------------------------------------------------------
_GLOO_PROGRAM = textwrap.dedent('''
    import sys
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.profiler import ProfilerActivity, profile

    dist.init_process_group("gloo", world_size=1, rank=0,
                            store=dist.HashStore())
    g = dist.group.WORLD

    def program(x, y):
        a = funcol.all_reduce(x, "sum", g) * 1
        b = funcol.all_reduce(y, "sum", g) * 1
        dist.all_reduce(x, group=g)
        out = torch.empty(x.shape[0] * dist.get_world_size(), x.shape[1])
        dist.all_gather_into_tensor(out, x, group=g)
        return a, b, out

    x, y = torch.randn(1024, 256), torch.randn(64).bfloat16()
    program(x, y)
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        program(x, y)
    prof.export_chrome_trace(sys.argv[1])
    dist.destroy_process_group()
''')


@pytest.fixture(scope="module")
def gloo_trace(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("gloo") / "step.pt.trace.json")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", _GLOO_PROGRAM, path], env=env,
                   check=True, timeout=300, capture_output=True)
    return path


def test_torch_frontend_reads_a_gloo_profile(gloo_trace):
    assert trace.sniff_format(gloo_trace) == "torch"
    imp = trace.load_trace(gloo_trace)
    assert imp.num_devices == 1
    assert [(op.kind, op.payload_bytes) for op in imp.ops] == [
        ("all-reduce", 1024 * 256 * 4), ("all-reduce", 64 * 2),
        ("all-reduce", 1024 * 256 * 4), ("all-gather", 1024 * 256 * 4)]
    assert all(op.measured_s > 0 for op in imp.ops)
    assert all(op.replica_groups == [[0]] for op in imp.ops)
    assert imp.meta["source"] == "torch"
    assert imp.meta["backend"] == "gloo"
    # no device here: gloo's ops are timed on the host
    assert set(imp.meta["timing"]) <= {"cpu_op", "cpu_annotation"}
    assert sum(imp.meta["timing"].values()) == 4
    # the bare dist.all_reduce records a TensorList: its dtype is lent by
    # the annotation gloo's own thread records
    assert imp.meta["dtype_from_backend_thread"] == 1
    assert imp.meta["backend_thread_annotations"] >= 1
    rep = imp.report()
    assert rep.trace_meta["source"] == "torch"
    assert rep.measured_seconds() == pytest.approx(
        sum(op.measured_s for op in imp.ops))


def test_torch_profile_compares_with_its_capture(gloo_trace):
    """The same program captured on the fake 8-rank mesh: every measured
    op matches a captured one, in order, with a finite relative error."""
    mesh = mesh_4x2()
    sess = MonitorSession(mesh=mesh, name="program")
    world = dist.group.WORLD
    with sess.fake_mode:
        x, y = torch.empty(1024, 256), torch.empty(64, dtype=torch.bfloat16)

    def program(x, y):
        a = funcol.all_reduce(x, "sum", world) * 1
        b = funcol.all_reduce(y, "sum", world) * 1
        dist.all_reduce(x, group=world)
        out = torch.empty(x.shape[0] * dist.get_world_size(), x.shape[1])
        dist.all_gather_into_tensor(out, x, group=world)
        return a, b, out

    sess.capture(program, x, y)
    capture = sess.report()
    measured = trace.load_trace(gloo_trace).report()
    res = measured.compare(capture)
    assert res.unmatched_measured == 0
    assert len(res.rows) == 4
    assert all(np.isfinite(r.rel_err) for r in res.rows)
    got = [op.payload_bytes for op in measured.compiled_ops
           if op.kind == "all-reduce"]
    assert got == [op.payload_bytes for op in capture.compiled_ops
                   if op.kind == "all-reduce"]


def _kineto(events, world=4, backend="nccl"):
    """A Chrome trace shaped as ``export_chrome_trace`` writes it."""
    return json.dumps({
        "schemaVersion": 1,
        "deviceProperties": [{"id": 0, "name": "NVIDIA H100 80GB HBM3"}],
        "distributedInfo": {"backend": backend, "rank": 0,
                            "world_size": world},
        "traceEvents": events, "traceName": "hand.json"})


def _ev(name, ts, dur, cat="cpu_op", tid=1, pid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _nccl_allreduce(t0, ext0, dims=(1024, 256), dtype="float",
                    comms=True):
    """What one NCCL functional all-reduce records on the host."""
    evs = [_ev("_c10d_functional::all_reduce", t0, 100, **{
               "External id": ext0, "Input type": [dtype, "", ""],
               "Input Dims": [list(dims), [], []]}),
           _ev("c10d::allreduce_", t0 + 10, 80, **{
               "External id": ext0 + 1, "Input type": ["TensorList"],
               "Input Dims": [[list(dims)]]}),
           _ev("nccl:all_reduce", t0 + 30, 40, cat="user_annotation", **{
               "External id": ext0 + 3, "Input type": [dtype],
               "Input Dims": [list(dims)]}),
           _ev("cudaLaunchKernel", t0 + 35, 5, cat="cuda_runtime", **{
               "External id": ext0 + 3, "correlation": 500 + ext0})]
    if comms:
        evs.append(_ev("record_param_comms", t0 + 20, 60, **{
            "External id": ext0 + 2, "Collective name": "allreduce",
            "dtype": "BFloat16" if dtype == "c10::BFloat16" else "Float",
            "In msg nelems": int(np.prod(dims)),
            "Out msg nelems": int(np.prod(dims)), "Group size": 4,
            "Process Group Ranks": "[0, 1, 2, 3]"}))
    return evs


@pytest.mark.parametrize("link", ["correlation", "external_id"])
def test_torch_frontend_times_the_linked_nccl_kernel(tmp_path, link):
    evs = _nccl_allreduce(1000.0, 10)
    kernel = _ev("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 1200.0, 12.5,
                 cat="kernel", pid=0, tid=7,
                 **({"correlation": 510} if link == "correlation"
                    else {"External id": 12}))
    other = _ev("void at::native::vectorized_elementwise_kernel", 1300.0,
                3.0, cat="kernel", pid=0, tid=7, correlation=510)
    path = _write(tmp_path, "k.json", _kineto(evs + [kernel, other]))
    assert trace.sniff_format(path) == "torch"
    (op,) = trace.load_trace(path).ops
    assert op.kind == "all-reduce"
    assert op.payload_bytes == 1024 * 256 * 4
    assert op.replica_groups == [[0, 1, 2, 3]]
    assert op.measured_s == pytest.approx(12.5e-6)
    assert trace.load_trace(path).meta["timing"] == {"nccl_kernel": 1}


def test_torch_frontend_timing_fallbacks(tmp_path):
    """No kernel: the annotation's device span, else its host span."""
    evs = _nccl_allreduce(1000.0, 10) + _nccl_allreduce(
        2000.0, 20, dims=(64,), dtype="c10::BFloat16", comms=False)
    evs.append(_ev("nccl:all_reduce", 1500.0, 2.5,
                   cat="gpu_user_annotation", pid=0, tid=7,
                   **{"External id": 13}))
    imp = trace.load_trace(_write(tmp_path, "f.json", _kineto(evs)))
    a, b = imp.ops
    assert (a.measured_s, b.measured_s) == (pytest.approx(2.5e-6),
                                            pytest.approx(40e-6))
    assert (a.payload_bytes, b.payload_bytes) == (1024 * 256 * 4, 64 * 2)
    # without record_param_comms the group is the world of the trace
    assert b.replica_groups == [[0, 1, 2, 3]]
    assert imp.meta["timing"] == {"gpu_annotation": 1, "cpu_annotation": 1}


@pytest.mark.parametrize("case,match", [
    ("no_shapes", r"event 0 \('c10d::allreduce_'\).*has no size"),
    ("no_collective", "no collective in trace"),
    ("negative_dur", "bad ts/dur"),
    ("truncated", "truncated or invalid JSON"),
    ("out_of_range", "out of range for 2 devices"),
])
def test_torch_frontend_refuses_malformed(tmp_path, case, match):
    if case == "truncated":
        text = _kineto(_nccl_allreduce(1000.0, 10))[:300]
    elif case == "no_shapes":
        text = _kineto([_ev("c10d::allreduce_", 10, 5, **{
            "External id": 1, "Input type": ["TensorList"],
            "Input Dims": [[[8]]]})])
    elif case == "no_collective":
        text = _kineto([_ev("aten::mm", 10, 5)])
    elif case == "negative_dur":
        text = _kineto([_ev("_c10d_functional::all_reduce", 10, -5)])
    else:
        text = _kineto(_nccl_allreduce(1000.0, 10), world=2)
    path = _write(tmp_path, "bad.json", text)
    with pytest.raises(trace.TraceParseError, match=match):
        trace.load_trace(path, fmt="torch")


def test_torch_frontend_sniffed_before_perfetto(gloo_trace):
    assert trace.TorchProfilerSource.sniff(gloo_trace, open(gloo_trace)
                                           .read(4096))
    # the generic Perfetto parser would take it too, and find no bytes
    assert trace.PerfettoSource.sniff(gloo_trace, "traceEvents")
    with pytest.raises(trace.TraceParseError, match="no byte annotation"):
        trace.load_trace(gloo_trace, fmt="perfetto")
