"""The port's exporters (``repro_torch.core.export``: CSV, comparison JSON,
HTML dashboard, scale and compare pages) against the reference's, byte for
byte, on the same loaded reports.

Each report is loaded from one JSON file by both packages and rendered by
both; the files must be equal.  The inputs: the committed fixtures (a
two-phase serve report and a three-phase translation report, both with a
topology), both together (the dashboard's per-report tab ids), the serve
fixture rewritten with COO (sparse) matrices, a port capture on 2x2x2 whose
flat ring draws lint findings, trace imports (the measured panel), a
compare result and scale-curve rows.
"""
import json
from pathlib import Path

import pytest

from repro import scale as ref_scale
from repro.core import export as ref_export
from repro.core.export import csv_exporter as ref_csv
from repro.core.export import html_exporter as ref_html
from repro.core.trace import load_trace as ref_load_trace
from repro_torch import scale, sweep
from repro_torch.core import export
from repro_torch.core.export import csv_exporter, html_exporter
from repro_torch.core.export import serialize as ser
from repro_torch.core.sparse import from_dense
from repro_torch.core.trace import load_trace
from torch_fixtures import mesh_4x2

FIXTURES = Path(__file__).parent / "fixtures"


def _same_bytes(fmt: str, port_path, ref_path) -> bool:
    """Equal files.  The Perfetto timeline names its producer in
    ``otherData.generator`` (``repro_torch.core.export.perfetto`` against
    ``repro.core.export.perfetto``), on purpose: that one string, once,
    is the pinned difference."""
    a, b = Path(port_path).read_bytes(), Path(ref_path).read_bytes()
    if fmt == "perfetto":
        mine = b'"generator": "repro_torch.core.export.perfetto"'
        assert a.count(mine) == 1
        a = a.replace(mine, b'"generator": "repro.core.export.perfetto"')
    return a == b


def _sparse_fixture(tmp_path) -> Path:
    """The serve fixture with every matrix in the schema-v6 COO form."""
    d = json.loads((FIXTURES / "serve_report.json").read_text())
    rep = ser.report_from_dict(d)
    d["matrix"] = ser.matrix_to_jsonable(from_dense(rep.matrix))
    d["per_primitive"] = {k: ser.matrix_to_jsonable(from_dense(m))
                          for k, m in rep.per_primitive.items()}
    path = tmp_path / "serve_sparse.json"
    path.write_text(json.dumps(d))
    return path


def _lint_capture(tmp_path) -> Path:
    """A port capture of the paper microbenchmark on 2x2x2 (a flat ring
    across pods: flat-ring-multipod errors), saved."""
    mesh_4x2()
    rep = sweep._monitor_cell(sweep.available_configs()["paper"].build,
                              sweep.build_mesh("2x2x2", device="cpu"),
                              "paper@2x2x2")
    assert rep.lint()
    path = tmp_path / "paper_2x2x2.json"
    rep.save(str(path))
    return path


SOURCES = {
    "serve": lambda tmp: FIXTURES / "serve_report.json",
    "translation": lambda tmp: FIXTURES / "translation_report.json",
    "sparse": _sparse_fixture,
    "lint": _lint_capture,
}


def _pair(path):
    return export.load_json_reports(str(path)), \
        ref_export.load_json_reports(str(path))


@pytest.mark.parametrize("source", sorted(SOURCES))
@pytest.mark.parametrize("fmt", ["csv", "html", "json", "perfetto"])
def test_report_exports_equal_reference(source, fmt, tmp_path):
    (port,), (ref,) = _pair(SOURCES[source](tmp_path))
    a = export.export_report(port, fmt, str(tmp_path / f"port.{fmt}"))
    b = ref_export.export_report(ref, fmt, str(tmp_path / f"ref.{fmt}"))
    assert _same_bytes(fmt, a, b)


@pytest.mark.parametrize("source", sorted(SOURCES))
def test_matrix_csv_equals_reference(source, tmp_path):
    (port,), (ref,) = _pair(SOURCES[source](tmp_path))
    a = csv_exporter.export_matrix_csv(port, str(tmp_path / "port.csv"))
    b = ref_csv.export_matrix_csv(ref, str(tmp_path / "ref.csv"))
    assert Path(a).read_bytes() == Path(b).read_bytes()
    if source == "sparse":
        assert Path(a).read_text().startswith("src,dst,bytes\n")


def test_comparison_set_equals_reference(tmp_path):
    """Several reports in one artifact set: one dashboard (per-report tab
    ids ``phases0``, ``phases1``), one CSV, one JSON document, one
    timeline -- and the JSON document reloads in either package."""
    paths = [FIXTURES / "serve_report.json",
             FIXTURES / "translation_report.json", _lint_capture(tmp_path)]
    port = [r for p in paths for r in export.load_json_reports(str(p))]
    ref = [r for p in paths for r in ref_export.load_json_reports(str(p))]
    a = export.export_comparison(port, str(tmp_path / "port"), stem="sw")
    b = ref_export.export_comparison(ref, str(tmp_path / "ref"), stem="sw")
    assert sorted(a) == sorted(b) == sorted(export.FORMATS)
    for fmt in export.FORMATS:
        assert _same_bytes(fmt, a[fmt], b[fmt]), fmt
    page = Path(a["html"]).read_text()
    assert "id='phases0-0'" in page and "id='phases1-0'" in page
    back = export.load_json_reports(a["json"])
    assert [r.name for r in back] == [r.name for r in port]
    assert [r.compiled_summary for r in back] == \
        [r.compiled_summary for r in port]
    assert export.SUFFIXES == ref_export.SUFFIXES
    assert export.FORMATS == ref_export.FORMATS


def test_html_has_one_heatmap_panel_per_phase():
    (port,), _ = _pair(FIXTURES / "translation_report.json")
    page = html_exporter.render_dashboard(port)
    for phase in port.phase_names():
        assert page.count(f"<h3>phase {phase}: all primitives</h3>") == 1
    assert "class='tabs'" in page


def test_lint_panel_renders_findings(tmp_path):
    (port,), _ = _pair(_lint_capture(tmp_path))
    panel = html_exporter.lint_panel(port)
    assert "flat-ring-multipod" in panel and "color:#c0392b" in panel
    assert html_exporter.lint_panel(_pair(
        FIXTURES / "serve_report.json")[0][0]) == ""


@pytest.mark.parametrize("trace", ["translation_trace.json",
                                   "serve_trace.csv"])
def test_measured_report_exports_equal_reference(trace, tmp_path):
    """Trace imports: a Perfetto export of the port's own kind (with a
    topology, so the dashboard draws the modeled-vs-measured panel) and an
    nvprof CSV."""
    port = load_trace(str(FIXTURES / trace)).report()
    ref = ref_load_trace(str(FIXTURES / trace)).report()
    for fmt in ("csv", "html", "json"):
        a = export.export_report(port, fmt, str(tmp_path / f"p.{fmt}"))
        b = ref_export.export_report(ref, fmt, str(tmp_path / f"r.{fmt}"))
        assert Path(a).read_bytes() == Path(b).read_bytes(), fmt
    page = html_exporter.render_dashboard(port)
    assert ("modeled vs measured" in page) == (port.topo is not None)


def test_compare_exports_equal_reference(tmp_path):
    model_path = str(FIXTURES / "serve_report.json")
    port = load_trace(str(FIXTURES / "serve_trace.csv")).report().compare(
        export.load_json(model_path))
    ref = ref_load_trace(str(FIXTURES / "serve_trace.csv")).report().compare(
        ref_export.load_json(model_path))
    assert csv_exporter.COMPARE_COLUMNS == ref_csv.COMPARE_COLUMNS
    a = csv_exporter.export_compare_csv(port, str(tmp_path / "p.csv"))
    b = ref_csv.export_compare_csv(ref, str(tmp_path / "r.csv"))
    assert Path(a).read_bytes() == Path(b).read_bytes()
    assert Path(a).read_text().count("\n") == 1 + len(port.rows) > 1
    a = html_exporter.export_compare_html([port, port],
                                          str(tmp_path / "p.html"))
    b = ref_html.export_compare_html([ref, ref], str(tmp_path / "r.html"))
    assert Path(a).read_bytes() == Path(b).read_bytes()


def test_scale_exports_equal_reference(tmp_path):
    """Scale-curve rows of the serve fixture at 256 and 1024 devices: equal
    in both packages but for ``build_ms`` (a wall-clock time), and written
    identically from the same rows."""
    port = export.load_json(str(FIXTURES / "serve_report.json"))
    ref = ref_export.load_json(str(FIXTURES / "serve_report.json"))
    rows = [p.row() for p in scale.scale_curve([port], (256, 1024))]
    ref_rows = [p.row() for p in ref_scale.scale_curve([ref], (256, 1024))]
    strip = [{k: v for k, v in r.items() if k != "build_ms"} for r in rows]
    assert strip == [{k: v for k, v in r.items() if k != "build_ms"}
                     for r in ref_rows]
    assert csv_exporter.SCALE_COLUMNS == ref_csv.SCALE_COLUMNS
    assert len(csv_exporter.SCALE_COLUMNS) == 13
    a = csv_exporter.export_scale_csv(rows, str(tmp_path / "p.csv"))
    b = ref_csv.export_scale_csv(rows, str(tmp_path / "r.csv"))
    assert Path(a).read_bytes() == Path(b).read_bytes()
    a = html_exporter.export_scale_html(rows, str(tmp_path / "p.html"))
    b = ref_html.export_scale_html(rows, str(tmp_path / "r.html"))
    assert Path(a).read_bytes() == Path(b).read_bytes()
    assert "<svg" in Path(a).read_text()


def test_export_validates_formats(tmp_path):
    (port,), _ = _pair(FIXTURES / "serve_report.json")
    with pytest.raises(ValueError, match="unknown format"):
        export.export_report(port, "xml", str(tmp_path / "x"))
    with pytest.raises(ValueError, match="unknown format"):
        export.export_comparison([port], str(tmp_path), formats=["pdf"])


def test_save_with_schedules_equals_reference(tmp_path):
    (port,), (ref,) = _pair(FIXTURES / "serve_report.json")
    port.save(str(tmp_path / "p.json"), include_schedules=True)
    ref.save(str(tmp_path / "r.json"), include_schedules=True)
    assert (tmp_path / "p.json").read_bytes() == \
        (tmp_path / "r.json").read_bytes()
    d = json.loads((tmp_path / "p.json").read_text())
    assert len(d["schedules"]) == len(d["ops"])
    assert port.schedule_summaries() == ref.schedule_summaries()


def test_load_json_refuses_a_sweep_document(tmp_path):
    (port,), _ = _pair(FIXTURES / "serve_report.json")
    path = export.export_comparison_json([port, port],
                                         str(tmp_path / "two.json"))
    with pytest.raises(ValueError, match="holds 2 reports"):
        export.load_json(path)
    assert len(export.load_json_reports(path)) == 2
