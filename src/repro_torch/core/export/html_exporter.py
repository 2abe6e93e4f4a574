"""Self-contained HTML dashboard of communication matrices (paper Figs. 2/3),
the port of ``repro.core.export.html_exporter``: for the same report its
output is the reference's, byte for byte.

One static file, no JavaScript libraries: every ``(d+1) x (d+1)`` matrix is an
HTML table whose cells are bucketed onto a 13-step single-hue sequential ramp
(log scale, light -> dark = near-zero -> max).  Dark mode re-steps the same
ramp against the dark surface (reversed, so "near zero" recedes toward the
surface in both modes) via ``prefers-color-scheme`` -- the cells themselves
only carry a bucket class.

Each cell exposes its exact value as a hover tooltip (``title``), every
matrix ships a color legend with min/max labels, and a collapsible raw-value
table preserves a text-readable view of the same data.

Session reports with two or more named phases additionally render a pure-CSS
tab strip per report (radio inputs + sibling selectors, still zero
JavaScript): an "all phases" tab with the full artifact set, and one tab per
phase holding that phase's summary table and matrix heatmap.
"""
from __future__ import annotations

import html
import math
import os

import numpy as np

from .. import reporter
from ..sparse import is_sparse

# 13-step sequential blue ramp (steps 100..700 of the reference palette);
# validated single-hue light->dark -- index 0 = near zero, 12 = max.
_RAMP = (
    "#cde2fb", "#b7d3f6", "#9ec5f4", "#86b6ef", "#6da7ec", "#5598e7",
    "#3987e5", "#2a78d6", "#256abf", "#1c5cab", "#184f95", "#104281",
    "#0d366b",
)
_NBUCKETS = len(_RAMP)

_CSS = """
:root {
  color-scheme: light dark;
  --surface: #fcfcfb; --surface-2: #f0efec;
  --text-1: #0b0b0b; --text-2: #52514e; --border: #d9d8d3;
}
@media (prefers-color-scheme: dark) {
  :root { --surface: #1a1a19; --surface-2: #262624;
          --text-1: #ffffff; --text-2: #c3c2b7; --border: #3a3a37; }
}
body { background: var(--surface); color: var(--text-1);
       font: 14px/1.5 system-ui, sans-serif; margin: 2rem auto;
       max-width: 1100px; padding: 0 1rem; }
h1, h2, h3 { font-weight: 600; }
h1 { font-size: 1.4rem; } h2 { font-size: 1.15rem; margin-top: 2.5rem; }
h3 { font-size: 0.95rem; color: var(--text-2); margin-bottom: 0.3rem; }
.meta { color: var(--text-2); font-size: 0.85rem; }
.grid { display: flex; flex-wrap: wrap; gap: 1.5rem; align-items: flex-start; }
table.hm { border-collapse: separate; border-spacing: 2px; }
table.hm td { width: 16px; height: 16px; padding: 0; border-radius: 2px; }
table.hm th { font-weight: 400; font-size: 0.65rem; color: var(--text-2);
              padding: 0 2px; text-align: center; }
table.sum { border-collapse: collapse; margin: 0.5rem 0; }
table.sum th, table.sum td { text-align: left; padding: 2px 12px 2px 0;
  border-bottom: 1px solid var(--border); font-size: 0.85rem; }
table.sum th { color: var(--text-2); font-weight: 500; }
td.z { background: var(--surface-2); }
.legend { display: flex; align-items: center; gap: 6px; margin: 0.4rem 0;
          font-size: 0.75rem; color: var(--text-2); }
.legend .bar { display: flex; }
.legend .bar i { width: 12px; height: 10px; display: inline-block; }
details { margin: 0.5rem 0 1rem; }
details summary { cursor: pointer; color: var(--text-2); font-size: 0.8rem; }
details pre { font-size: 0.7rem; overflow-x: auto; background: var(--surface-2);
              padding: 0.5rem; border-radius: 4px; }
.tabs { margin: 1rem 0; }
.tabs > input { display: none; }
.tabs > label { display: inline-block; padding: 4px 14px; cursor: pointer;
                border: 1px solid var(--border); border-bottom: none;
                border-radius: 6px 6px 0 0; color: var(--text-2);
                font-size: 0.85rem; margin-right: 2px; }
.tabs > input:checked + label { background: var(--surface-2);
                                color: var(--text-1); font-weight: 600; }
.tabs > .panel { display: none; border-top: 1px solid var(--border);
                 padding-top: 0.8rem; }
""" + "\n".join(
    # pure-CSS tab switching: the checked radio reveals the same-index panel
    f".tabs > input:nth-of-type({i}):checked ~ .panel:nth-of-type({i})"
    " { display: block; }"
    for i in range(1, 17)
) + "\n" + "\n".join(
    f"td.q{i} {{ background: {c}; }}" for i, c in enumerate(_RAMP)
) + "\n@media (prefers-color-scheme: dark) {\n" + "\n".join(
    # dark mode: reversed ramp so near-zero recedes toward the dark surface
    f"  td.q{i} {{ background: {c}; }}"
    for i, c in enumerate(reversed(_RAMP))
) + "\n}\n"


def _bucket(value: float, vmax_log: float) -> int:
    if value <= 0 or vmax_log <= 0:
        return -1                      # zero cell: surface, not on the ramp
    t = max(0.0, math.log10(value)) / vmax_log
    return min(_NBUCKETS - 1, int(t * _NBUCKETS))


def _labels(d: int, block: int) -> list[str]:
    if block > 1:
        return ["host"] + [f"d{i * block}" for i in range(d - 1)]
    return ["host"] + [f"d{i}" for i in range(d - 1)]


def matrix_table(mat, *, max_devices: int = 32) -> str:
    """One matrix as an HTML heatmap table (+ legend + raw-value fallback).

    ``mat`` may be dense or a :class:`~repro_torch.core.sparse.SparseCommMatrix`
    -- ``coarsen_matrix`` dispatches, so the rendered table is identical
    either way and the sparse path never builds the ``(d+1)^2`` array.
    """
    if not is_sparse(mat):
        mat = np.asarray(mat, dtype=np.float64)
    m, block = reporter.coarsen_matrix(mat, max_devices=max_devices)
    d = m.shape[0]
    labels = _labels(d, block)
    vmax = float(m.max())
    vmax_log = math.log10(vmax) if vmax > 1 else 1.0
    rows = ["<table class='hm'>",
            "<tr><th></th>" + "".join(f"<th>{l}</th>" for l in labels)
            + "</tr>"]
    for i in range(d):
        cells = [f"<th>{labels[i]}</th>"]
        for j in range(d):
            b = _bucket(m[i, j], vmax_log)
            cls = "z" if b < 0 else f"q{b}"
            tip = (f"{labels[i]} → {labels[j]}: "
                   f"{reporter.human_bytes(m[i, j])}")
            cells.append(f"<td class='{cls}' title='{html.escape(tip)}'></td>")
        rows.append("<tr>" + "".join(cells) + "</tr>")
    rows.append("</table>")
    swatches = "".join(f"<i style='background:{c}'></i>" for c in _RAMP)
    rows.append(
        "<div class='legend'><span>0</span><span class='bar'>"
        f"{swatches}</span><span>{reporter.human_bytes(vmax)}</span>"
        "<span>(log scale)</span></div>")
    if block > 1:
        rows.append(f"<div class='meta'>device blocks of {block}</div>")
    rows.append("<details><summary>raw values (CSV)</summary><pre>"
                + html.escape(reporter.matrix_to_csv(m)) + "</pre></details>")
    return "\n".join(rows)


def _summary_table(summary: dict) -> str:
    has_skew = any("max_skew" in summary[k] for k in summary)
    skew_th = "<th>skew (max/mean)</th>" if has_skew else ""
    rows = ["<table class='sum'><tr><th>primitive</th><th>calls</th>"
            f"<th>payload</th><th>wire bytes</th>{skew_th}</tr>"]
    for kind in sorted(summary, key=lambda k: -summary[k].get("wire_bytes", 0)):
        r = summary[kind]
        skew_td = (f"<td>{r.get('max_skew', 1.0):.2f}x</td>"
                   if has_skew else "")
        rows.append(
            f"<tr><td>{html.escape(kind)}</td><td>{r.get('calls', 0):,}</td>"
            f"<td>{reporter.human_bytes(r.get('payload_bytes', 0))}</td>"
            f"<td>{reporter.human_bytes(r.get('wire_bytes', 0))}</td>"
            f"{skew_td}</tr>")
    rows.append("</table>")
    return "\n".join(rows)


def _link_summary_table(lu) -> str:
    """Per link-kind aggregates (ICI vs DCN) under the link heatmap."""
    rows = ["<table class='sum'><tr><th>link kind</th><th>links</th>"
            "<th>total bytes</th><th>busiest link</th>"
            "<th>bottleneck ms</th></tr>"]
    summary = lu.summary()
    for kind in sorted(summary):
        r = summary[kind]
        rows.append(
            f"<tr><td>{html.escape(kind)}</td><td>{r['links']}</td>"
            f"<td>{reporter.human_bytes(r['bytes'])}</td>"
            f"<td>{html.escape(r['busiest_link'])}</td>"
            f"<td>{r['bottleneck_seconds'] * 1e3:.3f}</td></tr>")
    rows.append("</table>")
    return "\n".join(rows)


def _overlap_table(report, lu) -> str:
    """Tier-overlap view: serialized per-tier seconds next to each tier's
    busiest-link time, plus the overlapped vs serialized bound."""
    if not hasattr(report, "collective_seconds_split"):
        return ""
    ici_s, dcn_s = report.collective_seconds_split()
    rows = ["<table class='sum'><tr><th>tier</th><th>serialized ms</th>"
            "<th>busiest-link ms</th></tr>"]
    for tier, serial in (("ici", ici_s), ("dcn", dcn_s)):
        rows.append(
            f"<tr><td>{tier}</td><td>{serial * 1e3:.3f}</td>"
            f"<td>{lu.busy_seconds(tier) * 1e3:.3f}</td></tr>")
    rows.append("</table>")
    rows.append(
        f"<div class='meta'>overlapped (ici ∥ dcn): "
        f"{max(ici_s, dcn_s) * 1e3:.3f} ms &middot; serialized: "
        f"{(ici_s + dcn_s) * 1e3:.3f} ms</div>")
    return "\n".join(rows)


def link_section(report) -> str:
    """The physical-link panel: per-link byte heatmap + per-kind summary +
    the tier-overlap table.

    Entry ``(i+1, j+1)`` of the heatmap is the physical ICI link ``i -> j``
    (only torus neighbours light up); row/col 0 is the DCN tier (uplinks /
    downlinks).  Empty string for reports without a topology.
    """
    lu = report.link_utilization() \
        if hasattr(report, "link_utilization") else None
    if lu is None:
        return ""
    # sparse reports keep the link view sparse too: the COO link matrix is
    # O(links), the dense one O(d^2)
    link_mat = (lu.sparse_matrix() if is_sparse(report.matrix)
                else lu.matrix())
    return ("<div><h3>physical links</h3>"
            "<div class='meta'>row/col 0 = DCN uplink/downlink; "
            "other cells = ICI neighbour links</div>"
            + matrix_table(link_mat) + _link_summary_table(lu)
            + _overlap_table(report, lu)
            + "</div>")


_SEV_BADGE = {"error": "#c0392b", "warn": "#b9770e", "info": "#2874a6"}


def lint_panel(report) -> str:
    """The static-lint findings panel: one row per finding with severity,
    flagged ops, modeled savings and the suggested fix.  Empty string when
    the report carries no findings (clean capture, or no lint surface)."""
    findings = report.lint() if hasattr(report, "lint") else []
    if not findings:
        return ""
    rows = ["<div><h3>lint findings</h3>",
            "<div class='meta'>static anti-patterns with savings modeled "
            "by the decomposition engine (current vs suggested "
            "schedule)</div>",
            "<table class='sum'><tr><th>rule</th><th>severity</th>"
            "<th>phase</th><th>ops</th><th>est. savings</th>"
            "<th>DCN bytes saved</th><th>suggested fix</th></tr>"]
    for f in findings:
        ops = ",".join(f.op_names)
        if len(ops) > 60:
            ops = ops[:57] + f"...({len(f.op_names)} ops)"
        color = _SEV_BADGE.get(f.severity, "inherit")
        rows.append(
            f"<tr><td>{html.escape(f.rule_id)}</td>"
            f"<td style='color:{color}'>{html.escape(f.severity)}</td>"
            f"<td>{html.escape(f.phase or '-')}</td>"
            f"<td title='{html.escape(f.message)}'>{html.escape(ops)}</td>"
            f"<td>{f.est_savings_s * 1e3:.3f} ms</td>"
            f"<td>{reporter.human_bytes(f.est_dcn_bytes_saved)}</td>"
            f"<td>{html.escape(f.suggested_fix)}</td></tr>")
    rows.append("</table></div>")
    return "\n".join(rows)


def _compare_rows_table(result) -> str:
    """The shared per-collective modeled-vs-measured table body."""
    rows = ["<table class='sum'><tr><th>op</th><th>kind</th><th>phase</th>"
            "<th>payload</th><th>modeled</th><th>measured</th>"
            "<th>rel err</th></tr>"]
    for r in result.rows:
        mod = "-" if r.modeled_s is None else f"{r.modeled_s * 1e3:.3f} ms"
        err = "-" if r.rel_err is None else f"{r.rel_err * 100:.1f}%"
        rows.append(
            f"<tr><td>{html.escape(r.name)}</td>"
            f"<td>{html.escape(r.kind)}</td>"
            f"<td>{html.escape(r.phase or '-')}</td>"
            f"<td>{reporter.human_bytes(r.payload_bytes)}</td>"
            f"<td>{mod}</td><td>{r.measured_s * 1e3:.3f} ms</td>"
            f"<td>{err}</td></tr>")
    rows.append("</table>")
    return "\n".join(rows)


def _compare_buckets_table(label: str, buckets: dict) -> str:
    rows = [f"<table class='sum'><tr><th>{html.escape(label)}</th>"
            "<th>ops</th><th>modeled</th><th>measured</th>"
            "<th>mean err</th><th>max err</th></tr>"]
    for key, b in buckets.items():
        mean = ("-" if b["mean_rel_err"] is None
                else f"{b['mean_rel_err'] * 100:.1f}%")
        mx = ("-" if b["max_rel_err"] is None
              else f"{b['max_rel_err'] * 100:.1f}%")
        rows.append(
            f"<tr><td>{html.escape(str(key))}</td><td>{b['count']}</td>"
            f"<td>{b['modeled_s'] * 1e3:.3f} ms</td>"
            f"<td>{b['measured_s'] * 1e3:.3f} ms</td>"
            f"<td>{mean}</td><td>{mx}</td></tr>")
    rows.append("</table>")
    return "\n".join(rows)


def compare_panel(result) -> str:
    """The modeled-vs-measured panel for one
    :class:`repro_torch.core.trace.compare.CompareResult`: per-collective rows
    plus per-kind and per-size-class aggregates."""
    s = result.stats()
    mean = ("-" if s["mean_rel_err"] is None
            else f"{s['mean_rel_err'] * 100:.1f}%")
    mx = ("-" if s["max_rel_err"] is None
          else f"{s['max_rel_err'] * 100:.1f}%")
    parts = [
        "<div><h3>modeled vs measured</h3>",
        f"<div class='meta'>measured: {html.escape(result.measured_label)}"
        f" &middot; model: {html.escape(result.modeled_label)}"
        f" [{html.escape(result.algorithm)}] &middot; {s['count']} matched"
        f" ({s['unmatched_measured']} measured /"
        f" {s['unmatched_modeled']} modeled unmatched) &middot;"
        f" mean rel err {mean}, max {mx}</div>",
        _compare_rows_table(result),
        _compare_buckets_table("kind", result.by_kind()),
        _compare_buckets_table("size class", result.by_size_class()),
        "</div>",
    ]
    return "\n".join(parts)


def _measured_panel(report) -> str:
    """The compare panel for a measured (trace-imported) report, against
    its own model when one exists.  Empty string for purely modeled
    reports or when no comparison is possible (no topology, nothing
    matched) -- the dashboard never fails over an absent model."""
    if not hasattr(report, "compare") or \
            not any(getattr(op, "measured_s", None) is not None
                    for op in report.compiled_ops):
        return ""
    try:
        return compare_panel(report.compare())
    except ValueError:
        return ""


def _matrices_section(report) -> str:
    """The whole-report artifact set: summary + lint findings +
    modeled-vs-measured panel (trace imports) +
    combined/per-primitive/link heatmaps (the body of the "all phases"
    view)."""
    parts = [
        _summary_table(report.compiled_summary),
        lint_panel(report),
        _measured_panel(report),
        "<div class='grid'>",
        "<div><h3>all primitives</h3>" + matrix_table(report.matrix)
        + "</div>",
    ]
    for kind, mat in sorted(report.per_primitive.items()):
        parts.append(f"<div><h3>{html.escape(kind)}</h3>"
                     + matrix_table(mat) + "</div>")
    parts.append(link_section(report))
    parts.append("</div>")
    return "\n".join(parts)


def _phase_panel(report, phase: str) -> str:
    """One phase's view: its summary table + combined matrix heatmap."""
    view = report.view(phase=phase)
    parts = [_summary_table(view.summary),
             "<div class='grid'>",
             f"<div><h3>phase {html.escape(phase)}: all primitives</h3>"
             + matrix_table(view.matrix) + "</div>"]
    for kind, mat in sorted(view.per_primitive.items()):
        parts.append(f"<div><h3>{html.escape(kind)}</h3>"
                     + matrix_table(mat) + "</div>")
    parts.append("</div>")
    return "\n".join(parts)


def _phase_tabs(report, uid: str) -> str:
    """Pure-CSS tab strip: "all phases" + one tab per session phase."""
    names = report.phase_names()
    panels = [("all phases", _matrices_section(report))]
    panels += [(p, _phase_panel(report, p)) for p in names]
    if len(panels) > 16:        # CSS switch rules cover 16 tabs; stack past it
        return "\n".join(f"<h3>{html.escape(label)}</h3>\n{content}"
                         for label, content in panels)
    parts = ["<div class='tabs'>"]
    for i, (label, _) in enumerate(panels):
        checked = " checked" if i == 0 else ""
        parts.append(f"<input type='radio' name='{uid}' id='{uid}-{i}'"
                     f"{checked}><label for='{uid}-{i}'>"
                     f"{html.escape(label)}</label>")
    for _, content in panels:
        parts.append(f"<div class='panel'>\n{content}\n</div>")
    parts.append("</div>")
    return "\n".join(parts)


def report_section(report, idx: int = 0) -> str:
    """One report: header, primitive summary, combined + per-primitive +
    physical-link maps; multi-phase session reports get a per-phase tab
    strip ("all phases" first, then one tab per phase)."""
    algorithm = getattr(report, "algorithm", "ring")
    total_wire = sum(r.get("wire_bytes", 0.0)
                     for r in report.compiled_summary.values())
    phase_names = (report.phase_names()
                   if hasattr(report, "phase_names") else [])
    phase_note = (f" &middot; phases: "
                  f"{html.escape(' → '.join(phase_names))}"
                  if len(phase_names) >= 2 else "")
    parts = [
        f"<h2>{html.escape(report.name)}</h2>",
        f"<div class='meta'>{report.num_devices} devices &middot; "
        f"algorithm: {html.escape(algorithm)} &middot; wire bytes "
        f"{reporter.human_bytes(total_wire)} &middot; compile "
        f"{report.compile_seconds * 1e3:.0f} ms{phase_note}</div>",
    ]
    if len(phase_names) >= 2:
        parts.append(_phase_tabs(report, uid=f"phases{idx}"))
    else:
        parts.append(_matrices_section(report))
    return "\n".join(parts)


def render_dashboard(reports, title: str = "Communication matrices") -> str:
    if not isinstance(reports, (list, tuple)):
        reports = [reports]
    body = "\n".join(report_section(r, idx=i) for i, r in enumerate(reports))
    return (
        "<!doctype html>\n<html lang='en'>\n<head>\n<meta charset='utf-8'>\n"
        f"<title>{html.escape(title)}</title>\n"
        "<meta name='viewport' content='width=device-width, initial-scale=1'>"
        f"\n<style>{_CSS}</style>\n</head>\n<body>\n"
        f"<h1>{html.escape(title)}</h1>\n"
        "<div class='meta'>(d+1)&sup2; byte matrices, row/col 0 = host "
        "(paper Figs. 2/3); hover a cell for the exact value.</div>\n"
        f"{body}\n</body>\n</html>\n")


def export_html(reports, path: str, title: str = "Communication matrices") -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(render_dashboard(reports, title))
    return path


# ---------------------------------------------------------------------------
# scale-curve panel (``sweep --scale-curve``): per-config device sweeps
# ---------------------------------------------------------------------------
def _scale_svg(rows: list[dict]) -> str:
    """Inline SVG: overlapped communication time vs device count, both axes
    log scale (straight lines = power-law scaling)."""
    pts = [(r["devices"], r["overlap_ms"]) for r in rows
           if r["overlap_ms"] > 0]
    if len(pts) < 2:
        return ""
    w, h, pad = 260, 120, 24
    xs = [math.log2(p[0]) for p in pts]
    ys = [math.log10(p[1]) for p in pts]
    x0, x1 = min(xs), max(xs)
    y0, y1 = min(ys), max(ys)
    xspan = (x1 - x0) or 1.0
    yspan = (y1 - y0) or 1.0
    coords = " ".join(
        f"{pad + (x - x0) / xspan * (w - 2 * pad):.1f},"
        f"{h - pad - (y - y0) / yspan * (h - 2 * pad):.1f}"
        for x, y in zip(xs, ys))
    labels = "".join(
        f"<text x='{pad + (x - x0) / xspan * (w - 2 * pad):.1f}' "
        f"y='{h - 6}' font-size='9' fill='currentColor' "
        f"text-anchor='middle'>{d}</text>"
        for (d, _), x in zip(pts, xs))
    return (f"<svg width='{w}' height='{h}' role='img' "
            "style='color: var(--text-2)'>"
            f"<polyline points='{coords}' fill='none' "
            "stroke='#3987e5' stroke-width='2'/>"
            + "".join(f"<circle cx='{c.split(',')[0]}' "
                      f"cy='{c.split(',')[1]}' r='2.5' fill='#3987e5'/>"
                      for c in coords.split())
            + labels
            + f"<text x='{pad}' y='12' font-size='9' "
              "fill='currentColor'>overlap ms vs devices "
              "(log-log)</text></svg>")


def render_scale_curve(points: list[dict],
                       title: str = "Fleet scale curves") -> str:
    """Standalone dashboard for ``sweep --scale-curve`` output: one panel
    per (config, algorithm) with the per-device-count scaling table and a
    log-log time-to-solution sparkline.  ``points`` are
    :meth:`repro_torch.scale.ScalePoint.row` dicts."""
    groups: dict[tuple, list[dict]] = {}
    for p in points:
        groups.setdefault((p["config"], p["algorithm"]), []).append(p)
    sections = []
    for (config, algorithm), rows in sorted(groups.items()):
        rows = sorted(rows, key=lambda r: r["devices"])
        body = ["<table class='sum'><tr><th>devices</th><th>pods</th>"
                "<th>wire bytes</th><th>ici ms</th><th>dcn ms</th>"
                "<th>overlap ms</th><th>bottleneck link</th>"
                "<th>bottleneck ms</th><th>nnz</th></tr>"]
        for r in rows:
            body.append(
                f"<tr><td>{r['devices']:,}</td><td>{r['pods']}</td>"
                f"<td>{reporter.human_bytes(r['wire_bytes'])}</td>"
                f"<td>{r['ici_ms']:.3f}</td><td>{r['dcn_ms']:.3f}</td>"
                f"<td>{r['overlap_ms']:.3f}</td>"
                f"<td>{html.escape(r['bottleneck_link'])}</td>"
                f"<td>{r['bottleneck_ms']:.3f}</td>"
                f"<td>{r['nnz']:,}</td></tr>")
        body.append("</table>")
        sections.append(
            f"<h2>{html.escape(config)} &middot; "
            f"{html.escape(algorithm)}</h2>\n"
            + _scale_svg(rows) + "\n" + "\n".join(body))
    return (
        "<!doctype html>\n<html lang='en'>\n<head>\n<meta charset='utf-8'>\n"
        f"<title>{html.escape(title)}</title>\n"
        "<meta name='viewport' content='width=device-width, initial-scale=1'>"
        f"\n<style>{_CSS}</style>\n</head>\n<body>\n"
        f"<h1>{html.escape(title)}</h1>\n"
        "<div class='meta'>sparse COO matrices per device count; "
        "time-to-solution = tier-overlapped collective ms; bottleneck = "
        "busiest physical link's contention-aware ms.</div>\n"
        + "\n".join(sections) + "\n</body>\n</html>\n")


def export_scale_html(points: list[dict], path: str,
                      title: str = "Fleet scale curves") -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(render_scale_curve(points, title))
    return path


# ---------------------------------------------------------------------------
# compare page (``python -m repro_torch compare``): modeled vs measured
# ---------------------------------------------------------------------------
def render_compare(results, title: str = "Modeled vs measured") -> str:
    """Standalone page for one or many
    :class:`repro_torch.core.trace.compare.CompareResult` (one per algorithm
    binding)."""
    if not isinstance(results, (list, tuple)):
        results = [results]
    sections = []
    for res in results:
        sections.append(
            f"<h2>{html.escape(res.measured_label)} vs "
            f"{html.escape(res.modeled_label)} "
            f"[{html.escape(res.algorithm)}]</h2>\n" + compare_panel(res))
    return (
        "<!doctype html>\n<html lang='en'>\n<head>\n<meta charset='utf-8'>\n"
        f"<title>{html.escape(title)}</title>\n"
        "<meta name='viewport' content='width=device-width, initial-scale=1'>"
        f"\n<style>{_CSS}</style>\n</head>\n<body>\n"
        f"<h1>{html.escape(title)}</h1>\n"
        "<div class='meta'>per-collective cost-model seconds vs the wall "
        "time a real device trace measured; rel err = |measured &minus; "
        "modeled| / measured.</div>\n"
        + "\n".join(sections) + "\n</body>\n</html>\n")


def export_compare_html(results, path: str,
                        title: str = "Modeled vs measured") -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(render_compare(results, title))
    return path
