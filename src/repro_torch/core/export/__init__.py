"""Report export (port of ``repro.core.export``): one serializer, many
renderings.

* ``json``     -- lossless schema-v9 report (``CommReport.save``/``load``);
* ``csv``      -- long-form per-primitive comparison rows (+ matrix CSV);
* ``html``     -- self-contained heatmap dashboard of the ``(d+1)^2``
                  communication matrices (paper Figs. 2/3);
* ``perfetto`` -- Chrome trace-event timeline of the collective schedule
                  (open in https://ui.perfetto.dev).

``export_report`` writes one report in one format; ``export_comparison``
writes a whole sweep's artifact set.  For the same report every format is
the reference's, byte for byte.
"""
from __future__ import annotations

import os

from . import serialize
from .csv_exporter import export_matrix_csv, export_summary_csv, summary_rows
from .html_exporter import export_html, render_dashboard
from .json_exporter import (export_comparison_json, export_json, load_json,
                            load_json_reports)
from .perfetto import chrome_trace, export_perfetto
from .serialize import SCHEMA, report_from_dict, report_to_dict

FORMATS = ("json", "csv", "html", "perfetto")

SUFFIXES = {"json": ".json", "csv": ".csv", "html": ".html",
            "perfetto": ".trace.json"}


def _check_formats(formats):
    unknown = [f for f in formats if f not in FORMATS]
    if unknown:
        raise ValueError(f"unknown format(s) {unknown}; known: {FORMATS}")


def export_report(report, fmt: str, path: str) -> str:
    """Write one report in ``fmt`` (one of :data:`FORMATS`) to ``path``."""
    _check_formats([fmt])
    if fmt == "json":
        return export_json(report, path)
    if fmt == "csv":
        return export_summary_csv(report, path)
    if fmt == "html":
        return export_html(report, path, title=report.name)
    return export_perfetto(report, path)


def export_comparison(reports: list, out_dir: str, formats=FORMATS,
                      stem: str = "sweep") -> dict[str, str]:
    """Write the comparative artifact set for many reports.

    Returns ``{format: path}``.  ``json``/``csv`` hold one row/document per
    report; ``html`` is a single dashboard; ``perfetto`` a single timeline
    with one process per report.
    """
    _check_formats(formats)
    os.makedirs(out_dir, exist_ok=True)
    paths: dict[str, str] = {}
    for fmt in formats:
        path = os.path.join(out_dir, stem + SUFFIXES[fmt])
        if fmt == "json":
            export_comparison_json(reports, path)
        elif fmt == "csv":
            export_summary_csv(reports, path)
        elif fmt == "html":
            export_html(reports, path, title=f"{stem}: communication matrices")
        else:
            export_perfetto(reports, path)
        paths[fmt] = path
    return paths


__all__ = [
    "FORMATS", "SCHEMA", "SUFFIXES", "chrome_trace", "export_comparison",
    "export_comparison_json", "export_html", "export_json",
    "export_matrix_csv", "export_perfetto", "export_report",
    "export_summary_csv", "load_json", "load_json_reports",
    "render_dashboard", "report_from_dict", "report_to_dict", "serialize",
    "summary_rows",
]
