"""JSON export (port of ``repro.core.export.json_exporter``): the
schema-``v9`` report dict, verbatim, on disk."""
from __future__ import annotations

import json
import os

from . import serialize


def export_json(report, path: str, *, include_schedules: bool = False,
                include_lint: bool = False) -> str:
    """Write one report as schema-v9 JSON.  Returns ``path``.

    ``include_schedules=True`` adds the optional per-op decomposition-
    schedule summaries; ``include_lint=True`` adds (and loaders restore)
    the default binding's lint findings.  The reference's ``include_hlo``
    has no counterpart: a capture compiles nothing.
    """
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(serialize.report_to_dict(
            report, include_schedules=include_schedules,
            include_lint=include_lint), f, indent=1)
    return path


def export_comparison_json(reports: list, path: str) -> str:
    """Write a list of reports as one JSON document (sweep output)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"schema": serialize.SCHEMA + ".sweep",
                   "reports": [serialize.report_to_dict(r) for r in reports]},
                  f, indent=1)
    return path


def load_json_reports(path: str) -> list:
    """Read any JSON either package writes: a single report, a report-cache
    entry, or a sweep comparison document.  Always returns a list."""
    with open(path) as f:
        d = json.load(f)
    if isinstance(d.get("reports"), list):
        # a sweep comparison document (export_comparison_json)
        return [serialize.report_from_dict(r) for r in d["reports"]]
    if "name" not in d and isinstance(d.get("report"), dict):
        # a report-cache entry: the report dict is wrapped with its meta
        report = serialize.report_from_dict(d["report"])
        report.meta = dict(d.get("meta", {}))
        return [report]
    return [serialize.report_from_dict(d)]


def load_json(path: str):
    """Read exactly one report (see :func:`load_json_reports`)."""
    reports = load_json_reports(path)
    if len(reports) != 1:
        raise ValueError(
            f"{path} holds {len(reports)} reports (a sweep document); "
            "use load_json_reports")
    return reports[0]
