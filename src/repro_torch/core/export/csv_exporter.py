"""CSV export (port of ``repro.core.export.csv_exporter``): communication
matrices + per-primitive summary rows, byte for byte the reference's.

Four products:

* ``export_matrix_csv`` -- one ``(d+1) x (d+1)`` matrix as CSV.  Dense
  matrices keep the square layout (paper Fig. 2/3 data, host row/column
  first, identical to ``reporter.matrix_to_csv``); sparse COO matrices
  write long-form ``src,dst,bytes`` rows instead -- the square form is
  exactly the O(d^2) materialization the sparse path exists to avoid;
* ``export_summary_csv`` -- long-form rows
  ``config,mesh,algorithm,primitive,calls,payload_bytes,wire_bytes`` across
  one or many reports -- the sweep's machine-readable comparison table;
* ``export_compare_csv`` -- one modeled-vs-measured row per matched
  collective of a trace-import comparison
  (``python -m repro_torch compare``);
* ``export_scale_csv`` -- one row per (config, algorithm, device count)
  from a ``sweep --scale-curve`` run.
"""
from __future__ import annotations

import os

from .. import reporter
from ..sparse import is_sparse


def export_matrix_csv(report, path: str) -> str:
    mat = report.matrix
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if is_sparse(mat):
        body = "\n".join(["src,dst,bytes"] + mat.to_csv_rows())
    else:
        body = reporter.matrix_to_csv(mat)
    with open(path, "w") as f:
        f.write(body + "\n")
    return path


def summary_rows(report) -> list[dict]:
    """Long-form per-primitive rows for one report."""
    meta = getattr(report, "meta", {}) or {}
    mesh = meta.get("mesh", f"{report.num_devices}dev")
    config = meta.get("config", report.name)
    rows = []
    for kind in sorted(report.compiled_summary):
        row = report.compiled_summary[kind]
        rows.append({
            "config": config,
            "mesh": mesh,
            "algorithm": getattr(report, "algorithm", "ring"),
            "num_devices": report.num_devices,
            "primitive": kind,
            "calls": row.get("calls", 0),
            "payload_bytes": row.get("payload_bytes", 0),
            "wire_bytes": round(float(row.get("wire_bytes", 0.0)), 3),
        })
    return rows


_COLUMNS = ("config", "mesh", "algorithm", "num_devices", "primitive",
            "calls", "payload_bytes", "wire_bytes")


def export_summary_csv(reports, path: str) -> str:
    """Write the long-form comparison CSV for one or many reports."""
    if not isinstance(reports, (list, tuple)):
        reports = [reports]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    lines = [",".join(_COLUMNS)]
    for rep in reports:
        for row in summary_rows(rep):
            lines.append(",".join(str(row[c]) for c in _COLUMNS))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


# stable schema for ``python -m repro_torch compare`` output (the
# reference's header); tests pin it
COMPARE_COLUMNS = ("op", "kind", "phase", "payload_bytes", "size_class",
                   "modeled_s", "measured_s", "rel_err")


def export_compare_csv(result, path: str) -> str:
    """Write one modeled-vs-measured row per matched collective (a
    :class:`repro_torch.core.trace.compare.CompareResult`), in match order."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    lines = [",".join(COMPARE_COLUMNS)]
    for r in result.rows:
        d = r.to_dict()
        d["op"] = d.pop("name")
        lines.append(",".join(
            "" if d[c] is None else str(d[c]) for c in COMPARE_COLUMNS))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


# stable schema for ``sweep --scale-curve`` output; tests pin the header
SCALE_COLUMNS = ("config", "algorithm", "devices", "pods", "ops",
                 "wire_bytes", "ici_ms", "dcn_ms", "overlap_ms",
                 "bottleneck_link", "bottleneck_ms", "nnz", "build_ms")


def export_scale_csv(points, path: str) -> str:
    """Write scale-curve rows (``repro_torch.scale.ScalePoint.row`` dicts), one
    per (config, algorithm, device count), sorted for diff-stable goldens."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    lines = [",".join(SCALE_COLUMNS)]
    for p in sorted(points, key=lambda r: (r["config"], r["algorithm"],
                                           r["devices"])):
        lines.append(",".join(str(p[c]) for c in SCALE_COLUMNS))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path
