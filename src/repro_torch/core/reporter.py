"""Human-readable reports: the paper's tables and heatmaps (port of the
terminal half of ``repro.core.reporter``).

* per-primitive call-count / byte tables (paper Tables 2 & 3), overall and
  per session phase,
* the ``(d+1) x (d+1)`` communication matrix rendered as an ASCII heatmap in
  log scale (paper Figs. 2 & 3),
* the traced-vs-issued diff table,
* the lint findings table.
"""
from __future__ import annotations

import math

import numpy as np

# ---------------------------------------------------------------------------
# formatting helpers
# ---------------------------------------------------------------------------
_UNITS = ["B", "KiB", "MiB", "GiB", "TiB", "PiB"]


def human_bytes(n: float) -> str:
    n = float(n)
    if n <= 0:
        return "0 B"
    k = min(len(_UNITS) - 1, int(math.log(n, 1024)))
    return f"{n / 1024 ** k:,.2f} {_UNITS[k]}"


def format_table(rows: list[list[str]], header: list[str]) -> str:
    widths = [len(h) for h in header]
    for r in rows:
        for i, c in enumerate(r):
            widths[i] = max(widths[i], len(str(c)))
    def fmt(row):
        return " | ".join(str(c).ljust(w) for c, w in zip(row, widths))
    sep = "-+-".join("-" * w for w in widths)
    return "\n".join([fmt(header), sep] + [fmt(r) for r in rows])


def lint_table(findings, title: str = "") -> str:
    """Findings table (:class:`~repro_torch.core.lint.LintFinding`
    records): rule, severity, ops, modeled savings -- already sorted
    errors-first by the lint pass."""
    if not findings:
        out = "(no lint findings)"
        return f"== {title} ==\n{out}" if title else out
    rows = []
    for f in findings:
        ops = ",".join(f.op_names)
        if len(ops) > 40:
            ops = ops[:37] + f"...({len(f.op_names)} ops)"
        rows.append([
            f.rule_id, f.severity, f.phase or "-", ops,
            f"{f.est_savings_s * 1e3:.3f} ms",
            human_bytes(f.est_dcn_bytes_saved),
            f.suggested_fix,
        ])
    out = format_table(rows, ["Rule", "Severity", "Phase", "Ops",
                              "Est. Savings", "DCN Bytes Saved",
                              "Suggested Fix"])
    if title:
        out = f"== {title} ==\n{out}"
    return out


# ---------------------------------------------------------------------------
# paper Table 2/3 — primitive usage analysis
# ---------------------------------------------------------------------------
def primitive_usage_table(summary: dict, title: str = "") -> str:
    """``summary`` maps primitive name -> {calls, payload_bytes[,
    wire_bytes][, max_skew][, measured_s]}.  ``max_skew`` (worst max/mean
    per-rank byte ratio of any irregular op of that kind) adds a Skew
    column only when some row carries it; ``measured_s`` (trace-imported
    wall time, schema v9) likewise adds a Measured column -- regular,
    purely modeled captures keep the classic layout."""
    has_skew = any("max_skew" in summary[k] for k in summary)
    has_meas = any("measured_s" in summary[k] for k in summary)
    rows = []
    for name in sorted(summary, key=lambda k: -summary[k].get("payload_bytes", 0)):
        row = summary[name]
        cells = [name, f"{row['calls']:,}", human_bytes(row.get("payload_bytes", 0))]
        if "wire_bytes" in row:
            cells.append(human_bytes(row["wire_bytes"]))
        if has_skew:
            cells.append(f"{row.get('max_skew', 1.0):.2f}x")
        if has_meas:
            cells.append(f"{row.get('measured_s', 0.0) * 1e3:.3f} ms")
        rows.append(cells)
    header = ["Communication Type", "Number of Calls", "Total Size"]
    if rows and len(rows[0]) >= 4 + has_skew + has_meas:
        header.append("Wire Bytes")
    if has_skew:
        header.append("Skew (max/mean)")
    if has_meas:
        header.append("Measured")
    out = format_table(rows, header)
    if title:
        out = f"== {title} ==\n{out}"
    return out


# ---------------------------------------------------------------------------
# session phases — per-phase Table 2 breakdown and phase-vs-phase diff
# ---------------------------------------------------------------------------
def phase_usage_table(phase_summaries: dict, title: str = "") -> str:
    """Per-phase primitive usage: one row per (phase, primitive).

    ``phase_summaries`` maps phase name (in session order) to a Table-2
    style summary dict.  A phase with no compiled collectives still gets a
    row -- an optimizer phase that moves no bytes is a finding, not an
    omission.
    """
    rows = []
    for phase, summary in phase_summaries.items():
        if not summary:
            rows.append([phase, "(none)", "0", "0 B", "0 B"])
            continue
        for name in sorted(summary,
                           key=lambda k: -summary[k].get("payload_bytes", 0)):
            r = summary[name]
            rows.append([phase, name, f"{r.get('calls', 0):,}",
                         human_bytes(r.get("payload_bytes", 0)),
                         human_bytes(r.get("wire_bytes", 0))])
    out = format_table(rows, ["Phase", "Communication Type",
                              "Number of Calls", "Total Size", "Wire Bytes"])
    if title:
        out = f"== {title} ==\n{out}"
    return out


# ---------------------------------------------------------------------------
# paper Fig. 2/3 — communication-matrix heatmap (log scale), ASCII rendering
# ---------------------------------------------------------------------------
_SHADES = " .:-=+*#%@"


def coarsen_matrix(mat, max_devices: int = 32) -> tuple[np.ndarray, int]:
    """Block-sum the device block of a (d+1)x(d+1) matrix down to at most
    ``max_devices`` rows/cols (host row/col 0 stays exact).

    Returns ``(matrix, block)`` where ``block`` is the number of devices per
    aggregated row (1 when no coarsening happened).  Accepts the dense array
    or a :class:`~repro_torch.core.sparse.SparseCommMatrix`, coarsened
    straight from its COO entries (the fleet-scale path never builds the
    dense form).
    """
    from .sparse import SparseCommMatrix
    if isinstance(mat, SparseCommMatrix):
        return mat.coarsen(max_devices)
    m = np.asarray(mat, dtype=np.float64)
    d = m.shape[0]
    if d <= max_devices + 1:
        return m, 1
    dev = m[1:, 1:]
    k = math.ceil(dev.shape[0] / max_devices)
    nb = math.ceil(dev.shape[0] / k)
    pad = nb * k - dev.shape[0]
    dev = np.pad(dev, ((0, pad), (0, pad)))
    dev = dev.reshape(nb, k, nb, k).sum(axis=(1, 3))
    hm = np.zeros((nb + 1, nb + 1))
    hm[0, 0] = m[0, 0]
    hm[1:, 1:] = dev
    hm[0, 1:] = np.pad(m[0, 1:], (0, pad)).reshape(nb, k).sum(1)
    hm[1:, 0] = np.pad(m[1:, 0], (0, pad)).reshape(nb, k).sum(1)
    return hm, k


def ascii_heatmap(mat: np.ndarray, title: str = "", log: bool = True,
                  max_devices: int = 32) -> str:
    """Render a (d+1)x(d+1) byte matrix as an ASCII heatmap.

    Row/col 0 is the host (paper convention).  For d > max_devices the matrix
    is coarsened by block-summing so the rendering stays terminal-sized.
    """
    m, block = coarsen_matrix(mat, max_devices=max_devices)
    blk = f" (device blocks of {block})" if block > 1 else ""
    v = m.copy()
    if log:
        with np.errstate(divide="ignore"):
            v = np.where(v > 0, np.log10(v), 0.0)
    vmax = v.max() if v.max() > 0 else 1.0
    lines = []
    if title or blk:
        lines.append(f"== {title}{blk} ==")
    lines.append("    " + "".join(f"{j:>2d}" for j in range(m.shape[1])))
    for i in range(m.shape[0]):
        row = "".join(
            " " + _SHADES[min(len(_SHADES) - 1, int(v[i, j] / vmax * (len(_SHADES) - 1)))]
            for j in range(m.shape[1])
        )
        lines.append(f"{i:>3d} {row}")
    lines.append(f"max cell = {human_bytes(m.max())}"
                 + (" (log scale)" if log else ""))
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# traced-vs-compiled diff (beyond paper)
# ---------------------------------------------------------------------------
def diff_table(traced_summary: dict, compiled_summary: dict) -> str:
    """Logical (application) vs physical (compiler) collective comparison."""
    # map HLO kinds to NCCL-ish names for alignment
    kind_to_name = {
        "all-reduce": "AllReduce",
        "all-gather": "AllGather",
        "reduce-scatter": "ReduceScatter",
        "all-to-all": "AllToAll",
        "ragged-all-to-all": "AllToAll",
        "collective-permute": "SendRecv",
        "collective-broadcast": "Broadcast",
    }
    phys: dict[str, dict] = {}
    for kind, row in compiled_summary.items():
        name = kind_to_name.get(kind, kind)
        agg = phys.setdefault(name, {"calls": 0, "payload_bytes": 0})
        agg["calls"] += row["calls"]
        agg["payload_bytes"] += row["payload_bytes"]
    names = sorted(set(traced_summary) | set(phys))
    rows = []
    for n in names:
        t = traced_summary.get(n, {"calls": 0, "payload_bytes": 0})
        p = phys.get(n, {"calls": 0, "payload_bytes": 0})
        rows.append([
            n, f"{t['calls']:,}", human_bytes(t["payload_bytes"]),
            f"{p['calls']:,}", human_bytes(p["payload_bytes"]),
        ])
    return format_table(
        rows,
        ["Primitive", "Traced Calls", "Traced Bytes",
         "Compiled Ops", "Compiled Bytes"],
    )
