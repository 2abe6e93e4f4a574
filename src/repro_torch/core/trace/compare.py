"""Modeled-vs-measured comparison: the model-vs-measured loop, closed
(port of ``repro.core.trace.compare``).

Takes a *measured* report (ops carrying ``measured_s`` from a trace
import) and a *model* (the same report's own cost model, or a second
purely-modeled report, e.g. a sweep result for the same config) and pins
one against the other per collective:

* rows are matched by exact ``(phase, name)`` first, then per-kind FIFO
  (k-th measured all-reduce <-> k-th modeled all-reduce) -- trace tools
  rarely preserve HLO names, program order within a kind is the stable
  signal;
* each matched row gets ``rel_err = |measured - modeled| / measured``;
* aggregates (mean/max relative error, second totals) are bucketed
  per collective kind and per payload size class
  (<64KiB, 64KiB-1MiB, 1-16MiB, >=16MiB -- latency-bound through
  bandwidth-bound).

The result renders as a terminal table
(:meth:`CompareResult.table`) and JSON (:meth:`CompareResult.to_dict`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from ..reporter import format_table, human_bytes

#: payload size-class buckets (upper bound in bytes, label), ordered
SIZE_CLASSES = (
    (64 * 1024, "<64KiB"),
    (1 << 20, "64KiB-1MiB"),
    (16 << 20, "1-16MiB"),
    (None, ">=16MiB"),
)


def size_class(nbytes: float) -> str:
    for bound, label in SIZE_CLASSES:
        if bound is None or nbytes < bound:
            return label
    return SIZE_CLASSES[-1][1]


@dataclasses.dataclass
class CompareRow:
    """One matched collective: the model's seconds vs the trace's."""

    name: str
    kind: str
    phase: str
    payload_bytes: float
    modeled_s: Optional[float]
    measured_s: float

    @property
    def rel_err(self) -> Optional[float]:
        """``|measured - modeled| / measured``; None when either side is
        missing or the measurement is non-positive."""
        if self.modeled_s is None or self.measured_s <= 0:
            return None
        return abs(self.measured_s - self.modeled_s) / self.measured_s

    @property
    def size_class(self) -> str:
        return size_class(self.payload_bytes)

    def to_dict(self) -> dict:
        return {
            "name": self.name, "kind": self.kind, "phase": self.phase,
            "payload_bytes": float(self.payload_bytes),
            "modeled_s": (None if self.modeled_s is None
                          else float(self.modeled_s)),
            "measured_s": float(self.measured_s),
            "rel_err": self.rel_err,
            "size_class": self.size_class,
        }


def _bucket_stats(rows: list) -> dict:
    errs = [r.rel_err for r in rows if r.rel_err is not None]
    return {
        "count": len(rows),
        "measured_s": float(sum(r.measured_s for r in rows)),
        "modeled_s": float(sum(r.modeled_s or 0.0 for r in rows)),
        "mean_rel_err": (sum(errs) / len(errs)) if errs else None,
        "max_rel_err": max(errs) if errs else None,
    }


@dataclasses.dataclass
class CompareResult:
    """All matched rows plus the unmatched leftovers on both sides."""

    rows: list
    unmatched_measured: int = 0
    unmatched_modeled: int = 0
    measured_label: str = ""
    modeled_label: str = ""
    algorithm: str = "ring"

    def stats(self) -> dict:
        s = _bucket_stats(self.rows)
        s["unmatched_measured"] = self.unmatched_measured
        s["unmatched_modeled"] = self.unmatched_modeled
        return s

    def by_kind(self) -> dict:
        out: dict = {}
        for r in self.rows:
            out.setdefault(r.kind, []).append(r)
        return {k: _bucket_stats(v) for k, v in sorted(out.items())}

    def by_size_class(self) -> dict:
        out = {label: [] for _b, label in SIZE_CLASSES}
        for r in self.rows:
            out[r.size_class].append(r)
        return {label: _bucket_stats(v)
                for label, v in out.items() if v}

    def max_rel_err(self) -> Optional[float]:
        return self.stats()["max_rel_err"]

    def to_dict(self) -> dict:
        return {
            "measured": self.measured_label,
            "modeled": self.modeled_label,
            "algorithm": self.algorithm,
            "stats": self.stats(),
            "by_kind": self.by_kind(),
            "by_size_class": self.by_size_class(),
            "rows": [r.to_dict() for r in self.rows],
        }

    # -- terminal rendering -------------------------------------------------
    def table(self, title: str = "") -> str:
        """Per-collective modeled-vs-measured table plus the per-kind and
        per-size-class aggregate blocks."""
        def fmt_err(e):
            return "-" if e is None else f"{e * 100:.1f}%"

        def fmt_s(s):
            return "-" if s is None else f"{s * 1e3:.3f} ms"

        lines = []
        if title:
            lines.append(title)
        body = [[r.name, r.kind, r.phase or "-",
                 human_bytes(r.payload_bytes), fmt_s(r.modeled_s),
                 fmt_s(r.measured_s), fmt_err(r.rel_err)]
                for r in self.rows]
        lines.append(format_table(
            body, header=["Op", "Kind", "Phase", "Payload", "Modeled",
                          "Measured", "RelErr"]))
        for label, buckets in (("by kind", self.by_kind()),
                               ("by size class", self.by_size_class())):
            if not buckets:
                continue
            rows = [[k, str(b["count"]), fmt_s(b["modeled_s"]),
                     fmt_s(b["measured_s"]), fmt_err(b["mean_rel_err"]),
                     fmt_err(b["max_rel_err"])]
                    for k, b in buckets.items()]
            lines.append("")
            lines.append(format_table(
                rows, header=[label, "Ops", "Modeled", "Measured",
                              "MeanErr", "MaxErr"]))
        s = self.stats()
        lines.append("")
        tail = (f"{s['count']} matched"
                f" ({s['unmatched_measured']} measured /"
                f" {s['unmatched_modeled']} modeled unmatched);"
                f" mean rel err {fmt_err(s['mean_rel_err'])},"
                f" max {fmt_err(s['max_rel_err'])}")
        lines.append(tail)
        return "\n".join(lines)


def _measured_ops(report) -> list:
    return [op for op in report.compiled_ops if op.measured_s is not None]


def compare(measured, model=None, *, algorithm: Optional[str] = None
            ) -> CompareResult:
    """Build the :class:`CompareResult` for a measured report.

    ``measured`` is a :class:`~repro_torch.core.monitor.CommReport` whose ops
    carry ``measured_s`` (a trace import or a loaded v9 file).  ``model``
    picks the modeled side:

    * ``None`` -- the measured report's *own* cost model: each measured
      op's decomposition-schedule seconds under the report's topology
      (requires one);
    * another ``CommReport`` -- its ops' modeled seconds, matched to the
      measured ops by ``(phase, name)`` then per-kind FIFO.

    Raises :class:`ValueError` when there is nothing to compare (no
    measured ops, or no modeled seconds on the chosen side).
    """
    mops = _measured_ops(measured)
    if not mops:
        raise ValueError(
            f"report {measured.name!r} carries no measured ops"
            " (measured_s is unset on every op); import a trace first")

    if model is None:
        view = measured.view(algorithm)
        if view.topo is None:
            raise ValueError(
                f"report {measured.name!r} has no topology: its own ops"
                " cannot be modeled -- pass a modeled report or config")
        secs = view.op_seconds()
        rows = [CompareRow(name=op.name, kind=op.kind, phase=op.phase,
                           payload_bytes=op.payload_bytes,
                           modeled_s=s, measured_s=op.measured_s)
                for op, s in zip(view.ops, secs)
                if op.measured_s is not None]
        return CompareResult(
            rows=rows, measured_label=measured.name,
            modeled_label=f"{measured.name} (own model)",
            algorithm=view.algorithm)

    mview = model.view(algorithm)
    if mview.topo is None:
        raise ValueError(
            f"model report {model.name!r} has no topology --"
            " no modeled seconds to compare against")
    model_secs = mview.op_seconds()
    model_ops = list(mview.ops)

    used = [False] * len(model_ops)
    by_name = {}
    for i, op in enumerate(model_ops):
        by_name.setdefault((op.phase, op.name), []).append(i)
    rows: list[CompareRow] = []
    unmatched = 0

    def claim(i, mop):
        used[i] = True
        op = model_ops[i]
        rows.append(CompareRow(
            name=op.name, kind=op.kind, phase=op.phase,
            payload_bytes=op.payload_bytes, modeled_s=model_secs[i],
            measured_s=mop.measured_s))

    fifo: list = []
    for mop in mops:
        cands = by_name.get((mop.phase, mop.name), [])
        i = next((j for j in cands if not used[j]), None)
        if i is not None:
            claim(i, mop)
        else:
            fifo.append(mop)
    for mop in fifo:
        i = next((j for j, op in enumerate(model_ops)
                  if not used[j] and op.kind == mop.kind), None)
        if i is not None:
            claim(i, mop)
        else:
            unmatched += 1

    result = CompareResult(
        rows=rows, unmatched_measured=unmatched,
        unmatched_modeled=used.count(False),
        measured_label=measured.name, modeled_label=model.name,
        algorithm=mview.algorithm)
    if not rows:
        raise ValueError(
            f"no measured op of {measured.name!r} matched any modeled op"
            f" of {model.name!r} (kinds measured:"
            f" {sorted({o.kind for o in mops})}, modeled:"
            f" {sorted({o.kind for o in model_ops})})")
    if all(r.rel_err is None or not math.isfinite(r.rel_err)
           for r in result.rows):
        raise ValueError(
            "no finite relative error in any matched row -- measured"
            " durations are zero or modeled seconds missing")
    return result
