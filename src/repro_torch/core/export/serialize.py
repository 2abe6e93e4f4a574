"""Lossless CommReport <-> plain-dict serialization (port of
``repro.core.export.serialize``).

Writes schema ``repro.comm_report.v9`` in the reference's spelling, so the
reference's ``report_from_dict`` loads the port's files, and loads every
schema the reference accepts (v1 ... v9).  Matrices are dense nested lists,
or for a sparse report the schema-v6 COO dict ``{"format": "coo", "side",
"src", "dst", "val"}``; loading restores the same representation.  Reports
with a topology carry the derived v2/v3 physical-link sections
(``link_matrix``, ``links``, ``link_summary``, ``link_tiers``) and the
``overlap`` section; a sparse report omits the O(d^2) ``link_matrix`` and
keeps only the ``links`` rows that carried bytes, as the reference does.
Reports with trace-imported ops carry the v9 ``trace_meta`` section.
``include_lint=True`` writes the optional schema-v7 ``lint`` section (the
default binding's findings), and a file that has one gets its findings back
on load as ``_lint_findings``, which ``CommReport.lint()`` serves; the
per-op ``operand_names``/``use_global_device_ids`` keys are written, and
default when absent.  The optional ``hlo_gz`` and ``schedules`` sections are
not written (the port has no compiled module) and, like the derived
sections, are not restored, so the reference loads the port's files and
the port loads the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..events import (CollectiveOp, HostTransfer, PhaseRecord, Shape,
                      TraceEvent)
from ..sparse import SparseCommMatrix, is_sparse
from ..topology import HardwareSpec, MeshTopology

SCHEMA = "repro.comm_report.v9"
ACCEPTED_SCHEMAS = tuple(f"repro.comm_report.v{i}" for i in range(9, 0, -1))


# ---------------------------------------------------------------------------
# leaf types
# ---------------------------------------------------------------------------
def shape_to_dict(s: Shape) -> dict:
    return {"dtype": s.dtype, "dims": list(s.dims)}


def shape_from_dict(d: dict) -> Shape:
    return Shape(dtype=d["dtype"], dims=tuple(d["dims"]))


def op_to_dict(op: CollectiveOp) -> dict:
    d = {
        "kind": op.kind,
        "name": op.name,
        "result_shapes": [shape_to_dict(s) for s in op.result_shapes],
        # legacy spelling kept for external consumers of dump_report files
        "shapes": [repr(s) for s in op.result_shapes],
        "replica_groups": [list(g) for g in op.replica_groups],
        "channel_id": op.channel_id,
        "dimensions": list(op.dimensions),
        "source_target_pairs": [list(p) for p in op.source_target_pairs],
        "op_name": op.op_name,
        "weight": op.weight,
        "phase": op.phase,
        "operand_names": list(op.operand_names),
        "use_global_device_ids": op.use_global_device_ids,
        "payload_bytes": op.payload_bytes,
        "group_size": op.group_size,
        "num_groups": op.num_groups,
    }
    # schema v8: irregular ops only -- regular ops keep the v7 spelling
    if op.bytes_per_rank_vec is not None:
        d["bytes_per_rank_vec"] = [float(x) for x in op.bytes_per_rank_vec]
    # schema v9: measured (imported-trace) ops only -- modeled ops keep
    # the v8 spelling, so all-modeled files stay byte-identical
    if op.measured_s is not None:
        d["measured_s"] = float(op.measured_s)
    return d


def op_from_dict(d: dict) -> CollectiveOp:
    return CollectiveOp(
        kind=d["kind"],
        name=d["name"],
        result_shapes=[shape_from_dict(s) for s in d["result_shapes"]],
        replica_groups=[list(g) for g in d["replica_groups"]],
        channel_id=d.get("channel_id"),
        dimensions=tuple(d.get("dimensions", ())),
        source_target_pairs=[tuple(p) for p in d.get("source_target_pairs", [])],
        op_name=d.get("op_name", ""),
        weight=float(d.get("weight", 1.0)),
        phase=d.get("phase", ""),
        operand_names=list(d.get("operand_names", [])),
        use_global_device_ids=bool(d.get("use_global_device_ids", False)),
        bytes_per_rank_vec=(list(d["bytes_per_rank_vec"])
                            if d.get("bytes_per_rank_vec") is not None
                            else None),
        measured_s=(float(d["measured_s"])
                    if d.get("measured_s") is not None else None),
    )


def event_to_dict(e: TraceEvent) -> dict:
    return {
        "primitive": e.primitive,
        "axis_name": e.axis_name,
        "arg_shapes": [shape_to_dict(s) for s in e.arg_shapes],
        "axis_size": e.axis_size,
        "call_site": e.call_site,
        "phase": e.phase,
    }


def event_from_dict(d: dict) -> TraceEvent:
    return TraceEvent(
        primitive=d["primitive"],
        axis_name=d["axis_name"],
        arg_shapes=[shape_from_dict(s) for s in d["arg_shapes"]],
        axis_size=d.get("axis_size"),
        call_site=d.get("call_site", ""),
        phase=d.get("phase", ""),
    )


def transfer_to_dict(t: HostTransfer) -> dict:
    return {"direction": t.direction, "device": t.device,
            "nbytes": t.nbytes, "label": t.label, "phase": t.phase}


def transfer_from_dict(d: dict) -> HostTransfer:
    return HostTransfer(direction=d["direction"], device=d["device"],
                        nbytes=d["nbytes"], label=d.get("label", ""),
                        phase=d.get("phase", ""))


def phase_to_dict(p: PhaseRecord) -> dict:
    return {"name": p.name, "num_captures": p.num_captures,
            "trace_seconds": p.trace_seconds,
            "compile_seconds": p.compile_seconds}


def phase_from_dict(d: dict) -> PhaseRecord:
    return PhaseRecord(name=d["name"],
                       num_captures=int(d.get("num_captures", 0)),
                       trace_seconds=float(d.get("trace_seconds", 0.0)),
                       compile_seconds=float(d.get("compile_seconds", 0.0)))


def topo_to_dict(t: Optional[MeshTopology]) -> Optional[dict]:
    if t is None:
        return None
    return {
        "axis_names": list(t.axis_names),
        "axis_sizes": list(t.axis_sizes),
        "dcn_axes": list(t.dcn_axes),
        "hw": dataclasses.asdict(t.hw),
    }


def topo_from_dict(d: Optional[dict]) -> Optional[MeshTopology]:
    if d is None:
        return None
    return MeshTopology(
        axis_names=tuple(d["axis_names"]),
        axis_sizes=tuple(d["axis_sizes"]),
        hw=HardwareSpec(**d["hw"]),
        dcn_axes=tuple(d["dcn_axes"]),
    )


# ---------------------------------------------------------------------------
# matrices: dense nested-list vs sparse COO dict (schema v6)
# ---------------------------------------------------------------------------
def matrix_to_jsonable(mat):
    """Dense ndarray -> nested list; sparse :class:`SparseCommMatrix` ->
    ``{"format": "coo", ...}`` dict whose size is O(nnz), never O(d^2)."""
    if is_sparse(mat):
        return {
            "format": "coo",
            "side": mat.side,
            "src": mat.src.tolist(),
            "dst": mat.dst.tolist(),
            "val": mat.val.tolist(),
        }
    return np.asarray(mat).tolist()


def matrix_from_jsonable(j):
    """The inverse: the COO dict form restores a ``SparseCommMatrix``
    (already coalesced on write), anything else the dense float64 array."""
    if isinstance(j, dict):
        fmt = j.get("format")
        if fmt != "coo":
            raise ValueError(f"unknown matrix format {fmt!r}; expected 'coo'")
        return SparseCommMatrix(
            int(j["side"]) - 1,
            np.asarray(j["src"], dtype=np.int64),
            np.asarray(j["dst"], dtype=np.int64),
            np.asarray(j["val"], dtype=np.float64),
            coalesced=True,
        )
    return np.asarray(j, dtype=np.float64)


# ---------------------------------------------------------------------------
# whole-report round-trip
# ---------------------------------------------------------------------------
def _jsonable_cost(cost: dict) -> dict:
    return {k: float(v) for k, v in (cost or {}).items()
            if isinstance(v, (int, float))}


def _link_section(report) -> dict:
    """Schema v2+v3 physical-link view (empty when the report has no topo).

    For sparse (fleet-scale) reports the dense ``link_matrix`` is omitted
    -- it is the same O(d^2) array the sparse path avoids -- and ``links``
    keeps only the rows that actually carried bytes; both are derived
    data, recomputed from ``ops`` + ``topo`` on load either way.
    """
    lu = report.link_utilization() if report.topo is not None else None
    if lu is None:
        return {}
    out = {} if is_sparse(report.matrix) else {
        "link_matrix": lu.matrix().tolist()}
    rows = lu.rows()
    if is_sparse(report.matrix):
        rows = [r for r in rows if r["bytes"] > 0]
    ici_s, dcn_s = report.collective_seconds_split()
    out.update({
        "links": rows,
        "link_summary": lu.summary(),
        "link_tiers": lu.tier_summary(),
        "overlap": {
            "collective_ici_s": ici_s,
            "collective_dcn_s": dcn_s,
            "collective_overlap_s": max(ici_s, dcn_s),
            "collective_serial_s": ici_s + dcn_s,
        },
    })
    return out


def report_to_dict(report, *, include_lint: bool = False) -> dict:
    """``CommReport`` -> JSON-serializable dict (schema ``v9``), with the
    default binding's lint findings when ``include_lint``."""
    out = {"schema": SCHEMA, **_link_section(report)}
    if report.trace_meta:
        out["trace_meta"] = dict(report.trace_meta)
    if include_lint:
        out["lint"] = [f.to_dict() for f in report.lint()]
    out.update({
        "phases": [phase_to_dict(p) for p in report.phases],
        "name": report.name,
        "num_devices": report.num_devices,
        "algorithm": report.algorithm,
        "summary": report.compiled_summary,
        "traced_summary": report.traced_summary,
        "ops": [op_to_dict(op) for op in report.compiled_ops],
        "traced": [event_to_dict(e) for e in report.traced],
        "matrix": matrix_to_jsonable(report.matrix),
        "per_primitive": {k: matrix_to_jsonable(m)
                          for k, m in report.per_primitive.items()},
        "cost": _jsonable_cost(report.cost),
        "memory_stats": report.memory_stats,
        "trace_seconds": report.trace_seconds,
        "compile_seconds": report.compile_seconds,
        "topo": topo_to_dict(report.topo),
        "host_transfers": [transfer_to_dict(t) for t in report.host_transfers],
        "meta": dict(report.meta or {}),
    })
    return out


def report_from_dict(d: dict):
    """Dict (schema ``v1`` ... ``v9``) -> ``CommReport``.

    Derived sections (links, overlap, schedules) are not restored: the
    report's views recompute them from ``ops`` + ``topo``.  ``hlo_gz`` is
    ignored; a ``lint`` section comes back as ``_lint_findings``.
    """
    from ..monitor import CommReport  # deferred: monitor imports this module

    schema = d.get("schema")
    if schema is not None and schema not in ACCEPTED_SCHEMAS:
        raise ValueError(
            f"unknown report schema {schema!r}; accepted: {ACCEPTED_SCHEMAS}")
    report = CommReport(
        name=d["name"],
        num_devices=int(d["num_devices"]),
        traced=[event_from_dict(e) for e in d.get("traced", [])],
        compiled_ops=[op_from_dict(o) for o in d.get("ops", [])],
        traced_summary=d.get("traced_summary", {}),
        compiled_summary=d.get("summary", {}),
        matrix=matrix_from_jsonable(d["matrix"]),
        per_primitive={k: matrix_from_jsonable(m)
                       for k, m in d.get("per_primitive", {}).items()},
        cost=d.get("cost", {}),
        memory_stats=d.get("memory_stats"),
        trace_seconds=float(d.get("trace_seconds", 0.0)),
        compile_seconds=float(d.get("compile_seconds", 0.0)),
        topo=topo_from_dict(d.get("topo")),
        host_transfers=[transfer_from_dict(t)
                        for t in d.get("host_transfers", [])],
        algorithm=d.get("algorithm", "ring"),
        meta=dict(d.get("meta", {})),
        phases=[phase_from_dict(p) for p in d.get("phases", [])],
        trace_meta=(dict(d["trace_meta"])
                    if d.get("trace_meta") else None),
    )
    if "lint" in d:
        from ..lint import LintFinding   # deferred: keep leaf import light
        report._lint_findings = [LintFinding.from_dict(x)
                                 for x in d["lint"]]
    return report
