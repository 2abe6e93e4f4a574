"""Table-2/3 summaries of a collective-op stream.

The port of the summary half of ``repro.core.hlo_parser`` (``summarize``,
``total_wire_bytes``, ``count_by_opname``).  The HLO-text parser itself has
no counterpart here: the port's ops come from the interceptor.
"""
from __future__ import annotations

from typing import Iterable

from . import cost_models
from .decompose import decompose
from .events import CollectiveOp


def _op_wire_bytes(op: CollectiveOp, algorithm: str, topo) -> float:
    """Execution-weighted wire bytes for one op, decided **per replica
    group** with the shared hierarchical predicate -- so summaries
    degenerate to ring exactly where the placement and the cost model do
    (one predicate, no divergence), even when groups differ in how they
    straddle pods."""
    if op.kind == "collective-permute":
        if algorithm == "hierarchical" and topo is not None \
                and topo.num_pods > 1 and op.source_target_pairs:
            # the pod-leader relay adds ICI hops the flat pair count
            # misses; read the total off the same schedule the matrix
            # places so summary == matrix
            return decompose(op, algorithm, topo,
                             warn=False).total_bytes() * op.weight
        return op.wire_bytes_total(algorithm)
    if topo is None or not op.replica_groups:
        return op.wire_bytes_total(algorithm)
    total = 0.0
    for g in op.replica_groups:
        total += cost_models.wire_bytes_group_total(
            op.kind, op.payload_bytes, len(g), algorithm,
            pods=cost_models.effective_pods(op.kind, g, topo),
            vec=op.byte_vector())
    return total * op.weight


def summarize(ops: Iterable[CollectiveOp], algorithm: str = "ring",
              topo=None) -> dict:
    """Paper Table-2/3-style summary: per-kind call counts and byte totals.

    Counts are execution-weighted: an op with weight 64 contributes 64
    calls (the reference reads while-loop trip counts from the HLO; an
    eager torch program unrolls its loops, so its ops carry weight 1).
    ``topo`` (a
    :class:`~repro_torch.core.topology.MeshTopology`) makes the hierarchical
    algorithm's byte totals pod-aware.
    """
    table: dict[str, dict] = {}
    for op in ops:
        row = table.setdefault(
            op.kind,
            {"calls": 0, "payload_bytes": 0, "wire_bytes": 0.0},
        )
        row["calls"] += int(op.weight)
        row["payload_bytes"] += int(op.payload_bytes * op.num_groups * op.weight)
        row["wire_bytes"] += _op_wire_bytes(op, algorithm, topo)
        skew = op.skew()
        if skew > 1.0:
            # irregular ops surface their worst max/mean per-rank skew
            # (absent for regular kinds, so fixed-column consumers keep
            # their layout)
            row["max_skew"] = max(row.get("max_skew", 1.0), skew)
        if op.measured_s is not None:
            # trace-imported ops carry measured wall time (schema v9);
            # absent for purely modeled captures, so fixed-column
            # consumers keep their layout
            row["measured_s"] = (row.get("measured_s", 0.0)
                                 + float(op.measured_s))
    return table


def total_wire_bytes(ops: Iterable[CollectiveOp], algorithm: str = "ring",
                     topo=None) -> float:
    """Global bytes-on-the-wire across all devices (roofline numerator)."""
    return float(sum(_op_wire_bytes(op, algorithm, topo) for op in ops))


def count_by_opname(ops: Iterable[CollectiveOp]) -> dict[str, int]:
    out: dict[str, int] = {}
    for op in ops:
        key = op.op_name or "<unattributed>"
        out[key] = out.get(key, 0) + 1
    return out
