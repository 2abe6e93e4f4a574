"""Fleet-scale projection: one monitored program, many device counts (port
of ``repro.scale``).

:func:`scale_curve` answers the question the paper's per-run matrices
cannot: *how does this workload's communication scale?*  A report is
captured once on a small base mesh, then its op stream is **projected**
onto synthetic fleet topologies -- 256 / 1k / 4k / 16k devices -- and every
derived artifact (sparse matrix, per-tier times, bottleneck link) is
recomputed per point.  No new capture, no device mesh, and critically **no
dense matrix**: every point binds a :class:`~repro_torch.core.views.
CommView` with ``sparse=True``, so the 16k-device point never allocates the
~2 GiB ``(d+1)^2`` array.

Projection rule (documented convention, pinned by tests):

* device ``d`` of the base mesh becomes the contiguous block
  ``[d*F, (d+1)*F)`` of the fleet, ``F = devices / base_devices`` -- so
  replica groups stay a partition, group *count* is preserved, and group
  *size* grows proportionally (``n' = n * F``);
* collective-permute pairs map ``(s, t) -> (s*F, t*F)`` (injective, so no
  self-pairs or duplicates appear);
* all-to-all groups additionally split into pod-sized chunks
  (:data:`POD_DEVICES`) -- fleet-scale a2a is pod-local in practice, and
  an unsplit 16k-wide a2a would place ``n^2`` edges;
* result shapes (and hence per-primitive payload semantics) are held
  constant: per-device tensor shards do not change as the job scales out;
* an *irregular* op (``bytes_per_rank_vec``) expands its vector with the
  group -- each base entry tiles over its clone block and renormalizes by
  the factor (``repeat(vec, F) / F``), so the group total is preserved
  and a uniform vector stays the scalar path's equal shares.  When an
  irregular a2a splits into pod chunks, each chunk op carries its own
  *slice* of the expanded vector scaled by the chunk count (the same
  convention that keeps every scalar chunk's payload at the base
  payload), so the hot-expert pod stays hot instead of being flattened
  to the group mean.

Topologies come from :meth:`repro_torch.core.topology.MeshTopology.fleet`:
2D torus pods of ``16 x 16`` joined by a DCN ``pod`` axis.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, Optional

import numpy as np

from repro_torch.core.events import CollectiveOp
from repro_torch.core.reporter import format_table, human_bytes
from repro_torch.core.topology import MeshTopology
from repro_torch.core.views import CommView

POD_SIDE = 16
POD_DEVICES = POD_SIDE * POD_SIDE
DEFAULT_SCALE_POINTS = (256, 1024, 4096, 16384)

_A2A_KINDS = ("all-to-all", "ragged-all-to-all")


def fleet_topology(num_devices: int) -> MeshTopology:
    """The synthetic topology a scale point projects onto."""
    return MeshTopology.fleet(num_devices, pod_side=POD_SIDE)


def _scale_group(group: list[int], factor: int) -> list[int]:
    return [d * factor + i for d in group for i in range(factor)]


def _chunk(group: list[int], size: int) -> list[list[int]]:
    return [group[i:i + size] for i in range(0, len(group), size)]


def _scale_vec(op: CollectiveOp, factor: int):
    """Expanded per-rank byte vector (``repeat(vec, F) / F``), or ``None``
    for regular ops.  Tiling preserves each base rank's *share* across its
    clone block; dividing by the factor keeps the group total constant,
    so a uniform vector expands to the scalar path's equal shares."""
    vec = op.byte_vector()
    if vec is None:
        return None
    return np.repeat(vec, factor) / factor


def scale_op(op: CollectiveOp, factor: int) -> CollectiveOp:
    """Project ONE op onto a fleet ``factor`` times the base device count.

    Returns a *list* of ops in exactly one case: an irregular a2a whose
    scaled group splits into multiple pod chunks -- the chunks carry
    different slices of the expanded byte vector, so they cannot share
    one op record.  Every other op (including ``factor == 1``, which is
    the identity) comes back as a single op.
    """
    if factor == 1:
        return op
    if op.kind == "collective-permute":
        return dataclasses.replace(op, source_target_pairs=[
            (s * factor, t * factor) for s, t in op.source_target_pairs])
    groups = [_scale_group(list(g), factor) for g in op.replica_groups]
    vec = _scale_vec(op, factor)
    if op.kind in _A2A_KINDS:
        per_group = [_chunk(g, POD_DEVICES) for g in groups]
        n_chunks = len(per_group[0]) if per_group else 1
        if vec is not None and n_chunks > 1:
            # one op per chunk index: chunk j of every group spans the
            # same positional slice of the expanded vector.  Each slice is
            # scaled by the chunk count -- the irregular twin of scalar
            # chunking, where every chunk op keeps the full base payload.
            out = []
            for j in range(n_chunks):
                sl = vec[j * POD_DEVICES:(j + 1) * POD_DEVICES] * n_chunks
                out.append(dataclasses.replace(
                    op,
                    replica_groups=[ch[j] for ch in per_group],
                    bytes_per_rank_vec=[float(x) for x in sl]))
            return out
        groups = [c for chunks in per_group for c in chunks]
    rep = {"replica_groups": groups}
    if vec is not None:
        rep["bytes_per_rank_vec"] = [float(x) for x in vec]
    return dataclasses.replace(op, **rep)


def scale_ops(ops: Iterable[CollectiveOp], base_devices: int,
              num_devices: int) -> list[CollectiveOp]:
    """Project a compiled op stream from ``base_devices`` onto
    ``num_devices`` (which must be a positive multiple of the base)."""
    if num_devices % base_devices or num_devices < base_devices:
        raise ValueError(
            f"fleet size {num_devices} must be a multiple of the base "
            f"mesh's {base_devices} devices")
    factor = num_devices // base_devices
    out: list[CollectiveOp] = []
    for op in ops:
        scaled = scale_op(op, factor)
        if isinstance(scaled, list):
            out.extend(scaled)
        else:
            out.append(scaled)
    return out


@dataclasses.dataclass
class ScalePoint:
    """One (config, algorithm, device count) cell of a scale curve."""

    config: str
    algorithm: str
    devices: int
    pods: int
    ops: int
    wire_bytes: float
    ici_ms: float
    dcn_ms: float
    overlap_ms: float
    bottleneck_link: str
    bottleneck_ms: float
    nnz: int
    build_ms: float

    def row(self) -> dict:
        """CSV/HTML row (floats rounded for diff-stable goldens)."""
        d = dataclasses.asdict(self)
        for k in ("wire_bytes", "ici_ms", "dcn_ms", "overlap_ms",
                  "bottleneck_ms", "build_ms"):
            d[k] = round(d[k], 3)
        return d


def scale_point(report, num_devices: int) -> ScalePoint:
    """Evaluate one fleet size for one report: scale the ops, bind a
    sparse :class:`CommView` against the fleet topology, read the derived
    artifacts.  ``build_ms`` times the sparse matrix construction."""
    topo = fleet_topology(num_devices)
    ops = scale_ops(report.compiled_ops, report.num_devices, num_devices)
    view = CommView(ops, num_devices, algorithm=report.algorithm,
                    topo=topo, label=f"scale:{num_devices}", sparse=True)
    t0 = time.perf_counter()
    mat = view.matrix
    build_ms = (time.perf_counter() - t0) * 1e3
    ici_s, dcn_s = view.collective_seconds_split()
    lu = view.link_utilization()
    bn = lu.bottleneck() if lu is not None else None
    return ScalePoint(
        config=report.meta.get("config", report.name),
        algorithm=report.algorithm,
        devices=num_devices,
        pods=topo.num_pods,
        ops=len(ops),
        wire_bytes=view.total_wire_bytes(),
        ici_ms=ici_s * 1e3,
        dcn_ms=dcn_s * 1e3,
        overlap_ms=max(ici_s, dcn_s) * 1e3,
        bottleneck_link=bn[0].name if bn else "-",
        bottleneck_ms=bn[1] * 1e3 if bn else 0.0,
        nnz=mat.nnz,
        build_ms=build_ms,
    )


def scale_curve(
    reports,
    device_counts: Iterable[int] = DEFAULT_SCALE_POINTS,
    *,
    log: Optional[Callable[[str], None]] = None,
) -> list[ScalePoint]:
    """Every (report, device count) cell.  Fleet sizes that are not a
    multiple of a report's base mesh are skipped (and logged) rather than
    silently rounded."""
    points: list[ScalePoint] = []
    for rep in reports:
        for d in device_counts:
            if d % rep.num_devices or d < rep.num_devices:
                if log:
                    log(f"[scale] skip devices={d} for "
                        f"{rep.meta.get('config', rep.name)}: not a "
                        f"multiple of base mesh ({rep.num_devices})")
                continue
            if log:
                log(f"[scale] {rep.meta.get('config', rep.name)} "
                    f"algorithm={rep.algorithm} devices={d} ...")
            points.append(scale_point(rep, d))
    return points


def scale_table(points: list[ScalePoint]) -> str:
    """Terminal rendering of a scale curve (one row per cell)."""
    rows = [[p.config, p.algorithm, f"{p.devices:,}", f"{p.pods}",
             human_bytes(p.wire_bytes), f"{p.ici_ms:.3f}",
             f"{p.dcn_ms:.3f}", f"{p.overlap_ms:.3f}", p.bottleneck_link,
             f"{p.bottleneck_ms:.3f}", f"{p.nnz:,}"]
            for p in sorted(points, key=lambda p: (p.config, p.algorithm,
                                                   p.devices))]
    return format_table(rows, [
        "config", "algorithm", "devices", "pods", "wire bytes", "ici ms",
        "dcn ms", "overlap ms", "bottleneck link", "bottleneck ms", "nnz"])
