"""Perfetto / Chrome trace-event timeline of the collective schedule (port
of ``repro.core.export.perfetto``).

Renders each report's compiled collectives as a timeline loadable in
https://ui.perfetto.dev or ``chrome://tracing``: one *process* per report,
one *thread* (track) per collective primitive, one complete (``ph="X"``)
event per collective op.  Durations come straight from the op's
decomposition schedule (:func:`repro_torch.core.decompose.decompose`) -- the same
phase IR the cost models bill -- so the timeline *is* the roofline's
collective term, made visible.

**Overlap-aware per-tier lanes.**  Reports with a topology additionally get
one **ICI lane** and one **DCN lane**: every schedule phase is drawn as a
span on its tier's lane, laid out with a software-pipelined clock -- a
phase starts when both its predecessor phase (within its op *stream*;
disjoint replica groups are concurrent streams and overlap) and the op's
tier base are free.  Ops therefore overlap across tiers exactly the way the
link-overlap roofline bound (``max(ici_s, dcn_s)``) assumes: op ``k+1``'s
intra-pod ICI phases run while op ``k``'s DCN shard exchange is still in
flight, and the timeline's end approaches the overlapped bound instead of
the serialized sum.

Session reports with named phases additionally get a **phase lane**: a
dedicated track whose ``X`` events span each phase's extent on the same
clock, so the fwd/bwd/optimizer structure reads directly off the timeline
(every op event also carries its ``phase`` in ``args``).

Only the documented subset of the Chrome trace-event format is emitted
(https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU):
``X`` duration events and ``M`` metadata events, each with ``name``, ``ph``,
``ts``/``dur`` in microseconds, ``pid``, ``tid``, ``cat`` and ``args``.

**Lossless re-import.**  Every ``collective`` event embeds the op's full
serialized record (``args.repro_op``, the schema-v9 op dict) and each
process carries one ``repro_report`` metadata event (devices, algorithm,
topology, phases, host transfers), so the Perfetto frontend of
:mod:`repro_torch.core.trace` can rebuild the originating report exactly --
importing our own export reproduces the comm matrix bitwise.
"""
from __future__ import annotations

import json
import os

from ..decompose import cached_decompose as _decompose
from ..sparse import is_sparse
from . import serialize

# floor so zero-cost ops (group size 1, no topology) stay visible in the UI
_MIN_DUR_US = 0.05

# metadata-event name carrying the report-level round-trip record
REPORT_META_EVENT = "repro_report"


def _op_args(op, algorithm: str) -> dict:
    args = {
        "kind": op.kind,
        "hlo_name": op.name,
        "payload_bytes": int(op.payload_bytes),
        "wire_bytes_total": float(op.wire_bytes_total(algorithm)),
        "group_size": op.group_size,
        "num_groups": op.num_groups,
        "weight": op.weight,
        # the full serialized op -- replica groups, shapes, pairs, byte
        # vectors -- so a re-import loses nothing the matrix needs
        "repro_op": serialize.op_to_dict(op),
    }
    if op.phase:
        args["phase"] = op.phase
    if op.skew() > 1.0:
        args["skew"] = round(op.skew(), 4)
    if op.measured_s is not None:
        args["measured_s"] = float(op.measured_s)
    return args


def _report_meta(report) -> dict:
    """Report-level round-trip record for the ``repro_report`` metadata
    event: everything the comm matrix needs beyond the op list (device
    count, algorithm binding, topology, phase order, host transfers --
    the matrix's row/col 0)."""
    meta = {
        "name": report.name,
        "num_devices": report.num_devices,
        "algorithm": getattr(report, "algorithm", "ring"),
        "topo": serialize.topo_to_dict(getattr(report, "topo", None)),
        "sparse": bool(is_sparse(getattr(report, "matrix", None))),
        "phases": [serialize.phase_to_dict(p)
                   for p in getattr(report, "phases", []) or []],
        "host_transfers": [serialize.transfer_to_dict(t)
                           for t in getattr(report, "host_transfers", [])],
    }
    return meta


def _memoized_schedules(report, algorithm: str) -> tuple[dict, dict]:
    """``({id(op): CollectiveSchedule}, {id(op): phase seconds})`` from
    the report view's memoized :class:`~repro_torch.core.decompose.
    ScheduleBatch` when the report offers one (a ``CommReport``), so the
    exporter shares the IR other artifacts already computed -- including
    the batch's columnar per-phase seconds, sliced per op -- instead of
    re-running ``decompose`` and per-phase timing per op.  Empty dicts
    for plain objects."""
    view = getattr(report, "view", None)
    if view is None:
        return {}, {}
    try:
        v = view(algorithm)
        batch = v.schedule_batch()
        sched_of = {id(op): sched
                    for op, sched in zip(batch.ops, batch.schedules)}
        secs_of = {}
        if batch.topo is not None:
            sec = batch.phase_seconds()
            secs_of = {id(op): sec[batch.phase_slice(i)]
                       for i, op in enumerate(batch.ops)}
        return sched_of, secs_of
    except Exception:
        return {}, {}


def _ordered_ops(report, phase_names):
    ops = report.compiled_ops
    if phase_names:
        # lay phases out contiguously in session order (stable within phase)
        order = {p: i for i, p in enumerate(phase_names)}
        ops = sorted(ops, key=lambda op: order.get(op.phase, len(order)))
    return ops


def trace_events(report, *, pid: int = 1) -> list[dict]:
    """Trace events for one report (one process, one track per primitive,
    plus the per-tier lanes when the report carries a topology)."""
    algorithm = getattr(report, "algorithm", "ring")
    topo = getattr(report, "topo", None)
    label = f"{report.name} [{report.num_devices} devices, {algorithm}]"
    events: list[dict] = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": label},
    }, {
        "name": REPORT_META_EVENT, "ph": "M", "pid": pid, "tid": 0,
        "args": _report_meta(report),
    }]
    kinds = sorted({op.kind for op in report.compiled_ops})
    tid_of = {kind: i + 1 for i, kind in enumerate(kinds)}
    for kind, tid in tid_of.items():
        events.append({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": kind},
        })
    phase_names = (report.phase_names()
                   if hasattr(report, "phase_names") else [])
    ops = _ordered_ops(report, phase_names)
    next_tid = len(kinds) + 1
    tier_tid: dict[str, int] = {}
    if topo is not None and ops:
        for tier in ("ici", "dcn"):
            tier_tid[tier] = next_tid
            events.append({
                "name": "thread_name", "ph": "M", "pid": pid,
                "tid": next_tid, "args": {"name": f"{tier} lane"}})
            next_tid += 1

    phase_spans: dict[str, list[float]] = {}

    def note_span(op, start: float, end: float):
        if op.phase:
            span = phase_spans.setdefault(op.phase, [start, end])
            span[0] = min(span[0], start)
            span[1] = max(span[1], end)

    if topo is None:
        # no topology: the legacy serial layout (generic 50 GB/s link);
        # imported ops carry measured wall time -- already execution-total
        # -- so their spans show the trace's truth, not the generic link
        ts = 0.0
        for op in ops:
            if op.measured_s is not None:
                dur = max(_MIN_DUR_US, op.measured_s * 1e6)
            else:
                sec = op.wire_bytes_per_rank(algorithm) / 50e9
                dur = max(_MIN_DUR_US, sec * 1e6) * max(1.0, op.weight)
            events.append({
                "name": op.op_name or op.kind, "cat": "collective",
                "ph": "X", "ts": round(ts, 3), "dur": round(dur, 3),
                "pid": pid, "tid": tid_of[op.kind],
                "args": _op_args(op, algorithm)})
            note_span(op, ts, ts + dur)
            ts += dur
    else:
        # software-pipelined layout: a phase starts when its predecessor
        # (within its op *stream*) and its tier's lane are both free --
        # ICI and DCN overlap across ops exactly as the roofline's overlap
        # bound assumes, and concurrent streams (disjoint replica groups)
        # overlap within the op like ``time_split``'s max-over-streams.
        # A weighted op (while-loop body) executes ``weight`` times; its
        # phases show the aggregate as one span each.
        sched_of, secs_of = _memoized_schedules(report, algorithm)
        cursor = {"ici": 0.0, "dcn": 0.0}
        issue = 0.0   # monotone issue clock: ops are issued in program
        for op in ops:  # order, so op k+1 never *starts* before op k does
            sched = sched_of.get(id(op)) \
                or _decompose(op, algorithm, topo, warn=False)
            secs = secs_of.get(id(op))
            w = max(1.0, op.weight)
            # a schedule-less op (size-1 groups) moves nothing: marker at
            # the issue clock, gating nothing (no pipeline barrier)
            t_prev = issue if not sched.phases else 0.0
            # streams start from the op's base (not behind each other's
            # phases); the base honours both lane availability and issue
            # order
            base = {t: max(c, issue) for t, c in cursor.items()}
            op_start = None
            op_end = 0.0
            stream_end: dict[int, float] = {}
            tier_events: list[dict] = []
            for j, ph in enumerate(sched.phases):
                sec = float(secs[j]) if secs is not None \
                    else ph.seconds(topo)
                dur = max(_MIN_DUR_US, sec * 1e6 * w)
                start = max(stream_end.get(ph.stream, 0.0), base[ph.tier])
                end = start + dur
                cursor[ph.tier] = max(cursor[ph.tier], end)
                stream_end[ph.stream] = end
                op_start = start if op_start is None else min(op_start,
                                                              start)
                op_end = max(op_end, end)
                tier_events.append({
                    "name": f"{ph.kind}"
                            + (f"@{ph.axis}" if ph.axis else ""),
                    "cat": "tier", "ph": "X",
                    "ts": round(start, 3), "dur": round(dur, 3),
                    "pid": pid, "tid": tier_tid[ph.tier],
                    "args": {
                        "tier": ph.tier, "structure": ph.structure,
                        "axis": ph.axis, "hlo_name": op.name,
                        "bytes_per_rank": float(ph.max_bytes_per_rank()),
                        "latency_hops": float(ph.latency_hops),
                    }})
            # concurrent streams restart from the op's base, so sort the
            # op's lane spans by start time to keep each track ordered
            events.extend(sorted(tier_events, key=lambda e: e["ts"]))
            if op_start is None:            # scheduleless op (size-1 group)
                op_start, op_end = t_prev, t_prev + _MIN_DUR_US
            issue = op_start
            events.append({
                "name": op.op_name or op.kind, "cat": "collective",
                "ph": "X", "ts": round(op_start, 3),
                "dur": round(max(_MIN_DUR_US, op_end - op_start), 3),
                "pid": pid, "tid": tid_of[op.kind],
                "args": _op_args(op, algorithm)})
            note_span(op, op_start, op_end)

    if len(phase_names) >= 2:
        # the phase lane: one span per phase on a dedicated track (phases
        # with no collectives occupy no wall-clock on this model, so they
        # have no span to draw)
        lane_tid = next_tid
        events.append({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": lane_tid,
            "args": {"name": "phases"},
        })
        for name in phase_names:
            span = phase_spans.get(name)
            if span is None:
                continue
            events.append({
                "name": name,
                "cat": "phase",
                "ph": "X",
                "ts": round(span[0], 3),
                "dur": round(max(_MIN_DUR_US, span[1] - span[0]), 3),
                "pid": pid,
                "tid": lane_tid,
                "args": {"phase": name},
            })
    return events


def chrome_trace(reports) -> dict:
    """Combined trace document for one or many reports (one process each)."""
    if not isinstance(reports, (list, tuple)):
        reports = [reports]
    events: list[dict] = []
    for i, rep in enumerate(reports):
        events.extend(trace_events(rep, pid=i + 1))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"generator": "repro_torch.core.export.perfetto",
                      "schema": "chrome-trace-event/json"},
    }


def export_perfetto(reports, path: str) -> str:
    """Write the Chrome-trace JSON for one or many reports."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(chrome_trace(reports), f, indent=1)
    return path
