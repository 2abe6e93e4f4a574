"""High-level monitoring API (port of ``repro.core.monitor``).

The paper's workflow (Fig. 1): preload shim -> record transfers during
execution -> post-process into matrices + statistics.  The port's:

1. **intercept**: run each captured function under a fake process group and
   ``FakeTensorMode`` with a dispatch-mode shim over the ``c10d`` ops
   (:mod:`repro_torch.core.interceptor`);
2. **extract**: every collective that reaches the process group -- the ones
   the program issued and the ones DTensor inserted to reshard -- becomes a
   :class:`~repro_torch.core.events.CollectiveOp` with per-device shapes;
3. **post-process**: per-primitive statistics (Tables 2/3) and ``(d+1)^2``
   communication matrices (Figs. 2/3), through the same decomposition
   engine as the reference, and the roofline terms (:func:`roofline_of`)
   from the FLOPs and bytes counted during the capture.

:class:`~repro_torch.core.session.MonitorSession` is the accumulating front
door; ``monitor_fn`` below is the one-capture wrapper.  Reports round-trip
through :meth:`CommReport.save` / :meth:`CommReport.load` (schema v9) in the
reference's format, so either package loads the other's files.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from . import cost_models, reporter, roofline
from .events import CollectiveOp, HostTransfer, PhaseRecord, TraceEvent
from .sparse import is_sparse
from .topology import MeshTopology
from .views import CommView, build_view


@dataclasses.dataclass
class CommReport:
    """The serializable snapshot of a monitoring session.

    ``algorithm`` records which collective algorithm the eager byte
    accounting (``matrix``, ``per_primitive``, ``compiled_summary``) was
    derived with; every other artifact is served lazily by :meth:`view`.
    ``compiled_ops`` keeps the reference's field name: here they are the
    collectives that reached the process group.
    """

    name: str
    num_devices: int
    traced: list[TraceEvent]
    compiled_ops: list[CollectiveOp]
    traced_summary: dict
    compiled_summary: dict
    # (d+1)x(d+1) bytes, row/col 0 host: a dense ndarray, or the COO
    # SparseCommMatrix form at fleet scale (sparse sessions / loaded v6)
    matrix: np.ndarray
    per_primitive: dict[str, np.ndarray]
    cost: dict
    memory_stats: Optional[dict]
    trace_seconds: float
    compile_seconds: float
    topo: Optional[MeshTopology] = None
    host_transfers: list[HostTransfer] = dataclasses.field(default_factory=list)
    algorithm: str = "ring"
    meta: dict = dataclasses.field(default_factory=dict)
    phases: list[PhaseRecord] = dataclasses.field(default_factory=list)
    trace_meta: Optional[dict] = None

    # -- lazy algorithm/phase-bound views ---------------------------------
    def view(self, algorithm: Optional[str] = None,
             phase: Optional[str] = None) -> CommView:
        """The :class:`CommView` for ``(algorithm, phase)``; the default
        binding is seeded with the snapshot's eager artifacts."""
        alg = algorithm or self.algorithm
        cost_models.validate_algorithm(alg)
        if not hasattr(self, "_views"):
            self._views: dict = {}
        key = (alg, phase)
        if key not in self._views:
            v = build_view(
                self.compiled_ops, self.num_devices, alg, self.topo,
                self.host_transfers, phase=phase,
                known_phases=self.phase_names(), label=self.name,
                # a sparse snapshot keeps every binding sparse; dense ones
                # leave the per-binding cutover in charge
                sparse=True if is_sparse(self.matrix) else None,
                graphs=getattr(self, "_defuse_graphs", ()))
            if phase is None and alg == self.algorithm:
                v._memo.update(matrix=self.matrix,
                               per_primitive=self.per_primitive,
                               summary=self.compiled_summary)
            self._views[key] = v
        return self._views[key]

    def phase_names(self) -> list[str]:
        """Phase order of the originating session (op-tag order for files
        predating the phase records)."""
        if self.phases:
            return [p.name for p in self.phases]
        seen: list[str] = []
        for op in self.compiled_ops:
            if op.phase and op.phase not in seen:
                seen.append(op.phase)
        return seen

    def phase_view(self, phase: str,
                   algorithm: Optional[str] = None) -> CommView:
        """Shorthand for :meth:`view` with a required phase."""
        return self.view(algorithm, phase=phase)

    def phase_summaries(self, algorithm: Optional[str] = None) -> dict:
        """``{phase: Table-2 summary}`` in phase order."""
        return {p: self.view(algorithm, phase=p).summary
                for p in self.phase_names()}

    # -- paper-style renderings -------------------------------------------
    def usage_table(self) -> str:
        return reporter.primitive_usage_table(
            self.compiled_summary, title=f"{self.name}: issued collectives")

    def logical_table(self) -> str:
        return reporter.primitive_usage_table(
            self.traced_summary,
            title=f"{self.name}: traced (application) collectives")

    def phase_table(self, algorithm: Optional[str] = None) -> str:
        """Per-phase Table-2 breakdown (one block per phase)."""
        return reporter.phase_usage_table(
            self.phase_summaries(algorithm),
            title=f"{self.name}: per-phase collectives")

    def phase_diff(self, a: str, b: str,
                   algorithm: Optional[str] = None) -> str:
        """Primitive-by-primitive comparison of two phases' communication
        (calls + wire bytes, with the wire-byte delta)."""
        return reporter.phase_diff_table(
            a, self.view(algorithm, phase=a).summary,
            b, self.view(algorithm, phase=b).summary)

    def heatmap(self, kind: Optional[str] = None,
                phase: Optional[str] = None) -> str:
        v = self.view(phase=phase)
        mat = v.per_primitive.get(kind, v.matrix) if kind else v.matrix
        t = (f"{self.name} comm matrix"
             + (f" [{kind}]" if kind else "")
             + (f" [phase {phase}]" if phase else ""))
        return reporter.ascii_heatmap(mat, title=t)

    def diff(self) -> str:
        return reporter.diff_table(self.traced_summary, self.compiled_summary)

    def total_wire_bytes(self, algorithm: Optional[str] = None) -> float:
        return self.view(algorithm).total_wire_bytes()

    def collective_seconds(self, algorithm: Optional[str] = None) -> float:
        return self.view(algorithm).collective_seconds()

    def collective_seconds_split(
            self, algorithm: Optional[str] = None) -> tuple[float, float]:
        """Per-tier serialized collective time ``(ici_s, dcn_s)``."""
        return self.view(algorithm).collective_seconds_split()

    def collective_overlap_seconds(
            self, algorithm: Optional[str] = None) -> float:
        """Overlap-aware communication time: ``max`` of the per-tier
        serialized sums (ICI and DCN are independent fabrics)."""
        return self.view(algorithm).collective_overlap_seconds()

    # -- physical-link view ------------------------------------------------
    def link_utilization(self, algorithm: Optional[str] = None):
        """The matrix projected onto physical links (ICI hops, DCN
        uplinks): a :class:`~repro_torch.core.comm_matrix.LinkUtilization`,
        or ``None`` without a topology.  Derived from the ops, so loaded
        reports have it too."""
        return self.view(algorithm).link_utilization()

    def link_matrix(self, algorithm: Optional[str] = None):
        """The ``(d+1)^2`` per-link byte matrix: entry ``(i+1, j+1)`` is the
        physical ICI link ``i -> j``; row/col 0 is the DCN tier.  ``None``
        without a topology."""
        return self.view(algorithm).link_matrix()

    def link_seconds(self, algorithm: Optional[str] = None) -> float:
        """Contention-aware communication time: the bottleneck link's
        bytes/bandwidth."""
        return self.view(algorithm).link_seconds()

    def link_table(self) -> str:
        lu = self.link_utilization()
        if lu is None:
            return "(no topology: pass mesh= to the monitor for link stats)"
        ici_s, dcn_s = self.collective_seconds_split()
        overlap = (f"tier overlap: ici {ici_s * 1e3:.3f} ms ∥ dcn "
                   f"{dcn_s * 1e3:.3f} ms -> overlapped "
                   f"{max(ici_s, dcn_s) * 1e3:.3f} ms "
                   f"(serialized {(ici_s + dcn_s) * 1e3:.3f} ms)")
        return lu.table() + "\n" + overlap

    def rebound(self, algorithm: str) -> "CommReport":
        """A sibling snapshot with its eager artifacts re-derived from
        ``view(algorithm)``: what the sweep's cache stores, one report per
        ``(config, mesh, algorithm)`` cell.  Nothing is recaptured; to
        compare algorithms, :meth:`view` is the lazy way."""
        if algorithm == self.algorithm:
            return self
        v = self.view(algorithm)
        rep = dataclasses.replace(
            self,
            algorithm=algorithm,
            compiled_summary=v.summary,
            matrix=v.matrix,
            per_primitive=v.per_primitive,
            meta=dict(self.meta, algorithm=algorithm),
        )
        if hasattr(self, "_defuse_graphs"):
            rep._defuse_graphs = self._defuse_graphs
        return rep

    def schedule_summaries(self,
                           algorithm: Optional[str] = None) -> list[dict]:
        """Per-op decomposition-schedule summaries (aligned with
        ``compiled_ops``), also written by ``save(...,
        include_schedules=True)``."""
        return self.view(algorithm).schedule_summaries()

    # -- measured (trace-imported) time -------------------------------------
    def measured_seconds(self, phase: Optional[str] = None) -> Optional[float]:
        """Total *measured* wall seconds over ops that carry a trace
        measurement (``op.measured_s``, schema v9) -- ``None`` when no op
        does, i.e. for purely modeled reports."""
        return self.view(phase=phase).measured_seconds()

    def compare(self, model=None, algorithm: Optional[str] = None):
        """Modeled-vs-measured comparison
        (:class:`~repro_torch.core.trace.compare.CompareResult`) of this
        report's measured ops against ``model`` (a CommReport; default:
        this report's own modeled times)."""
        from .trace.compare import compare as compare_fn

        return compare_fn(self, model, algorithm=algorithm)

    # -- static lint ---------------------------------------------------------
    def lint(self, algorithm: Optional[str] = None,
             phase: Optional[str] = None) -> list:
        """Static anti-pattern findings
        (:class:`~repro_torch.core.lint.LintFinding`) for the ``(algorithm,
        phase)`` binding -- lazy and memoized via :meth:`view`.  A report
        loaded from a file saved with ``include_lint=True`` serves its
        persisted default-binding findings without re-analysis (and without
        the def-use graphs, which are not saved)."""
        alg = algorithm or self.algorithm
        if phase is None and alg == self.algorithm:
            cached = getattr(self, "_lint_findings", None)
            if cached is not None:
                return cached
        return self.view(alg, phase=phase).lint()

    def lint_table(self, algorithm: Optional[str] = None) -> str:
        """Terminal rendering of :meth:`lint` (reporter.lint_table)."""
        return reporter.lint_table(
            self.lint(algorithm), title=f"{self.name}: lint findings")

    def render(self) -> str:
        parts = [
            f"### CommReport: {self.name} ({self.num_devices} devices) ###",
            self.logical_table(),
            self.usage_table(),
        ]
        if len(self.phase_names()) >= 2:
            parts.append(self.phase_table())
        parts += ["-- traced vs issued --", self.diff(), self.heatmap()]
        if self.topo is not None:
            parts.append("-- physical links --\n" + self.link_table())
        parts.append(
            f"trace {self.trace_seconds * 1e3:.1f} ms | "
            f"wire bytes (all devices) "
            f"{reporter.human_bytes(self.total_wire_bytes())}")
        return "\n\n".join(parts)

    def save(self, path: str, *, include_schedules: bool = False,
             include_lint: bool = False) -> str:
        """Write the report as schema-v9 JSON (see :meth:`load`).
        ``include_schedules=True`` adds the schema-v5 per-op schedule
        summaries; ``include_lint=True`` the schema-v7 ``lint`` section:
        the default binding's :meth:`lint` findings, served back by loaded
        reports without re-analysis."""
        from .export import export_json
        return export_json(self, path, include_schedules=include_schedules,
                           include_lint=include_lint)

    @classmethod
    def load(cls, path: str) -> "CommReport":
        """Read a report written by either package (schema v1 ... v9)."""
        from .export import load_json
        return load_json(path)


def monitor_fn(fn, *args, mesh=None, name: str = "fn",
               algorithm: str = "ring",
               host_transfers: Optional[list[HostTransfer]] = None,
               op_transform=None, **kwargs) -> CommReport:
    """Monitor one function: a single-capture, single-phase
    :class:`~repro_torch.core.session.MonitorSession`, snapshotted."""
    from .session import MonitorSession

    session = MonitorSession(mesh=mesh, name=name, algorithm=algorithm)
    with session:
        session.capture(fn, *args, name=name, host_transfers=host_transfers,
                        op_transform=op_transform, **kwargs)
    return session.report()


def roofline_of(report: CommReport, *, arch: str = "", mesh_name: str = "",
                model_flops: float = 0.0,
                algorithm: str = "ring") -> roofline.RooflineReport:
    """The roofline of a report: its counted per-device FLOPs and bytes
    (``report.cost``, from the capture) and its recorded ops.

    Only the port's own count is accepted, ``cost`` with exactly the keys
    ``flops`` and ``bytes accessed``.  A report with no cost raises, and so
    does the reference's ``cost``: XLA's ``cost_analysis`` (per-operand
    ``bytes accessed0{}``, ``utilization...`` keys), which counts a loop
    body once and which the reference's own roofline does not use either
    (it walks the HLO).  It never returns zeros."""
    if report.topo is None:
        raise ValueError("report has no topology: monitor with mesh= for a "
                         "roofline")
    cost = report.cost or {}
    if set(cost) != {"flops", "bytes accessed"}:
        raise ValueError(
            f"report {report.name!r} carries no counted cost (cost keys "
            f"{sorted(cost)[:4]}{'...' if len(cost) > 4 else ''}): "
            "re-capture it with repro_torch, whose captures count FLOPs "
            "and bytes")
    return roofline.analyze(
        arch=arch or report.name,
        mesh_name=mesh_name,
        cost=cost,
        ops=report.compiled_ops,
        topo=report.topo,
        hw=report.topo.hw,
        model_flops=model_flops,
        memory_stats=report.memory_stats,
        algorithm=algorithm,
        link_utilization=report.link_utilization(algorithm),
    )
