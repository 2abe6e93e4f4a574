"""Lazy, memoized algorithm-bound views of a collective-op stream (port of
``repro.core.views``).

A :class:`CommView` owns ONE ``(algorithm, topology)`` binding of a set of
ops and every artifact derived from it -- the ``(d+1)^2`` matrix (dense, or
COO above :data:`~repro_torch.core.sparse.SPARSE_DEVICE_THRESHOLD`
devices), per-primitive matrices, the Table-2/3 summary, link utilization,
per-tier collective seconds and their overlap bound, measured seconds and
the lint's findings.  Each artifact is
computed on first access and memoized: bind once, read many.
``view.rebind("tree")`` shares the op list and recomputes nothing until an
artifact is read.  Every timing reads one columnar
:class:`~repro_torch.core.decompose.ScheduleBatch`, as the reference's
views do.
"""
from __future__ import annotations

from typing import Iterable, Optional

from . import comm_matrix, cost_models, summary as summary_mod
from .decompose import ScheduleBatch
from .events import CollectiveOp, HostTransfer
from .sparse import SPARSE_DEVICE_THRESHOLD
from .topology import MeshTopology


def build_view(ops, num_devices: int, algorithm: str,
               topo: Optional[MeshTopology], host_transfers,
               *, phase: Optional[str], known_phases, label: str,
               sparse: Optional[bool] = None, graphs=()):
    """Construct the :class:`CommView` for one ``(algorithm, phase)``
    binding -- the shared filter/validation behind both
    ``MonitorSession.view`` and ``CommReport.view`` (one implementation,
    so session and snapshot views cannot diverge).

    ``phase=None`` binds everything; a named phase filters ops and host
    transfers by their tag and must be one of ``known_phases``.
    ``sparse`` is the matrix-representation mode (None = auto by device
    count, see :class:`CommView`).  ``graphs`` are the captures' def-use
    graphs (:mod:`~repro_torch.core.defuse`), read by the lint.
    """
    if phase is not None:
        known = list(known_phases)
        if phase not in known:
            raise KeyError(
                f"unknown phase {phase!r}; known phases: {known}")
        ops = [op for op in ops if op.phase == phase]
        host_transfers = [t for t in host_transfers if t.phase == phase]
    return CommView(ops, num_devices, algorithm=algorithm, topo=topo,
                    host_transfers=host_transfers,
                    label=f"{label}:{phase or 'all'}", sparse=sparse,
                    graphs=graphs)


class CommView:
    """One ``(ops, algorithm, topology)`` binding; every derived artifact
    lazy and memoized.

    The view never mutates its inputs: ``rebind`` shares the same op list
    under a different algorithm with a fresh memo, and the memoized arrays
    are handed out by reference (treat them as read-only).
    """

    def __init__(self, ops: Iterable[CollectiveOp], num_devices: int, *,
                 algorithm: str = "ring",
                 topo: Optional[MeshTopology] = None,
                 host_transfers: Iterable[HostTransfer] = (),
                 label: str = "", sparse: Optional[bool] = None,
                 graphs: Iterable = ()):
        cost_models.validate_algorithm(algorithm)
        self.ops = list(ops)
        self.num_devices = int(num_devices)
        self.algorithm = algorithm
        self.topo = topo
        self.host_transfers = list(host_transfers)
        self.label = label
        # matrix representation: True = COO SparseCommMatrix, False =
        # dense ndarray, None = auto (sparse above the device-count
        # cutover -- the dense array is O(d^2) memory)
        self.sparse = sparse
        self.graphs = list(graphs)
        self._memo: dict = {}

    @property
    def use_sparse(self) -> bool:
        """The resolved matrix representation for this view."""
        if self.sparse is None:
            return self.num_devices > SPARSE_DEVICE_THRESHOLD
        return bool(self.sparse)

    def __repr__(self) -> str:
        tag = f" {self.label!r}" if self.label else ""
        return (f"CommView({len(self.ops)} ops, {self.num_devices} devices, "
                f"algorithm={self.algorithm!r}{tag})")

    def _cached(self, key: str, build):
        if key not in self._memo:
            self._memo[key] = build()
        return self._memo[key]

    def rebind(self, algorithm: str) -> "CommView":
        """Same ops/topology under another algorithm (fresh memo)."""
        if algorithm == self.algorithm:
            return self
        return CommView(self.ops, self.num_devices, algorithm=algorithm,
                        topo=self.topo, host_transfers=self.host_transfers,
                        label=self.label, sparse=self.sparse,
                        graphs=self.graphs)

    # -- byte accounting ---------------------------------------------------
    @property
    def matrix(self):
        """``(d+1)^2`` bytes-sent matrix (host transfers in row/col 0).

        A dense ``np.ndarray`` or, when :attr:`use_sparse` resolves true,
        the byte-identical COO :class:`~repro_torch.core.sparse.
        SparseCommMatrix` -- every downstream consumer (link projection,
        heatmaps, serialization) accepts both.
        """
        def build():
            mat = comm_matrix.matrix_for_schedules(
                self.ops, self.schedule_batch(), self.num_devices,
                sparse=self.use_sparse)
            if self.host_transfers:
                comm_matrix.add_host_transfers(mat, self.host_transfers)
            return mat
        return self._cached("matrix", build)

    @property
    def per_primitive(self) -> dict:
        """Paper Fig. 3: one matrix per collective primitive."""
        def build():
            return {k: comm_matrix.matrix_for_schedules(
                        self.ops, self.schedule_batch(), self.num_devices,
                        kinds={k}, sparse=self.use_sparse)
                    for k in sorted({op.kind for op in self.ops})}
        return self._cached("per_primitive", build)

    @property
    def summary(self) -> dict:
        """Paper Table-2/3 per-kind calls / payload / wire bytes."""
        return self._cached("summary", lambda: summary_mod.summarize(
            self.ops, self.algorithm, topo=self.topo))

    def total_wire_bytes(self) -> float:
        """Global bytes-on-the-wire across all devices."""
        return self._cached("total_wire_bytes", lambda: (
            summary_mod.total_wire_bytes(self.ops, self.algorithm,
                                         topo=self.topo)))

    # -- decomposition schedules -------------------------------------------
    def schedule_batch(self) -> ScheduleBatch:
        """The columnar :class:`~repro_torch.core.decompose.ScheduleBatch`
        over this binding's ops -- deduped by op signature (``decompose``
        runs once per *distinct shape*, not once per op), memoized, and
        shared by every derived artifact: :attr:`matrix` /
        :attr:`per_primitive` reuse its per-schedule edge cache, the time
        models read its flat phase columns.  Built with fallback warnings
        on, like the placement always warned."""
        return self._cached("schedule_batch", lambda: (
            ScheduleBatch.from_ops(self.ops, self.algorithm, self.topo,
                                   warn=True)))

    def schedules(self) -> list:
        """One :class:`~repro_torch.core.decompose.CollectiveSchedule` per
        op (aligned with ``self.ops``; ops sharing a signature share one
        schedule object) -- the phase IR every derived artifact reads."""
        return self.schedule_batch().schedules

    def schedule_summaries(self) -> list[dict]:
        """Serializable per-op schedule summaries (schema-v5 section)."""
        return [sched.summary() for sched in self.schedules()]

    # -- time models -------------------------------------------------------
    def collective_seconds(self) -> float:
        """Serialized collective time (0.0 without a topology)."""
        ici, dcn = self.collective_seconds_split()
        return ici + dcn

    def collective_seconds_split(self) -> tuple[float, float]:
        """Per-tier serialized collective time ``(ici_s, dcn_s)``,
        execution-weighted, summed over the memoized schedules."""
        def build():
            if self.topo is None:
                return 0.0, 0.0
            return self.schedule_batch().total_time_split(self.topo)
        return self._cached("seconds_split", build)

    def collective_overlap_seconds(self) -> float:
        """Tier-overlapped communication time: ``max(ici_s, dcn_s)``."""
        return max(self.collective_seconds_split())

    def op_seconds(self) -> list:
        """Modeled seconds per op (aligned with ``self.ops``): each entry
        is the op's serialized schedule time -- ``sum(time_split)`` --
        times its execution weight.  ``None`` entries without a topology
        (no time model); the compare layer matches these against the
        measured ``op.measured_s`` values a trace import carries."""
        def build():
            if self.topo is None:
                return [None] * len(self.ops)
            batch = self.schedule_batch()
            ici, dcn = batch.time_split_per_op(self.topo)
            return ((ici + dcn) * batch.weight).tolist()
        return self._cached("op_seconds", build)

    def measured_seconds(self):
        """Total measured wall seconds over ops carrying ``measured_s``
        (trace imports, schema v9); ``None`` when no op is measured."""
        vals = [op.measured_s for op in self.ops
                if op.measured_s is not None]
        return float(sum(vals)) if vals else None

    # -- physical-link view ------------------------------------------------
    def link_utilization(self):
        """Per-physical-link byte counts (None without a topology)."""
        def build():
            if self.topo is None:
                return None
            return comm_matrix.project_links(self.matrix, self.topo)
        return self._cached("link_utilization", build)

    def link_matrix(self):
        lu = self.link_utilization()
        return None if lu is None else lu.matrix()

    def link_seconds(self) -> float:
        """Contention-aware bound: the bottleneck link's bytes/bandwidth."""
        lu = self.link_utilization()
        return 0.0 if lu is None else lu.bottleneck_seconds()

    # -- static lint ---------------------------------------------------------
    def lint(self) -> list:
        """Static anti-pattern findings for this binding (lazy, memoized
        like every other artifact): a list of
        :class:`~repro_torch.core.lint.LintFinding`, errors first, then by
        modeled savings.  The def-use rules run only when the view carries
        :attr:`graphs`; the op-stream rules always run (savings are zero
        without a topology)."""
        from .lint import lint_ops   # deferred: lint imports decompose

        return self._cached("lint", lambda: lint_ops(
            self.ops, topo=self.topo, algorithm=self.algorithm,
            graphs=self.graphs))
