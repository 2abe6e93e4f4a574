"""Lazy, memoized algorithm-bound views of a collective-op stream (port of
``repro.core.views``, dense only).

A :class:`CommView` owns ONE ``(algorithm, topology)`` binding of a set of
ops and every artifact derived from it -- the ``(d+1)^2`` matrix,
per-primitive matrices, the Table-2/3 summary, per-tier collective seconds.
Each artifact is computed on first access and memoized: bind once, read
many.  ``view.rebind("tree")`` shares the op list and recomputes nothing
until an artifact is read.
"""
from __future__ import annotations

from typing import Iterable, Optional

from . import comm_matrix, cost_models, summary as summary_mod
from .decompose import decompose
from .events import CollectiveOp, HostTransfer
from .topology import MeshTopology

# The reference switches to its COO matrix above this many devices; the
# port's sparse form waits for a later slice, so it refuses those sizes.
DENSE_DEVICE_LIMIT = 2048


def build_view(ops, num_devices: int, algorithm: str,
               topo: Optional[MeshTopology], host_transfers,
               *, phase: Optional[str], known_phases, label: str,
               sparse: Optional[bool] = None):
    """Construct the :class:`CommView` for one ``(algorithm, phase)``
    binding -- the shared filter/validation behind both
    ``MonitorSession.view`` and ``CommReport.view``.

    ``phase=None`` binds everything; a named phase filters ops and host
    transfers by their tag and must be one of ``known_phases``.
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
                    label=f"{label}:{phase or 'all'}", sparse=sparse)


class CommView:
    """One ``(ops, algorithm, topology)`` binding; every derived artifact
    lazy and memoized (hand-outs are by reference: treat them as
    read-only)."""

    def __init__(self, ops: Iterable[CollectiveOp], num_devices: int, *,
                 algorithm: str = "ring",
                 topo: Optional[MeshTopology] = None,
                 host_transfers: Iterable[HostTransfer] = (),
                 label: str = "", sparse: Optional[bool] = None):
        cost_models.validate_algorithm(algorithm)
        if sparse or num_devices > DENSE_DEVICE_LIMIT:
            raise NotImplementedError(
                f"sparse matrices ({num_devices} devices, sparse={sparse}) "
                "wait for the port's sparse-engine slice; the dense view "
                f"covers up to {DENSE_DEVICE_LIMIT} devices")
        self.ops = list(ops)
        self.num_devices = int(num_devices)
        self.algorithm = algorithm
        self.topo = topo
        self.host_transfers = list(host_transfers)
        self.label = label
        self._memo: dict = {}

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
                        label=self.label)

    # -- byte accounting ---------------------------------------------------
    @property
    def matrix(self):
        """``(d+1)^2`` bytes-sent matrix (host transfers in row/col 0)."""
        def build():
            mat = comm_matrix.matrix_for_schedules(
                self.ops, self.schedules(), self.num_devices)
            if self.host_transfers:
                comm_matrix.add_host_transfers(mat, self.host_transfers)
            return mat
        return self._cached("matrix", build)

    @property
    def per_primitive(self) -> dict:
        """Paper Fig. 3: one matrix per collective primitive."""
        def build():
            return {k: comm_matrix.matrix_for_schedules(
                        self.ops, self.schedules(), self.num_devices,
                        kinds={k})
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
    def schedules(self) -> list:
        """One :class:`~repro_torch.core.decompose.CollectiveSchedule` per
        op (aligned with ``self.ops``), decomposed with fallback warnings
        on, like the placement always warned."""
        return self._cached("schedules", lambda: [
            decompose(op, self.algorithm, self.topo) for op in self.ops])

    # -- time models -------------------------------------------------------
    def collective_seconds(self) -> float:
        """Serialized collective time (0.0 without a topology)."""
        ici, dcn = self.collective_seconds_split()
        return ici + dcn

    def collective_seconds_split(self) -> tuple[float, float]:
        """Per-tier serialized collective time ``(ici_s, dcn_s)``,
        execution-weighted: per-op ``time_split`` times ``max(1, weight)``
        summed in op order -- the reference's columnar ``ScheduleBatch``
        reduces in the same order, so the two are bitwise equal."""
        def build():
            if self.topo is None:
                return 0.0, 0.0
            ici = 0.0
            dcn = 0.0
            for op, sched in zip(self.ops, self.schedules()):
                i, d = sched.time_split(self.topo)
                w = max(1.0, float(getattr(op, "weight", 1.0)))
                ici += i * w
                dcn += d * w
            return ici, dcn
        return self._cached("seconds_split", build)

    def op_seconds(self) -> list:
        """Modeled seconds per op (aligned with ``self.ops``): the op's
        serialized schedule time times its execution weight; ``None``
        entries without a topology."""
        def build():
            if self.topo is None:
                return [None] * len(self.ops)
            out = []
            for op, sched in zip(self.ops, self.schedules()):
                i, d = sched.time_split(self.topo)
                out.append((i + d) * max(1.0, float(op.weight)))
            return out
        return self._cached("op_seconds", build)
