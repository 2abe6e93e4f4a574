"""Shared datatypes of the trace-ingestion subsystem (port of
``repro.core.trace.base``).

Every frontend (:mod:`.perfetto`, :mod:`.nvprof`, :mod:`.jsonl`) is a
:class:`TraceSource`: it sniffs whether a file is in its format and parses
it into one :class:`TraceImport` -- a normalized bundle of
:class:`~repro_torch.core.events.CollectiveOp` records carrying *measured*
wall-clock seconds (``op.measured_s``, schema v9) plus host transfers,
optional topology, and import provenance.  ``TraceImport.report()`` then
snapshots the bundle as an ordinary
:class:`~repro_torch.core.monitor.CommReport`, so every downstream consumer --
matrix, links, phases, HTML, Perfetto, compare -- works on measured data
unchanged.

Malformed input never degrades silently: each frontend raises
:class:`TraceParseError` naming the offending record (line / row / event),
so a truncated file or an unknown device id can never produce a quiet
zero-row matrix.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..events import CollectiveOp, HostTransfer, PhaseRecord
from ..topology import MeshTopology


class TraceParseError(ValueError):
    """A trace file could not be parsed.

    Carries the file path and a short description of the offending record
    (``record``, e.g. ``"line 17"`` or ``"row 4 (ncclAllReduce...)"``) so
    the message pinpoints *which* record broke, not just that one did.
    """

    def __init__(self, message: str, *, path: Optional[str] = None,
                 record: Optional[str] = None):
        self.path = path
        self.record = record
        loc = ""
        if path:
            loc += f"{path}: "
        if record:
            loc += f"{record}: "
        super().__init__(f"{loc}{message}")


@dataclasses.dataclass
class TraceImport:
    """One parsed device trace, normalized onto the repo's event model.

    ``ops`` carry ``measured_s`` (total measured wall seconds per op,
    worst rank for multi-rank records); ``meta`` records import
    provenance (frontend, source path, device mapping, clock alignment)
    and is persisted as the report's schema-v9 ``trace_meta`` section.
    """

    name: str
    num_devices: int
    ops: list[CollectiveOp] = dataclasses.field(default_factory=list)
    host_transfers: list[HostTransfer] = dataclasses.field(
        default_factory=list)
    topo: Optional[MeshTopology] = None
    algorithm: str = "ring"
    phases: list[PhaseRecord] = dataclasses.field(default_factory=list)
    sparse: Optional[bool] = None
    meta: dict = dataclasses.field(default_factory=dict)

    def view(self, algorithm: Optional[str] = None):
        """A :class:`~repro_torch.core.views.CommView` over the imported ops."""
        from ..views import build_view

        return build_view(
            self.ops, self.num_devices, algorithm or self.algorithm,
            self.topo, self.host_transfers, phase=None, known_phases=(),
            label=self.name, sparse=self.sparse)

    def report(self):
        """Snapshot the import as a :class:`~repro_torch.core.monitor.CommReport`.

        The eager artifacts (matrix / per-primitive / summary) are built
        through the same :class:`~repro_torch.core.views.CommView` pipeline a
        live session uses, so an import of our own Perfetto export
        reproduces the original comm matrix bitwise.
        """
        from ..monitor import CommReport

        v = self.view()
        return CommReport(
            name=self.name,
            num_devices=self.num_devices,
            traced=[],
            compiled_ops=list(self.ops),
            traced_summary={},
            compiled_summary=v.summary,
            matrix=v.matrix,
            per_primitive=v.per_primitive,
            cost={},
            memory_stats=None,
            trace_seconds=0.0,
            compile_seconds=0.0,
            topo=self.topo,
            host_transfers=list(self.host_transfers),
            algorithm=self.algorithm,
            meta={},
            phases=list(self.phases),
            trace_meta=dict(self.meta) if self.meta else None,
        )


class TraceSource:
    """Interface of one trace-format frontend.

    Subclasses set :attr:`format` / :attr:`extensions` and implement
    :meth:`sniff` (cheap content test on the file's head) and
    :meth:`parse` (full file -> :class:`TraceImport`).  The registry in
    :mod:`repro_torch.core.trace` routes ``load_trace`` through these.
    """

    #: short format name (``load_trace``'s ``fmt``)
    format: str = ""
    #: lowercase filename extensions this frontend claims by default
    extensions: tuple = ()

    @classmethod
    def sniff(cls, path: str, head: str) -> bool:
        """Whether ``head`` (the file's first few KiB) looks like this
        format.  Must not raise."""
        raise NotImplementedError

    @classmethod
    def parse(cls, path: str, **opts) -> TraceImport:
        """Parse the full file; raise :class:`TraceParseError` on any
        malformed record."""
        raise NotImplementedError
