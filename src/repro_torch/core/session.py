"""Session-based monitoring: multi-phase capture over a whole run (port of
``repro.core.session``).

:class:`MonitorSession` is the accumulating front door::

    mesh = fake_mesh((4, 2), ("data", "model"), device="cuda")
    sess = MonitorSession(mesh=mesh, name="serve")
    with sess.fake_mode:                    # stand-ins allocate nothing
        params = shd.shard_tree(model.shapes(), model.axes())
    with sess.phase("prefill"):
        sess.capture(prefill, params, batch)
    with sess.phase("decode"):
        sess.capture(decode, params, cache, batch)
    sess.view(phase="decode")               # lazy, memoized CommView
    report = sess.report()                  # serializable CommReport

:meth:`MonitorSession.capture` runs the function under the session's
``FakeTensorMode`` and the :class:`~repro_torch.core.interceptor.
CollectiveInterceptor`, on a fake process group: nothing is allocated and
no NCCL call runs -- the analogue of the reference lowering against
``ShapeDtypeStruct``s.  Every recorded op is tagged with the active phase.
The reference also compiles and parses the HLO; the port has no compiled
half yet, so its logical and physical op lists are the same stream and the
traced-vs-compiled diff waits.  Every capture keeps its def-use record
(:mod:`repro_torch.core.defuse`), the port's stand-in for the compiled
module that the lint's def-use rules walk, as the reference always keeps
the HLO; under ``FakeTensorMode`` the tensors it holds allocate nothing.
Every capture also counts its FLOPs and bytes, one device's
(:mod:`repro_torch.core.op_cost`); the report's ``cost`` sums them over
the captures, as the reference sums each capture's ``cost_analysis``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Iterable, Optional

from . import cost_models, decompose
from .defuse import DefUseGraph
from .events import CollectiveOp, HostTransfer, PhaseRecord, TraceEvent
from .interceptor import CollectiveInterceptor, traced_summary
from .topology import MeshTopology
from .views import CommView, build_view

DEFAULT_PHASE = "main"


def fake_mesh(shape, axis_names, device: str = "cuda"):
    """A ``DeviceMesh`` over a fake process group of ``prod(shape)`` ranks
    (this process is rank 0).  The process group is process-global: the
    first call creates it, later calls must ask for the same world size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    world = int(math.prod(shape))
    if not dist.is_initialized():
        dist.init_process_group("fake", rank=0, world_size=world,
                                store=FakeStore())
    elif dist.get_world_size() != world:
        raise ValueError(
            f"a process group of {dist.get_world_size()} ranks already "
            f"exists; cannot build a {world}-rank mesh")
    return init_device_mesh(device, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


@dataclasses.dataclass
class Capture:
    """One monitored function inside a session."""

    name: str
    phase: str
    ops: list[CollectiveOp]
    traced: list[TraceEvent]
    trace_seconds: float
    graph: DefUseGraph
    cost: dict                  # {"flops", "bytes accessed"}, one device


class MonitorSession:
    """Accumulating, phase-aware monitoring context (see module docstring).

    ``mesh`` (a ``DeviceMesh``, e.g. from :func:`fake_mesh`) fixes the
    device topology for every capture; ``algorithm`` is the default binding
    of the views and the snapshot report.  Each capture records its
    def-use graph for the lint.
    """

    def __init__(self, mesh=None, name: str = "session",
                 algorithm: str = "ring"):
        from torch._subclasses.fake_tensor import FakeTensorMode

        cost_models.validate_algorithm(algorithm)
        decompose.reset_fallback_warnings()
        self.mesh = mesh
        self.name = name
        self.algorithm = algorithm
        self.topo = MeshTopology.from_mesh(mesh) if mesh is not None else None
        self.num_devices = int(mesh.size()) if mesh is not None else 1
        self.fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
        self.captures: list[Capture] = []
        self.host_transfers: list[HostTransfer] = []
        self._phases: dict[str, PhaseRecord] = {}
        self._phase_stack: list[str] = []
        self._views: dict = {}

    def __enter__(self) -> "MonitorSession":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    @contextlib.contextmanager
    def phase(self, name: str):
        """Scope subsequent captures under phase ``name``."""
        if not name:
            raise ValueError("phase name must be non-empty")
        self._phase_record(name)
        self._phase_stack.append(name)
        try:
            yield self
        finally:
            self._phase_stack.pop()

    @property
    def current_phase(self) -> str:
        return self._phase_stack[-1] if self._phase_stack else DEFAULT_PHASE

    def _phase_record(self, name: str) -> PhaseRecord:
        if name not in self._phases:
            self._phases[name] = PhaseRecord(name=name)
        return self._phases[name]

    # -- capture -----------------------------------------------------------
    def capture(self, fn, *args, name: Optional[str] = None,
                phase: Optional[str] = None,
                host_transfers: Optional[Iterable[HostTransfer]] = None,
                op_transform=None, **kwargs) -> Capture:
        """Run ``fn(*args, **kwargs)`` under the session's fake mode and
        the interceptor; accumulate its collectives.

        Inputs should be stand-ins made under :attr:`fake_mode`.
        ``op_transform`` (``CollectiveOp -> CollectiveOp``) is applied to
        every recorded op; returning ``None`` keeps the original.
        """
        phase_name = phase or self.current_phase
        rec = self._phase_record(phase_name)
        t0 = time.perf_counter()
        with self.fake_mode, CollectiveInterceptor(
                self.mesh, defuse=True, cost=True) as icpt:
            icpt.defuse.note_inputs((args, kwargs))
            returned = fn(*args, **kwargs)
        seconds = time.perf_counter() - t0
        ops = icpt.ops
        if op_transform is not None:
            ops = [op_transform(op) or op for op in ops]
        graph = icpt.defuse.graph(returned)
        graph.bind_ops(ops)
        for op in ops:
            op.phase = phase_name
        for ev in icpt.events:
            ev.phase = phase_name
        cap = Capture(name=name or getattr(fn, "__name__", "fn"),
                      phase=phase_name, ops=ops, traced=list(icpt.events),
                      trace_seconds=seconds, graph=graph,
                      cost=icpt.cost.cost())
        self.captures.append(cap)
        rec.num_captures += 1
        rec.trace_seconds += seconds
        if host_transfers:
            self.add_host_transfers(host_transfers, phase=phase_name)
        self._views.clear()
        return cap

    def add_host_transfers(self, transfers: Iterable[HostTransfer],
                           phase: Optional[str] = None):
        """Record host<->device transfers (paper row/col 0), phase-tagged
        (untagged transfers are copied with the active phase)."""
        phase_name = phase or self.current_phase
        self._phase_record(phase_name)
        for t in transfers:
            if not t.phase:
                t = dataclasses.replace(t, phase=phase_name)
            else:
                self._phase_record(t.phase)
            self.host_transfers.append(t)
        self._views.clear()

    # -- accumulated state -------------------------------------------------
    @property
    def compiled_ops(self) -> list[CollectiveOp]:
        """Every recorded op (the reference's name: its ops come from the
        compiled module)."""
        return [op for cap in self.captures for op in cap.ops]

    @property
    def traced(self) -> list[TraceEvent]:
        return [ev for cap in self.captures for ev in cap.traced]

    @property
    def trace_seconds(self) -> float:
        return sum(c.trace_seconds for c in self.captures)

    def phase_names(self) -> list[str]:
        return list(self._phases)

    @property
    def graphs(self) -> list[DefUseGraph]:
        """The captures' def-use graphs, one a capture."""
        return [c.graph for c in self.captures]

    def _merged_cost(self) -> dict:
        """Per-device FLOPs and bytes summed over the captures."""
        out: dict[str, float] = {}
        for cap in self.captures:
            for k, v in cap.cost.items():
                out[k] = out.get(k, 0.0) + float(v)
        return out

    # -- views and snapshots -----------------------------------------------
    def view(self, algorithm: Optional[str] = None,
             phase: Optional[str] = None) -> CommView:
        """Lazy :class:`CommView` of the session (or one ``phase``);
        memoized per ``(algorithm, phase)``, invalidated by a capture."""
        alg = algorithm or self.algorithm
        cost_models.validate_algorithm(alg)
        key = (alg, phase)
        if key not in self._views:
            self._views[key] = build_view(
                self.compiled_ops, self.num_devices, alg, self.topo,
                self.host_transfers, phase=phase,
                known_phases=self.phase_names(), label=self.name,
                graphs=self.graphs)
        return self._views[key]

    def report(self, name: Optional[str] = None):
        """Snapshot the session into a serializable
        :class:`~repro_torch.core.monitor.CommReport`."""
        from .monitor import CommReport   # deferred: monitor imports us

        v = self.view()
        rep = CommReport(
            name=name or self.name,
            num_devices=self.num_devices,
            traced=list(self.traced),
            compiled_ops=list(self.compiled_ops),
            traced_summary=traced_summary(self.traced),
            compiled_summary=v.summary,
            matrix=v.matrix,
            per_primitive=v.per_primitive,
            cost=self._merged_cost(),
            memory_stats=None,
            trace_seconds=self.trace_seconds,
            compile_seconds=0.0,
            topo=self.topo,
            host_transfers=list(self.host_transfers),
            algorithm=self.algorithm,
            phases=[dataclasses.replace(p) for p in self._phases.values()],
        )
        rep._defuse_graphs = self.graphs
        return rep
