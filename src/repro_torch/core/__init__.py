"""The monitor core of the port: events, topology, cost models, the
decomposition engine, matrices, views, capture and reports."""
from .events import CollectiveOp, HostTransfer, PhaseRecord, Shape, TraceEvent
from .monitor import CommReport, monitor_fn
from .session import MonitorSession, fake_mesh
from .topology import HardwareSpec, MeshTopology, V5E
from .views import CommView

__all__ = ["CollectiveOp", "CommReport", "CommView", "HardwareSpec",
           "HostTransfer", "MeshTopology", "MonitorSession", "PhaseRecord",
           "Shape", "TraceEvent", "V5E", "fake_mesh", "monitor_fn"]
