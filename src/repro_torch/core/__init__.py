"""The monitor core of the port: events, topology and its physical links,
cost models, the decomposition engine, dense and sparse matrices, views,
capture and its op counts, reports and their roofline."""
from .comm_matrix import (LinkUtilization, link_utilization_for_ops,
                          matrix_for_ops, project_links)
from .events import CollectiveOp, HostTransfer, PhaseRecord, Shape, TraceEvent
from .monitor import CommReport, monitor_fn, roofline_of
from .session import MonitorSession, fake_mesh
from .sparse import (SPARSE_DEVICE_THRESHOLD, SparseCommMatrix, from_dense,
                     is_sparse)
from .topology import HardwareSpec, Link, MeshTopology, V5E
from .views import CommView

__all__ = ["CollectiveOp", "CommReport", "CommView", "HardwareSpec",
           "HostTransfer", "Link", "LinkUtilization", "MeshTopology",
           "MonitorSession", "PhaseRecord", "SPARSE_DEVICE_THRESHOLD",
           "Shape", "SparseCommMatrix", "TraceEvent", "V5E", "fake_mesh",
           "from_dense", "is_sparse", "link_utilization_for_ops",
           "matrix_for_ops", "monitor_fn", "project_links", "roofline_of"]
