"""Three-term roofline of a captured program (port of
``repro.core.roofline``).

The terms, per device, over the hardware spec's per-chip peaks:

    compute_s    = flops_per_device        / peak_flops_per_chip
    memory_s     = bytes_accessed_per_dev  / hbm_bw_per_chip
    collective_s = wire_bytes_per_device   / link_bw  (spec formula), and a
                   topology-aware estimate (ring/DCN) as a refinement.

The reference reads FLOPs and bytes off the compiled HLO
(``hlo_cost.analyze_hlo``).  The port has no HLO: :func:`analyze` takes the
counts :mod:`repro_torch.core.op_cost` made during the capture (a report's
``cost``) and the report's recorded ops.  FLOPs are the same count (every
dot and convolution; the exceptions are pinned in the tests).  Bytes are
not: the reference's memory term is XLA's fusion-boundary traffic, the
port's each eager op's inputs and outputs, so ``memory_s`` differs from the
reference's by design.  The ``cost_analysis_*`` entries of
``memory_bytes_per_device`` hold the port's own counts (the reference
keeps XLA's loop-unaware ``cost_analysis`` there), and there is no
``hlo_bytes_logical``.

The collective terms run the port's cost models on the recorded ops and
equal the reference's on the same ops exactly: the wire bytes, the
per-tier serialized sums of ``cost_models.total_time_split`` (so
``collective_overlap_s = max(ici, dcn) <= collective_s_topo``), and the
busiest ICI and DCN links of ``LinkUtilization.busy_seconds``.

The default hardware spec stays ``V5E`` (the reference's), on a ``cuda``
mesh too.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from . import cost_models
from .events import CollectiveOp
from .summary import summarize
from .topology import HardwareSpec, MeshTopology, V5E


@dataclasses.dataclass
class RooflineReport:
    arch: str
    mesh: str
    num_devices: int
    # raw inputs
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    # three terms, in seconds
    compute_s: float
    memory_s: float
    collective_s: float
    collective_s_topo: float        # topology-aware (serialized, bw+latency)
    # link-level overlap terms (tiers are independent fabrics)
    collective_ici_s: float = 0.0   # serialized ICI share of collective_s_topo
    collective_dcn_s: float = 0.0   # serialized DCN share of collective_s_topo
    ici_busy_s: float = 0.0         # busiest physical ICI link (w/ transit)
    dcn_busy_s: float = 0.0         # busiest DCN up/downlink
    # analysis
    model_flops: float = 0.0        # 6*N*D (dense) / 6*N_active*D (MoE), global
    useful_flops_ratio: float = 0.0 # MODEL_FLOPS / (flops_per_device*chips)
    peak_fraction: float = 0.0      # compute_s / max(all terms)
    dominant: str = ""
    memory_bytes_per_device: Optional[dict] = None
    collective_breakdown: Optional[dict] = None

    @property
    def bound_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def collective_overlap_s(self) -> float:
        """ICI and DCN are independent fabrics, so their serialized
        per-tier sums run concurrently: ``max``, always <=
        ``collective_s_topo``."""
        return max(self.collective_ici_s, self.collective_dcn_s)

    @property
    def bound_overlap_s(self) -> float:
        """Overlap-aware bound: compute ∥ ICI ∥ DCN (and the HBM stream)."""
        return max(self.compute_s, self.memory_s,
                   self.collective_ici_s, self.collective_dcn_s)

    def one_liner(self) -> str:
        hints = {
            "compute": "increase arithmetic efficiency (less remat recompute, "
                       "larger fused matmuls, avoid redundant einsums)",
            "memory": "reduce HBM traffic (fuse elementwise chains, better remat "
                      "policy, bf16 activations, larger per-op tiles)",
            "collective": "cut wire bytes (overlapped/hierarchical collectives, "
                          "bf16/compressed gradients, resharding to remove "
                          "redundant all-gathers)",
        }
        val = getattr(self, "collective_s" if self.dominant == "collective"
                      else self.dominant + "_s")
        return (f"{self.arch}@{self.mesh}: dominant={self.dominant} "
                f"({val:.3e}s); {hints[self.dominant]}")


def _sum_wire_bytes_per_device(ops: list[CollectiveOp], num_devices: int,
                               algorithm: str = "ring") -> float:
    """Average per-device bytes *sent* over all collective ops in one step."""
    total = 0.0
    for op in ops:
        total += op.wire_bytes_total(algorithm)
    return total / max(1, num_devices)


def analyze(
    *,
    arch: str,
    mesh_name: str,
    cost: dict,
    ops: list[CollectiveOp],
    topo: MeshTopology,
    hw: HardwareSpec = V5E,
    model_flops: float = 0.0,
    memory_stats: Optional[dict] = None,
    algorithm: str = "ring",
    link_utilization=None,
) -> RooflineReport:
    """Build the roofline report for one captured cell.

    ``cost`` is the capture's per-device count (``{"flops", "bytes
    accessed"}``, :mod:`repro_torch.core.op_cost`) and ``ops`` its recorded
    collectives.  ``link_utilization`` lets a caller that already projected
    the program onto physical links (``CommReport.link_utilization()``)
    reuse it for the per-tier busy times.
    """
    flops = float(cost["flops"])
    byts = float(cost["bytes accessed"])
    wire = _sum_wire_bytes_per_device(ops, topo.num_devices, algorithm)

    compute_s = flops / hw.peak_flops_bf16
    memory_s = byts / hw.hbm_bw
    # spec formula: per-device wire bytes over one link's bandwidth
    # (conservative: a ring uses 2 links per axis, captured in the
    # topology-aware estimate below)
    collective_s = wire / hw.ici_bw
    ici_s, dcn_s = cost_models.total_time_split(ops, topo, algorithm)
    collective_s_topo = ici_s + dcn_s
    lu = link_utilization
    if lu is None and ops:
        from . import comm_matrix
        lu = comm_matrix.link_utilization_for_ops(ops, topo, algorithm)

    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    total_flops = flops * topo.num_devices
    mem = dict(memory_stats or {})
    mem["cost_analysis_flops"] = flops
    mem["cost_analysis_bytes"] = byts
    return RooflineReport(
        arch=arch,
        mesh=mesh_name,
        num_devices=topo.num_devices,
        flops_per_device=flops,
        bytes_per_device=byts,
        wire_bytes_per_device=wire,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        collective_s_topo=collective_s_topo,
        collective_ici_s=ici_s,
        collective_dcn_s=dcn_s,
        ici_busy_s=lu.busy_seconds("ici") if lu is not None else 0.0,
        dcn_busy_s=lu.busy_seconds("dcn") if lu is not None else 0.0,
        model_flops=model_flops,
        useful_flops_ratio=(model_flops / total_flops) if total_flops else 0.0,
        peak_fraction=(compute_s / max(terms.values()))
        if max(terms.values()) else 0.0,
        dominant=dominant,
        memory_bytes_per_device=mem,
        collective_breakdown=summarize(ops, algorithm),
    )


# ---------------------------------------------------------------------------
# MODEL_FLOPS helpers — 6*N*D for training, 2*N*D for a forward/decode token
# ---------------------------------------------------------------------------
def train_model_flops(n_params_active: float, tokens: float) -> float:
    return 6.0 * n_params_active * tokens


def forward_model_flops(n_params_active: float, tokens: float) -> float:
    return 2.0 * n_params_active * tokens


def to_row(r: RooflineReport) -> dict:
    return {
        "arch": r.arch,
        "mesh": r.mesh,
        "devices": r.num_devices,
        "flops/dev": r.flops_per_device,
        "bytes/dev": r.bytes_per_device,
        "wire_bytes/dev": r.wire_bytes_per_device,
        "compute_s": r.compute_s,
        "memory_s": r.memory_s,
        "collective_s": r.collective_s,
        "collective_s_topo": r.collective_s_topo,
        "collective_ici_s": r.collective_ici_s,
        "collective_dcn_s": r.collective_dcn_s,
        "collective_overlap_s": r.collective_overlap_s,
        "bound_overlap_s": r.bound_overlap_s,
        "ici_busy_s": r.ici_busy_s,
        "dcn_busy_s": r.dcn_busy_s,
        "dominant": r.dominant,
        "model_flops": r.model_flops,
        "useful_flops_ratio": r.useful_flops_ratio,
    }
