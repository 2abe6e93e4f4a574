"""Event datatypes for communication monitoring (PyTorch port).

The counterpart of ``repro.core.events``, kept in the reference's vocabulary
(HLO dtype names and collective kinds) so reports cross-load:

* ``TraceEvent``   -- a collective the *application* issued, captured while
  the program runs under the interceptor (the LD_PRELOAD analogue).
* ``CollectiveOp`` -- a collective as it hits the process group: one per
  ``c10d`` call, with per-device result shapes and the replica groups of the
  mesh dimension it ran on.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

# Bytes per element for HLO dtype names.
DTYPE_BYTES = {
    "pred": 1,
    "s4": 1, "u4": 1,
    "s8": 1, "u8": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
    "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3b11fnuz": 1, "f8e4m3fnuz": 1,
    "f8e5m2fnuz": 1, "f8e3m4": 1, "f8e4m3": 1,
}

# Canonical collective kinds (HLO opcode spelling).
COLLECTIVE_KINDS = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
    "collective-broadcast",
    "ragged-all-to-all",
)

# Kinds whose payload may legitimately differ per rank (allgatherv-style
# irregular collectives).  ``bytes_per_rank_vec`` on other kinds is ignored:
# an all-reduce moves the full reduced tensor through every rank, so a
# per-rank contribution vector has no wire meaning.
VECTOR_KINDS = (
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "ragged-all-to-all",
)


@dataclasses.dataclass
class Shape:
    dtype: str
    dims: tuple[int, ...]

    @property
    def num_elements(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n

    @property
    def bytes(self) -> int:
        return self.num_elements * DTYPE_BYTES.get(self.dtype, 4)

    def __repr__(self) -> str:
        return f"{self.dtype}[{','.join(map(str, self.dims))}]"


@dataclasses.dataclass
class CollectiveOp:
    """One collective op from a compiled (SPMD-partitioned, per-device) module."""

    kind: str                            # one of COLLECTIVE_KINDS
    name: str                            # HLO instruction name, e.g. %all-reduce.2
    result_shapes: list[Shape]           # tuple results flattened
    replica_groups: list[list[int]]      # explicit groups (possibly from iota form)
    channel_id: Optional[int] = None
    dimensions: tuple[int, ...] = ()     # gather/scatter/a2a dimension(s)
    source_target_pairs: list[tuple[int, int]] = dataclasses.field(default_factory=list)
    op_name: str = ""                    # source op that issued it
    weight: float = 1.0                  # execution count (while trip counts)
    phase: str = ""                      # session phase ("" = unphased/legacy)
    operand_names: list[str] = dataclasses.field(default_factory=list)
    use_global_device_ids: bool = False  # replica_groups hold global ids
    # Optional per-rank byte vector (irregular collectives, schema v8).
    # ``bytes_per_rank_vec[i]`` is the logical payload contribution (bytes)
    # of group POSITION i, applied positionally to every replica group:
    # the shard rank i contributes to an allgatherv, the chunk destined to
    # rank i for a v-reduce-scatter, the total bytes rank i injects into a
    # skewed all-to-all.  ``sum(vec)`` replaces ``payload_bytes``.  Kept as
    # a plain float list (JSON-friendly, dataclasses.replace-friendly);
    # consumers read the validated ndarray via :meth:`byte_vector`.
    bytes_per_rank_vec: Optional[list] = None
    # Optional *measured* wall-clock seconds (schema v9): the total device
    # time a real trace recorded for this op across all its executions
    # (worst rank for multi-rank records), set by the trace importers
    # (trace import waits for a later port slice).  ``None`` for purely modeled ops -- the
    # cost models never read it, so modeled and measured time coexist and
    # the compare layer (:mod:`repro.core.trace.compare`) can pin one
    # against the other.
    measured_s: Optional[float] = None

    # ------------------------------------------------------------------
    # Byte accounting.  The compiled module is per-device: result shapes are
    # the *local* post-op shapes.  ``payload_bytes`` is the full logical
    # payload S of the collective (paper Table 1's S), per group.
    # ------------------------------------------------------------------
    @property
    def group_size(self) -> int:
        if self.replica_groups:
            return len(self.replica_groups[0])
        if self.source_target_pairs:
            return len({d for p in self.source_target_pairs for d in p})
        return 1

    @property
    def num_groups(self) -> int:
        return max(1, len(self.replica_groups))

    @property
    def result_bytes(self) -> int:
        return sum(s.bytes for s in self.result_shapes)

    def byte_vector(self) -> Optional[np.ndarray]:
        """Validated per-rank byte vector, or None.

        Returns the ``float64`` vector only when the op's kind is in
        :data:`VECTOR_KINDS`, the vector's length matches the group size,
        and every entry is finite and non-negative -- anything else is
        silently treated as the regular (scalar) op, so a stale or
        malformed vector can never corrupt downstream byte accounting.
        """
        if self.bytes_per_rank_vec is None or self.kind not in VECTOR_KINDS:
            return None
        v = np.asarray(self.bytes_per_rank_vec, dtype=np.float64)
        if v.ndim != 1 or v.size != self.group_size or v.size < 2:
            return None
        if not np.all(np.isfinite(v)) or np.any(v < 0) or v.sum() <= 0:
            return None
        return v

    def skew(self) -> float:
        """Max/mean of the per-rank byte vector (1.0 for regular ops)."""
        v = self.byte_vector()
        if v is None:
            return 1.0
        return float(v.max() / v.mean())

    @property
    def payload_bytes(self) -> float:
        """Full logical payload S per group (bytes)."""
        v = self.byte_vector()
        if v is not None:
            return float(v.sum())
        n = self.group_size
        if self.kind == "all-reduce":
            # result (local) == full reduced tensor
            return self.result_bytes
        if self.kind in ("all-gather", "collective-broadcast"):
            # result is the gathered tensor == S
            return self.result_bytes
        if self.kind == "reduce-scatter":
            # result is S/N
            return self.result_bytes * n
        if self.kind in ("all-to-all", "ragged-all-to-all"):
            # each rank holds S/N in and out; define S as the full exchanged set
            return self.result_bytes * n
        if self.kind == "collective-permute":
            return self.result_bytes
        return self.result_bytes

    def wire_bytes_per_rank(self, algorithm: str = "ring",
                            pods: int = 1) -> float:
        """Bytes *sent* by one participating rank (paper Table 1 analogue).

        ``pods`` is the number of DCN tiers the group spans (only the
        hierarchical entries depend on it; pass
        ``cost_models.effective_pods`` so non-decomposable groups
        degenerate to ring exactly like the placement).
        """
        from . import cost_models

        return cost_models.wire_bytes_per_rank(
            self.kind, self.payload_bytes, self.group_size, algorithm,
            pods=pods, vec=self.byte_vector(),
        )

    def wire_bytes_total(self, algorithm: str = "ring",
                         pods: int = 1) -> float:
        """Bytes on the wire summed over every rank in every group,
        weighted by execution count (while-loop trip counts).  Tree
        entries sum true per-role amounts (see
        ``cost_models.wire_bytes_group_total``)."""
        from . import cost_models

        if self.kind == "collective-permute":
            # every group executes the pair schedule (num_groups scales the
            # total exactly like it does for every other kind)
            return float(self.result_bytes
                         * max(1, len(self.source_target_pairs))) \
                * self.num_groups * self.weight
        return (cost_models.wire_bytes_group_total(
                    self.kind, self.payload_bytes, self.group_size,
                    algorithm, pods=pods, vec=self.byte_vector())
                * self.num_groups * self.weight)


@dataclasses.dataclass
class TraceEvent:
    """A collective issued by user code, captured by the interceptor."""

    primitive: str                       # e.g. "psum", "all_gather", "ppermute"
    axis_name: str                       # mesh axis (or tuple repr)
    arg_shapes: list[Shape]
    axis_size: Optional[int] = None      # resolved group size if known
    call_site: str = ""                  # abbreviated stack location
    phase: str = ""                      # session phase ("" = unphased/legacy)

    @property
    def payload_bytes(self) -> int:
        return sum(s.bytes for s in self.arg_shapes)


@dataclasses.dataclass
class HostTransfer:
    """Host<->device transfer (paper's row/col 0); recorded by the data layer."""

    direction: str                       # "h2d" | "d2h"
    device: int
    nbytes: int
    label: str = ""
    phase: str = ""                      # session phase ("" = unphased/legacy)


@dataclasses.dataclass
class PhaseRecord:
    """One named capture phase of a :class:`~repro_torch.core.session.MonitorSession`.

    Serialized with the report (schema v4): ``name`` matches the ``phase``
    tag carried by every :class:`CollectiveOp` / :class:`TraceEvent` /
    :class:`HostTransfer` captured under it, so per-phase views can be
    rebuilt from any loaded report.
    """

    name: str
    num_captures: int = 0
    trace_seconds: float = 0.0
    compile_seconds: float = 0.0


# torch dtype -> HLO dtype name (the reference's report vocabulary)
TORCH_DTYPE_NAMES = {
    torch.float32: "f32", torch.float64: "f64", torch.float16: "f16",
    torch.bfloat16: "bf16", torch.int32: "s32", torch.int64: "s64",
    torch.int16: "s16", torch.int8: "s8", torch.uint8: "u8",
    torch.bool: "pred", torch.complex64: "c64", torch.complex128: "c128",
    torch.float8_e4m3fn: "f8e4m3fn", torch.float8_e5m2: "f8e5m2",
}


def torch_shape(x: torch.Tensor) -> Shape:
    """Shape of a tensor (real, fake or meta) in HLO dtype spelling."""
    return Shape(dtype=TORCH_DTYPE_NAMES.get(x.dtype, str(x.dtype)),
                 dims=tuple(int(d) for d in x.shape))
