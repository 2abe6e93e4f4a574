"""Normalization shared by every trace frontend (port of
``repro.core.trace.normalize``).

Real traces spell the same collective a dozen ways
(``ncclAllReduceRingLLKernel_sum_f32``, ``all_reduce``, ``psum``,
``AllReduce``) and name devices a dozen more (``GPU 3``,
``/device:TPU:3``, ``Tesla V100-SXM2-16GB (3)``).  This module maps both
onto the repo's canonical vocabulary -- :data:`~repro_torch.core.events.
COLLECTIVE_KINDS` and dense logical device ids -- plus clock alignment
across ranks and the synthetic-op builder that inverts the payload
relations of :attr:`CollectiveOp.payload_bytes` so a measured byte count
round-trips exactly.
"""
from __future__ import annotations

import re
from typing import Optional

from ..events import CollectiveOp, Shape
from .base import TraceParseError

# ---------------------------------------------------------------------------
# collective-kind aliasing
# ---------------------------------------------------------------------------
# Matched against the event name lowercased with every non-letter removed,
# first hit wins -- so order matters: ``ragged-all-to-all`` before
# ``all-to-all``, ``reduce-scatter`` before the bare ``reduce`` aliases.
_KIND_ALIASES: tuple[tuple[str, tuple[str, ...]], ...] = (
    ("ragged-all-to-all", ("raggedalltoall",)),
    ("all-to-all", ("alltoall",)),
    ("reduce-scatter", ("reducescatter",)),
    ("all-gather", ("allgather",)),
    ("all-reduce", ("allreduce", "crossreplicasum", "psum")),
    ("collective-broadcast", ("collectivebroadcast", "broadcast", "bcast")),
    ("collective-permute", ("collectivepermute", "ppermute", "permute",
                            "sendrecv", "neighborexchange")),
)


def collective_kind(raw_name: str) -> Optional[str]:
    """Canonical collective kind for a raw trace-event name, or ``None``
    for non-collective events (gemm kernels, memsets, ...).

    Understands HLO spellings (``all-reduce.17``), jax primitive names
    (``psum``), and NCCL kernel names as nvprof records them
    (``ncclAllReduceRingLLKernel_sum_f32(...)``).
    """
    s = re.sub(r"[^a-z]", "", str(raw_name).lower())
    for kind, keys in _KIND_ALIASES:
        if any(k in s for k in keys):
            return kind
    return None


# ---------------------------------------------------------------------------
# device-id mapping
# ---------------------------------------------------------------------------
_DEVICE_PATTERNS = (
    re.compile(r"\((\d+)\)\s*$"),                  # "Tesla V100-SXM2 (3)"
    re.compile(r"^/?device:[a-z_]+:(\d+)$", re.I),  # "/device:TPU:3"
    re.compile(r"^[a-z_ ]*?(\d+)\s*$", re.I),      # "GPU 3", "gpu3", "3"
)


class DeviceMap:
    """Raw trace device labels -> dense logical device ids.

    ``mapping`` pins explicit label -> id pairs (the device-mapping rule
    for traces whose labels carry no number); otherwise the id is parsed
    out of the label.  With ``num_devices`` set, any id outside
    ``[0, num_devices)`` raises :class:`TraceParseError` naming the label
    -- an unknown device is a mapping bug, never a silent drop.
    """

    def __init__(self, num_devices: Optional[int] = None,
                 mapping: Optional[dict] = None, *,
                 path: Optional[str] = None):
        self.num_devices = num_devices
        self.mapping = dict(mapping or {})
        self.path = path
        self.seen: set[int] = set()

    def resolve(self, raw, *, record: Optional[str] = None) -> int:
        if isinstance(raw, bool):
            raise TraceParseError(f"bad device id {raw!r}",
                                  path=self.path, record=record)
        if isinstance(raw, (int, float)) and int(raw) == raw:
            dev = int(raw)
        else:
            label = str(raw).strip()
            if label in self.mapping:
                dev = int(self.mapping[label])
            else:
                for pat in _DEVICE_PATTERNS:
                    m = pat.search(label)
                    if m:
                        dev = int(m.group(1))
                        break
                else:
                    raise TraceParseError(
                        f"cannot map device label {label!r} to a device id"
                        " (no trailing index; pass an explicit device"
                        " mapping)", path=self.path, record=record)
        if dev < 0 or (self.num_devices is not None
                       and dev >= self.num_devices):
            raise TraceParseError(
                f"device id {dev} out of range for {self.num_devices}"
                f" devices (label {raw!r})", path=self.path, record=record)
        self.seen.add(dev)
        return dev


# ---------------------------------------------------------------------------
# clock alignment
# ---------------------------------------------------------------------------
def align_clocks(ts_by_device: dict, mode: str = "global") -> dict:
    """Per-device clock shift (seconds to subtract from every timestamp).

    ``"global"`` anchors all devices to the earliest timestamp anywhere
    (ranks share a clock -- the jax profiler, single-process nvprof);
    ``"per-device"`` zeroes each device independently (per-rank files
    whose epochs never agreed).  Returns ``{device: shift}``.
    """
    if mode not in ("global", "per-device"):
        raise ValueError(f"unknown clock-align mode {mode!r};"
                         " expected 'global' or 'per-device'")
    firsts = {dev: min(ts) for dev, ts in ts_by_device.items() if ts}
    if not firsts:
        return {}
    if mode == "global":
        t0 = min(firsts.values())
        return {dev: t0 for dev in firsts}
    return firsts


# ---------------------------------------------------------------------------
# synthetic measured ops
# ---------------------------------------------------------------------------
def measured_op(kind: str, *, payload_bytes: float,
                groups: list[list[int]], name: str = "",
                measured_s: Optional[float] = None, weight: float = 1.0,
                phase: str = "",
                pairs: Optional[list[tuple[int, int]]] = None,
                op_name: str = "") -> CollectiveOp:
    """A :class:`CollectiveOp` whose :attr:`payload_bytes` equals the
    measured ``payload_bytes`` exactly.

    Inverts the payload relations of the byte accounting: kinds whose
    result *is* S get a ``u8[S]`` result shape; divide-by-N kinds
    (reduce-scatter, all-to-all) additionally carry an equal per-rank
    byte vector summing to S exactly, so integer division can never leak
    bytes.  ``measured_s`` is the op's TOTAL measured wall seconds across
    all its executions (already including ``weight``).
    """
    payload = int(round(float(payload_bytes)))
    if payload < 0:
        raise ValueError(f"negative payload {payload_bytes!r}")
    groups = [list(g) for g in groups] if groups else []
    n = len(groups[0]) if groups else (
        len({d for p in (pairs or []) for d in p}) or 1)
    vec = None
    if kind in ("reduce-scatter", "all-to-all", "ragged-all-to-all"):
        local = max(1, payload // max(1, n))
        if n >= 2 and payload > 0:
            vec = [payload / n] * n
    else:
        local = payload
    return CollectiveOp(
        kind=kind,
        name=name or kind,
        result_shapes=[Shape(dtype="u8", dims=(local,))],
        replica_groups=groups,
        source_target_pairs=[tuple(p) for p in (pairs or [])],
        op_name=op_name or name or kind,
        weight=float(weight),
        phase=phase,
        bytes_per_rank_vec=vec,
        measured_s=(float(measured_s)
                    if measured_s is not None else None),
    )
