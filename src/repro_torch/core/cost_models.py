"""Algorithm-aware data-movement models (port of ``repro.core.cost_models``).

The paper's central quantitative artifact is Table 1: the bytes a rank sends/
receives for an AllReduce of payload ``S`` over ``N`` ranks depends on the
algorithm NCCL picked (ring / tree / collnet).  XLA's TPU collectives have the
same structure; the TPU-native algorithm menu is:

* ``ring``         -- bandwidth-optimal ring per torus axis (XLA default for
                      large payloads; NCCL-ring analogue).
* ``tree``         -- binary reduce/broadcast tree, logarithmic latency (small
                      payloads; NCCL-tree analogue).
* ``hierarchical`` -- phase decomposition across the pod boundary (the
                      collnet/SHARP analogue): intra-pod ring phases over ICI
                      around a cross-pod DCN shard exchange, degenerating
                      exactly to ``ring`` at ``pods=1``.

Every entry below is **derived from the one schedule engine**
(:mod:`repro_torch.core.decompose`): :func:`wire_bytes_per_rank` sums the per-rank
bytes of the phases :func:`repro_torch.core.decompose.group_phases` emits,
:func:`device_send_bytes` resolves them per device role (tree roots/leaves
send different amounts), and :func:`collective_time_split` streams each
phase's bytes at its tier's bandwidth **plus the phase's serial
``latency_hops`` at the tier's per-hop latency** (the latency term
:func:`latency_model` describes, finally billed).  There is no per-kind
algorithm branching left here -- the schedule IR is the single source of
truth shared with matrix placement and link projection, so they cannot
diverge.  The algorithm menu, the shared hierarchical predicate and the
tree-structure helpers live in :mod:`repro_torch.core.decompose` and are
re-exported here for compatibility.
"""
from __future__ import annotations

import math
from typing import Iterable, Optional

import numpy as np

from . import decompose as _dec
from .decompose import (BoundedCache, effective_byte_vector,  # noqa: F401
                        effective_pods, validate_algorithm)
from .events import CollectiveOp
from .topology import MeshTopology

# Bounded caches for the Table-1 entry points: a long session repeats a few
# (kind, payload, n, algorithm, pods) tuples, and the cap keeps an
# adversarial stream from growing them without bound.
_PER_RANK_CACHE = BoundedCache(maxsize=8192)
_GROUP_TOTAL_CACHE = BoundedCache(maxsize=8192)


def clear_billing_caches() -> None:
    """Drop the memoized Table-1 entries (tests, post-spec mutation)."""
    _PER_RANK_CACHE.clear()
    _GROUP_TOTAL_CACHE.clear()


def wire_bytes_per_rank(kind: str, payload: float, n: int,
                        algorithm: str = "ring", *, pods: int = 1,
                        vec=None) -> float:
    """Bytes *sent* by one rank for one collective (paper Table 1 analogue).

    ``payload`` is S (the full logical payload per group), ``n`` the group
    size, ``pods`` the number of DCN tiers the group spans (pass
    :func:`effective_pods` so a group the schedule cannot decompose
    degenerates here too).  The value is the per-rank sum over the phases
    of :func:`repro_torch.core.decompose.group_phases` -- the same schedule the
    matrix placement walks -- which reproduces the closed-form Table-1
    entries exactly:

    ========================  =====================  ====================
    kind (hierarchical)       intra-pod (ICI)        cross-pod (DCN)
    ========================  =====================  ====================
    all-reduce                ``2(m-1)/m * S``       ``2(p-1)/n * S``
    all-gather                ``(m-1)/m * S``        ``(p-1)/n * S``
    reduce-scatter            ``(m-1)/m * S``        ``(p-1)/n * S``
    collective-broadcast      ``(m-1)/m * S``        ``(p-1)/n * S``
    ========================  =====================  ====================

    (``m = n/pods``; ring entries are the ``pods=1`` degenerate case:
    ``2(n-1)/n*S`` for all-reduce, ``(n-1)/n*S`` for the one-phase kinds,
    ``(n-1)/n^2*S`` for all-to-all; hierarchical all-to-all pays
    ``2(m-1)S/(p m^2)`` intra-pod plus ``(p-1)S/(p^2 m)`` over DCN.)
    Receives mirror sends for the symmetric entries; tree entries report
    the non-root (dominant) cost, with :func:`device_send_bytes`
    resolving per-role amounts.

    ``vec`` is an optional per-rank byte vector (irregular collectives):
    a uniform vector collapses to the cached scalar path bitwise; a
    genuinely skewed one bills the **straggler** -- the max over the
    per-device send totals of the vector schedule.
    """
    if n <= 1:
        return 0.0
    validate_algorithm(algorithm)
    vec = effective_byte_vector(kind, vec, n)
    if vec is None:
        return _per_rank_cached(kind, float(payload), n, algorithm,
                                int(pods))
    phases = _dec.group_phases(kind, float(vec.sum()),
                               np.arange(n, dtype=np.intp), algorithm,
                               topo=None, pods=int(pods), warn=False,
                               vec=vec)
    totals: dict[int, float] = {}
    for ph in phases:
        for d, b in ph.send_bytes().items():
            totals[d] = totals.get(d, 0.0) + b
    return float(max(totals.values(), default=0.0))


def _per_rank_cached(kind: str, payload: float, n: int, algorithm: str,
                     pods: int) -> float:
    """Scalar-cached per-rank sum over the abstract phase plan (ops repeat
    the same (kind, payload, n) tuples across summaries and matrices, so
    the schedule is built once per distinct entry)."""
    key = (kind, payload, n, algorithm, pods)
    hit = _PER_RANK_CACHE.get(key)
    if hit is not None:
        return hit
    phases = _dec.group_phases(kind, payload, np.arange(n, dtype=np.intp),
                               algorithm, topo=None, pods=pods,
                               warn=False)
    out = float(sum(ph.bytes_per_rank for ph in phases))
    _PER_RANK_CACHE.put(key, out)
    return out


def wire_bytes_group_total(kind: str, payload: float, n: int,
                           algorithm: str = "ring", *, pods: int = 1,
                           vec=None) -> float:
    """Bytes on the wire summed over every rank of ONE group.

    The per-device sum over the group's schedule: for the symmetric (ring,
    hierarchical) entries this is ``n * wire_bytes_per_rank``; tree phases
    resolve true per-role amounts (a binary tree all-reduce moves
    ``2*(n-1)*S`` total: S up and S down each of its ``n-1`` edges), so
    matrices, summaries and cost models all agree on the same totals.
    ``vec`` follows :func:`wire_bytes_per_rank`: irregular groups sum
    their true per-position amounts (cache bypassed; uniform vectors
    collapse to the cached scalar path).
    """
    if n <= 1:
        return 0.0
    validate_algorithm(algorithm)
    vec = effective_byte_vector(kind, vec, n)
    if vec is None:
        return _group_total_cached(kind, float(payload), n, algorithm,
                                   int(pods))
    phases = _dec.group_phases(kind, float(vec.sum()),
                               np.arange(n, dtype=np.intp), algorithm,
                               topo=None, pods=int(pods), warn=False,
                               vec=vec)
    return float(sum(ph.total_send_bytes() for ph in phases))


def _group_total_cached(kind: str, payload: float, n: int, algorithm: str,
                        pods: int) -> float:
    key = (kind, payload, n, algorithm, pods)
    hit = _GROUP_TOTAL_CACHE.get(key)
    if hit is not None:
        return hit
    phases = _dec.group_phases(kind, payload, np.arange(n, dtype=np.intp),
                               algorithm, topo=None, pods=pods,
                               warn=False)
    out = float(sum(ph.total_send_bytes() for ph in phases))
    _GROUP_TOTAL_CACHE.put(key, out)
    return out


def device_send_bytes(kind: str, payload: float, group: list[int],
                      algorithm: str = "ring",
                      topo: Optional[MeshTopology] = None, *,
                      vec=None) -> dict[int, float]:
    """Bytes each device of ``group`` sends for one collective execution.

    The per-role resolution of :func:`wire_bytes_per_rank` -- the
    matrix/model consistency contract: ``matrix_for_ops`` row sums must
    equal these values (times the op weight).  Both sides read the same
    schedule, so the contract holds by construction: ring and hierarchical
    phases are symmetric (every rank sends the per-phase amount); tree
    phases depend on the device's position (root sends S per child, a leaf
    sends S up and nothing down); vector phases resolve their per-position
    amounts (``vec`` is positional over ``group``'s order).
    """
    out = {d: 0.0 for d in group}
    if len(group) <= 1:
        return out
    phases = _dec.group_phases(kind, float(payload), group, algorithm,
                               topo, warn=False, vec=vec)
    for ph in phases:
        for d, b in ph.send_bytes().items():
            out[d] = out.get(d, 0.0) + b
    return out


def collective_time_split(op: CollectiveOp, topo: MeshTopology,
                          algorithm: str = "ring", *,
                          include_latency: bool = True) -> tuple[float, float]:
    """``(ici_seconds, dcn_seconds)`` for one collective.

    The per-tier resolution of :func:`collective_time`, read off the op's
    :func:`~repro_torch.core.decompose.decompose` schedule: each phase streams
    its per-rank bytes at its tier's per-chip ring bandwidth and adds its
    serial ``latency_hops`` at the tier's per-hop latency
    (``HardwareSpec.ici_hop_latency_s`` / ``dcn_hop_latency_s``; set
    ``include_latency=False`` for the pure bandwidth term, e.g. to compare
    against byte-conservation invariants).  Phase streams of disjoint
    replica groups run concurrently, so each tier's time is the max over
    streams.  The *requested* algorithm is honoured:

    * intra-pod groups stream over ICI only (per-axis decomposed groups
      pay fewer serial hops than the flattened ring -- same bytes, less
      latency);
    * a **hierarchical** group across pods that the shared predicate
      accepts pays its intra-pod phases over ICI and only the shard
      exchange over DCN;
    * a hierarchical request the predicate *refuses* is billed exactly
      like the placement's fallback -- flat ring phases crossing DCN --
      never as a phantom decomposition;
    * a **ring or tree** group spanning pods streams its full per-rank
      payload at the per-chip DCN share -- it is NOT silently rebilled as
      hierarchical (that would contradict the matrix's edge placement).
    """
    return _dec.cached_decompose(op, algorithm, topo,
                                 warn=False).time_split(
        topo, include_latency=include_latency)


def collective_time(op: CollectiveOp, topo: MeshTopology,
                    algorithm: str = "ring", *,
                    include_latency: bool = True) -> float:
    """Seconds for one collective on the torus: the serialized sum of the
    per-tier terms of :func:`collective_time_split`."""
    ici, dcn = collective_time_split(op, topo, algorithm,
                                     include_latency=include_latency)
    return ici + dcn


def total_time(ops: Iterable[CollectiveOp], topo: MeshTopology,
               algorithm: str = "ring", *,
               include_latency: bool = True) -> float:
    """Serialized collective time (no overlap) -- upper bound / roofline term.

    Execution-weighted: an op inside a while body contributes once per trip.
    """
    return float(sum(
        collective_time(op, topo, algorithm,
                        include_latency=include_latency)
        * max(1.0, getattr(op, "weight", 1.0)) for op in ops))


def total_time_split(ops: Iterable[CollectiveOp], topo: MeshTopology,
                     algorithm: str = "ring", *,
                     include_latency: bool = True) -> tuple[float, float]:
    """Execution-weighted per-tier serialized sums ``(ici_s, dcn_s)``.

    ``total_time == sum(total_time_split)`` by construction; the overlap
    roofline bound takes ``max`` of these instead of their sum (ICI and DCN
    are independent fabrics, so their busy times can fully overlap).
    Evaluated through the columnar :class:`~repro_torch.core.decompose.
    ScheduleBatch` (decompose once per distinct shape, per-tier sums as
    array expressions) -- bitwise identical to the per-op loop it
    replaced.
    """
    batch = _dec.ScheduleBatch.from_ops(list(ops), algorithm, topo,
                                        warn=False)
    return batch.total_time_split(topo, include_latency=include_latency)


def contention_time(ops: Iterable[CollectiveOp], topo: MeshTopology,
                    algorithm: str = "ring") -> float:
    """Bottleneck seconds: project every op onto physical links and take the
    busiest link (bytes / link bandwidth), instead of a flat per-chip
    bandwidth.  This is the contention-aware lower bound on communication
    time -- two logical edges sharing one ICI cable serialize on it.
    (Pure bandwidth: link projection carries bytes, not hop latencies.)
    """
    from . import comm_matrix  # deferred: comm_matrix imports this module

    lu = comm_matrix.link_utilization_for_ops(list(ops), topo, algorithm)
    return lu.bottleneck_seconds()


# ----------------------------------------------------------------------------
# Paper Table 1 (verbatim) -- used by tests & table1 benchmark to check that
# our generalized formulas reduce to the published entries.
# ----------------------------------------------------------------------------
def table1_allreduce_bytes(n: int, s: float, algorithm: str, role: str = "other") -> float:
    if algorithm == "ring":
        return 2.0 * (n - 1) * s / n
    if algorithm == "tree":
        return s if role == "root" else 2.0 * s
    if algorithm == "collnet":
        # paper: intranode 2S, internode S (SHARP in-network reduction)
        return 2.0 * s if role == "intranode" else s
    raise ValueError(algorithm)


def latency_model(kind: str, n: int, algorithm: str = "ring") -> float:
    """Number of serial hops (latency term), for small-payload reasoning.

    The closed-form reference the schedule reproduces on flattened rings:
    ``CollectiveSchedule.latency_hops()`` equals this for single-axis
    groups, and is strictly smaller for per-axis-decomposed multi-axis
    groups (``2 * sum(axis_size - 1)`` instead of ``2 * (n - 1)``).
    """
    if n <= 1:
        return 0.0
    if algorithm == "tree":
        return 2.0 * math.ceil(math.log2(n))
    if kind == "all-reduce":
        return 2.0 * (n - 1)
    return float(n - 1)
