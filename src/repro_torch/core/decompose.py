"""Unified collective decomposition engine (port of
``repro.core.decompose``): ONE phase-schedule IR.

:func:`decompose` turns one :class:`~repro_torch.core.events.CollectiveOp`
under one ``(algorithm, topology)`` binding into a
:class:`CollectiveSchedule`, an ordered list of :class:`CommPhase` records.
Every consumer derives from the schedule instead of re-implementing
algorithm knowledge:

* **placement** -- ``comm_matrix.op_edges`` / ``op_edge_arrays`` place each
  phase's edges (ring / tree / all-to-all / explicit pairs);
* **billing**  -- ``cost_models.wire_bytes_per_rank`` /
  ``device_send_bytes`` sum per-phase per-rank bytes;
* **timing**   -- ``cost_models.collective_time_split`` streams each
  phase's bytes at its tier's bandwidth and adds the phase's
  ``latency_hops`` at the tier's per-hop latency.

**Per-axis decomposition.**  A single-pod replica group that is exactly the
Cartesian product of two or more full torus axes decomposes into one ring
phase per torus axis -- reduce-scatter down the axes and all-gather back
up -- moving the same per-rank total (``2*(n-1)/n*S`` for all-reduce)
entirely over neighbour links.  The hierarchical algorithm's intra-pod
phases get the same treatment.

The engine depends on numpy, topology and events only.  Its batched half
evaluates an op stream per *distinct* op shape: :func:`cached_decompose`
memoizes :func:`decompose` on :func:`op_signature`, and
:class:`ScheduleBatch` lays every phase of a stream out in flat columns so
timing runs as array expressions -- bitwise equal to the per-op path.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Iterable, Optional

import numpy as np

from .events import CollectiveOp, VECTOR_KINDS
from .topology import MeshTopology

ALGORITHMS = ("ring", "tree", "hierarchical")

# Kinds the hierarchical algorithm knows how to decompose across pods, and
# the kinds the binary-tree placement covers.
HIERARCHICAL_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                      "collective-broadcast")
TREE_KINDS = HIERARCHICAL_KINDS
# Kinds whose ring form may decompose per torus axis (phase sequences
# below preserve the Table-1 per-rank totals exactly).
AXIS_DECOMPOSABLE_KINDS = HIERARCHICAL_KINDS
# Kinds the hierarchical algorithm decomposes as a two-tier exchange
# (intra-pod all-to-all, pod-slot DCN exchange, intra-pod distribution);
# kept separate from :data:`HIERARCHICAL_KINDS` because the ring-chain
# decomposition and its legacy oracle do not apply to all-to-all.
A2A_KINDS = ("all-to-all", "ragged-all-to-all")


class HierarchicalFallbackWarning(UserWarning):
    """``algorithm="hierarchical"`` was requested for a cross-pod group the
    shared predicate cannot decompose (uneven pod split, or a kind outside
    :data:`HIERARCHICAL_KINDS`); the schedule fell back to flat ring phases
    and billing/timing/placement all follow that same fallback."""


# One warning per (op kind, group size): a large capture decomposes the same
# shape hundreds of times across matrix / billing / timing / lint paths, and
# identical repeats would drown every other diagnostic.
# ``MonitorSession.__init__`` resets the set, so each session warns afresh.
_FALLBACK_SEEN: set[tuple[str, int]] = set()


def reset_fallback_warnings() -> None:
    """Forget which (kind, group size) hierarchical fallbacks already
    warned; the next occurrence of each warns again."""
    _FALLBACK_SEEN.clear()


def warn_fallback_once(kind: str, n: int, message: str,
                       stacklevel: int = 3) -> bool:
    """Emit a :class:`HierarchicalFallbackWarning` once per (kind, group
    size) since the last :func:`reset_fallback_warnings`.  Returns whether
    the warning fired (deduplicated repeats return False)."""
    key = (kind, int(n))
    if key in _FALLBACK_SEEN:
        return False
    _FALLBACK_SEEN.add(key)
    warnings.warn(HierarchicalFallbackWarning(message),
                  stacklevel=stacklevel + 1)
    return True


def _note_fallback(records: Optional[list], warn: bool, kind: str, n: int,
                   message: str) -> None:
    """Record a fallback for memoized replay and (optionally) warn now.

    :func:`decompose` routes its fallback sites through here so
    :func:`cached_decompose` can capture the ``(kind, n, message)``
    triples alongside the schedule and re-issue them on cache hits --
    a hit must warn exactly as loudly as a miss would have (still
    deduplicated by :func:`warn_fallback_once`).
    """
    if records is not None:
        records.append((kind, int(n), message))
    if warn:
        warn_fallback_once(kind, n, message, stacklevel=2)


def validate_algorithm(algorithm: str) -> str:
    """Reject unknown collective algorithms with a clear error.

    Every public entry point that accepts an ``algorithm`` string
    (``monitor_fn``, ``MonitorSession``, ``CommView``, ``matrix_for_ops``,
    the sweep engine / CLI) funnels through here, so a typo like
    ``"treee"`` raises immediately instead of silently falling through to
    ring edge placement.  Returns the validated name for call-through use.
    """
    if algorithm not in ALGORITHMS:
        raise ValueError(
            f"unknown algorithm {algorithm!r}; known: {ALGORITHMS}")
    return algorithm


def _hier_split(n: int, pods: int) -> tuple[int, int]:
    """(pods, in_pod) for a hierarchical decomposition of an ``n``-rank group.

    Degenerates to ``(1, n)`` when the group does not split evenly across
    pods (or there is no DCN tier), which makes hierarchical == ring.
    """
    p = max(1, int(pods))
    if p <= 1 or n % p != 0 or n // p < 1:
        return 1, n
    return p, n // p


def hierarchical_decomposition(
        kind: str, group: list[int],
        topo: Optional[MeshTopology]) -> Optional[
            tuple[int, int, list[list[int]]]]:
    """``(p, m, subgroups)`` when ``kind`` over ``group`` decomposes
    hierarchically.

    The single shared predicate behind the whole schedule engine: a group
    decomposes iff the kind is one of :data:`HIERARCHICAL_KINDS`, the group
    spans more than one pod, and the pods partition it into equal-size
    subgroups.  ``None`` otherwise -- placement, billing and timing all
    fall back to the flat ring model together because they all read the
    same schedule.  The per-pod subgroups ride along so callers never
    recompute the partition.
    """
    if topo is None or kind not in HIERARCHICAL_KINDS or not group:
        return None
    if not topo.group_crosses_dcn(group):
        return None
    subs = topo.pod_partition(group)
    p, n = len(subs), len(group)
    if p <= 1 or n % p != 0 or any(len(sub) != n // p for sub in subs):
        return None
    return p, n // p, subs


def a2a_decomposition(
        kind: str, group: list[int],
        topo: Optional[MeshTopology]) -> Optional[
            tuple[int, int, list[list[int]]]]:
    """``(p, m, subgroups)`` when an all-to-all over ``group`` decomposes
    into the two-tier exchange (the :data:`A2A_KINDS` twin of
    :func:`hierarchical_decomposition`, same acceptance rule: the group
    spans more than one pod and the pods partition it into equal-size
    subgroups).  ``None`` otherwise -- placement, billing and timing all
    fall back to the flat all-to-all phase together."""
    if topo is None or kind not in A2A_KINDS or not group:
        return None
    if not topo.group_crosses_dcn(group):
        return None
    subs = topo.pod_partition(group)
    p, n = len(subs), len(group)
    if p <= 1 or n % p != 0 or any(len(sub) != n // p for sub in subs):
        return None
    return p, n // p, subs


def effective_pods(kind: str, group: list[int],
                   topo: Optional[MeshTopology]) -> int:
    """``pods`` argument for the Table-1 entries: the decomposition's ``p``
    when :func:`hierarchical_decomposition` (or, for :data:`A2A_KINDS`,
    :func:`a2a_decomposition`) accepts the triple, else 1 (so hierarchical
    degenerates to ring exactly where the schedule does)."""
    dec = hierarchical_decomposition(kind, group, topo)
    if dec is None:
        dec = a2a_decomposition(kind, group, topo)
    return dec[0] if dec is not None else 1


def effective_byte_vector(kind: str, vec, n: int) -> Optional[np.ndarray]:
    """Validated, genuinely irregular per-rank byte vector, or ``None``.

    The single collapse point of the vector IR: a missing / malformed /
    wrong-kind / wrong-length vector -- and, crucially, a **uniform**
    one -- returns ``None``, routing the op down the scalar path with
    ``payload = sum(vec)``.  A uniform vector's sum is exactly the scalar
    payload, so uniform-vector ops reproduce scalar matrices, bills and
    times bitwise; only genuinely skewed vectors ever reach the vector
    phase constructors.  ``vec[i]`` is positional: the bytes the rank at
    group position ``i`` injects, applied identically to every replica
    group of the op.
    """
    if vec is None or kind not in VECTOR_KINDS:
        return None
    v = np.asarray(vec, dtype=np.float64)
    if v.ndim != 1 or int(v.size) != int(n) or v.size < 2:
        return None
    if not np.all(np.isfinite(v)) or np.any(v < 0) or v.sum() <= 0:
        return None
    if float(v.max()) == float(v.min()):
        return None
    return v


def hier_phases(kind: str) -> float:
    """Ring phases per tier: all-reduce = RS + AG (2), the one-phase kinds
    (all-gather / reduce-scatter / scatter-allgather broadcast) = 1."""
    return 2.0 if kind == "all-reduce" else 1.0


# ----------------------------------------------------------------------------
# Binary-tree structure (heap layout over group positions) -- the one
# definition every consumer of tree phases resolves per-role amounts from.
# ----------------------------------------------------------------------------
def tree_children(i: int, n: int) -> list[int]:
    """Children of position ``i`` in the implicit binary tree over ``n``."""
    return [c for c in (2 * i + 1, 2 * i + 2) if c < n]


def tree_subtree_sizes(n: int) -> list[int]:
    """Subtree size per position of the implicit binary tree over ``n``."""
    sizes = [1] * n
    for i in range(n - 1, 0, -1):
        sizes[(i - 1) // 2] += sizes[i]
    return sizes


def tree_latency_hops(n: int) -> float:
    """Serial hops of a double binary tree pass (up + down)."""
    return 2.0 * math.ceil(math.log2(n)) if n > 1 else 0.0


def tree_edge_profile(kind: str, s: float,
                      n: int) -> tuple[np.ndarray, np.ndarray]:
    """``(up, down)`` bytes per tree position ``1..n-1`` (child index).

    ``up[i-1]`` is what position ``i`` sends to its parent, ``down[i-1]``
    what the parent sends back down that edge:

    * all-reduce: S up (reduce) and S down (broadcast) every edge,
    * broadcast: S down only,
    * all-gather: a child sends its subtree's shards up, a parent sends
      everything the child's subtree lacks down,
    * reduce-scatter: the time-reversed all-gather.
    """
    sizes = np.asarray(tree_subtree_sizes(n), dtype=np.float64)[1:]
    if kind == "all-reduce":
        up = np.full(n - 1, float(s))
        return up, up
    if kind == "collective-broadcast":
        return np.zeros(n - 1), np.full(n - 1, float(s))
    if kind == "all-gather":
        return sizes * s / n, (n - sizes) * s / n
    # reduce-scatter
    return (n - sizes) * s / n, sizes * s / n


def tree_send_bytes(kind: str, s: float, n: int) -> np.ndarray:
    """Bytes each tree *position* sends (per-role resolution of the tree
    phase): root sends S per child, a leaf sends up only."""
    up, down = tree_edge_profile(kind, s, n)
    out = np.zeros(n, dtype=np.float64)
    out[1:] += up                                # child -> parent
    np.add.at(out, (np.arange(1, n) - 1) // 2, down)   # parent -> child
    return out


# ----------------------------------------------------------------------------
# The IR.
# ----------------------------------------------------------------------------
@dataclasses.dataclass
class CommPhase:
    """One step of a collective schedule.

    ``groups`` is a ``(k, m)`` array of ``k`` concurrent same-size groups
    (rings for ``structure="ring"``, heap-layout trees for ``"tree"``,
    full-exchange groups for ``"a2a"``); ``pairs`` replaces it for
    ``structure="pairs"`` (collective-permute).  ``bytes_per_rank`` is what
    each participating rank sends during the phase (the dominant per-role
    amount for tree phases; ``payload`` lets consumers resolve exact
    per-role bytes).  ``latency_hops`` is the phase's serial hop count --
    the latency term ``collective_time_split`` charges at the tier's
    per-hop latency.  ``axis`` names the torus axis the rings run along
    (``""`` for flattened rings, trees and the DCN exchange).  Phases
    sharing a ``stream`` are sequential; distinct streams (disjoint replica
    groups of one op) run concurrently.

    **Irregular phases.**  ``bytes_per_rank`` may be an ndarray instead of
    a float: 1-D of length ``m`` (positional -- entry ``i`` is what the
    rank at group position ``i`` sends, applied to every group row) or 2-D
    of shape ``(k, m)`` (per group row).  Consumers broadcast it to the
    ``groups`` shape (:meth:`byte_matrix`); timing charges the **max**
    entry (:meth:`max_bytes_per_rank` -- the straggler rank paces the
    phase), billing sums the true per-position amounts.  ``pair_bytes``
    likewise carries per-pair bytes for ``structure="pairs"`` phases whose
    pairs move different amounts (the hierarchical permute relay).
    """

    kind: str                       # semantic step, e.g. "reduce-scatter"
    tier: str                       # "ici" | "dcn"
    groups: Optional[np.ndarray]    # (k, m) device ids, or None for pairs
    bytes_per_rank: "float | np.ndarray"
    latency_hops: float
    axis: str = ""                  # torus axis for per-axis ring phases
    structure: str = "ring"         # "ring" | "tree" | "a2a" | "pairs"
    payload: float = 0.0            # logical payload S the phase operates on
    stream: int = 0                 # sequential within, concurrent across
    pairs: Optional[np.ndarray] = None   # (k, 2) for structure "pairs"
    pair_bytes: Optional[np.ndarray] = None  # per-pair bytes (num_groups-scaled)

    @property
    def group_size(self) -> int:
        return 0 if self.groups is None else int(self.groups.shape[-1])

    @property
    def num_groups(self) -> int:
        if self.groups is not None:
            return int(self.groups.shape[0]) if self.groups.ndim > 1 else 1
        return 0 if self.pairs is None else int(len(self.pairs))

    def max_bytes_per_rank(self) -> float:
        """Scalar per-rank bill of the phase: the value itself for scalar
        phases, the **max** entry for vector phases -- the straggler rank
        every other participant waits on, which is what timing charges."""
        if isinstance(self.bytes_per_rank, np.ndarray):
            return float(np.max(self.bytes_per_rank))
        return float(self.bytes_per_rank)

    def byte_matrix(self) -> Optional[np.ndarray]:
        """Per-position send bytes broadcast to the ``groups`` shape
        ``(k, m)``, or ``None`` for scalar phases (1-D vectors are
        positional: the same row applies to every group)."""
        if not isinstance(self.bytes_per_rank, np.ndarray) \
                or self.groups is None:
            return None
        G = np.atleast_2d(self.groups)
        return np.broadcast_to(
            np.asarray(self.bytes_per_rank, dtype=np.float64), G.shape)

    def seconds(self, topo: MeshTopology, *,
                include_latency: bool = True) -> float:
        """Streaming time of this phase on ``topo``: bytes at the tier's
        per-chip ring bandwidth, plus ``latency_hops`` at the tier's
        per-hop latency.  Vector phases stream their **max** per-rank
        bytes -- the straggler paces the phase."""
        dcn = self.tier == "dcn"
        t = self.max_bytes_per_rank() / topo.ring_bw_per_chip(dcn)
        if include_latency:
            t += self.latency_hops * (topo.hw.dcn_hop_latency_s if dcn
                                      else topo.hw.ici_hop_latency_s)
        return t

    def total_send_bytes(self) -> float:
        """Bytes sent by ALL participants of this phase (one execution) --
        the O(1)/vectorized aggregate of :meth:`send_bytes`, for billing
        paths that never need the per-device resolution.  Vector phases
        sum their true per-position amounts (not ``size * max``)."""
        if self.structure == "pairs" and self.pairs is not None:
            if self.pair_bytes is not None:
                return float(np.sum(self.pair_bytes))
            return float(len(self.pairs)) * self.payload
        if self.groups is None:
            return 0.0
        G = np.atleast_2d(self.groups)
        if self.structure == "tree":
            return float(G.shape[0]) * float(
                tree_send_bytes(self.kind, self.payload, G.shape[1]).sum())
        B = self.byte_matrix()
        if B is not None:
            return float(B.sum())
        return float(G.size) * self.bytes_per_rank

    def send_bytes(self) -> dict[int, float]:
        """Bytes each participating device sends during this phase."""
        out: dict[int, float] = {}
        if self.structure == "pairs" and self.pairs is not None:
            if self.pair_bytes is not None:
                for src, b in zip(self.pairs[:, 0].tolist(),
                                  self.pair_bytes.tolist()):
                    out[src] = out.get(src, 0.0) + b
                return out
            # payload is the per-edge byte amount (num_groups-scaled)
            for src in self.pairs[:, 0].tolist():
                out[src] = out.get(src, 0.0) + self.payload
            return out
        if self.groups is None:
            return out
        G = np.atleast_2d(self.groups)
        if self.structure == "tree":
            per_pos = tree_send_bytes(self.kind, self.payload, G.shape[1])
            for row in G:
                for d, b in zip(row.tolist(), per_pos.tolist()):
                    out[d] = out.get(d, 0.0) + b
            return out
        B = self.byte_matrix()
        if B is not None:
            for row, brow in zip(G, B):
                for d, b in zip(row.tolist(), brow.tolist()):
                    out[d] = out.get(d, 0.0) + b
            return out
        for d in G.ravel().tolist():
            out[d] = out.get(d, 0.0) + self.bytes_per_rank
        return out

    def to_summary(self) -> dict:
        """Serializable record (schema-v5 ``schedules`` section); vector
        phases report their max as ``bytes_per_rank`` plus mean and skew."""
        out = {
            "kind": self.kind,
            "tier": self.tier,
            "structure": self.structure,
            "axis": self.axis,
            "num_groups": self.num_groups,
            "group_size": self.group_size,
            "bytes_per_rank": self.max_bytes_per_rank(),
            "latency_hops": float(self.latency_hops),
            "stream": self.stream,
        }
        if isinstance(self.bytes_per_rank, np.ndarray):
            mean = float(np.mean(self.bytes_per_rank))
            out["bytes_per_rank_mean"] = mean
            out["skew"] = (out["bytes_per_rank"] / mean) if mean > 0 else 1.0
        return out


@dataclasses.dataclass
class CollectiveSchedule:
    """Ordered phase list for ONE execution of one collective op."""

    op_kind: str
    algorithm: str
    phases: list[CommPhase]

    def __iter__(self):
        return iter(self.phases)

    def time_split(self, topo: MeshTopology, *,
                   include_latency: bool = True) -> tuple[float, float]:
        """``(ici_seconds, dcn_seconds)`` for one execution.

        Phases of one stream serialize (sum); streams are disjoint replica
        groups running concurrently, so each tier's time is the max over
        streams -- the same semantics ``collective_time_split`` always had,
        now read off the schedule.
        """
        by_stream: dict[int, list[float]] = {}
        for ph in self.phases:
            acc = by_stream.setdefault(ph.stream, [0.0, 0.0])
            acc[ph.tier == "dcn"] += ph.seconds(
                topo, include_latency=include_latency)
        ici = max((v[0] for v in by_stream.values()), default=0.0)
        dcn = max((v[1] for v in by_stream.values()), default=0.0)
        return ici, dcn

    def total_bytes(self) -> float:
        """Wire bytes summed over every device (one execution)."""
        return float(sum(ph.total_send_bytes() for ph in self.phases))

    def latency_hops(self, tier: Optional[str] = None) -> float:
        """Serial hops on the slowest stream (per tier, or both summed)."""
        by_stream: dict[int, float] = {}
        for ph in self.phases:
            if tier is not None and ph.tier != tier:
                continue
            by_stream[ph.stream] = by_stream.get(ph.stream, 0.0) \
                + ph.latency_hops
        return max(by_stream.values(), default=0.0)

    def summary(self) -> dict:
        return {"kind": self.op_kind, "algorithm": self.algorithm,
                "phases": [ph.to_summary() for ph in self.phases]}


# ----------------------------------------------------------------------------
# Per-axis ring detection: is a group the Cartesian product of full torus
# axes (other coordinates fixed, single pod)?
# ----------------------------------------------------------------------------
def axis_rings(group, topo: Optional[MeshTopology]) -> Optional[
        list[tuple[str, np.ndarray]]]:
    """``[(axis_name, rings)]`` when ``group`` decomposes per torus axis.

    Accepts exactly the groups a mesh collective over named axes produces:
    every member in one pod, the member set equal to the Cartesian product
    of **two or more full ICI axes** (each participating axis spans its
    whole size, so every ring is a torus-neighbour ring with a one-hop
    wrap), all other coordinates fixed.  ``rings`` is a ``(k, size)`` array
    of the axis' neighbour rings in coordinate order.  ``None`` otherwise
    -- single-axis groups keep their (identical) flattened ring so the
    legacy oracle stays byte-exact on them.
    """
    n = len(group)
    if topo is None or n <= 1 or topo.group_crosses_dcn(list(group)):
        return None
    coords = np.asarray([topo.coords(d) for d in group])
    part: list[int] = []
    for i, name in enumerate(topo.axis_names):
        vals = np.unique(coords[:, i])
        if len(vals) == 1:
            continue
        if name in topo.dcn_axes or len(vals) != topo.axis_sizes[i] \
                or not np.array_equal(vals, np.arange(topo.axis_sizes[i])):
            return None
        part.append(i)
    if len(part) < 2:
        return None
    sizes = [topo.axis_sizes[i] for i in part]
    if n != math.prod(sizes):
        return None
    order = np.lexsort(tuple(coords[:, i] for i in reversed(part)))
    sorted_coords = coords[order][:, part]
    expect = np.stack(np.meshgrid(*[np.arange(s) for s in sizes],
                                  indexing="ij"), -1).reshape(n, len(part))
    if not np.array_equal(sorted_coords, expect):
        return None
    garr = np.asarray(group, dtype=np.intp)[order].reshape(sizes)
    out = []
    for j, i in enumerate(part):
        rings = np.moveaxis(garr, j, -1).reshape(-1, sizes[j])
        out.append((topo.axis_names[i], rings))
    return out


# ----------------------------------------------------------------------------
# Phase construction.
# ----------------------------------------------------------------------------
def _gather_chain(kind: str, chunk: float,
                  axes: list[tuple[str, np.ndarray]], tier: str,
                  stream: int) -> list[CommPhase]:
    """All-gather-direction ring phases along ``axes`` (growing chunks).

    Starting from a per-rank ``chunk``, each axis phase forwards
    ``(size-1) * chunk`` around its rings and multiplies the chunk by the
    axis size -- the shard-growth schedule whose per-rank total telescopes
    to ``(prod-1) * chunk``.  Reduce-scatter chains are the time-reverse:
    same per-axis amounts, reversed order (see :func:`_scatter_chain`).
    """
    out = []
    for axis_name, rings in axes:
        size = int(rings.shape[-1])
        out.append(CommPhase(
            kind=kind, tier=tier, groups=rings,
            bytes_per_rank=(size - 1) * chunk,
            latency_hops=float(size - 1), axis=axis_name, stream=stream))
        chunk *= size
    return out


def _scatter_chain(kind: str, chunk: float,
                   axes: list[tuple[str, np.ndarray]], tier: str,
                   stream: int) -> list[CommPhase]:
    """Reduce-scatter-direction chain: the reversed gather chain."""
    return list(reversed(_gather_chain(kind, chunk, axes, tier, stream)))


def _ring_phases(kind: str, s: float, axes: list[tuple[str, np.ndarray]],
                 n: int, tier: str, stream: int) -> list[CommPhase]:
    """Ring phase sequence for one (possibly per-axis) ring placement.

    ``axes`` is the ring set per torus axis (one flattened entry for a
    non-decomposable group); ``n`` the total member count.  All-reduce is
    the scatter chain followed by the mirrored gather chain (per-rank total
    ``2*(n-1)/n*S``); the one-phase kinds run a single gather- or
    scatter-direction chain (``(n-1)/n*S``); anything else streams its full
    payload once around the (flattened) rings, matching the generic ring
    entry.
    """
    if kind == "all-reduce":
        return (_scatter_chain("reduce-scatter", s / n, axes, tier, stream)
                + _gather_chain("all-gather", s / n, axes, tier, stream))
    if kind in ("all-gather", "collective-broadcast"):
        return _gather_chain(kind, s / n, axes, tier, stream)
    if kind == "reduce-scatter":
        return _scatter_chain(kind, s / n, axes, tier, stream)
    # generic/unknown kind: full payload once around the rings
    return [CommPhase(kind=kind, tier=tier, groups=rings,
                      bytes_per_rank=s,
                      latency_hops=float(rings.shape[-1] - 1),
                      axis=axis_name, stream=stream)
            for axis_name, rings in axes]


def _flat_phases(kind: str, s: float, arr: np.ndarray, algorithm: str,
                 crosses: bool, stream: int,
                 vec: Optional[np.ndarray] = None) -> list[CommPhase]:
    """Phases for a batch of same-size groups with no pod or per-axis
    structure (``arr`` is ``(k, n)``): the ONE place the flat a2a / tree /
    ring byte amounts are written -- both the group-level billing path
    (:func:`group_phases`) and :func:`decompose`'s batched fast path call
    it, so placement and billing cannot fork.

    ``vec`` (already validated / uniform-collapsed by
    :func:`effective_byte_vector`) switches the irregular forms: a skewed
    all-to-all where position ``i`` injects ``vec[i]`` sends
    ``vec[i] * (n-1)/n`` (``vec[i]/n`` to each peer); an allgatherv ring
    forwards every shard except the one it receives last
    (``S - vec[(i+1) % n]``); a v-reduce-scatter is its time reverse
    (``S - vec[i]``).  Irregular ops keep the single flat ring/a2a phase
    regardless of ``algorithm`` -- the tree and per-axis decompositions
    assume equal shards.
    """
    n = int(arr.shape[-1])
    tier = "dcn" if crosses else "ici"
    if vec is not None:
        if kind in A2A_KINDS:
            return [CommPhase(kind=kind, tier=tier, groups=arr,
                              bytes_per_rank=vec * (n - 1) / n,
                              latency_hops=float(n - 1), structure="a2a",
                              payload=s, stream=stream)]
        per = s - np.roll(vec, -1) if kind == "all-gather" else s - vec
        return [CommPhase(kind=kind, tier=tier, groups=arr,
                          bytes_per_rank=per, latency_hops=float(n - 1),
                          structure="ring", payload=s, stream=stream)]
    if kind in A2A_KINDS:
        return [CommPhase(kind=kind, tier=tier, groups=arr,
                          bytes_per_rank=(n - 1) * s / (n * n),
                          latency_hops=float(n - 1), structure="a2a",
                          payload=s, stream=stream)]
    if algorithm == "tree" and kind in TREE_KINDS:
        per = 2.0 * s if kind == "all-reduce" else (n - 1) * s / n
        return [CommPhase(kind=kind, tier=tier, groups=arr,
                          bytes_per_rank=per,
                          latency_hops=tree_latency_hops(n),
                          structure="tree", payload=s, stream=stream)]
    return _ring_phases(kind, s, [("", arr)], n, tier, stream)


def _subgroup_axes(subs: list[list[int]],
                   topo: Optional[MeshTopology]) -> list[
                       tuple[str, np.ndarray]]:
    """Ring set for the hierarchical intra-pod phases: per-axis rings when
    EVERY pod subgroup decomposes identically, else one flattened ring per
    subgroup."""
    per_pod = []
    for sub in subs:
        rings = axis_rings(sub, topo)
        if rings is None:
            break
        per_pod.append(rings)
    else:
        shapes = [[(a, r.shape) for a, r in rings] for rings in per_pod]
        if all(sh == shapes[0] for sh in shapes):
            return [(axis, np.concatenate([rings[j][1]
                                           for rings in per_pod]))
                    for j, (axis, _) in enumerate(per_pod[0])]
    return [("", np.asarray(subs, dtype=np.intp))]


def group_phases(kind: str, payload: float, group, algorithm: str,
                 topo: Optional[MeshTopology] = None, *,
                 pods: Optional[int] = None, stream: int = 0,
                 warn: bool = True,
                 vec: Optional[np.ndarray] = None) -> list[CommPhase]:
    """Phase sequence for ONE replica group of one collective.

    The group-level heart of :func:`decompose`, also usable abstractly:
    with ``topo=None`` and ``pods=p`` the group splits into ``p``
    consecutive chunks (how ``cost_models.wire_bytes_per_rank`` reproduces
    the Table-1 entries without a concrete mesh).  A hierarchical request
    the shared predicate refuses emits a
    :class:`HierarchicalFallbackWarning` (when ``warn``) and returns the
    flat-ring fallback every consumer then shares.

    ``vec`` is an optional per-rank byte vector (positional over the
    group); it is collapsed by :func:`effective_byte_vector` first, so a
    uniform vector takes the scalar path bitwise with
    ``payload = sum(vec)``.
    """
    members = np.asarray(group, dtype=np.intp)   # free if already ndarray
    n = int(members.size)
    if n <= 1:
        return []
    vec = effective_byte_vector(kind, vec, n)
    s = float(payload) if vec is None else float(vec.sum())
    arr = members[None, :]
    group = members.tolist() if topo is not None else members
    crosses = (topo.group_crosses_dcn(group) if topo is not None
               else (pods or 1) > 1)
    tier = "dcn" if crosses else "ici"

    if kind == "collective-permute":
        # pair schedules are op-level; the group-level entry only carries
        # the per-rank bill (S) for Table-1 reproduction
        return [CommPhase(kind=kind, tier=tier, groups=arr,
                          bytes_per_rank=s, latency_hops=1.0,
                          structure="pairs", payload=s, stream=stream)]

    if algorithm == "hierarchical" and crosses and kind in A2A_KINDS:
        if topo is not None:
            dec = a2a_decomposition(kind, group, topo)
        else:
            p0, m0 = _hier_split(n, pods or 1)
            dec = None if p0 <= 1 else (
                p0, m0, [list(group[i * m0:(i + 1) * m0])
                         for i in range(p0)])
        if dec is not None:
            return _hierarchical_a2a_phases(kind, s, dec, vec, group,
                                            stream)
        if warn:
            warn_fallback_once(
                kind, n,
                f"hierarchical {kind} over cross-pod group of {n} cannot "
                "decompose (uneven pod split); scheduling a flat "
                "all-to-all phase -- placement, billing and timing all "
                "share this fallback", stacklevel=2)
        return _flat_phases(kind, s, arr, algorithm, True, stream, vec=vec)

    if algorithm == "hierarchical" and crosses \
            and kind in HIERARCHICAL_KINDS:
        if vec is not None:
            # the ring-chain decomposition assumes equal shards; an
            # irregular gather/scatter stays a flat vector ring
            if warn:
                warn_fallback_once(
                    kind, n,
                    f"irregular (per-rank vector) {kind} over cross-pod "
                    f"group of {n} does not decompose hierarchically; "
                    "scheduling a flat vector ring phase -- placement, "
                    "billing and timing all share this fallback",
                    stacklevel=2)
            return _flat_phases(kind, s, arr, algorithm, True, stream,
                                vec=vec)
        if topo is not None:
            dec = hierarchical_decomposition(kind, group, topo)
        else:
            p0, m0 = _hier_split(n, pods or 1)
            dec = None if p0 <= 1 else (
                p0, m0, [group[i * m0:(i + 1) * m0] for i in range(p0)])
        if dec is not None:
            return _hierarchical_phases(kind, s, dec, topo, stream)
        if warn:
            warn_fallback_once(
                kind, n,
                f"hierarchical {kind} over cross-pod group of {n} cannot "
                "decompose (uneven pod split); scheduling flat ring phases "
                "-- placement, billing and timing all share this fallback",
                stacklevel=2)
        return _flat_phases(kind, s, arr, algorithm, True, stream)

    if vec is not None:
        # irregular ops skip the per-axis / tree decompositions (equal
        # shards assumed there); the flat vector phase carries the skew
        return _flat_phases(kind, s, arr, algorithm, crosses, stream,
                            vec=vec)
    if not crosses and kind in AXIS_DECOMPOSABLE_KINDS \
            and algorithm != "tree":
        axes = axis_rings(group, topo)
        if axes is not None:
            return _ring_phases(kind, s, axes, n, "ici", stream)
    return _flat_phases(kind, s, arr, algorithm, crosses, stream)


def _hierarchical_phases(kind: str, s: float, dec,
                         topo: Optional[MeshTopology],
                         stream: int) -> list[CommPhase]:
    """Hierarchical phase sequence: intra-pod ring chains (per-axis when
    the subgroups allow) around a cross-pod DCN shard exchange.

    All-reduce: reduce-scatter inside the pod, ring all-reduce of the
    ``S/m`` shard across the ``p`` same-index members over DCN, all-gather
    back inside the pod.  The one-phase kinds exchange their ``S/n`` shards
    across pods and run the single intra-pod chain.  Per-rank totals match
    the Table-1 hierarchical entries exactly.
    """
    p, m, subs = dec
    sub_arr = np.asarray(subs, dtype=np.intp)            # (p, m)
    cross_rings = sub_arr.T                              # (m, p) columns
    intra_axes = _subgroup_axes(subs, topo) if (topo is not None and m > 1) \
        else ([("", sub_arr)] if m > 1 else [])
    phases: list[CommPhase] = []
    if kind == "all-reduce":
        if intra_axes:
            phases += _scatter_chain("reduce-scatter", s / m, intra_axes,
                                     "ici", stream)
        phases.append(CommPhase(
            kind="all-reduce", tier="dcn", groups=cross_rings,
            bytes_per_rank=2.0 * (p - 1) * s / (p * m),
            latency_hops=2.0 * (p - 1), axis="dcn", stream=stream))
        if intra_axes:
            phases += _gather_chain("all-gather", s / m, intra_axes,
                                    "ici", stream)
        return phases
    cross = CommPhase(
        kind=kind, tier="dcn", groups=cross_rings,
        bytes_per_rank=(p - 1) * s / (p * m),
        latency_hops=float(p - 1), axis="dcn", stream=stream)
    if kind == "reduce-scatter":
        # scatter inside the pod first ((m-1)/m * S, chunk telescopes from
        # S down to the S/m shard), then scatter the shard across pods
        if intra_axes:
            phases.extend(_scatter_chain(kind, s / m, intra_axes, "ici",
                                         stream))
        phases.append(cross)
        return phases
    # all-gather / scatter-allgather broadcast: cross-pod exchange first
    # (each rank then holds the S/m pod shard), then gather inside the pod
    phases.append(cross)
    if intra_axes:
        phases.extend(_gather_chain(kind, s / m, intra_axes, "ici",
                                    stream))
    return phases


def _hierarchical_a2a_phases(kind: str, s: float, dec,
                             vec: Optional[np.ndarray], group,
                             stream: int) -> list[CommPhase]:
    """Two-tier all-to-all: intra-pod exchange, pod-slot DCN exchange,
    intra-pod distribution.

    Stage A is an all-to-all inside each pod that re-buckets every rank's
    payload by destination pod (each rank keeps ``1/p`` of what it holds,
    so it moves ``(m-1)/m`` of its ``S/p``-sized per-pod buckets); stage B
    exchanges the re-bucketed data between same-slot ranks across pods
    (``p``-way all-to-all of the ``S/m`` pod shard); stage C distributes
    the received shards to their final in-pod destinations (same form as
    stage A).  Per-rank total ``2(m-1)S/(p m^2) + (p-1)S/(p^2 m)``; DCN
    carries exactly the flat placement's cross-pod share ``(p-1)/p * S``.

    With a per-rank ``vec``, stages A/C move each rank's own injection
    (``vec_i * (m-1)/m``) while stage B carries the **pod mean** -- stage
    A load-balances the pod, so the DCN exchange of pod ``q`` is paced by
    ``mean(vec over pod q)``: the hierarchical decomposition smooths
    per-rank skew before it reaches the expensive tier.  Group totals
    depend only on per-pod sums, so billing and placement agree with the
    abstract (contiguous-chunk) split used by the Table-1 entries.
    """
    p, m, subs = dec
    sub_arr = np.asarray(subs, dtype=np.intp)            # (p, m)
    if vec is not None:
        pos = {int(d): i for i, d in enumerate(group)}
        vsub = np.asarray(
            [[vec[pos[int(d)]] for d in sub] for sub in subs],
            dtype=np.float64)                            # (p, m)
        total = float(vec.sum())
        bytes_a = vsub * (m - 1) / m
        bytes_b = vsub.mean(axis=1) * (p - 1) / p        # (p,) positional
        pay_a, pay_b = total / p, total / m
    else:
        bytes_a = (m - 1) * (s / p) / (m * m)
        bytes_b = (p - 1) * (s / m) / (p * p)
        pay_a, pay_b = s / p, s / m
    cross = CommPhase(
        kind=kind, tier="dcn", groups=sub_arr.T,         # (m, p) slots
        bytes_per_rank=bytes_b, latency_hops=float(p - 1),
        structure="a2a", payload=pay_b, axis="dcn", stream=stream)
    if m <= 1:
        return [cross]
    intra = CommPhase(
        kind=kind, tier="ici", groups=sub_arr,
        bytes_per_rank=bytes_a, latency_hops=float(m - 1),
        structure="a2a", payload=pay_a, stream=stream)
    return [intra, cross, dataclasses.replace(intra)]


def _pod_leaders(topo: MeshTopology) -> dict[int, int]:
    """Lowest device id per pod: the DCN egress rank of the hierarchical
    collective-permute relay."""
    leaders: dict[int, int] = {}
    for d in range(topo.num_devices):
        pod = topo.pod_index(d)
        if pod not in leaders:      # ids ascend, so first seen is the min
            leaders[pod] = d
    return leaders


def _permute_relay_phases(pairs: np.ndarray, pair_pods: np.ndarray,
                          per_edge: float, topo: MeshTopology,
                          stream: int) -> list[CommPhase]:
    """Pod-leader relay for cross-pod permute pairs under hierarchical.

    Instead of every cross-pod pair occupying its own DCN uplink, traffic
    funnels through pod leaders: source -> its pod leader (ICI), leader ->
    destination pod's leader (one aggregated DCN exchange per pod pair),
    leader -> destination (ICI).  The three hops serialize on one stream;
    ``pair_bytes`` carries the aggregated per-pair amounts and each
    phase's ``bytes_per_rank`` is the busiest source's total (the
    straggler timing charges).  Hops whose source already is the leader
    (or whose destination is) are elided rather than billed at zero.
    """
    leaders = _pod_leaders(topo)
    hops: list[dict[tuple[int, int], float]] = [{}, {}, {}]
    for (a, b), (pa, pb) in zip(pairs.tolist(), pair_pods.tolist()):
        la, lb = leaders[pa], leaders[pb]
        if a != la:
            hops[0][(a, la)] = hops[0].get((a, la), 0.0) + per_edge
        hops[1][(la, lb)] = hops[1].get((la, lb), 0.0) + per_edge
        if b != lb:
            hops[2][(lb, b)] = hops[2].get((lb, b), 0.0) + per_edge
    out: list[CommPhase] = []
    for tier, hop in zip(("ici", "dcn", "ici"), hops):
        if not hop:
            continue
        p_arr = np.asarray(list(hop.keys()), dtype=np.intp)
        b_arr = np.asarray(list(hop.values()), dtype=np.float64)
        by_src: dict[int, float] = {}
        for (src, _), b in hop.items():
            by_src[src] = by_src.get(src, 0.0) + b
        out.append(CommPhase(
            kind="collective-permute", tier=tier, groups=None,
            bytes_per_rank=float(max(by_src.values())),
            latency_hops=1.0, structure="pairs", payload=per_edge,
            axis="dcn" if tier == "dcn" else "",
            pairs=p_arr, pair_bytes=b_arr, stream=stream))
    return out


def decompose(op: CollectiveOp, algorithm: str = "ring",
              topo: Optional[MeshTopology] = None, *,
              warn: bool = True,
              _fallbacks: Optional[list] = None) -> CollectiveSchedule:
    """The engine's front door: one op -> its :class:`CollectiveSchedule`.

    The schedule covers ONE execution (consumers apply ``op.weight``).
    Same-class replica groups (same size, same tier, no pod or per-axis
    decomposition) are batched into shared phases whose ``groups`` arrays
    stack the rings, so a 32-group op costs the same handful of phases as
    one group would -- the batching ``matrix_for_ops``' vectorized
    accumulation relies on.  Groups that decompose (across pods, or per
    torus axis) get their own phase streams.
    """
    validate_algorithm(algorithm)
    phases: list[CommPhase] = []
    if op.kind == "collective-permute":
        if op.source_target_pairs:
            # bytes_per_rank is the per-rank bill (one pair's payload);
            # ``payload`` carries the per-edge bytes, scaled by num_groups
            # because every replica group executes the pair schedule.
            # Pairs split by tier: a cross-pod pair streams (and is
            # billed) on DCN, an intra-pod one on ICI -- concurrent
            # streams, since pairs occupy disjoint wires.
            pairs = np.asarray(op.source_target_pairs, dtype=np.intp)
            if topo is not None and topo.num_pods > 1:
                pods = np.asarray([[topo.pod_index(int(a)),
                                    topo.pod_index(int(b))]
                                   for a, b in pairs])
                cross = pods[:, 0] != pods[:, 1]
            else:
                cross = np.zeros(len(pairs), dtype=bool)
            if algorithm == "hierarchical" and cross.any():
                # pod-leader relay for the cross-pod pairs; intra-pod
                # pairs keep their own concurrent stream as before
                if (~cross).any():
                    phases.append(CommPhase(
                        kind=op.kind, tier="ici", groups=None,
                        bytes_per_rank=float(op.result_bytes),
                        latency_hops=1.0, structure="pairs",
                        payload=float(op.result_bytes) * op.num_groups,
                        pairs=pairs[~cross], stream=0))
                phases += _permute_relay_phases(
                    pairs[cross], pods[cross],
                    float(op.result_bytes) * op.num_groups, topo,
                    stream=1)
                return CollectiveSchedule(op.kind, algorithm, phases)
            for tier, mask, strm in (("ici", ~cross, 0),
                                     ("dcn", cross, 1)):
                if mask.any():
                    phases.append(CommPhase(
                        kind=op.kind, tier=tier, groups=None,
                        bytes_per_rank=float(op.result_bytes),
                        latency_hops=1.0, structure="pairs",
                        payload=float(op.result_bytes) * op.num_groups,
                        pairs=pairs[mask], stream=strm))
        return CollectiveSchedule(op.kind, algorithm, phases)

    s = float(op.payload_bytes)
    vec = effective_byte_vector(op.kind, op.byte_vector(), op.group_size)
    stream = 0
    flat: dict[tuple[int, bool], list] = {}
    for group in op.replica_groups or []:
        n = len(group)
        if n <= 1:
            continue
        gvec = vec if (vec is not None and vec.size == n) else None
        if topo is None:
            flat.setdefault((n, False), []).append(group)
            continue
        crosses = topo.group_crosses_dcn(group)
        if algorithm == "hierarchical" and crosses \
                and op.kind in A2A_KINDS:
            dec = a2a_decomposition(op.kind, group, topo)
            if dec is not None:
                phases += _hierarchical_a2a_phases(op.kind, s, dec, gvec,
                                                   group, stream)
                stream += 1
                continue
            _note_fallback(
                _fallbacks, warn, op.kind, n,
                f"hierarchical {op.kind} over cross-pod group of {n} "
                "cannot decompose (uneven pod split); scheduling a "
                "flat all-to-all phase -- placement, billing and "
                "timing all share this fallback")
            flat.setdefault((n, True), []).append(group)
            continue
        if algorithm == "hierarchical" and crosses \
                and op.kind in HIERARCHICAL_KINDS:
            if gvec is not None:
                _note_fallback(
                    _fallbacks, warn, op.kind, n,
                    f"irregular (per-rank vector) {op.kind} over "
                    f"cross-pod group of {n} does not decompose "
                    "hierarchically; scheduling a flat vector ring "
                    "phase -- placement, billing and timing all "
                    "share this fallback")
                flat.setdefault((n, True), []).append(group)
                continue
            dec = hierarchical_decomposition(op.kind, group, topo)
            if dec is not None:
                phases += _hierarchical_phases(op.kind, s, dec, topo,
                                               stream)
                stream += 1
                continue
            _note_fallback(
                _fallbacks, warn, op.kind, n,
                f"hierarchical {op.kind} over cross-pod group of {n} "
                "cannot decompose (uneven pod split); scheduling flat "
                "ring phases -- placement, billing and timing all "
                "share this fallback")
            flat.setdefault((n, True), []).append(group)
            continue
        if gvec is None and not crosses \
                and op.kind in AXIS_DECOMPOSABLE_KINDS \
                and algorithm != "tree":
            axes = axis_rings(group, topo)
            if axes is not None:
                phases += _ring_phases(op.kind, s, axes, n, "ici", stream)
                stream += 1
                continue
        flat.setdefault((n, crosses), []).append(group)
    for (n, crosses), gs in flat.items():
        phases += _flat_phases(op.kind, s, np.asarray(gs, dtype=np.intp),
                               algorithm, crosses, stream,
                               vec=vec if (vec is not None
                                           and vec.size == n) else None)
        stream += 1
    return CollectiveSchedule(op.kind, algorithm, phases)


# ----------------------------------------------------------------------------
# Batched schedule evaluation: memoized decompose + columnar phase columns.
#
# ``decompose`` is pure in ``(op shape, algorithm, topology)`` -- it never
# reads ``op.weight``, ``op.name`` or the hardware spec -- so a workload
# whose 10k ops repeat a few dozen shapes only needs a few dozen
# decompositions.  :func:`op_signature` canonicalizes exactly the inputs
# ``decompose`` consumes; :func:`cached_decompose` memoizes on it through
# an explicit :class:`BoundedCache` (no ``lru_cache``: that would pin op
# references for the life of the process); :func:`schedules_for_ops`
# dedupes an op stream before decomposing and fans the shared schedule
# objects back out, which downstream edge/phase caches key on ``id()``.
# ----------------------------------------------------------------------------
class BoundedCache:
    """Tiny explicit LRU: ``get`` refreshes recency, ``put`` evicts the
    stalest entry beyond ``maxsize``.  Replaces ``functools.lru_cache`` on
    the billing/schedule hot paths so long-running sessions cannot grow an
    unbounded key set, and so invalidation (:meth:`clear`) is a method on
    an object rather than an attribute of a decorated function.  A lock
    guards the recency reordering: the module-level schedule and billing
    caches may be shared by threads."""

    __slots__ = ("maxsize", "_data", "_lock", "hits", "misses")

    def __init__(self, maxsize: int = 4096):
        import threading
        from collections import OrderedDict
        self.maxsize = int(maxsize)
        self._data: "OrderedDict" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key, default=None):
        with self._lock:
            try:
                self._data.move_to_end(key)
            except KeyError:
                self.misses += 1
                return default
            self.hits += 1
            return self._data[key]

    def put(self, key, value) -> None:
        with self._lock:
            self._data[key] = value
            self._data.move_to_end(key)
            while len(self._data) > self.maxsize:
                self._data.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self.hits = 0
            self.misses = 0

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key) -> bool:
        return key in self._data


def topo_signature(topo: Optional[MeshTopology]):
    """Hashable token for everything :func:`decompose` reads off a
    topology: axis layout and the DCN axis set.  Deliberately EXCLUDES
    ``topo.hw`` -- schedules are hardware-independent (bandwidths and
    latencies only enter at :meth:`CommPhase.seconds` time), so two
    meshes differing only in hardware share cache entries, while two
    meshes with equal device counts but different axis shapes (say 8x4
    vs 4x8) get distinct tokens and can never collide."""
    if topo is None:
        return None
    return (tuple(topo.axis_names), tuple(topo.axis_sizes),
            tuple(topo.dcn_axes))


#: Identity-keyed memo for the list-valued signature tokens below.  Ops
#: emitted by a capture loop (``dataclasses.replace`` per repetition)
#: share their ``replica_groups`` / ``source_target_pairs`` /
#: ``bytes_per_rank_vec`` objects, so canonicalizing those lists -- the
#: dominant cost of :func:`op_signature` on wide meshes -- happens once
#: per distinct object instead of once per op.  Entries hold a strong
#: reference to the keyed object, so its ``id`` cannot be recycled while
#: the entry lives and the ``is`` check below is definitive.
_TOKEN_CACHE = BoundedCache(maxsize=4096)


def _identity_token(obj, build):
    """``build(obj)`` memoized by ``id(obj)`` (ops never mutate their
    group/pair/vector lists in place -- the repo's event records are
    replace-only by convention)."""
    ent = _TOKEN_CACHE.get(id(obj))
    if ent is not None and ent[0] is obj:
        return ent[1]
    tok = build(obj)
    _TOKEN_CACHE.put(id(obj), (obj, tok))
    return tok


def _groups_token_of(rg):
    """Canonical token for a replica-group list (device ids + grouping).

    Nested tuples, not array bytes: ``tuple()`` over each group runs at C
    speed on lists and ndarray rows alike, and numpy integer scalars hash
    equal to Python ints, so value-equal groups in either representation
    land on the same cache entry without ever materializing an array."""
    return tuple(map(tuple, rg))


def _groups_token(op: CollectiveOp):
    """Canonical token for ``op.replica_groups`` (device ids + grouping)."""
    rg = op.replica_groups or []
    if not rg:
        return ()
    return _identity_token(rg, _groups_token_of)


def _pairs_token_of(pairs):
    return tuple(map(tuple, pairs))


def _vec_token_of(raw):
    return tuple(raw)


def op_signature(op: CollectiveOp, algorithm: str = "ring",
                 topo: Optional[MeshTopology] = None):
    """Canonical, hashable key of ONE ``decompose`` call, or ``None`` when
    the op resists canonicalization (then callers just decompose it
    directly).  Covers every input the schedule depends on -- kind,
    algorithm, topology axis layout, payload bytes, the raw per-rank byte
    vector, and the exact replica groups / permute pairs -- and nothing
    it does not: ``op.weight``, names and phase tags are consumer-side.
    """
    base = (op.kind, algorithm, topo_signature(topo))
    try:
        if op.kind == "collective-permute":
            stp = op.source_target_pairs or []
            ptok = _identity_token(stp, _pairs_token_of) if stp else ()
            return base + (float(op.result_bytes), int(op.num_groups),
                           ptok)
        raw = getattr(op, "bytes_per_rank_vec", None)
        if raw is None:
            vtok = None
        else:
            op.byte_vector()          # keep the validation errors
            vtok = _identity_token(raw, _vec_token_of)
        return base + (float(op.payload_bytes), vtok, _groups_token(op))
    except (TypeError, ValueError, OverflowError):
        return None


#: Process-wide schedule cache.  2048 distinct (shape, algorithm, topo)
#: triples is far beyond any real capture's shape diversity; the bound
#: exists so adversarial streams degrade to plain decompose, not OOM.
_SCHEDULE_CACHE = BoundedCache(maxsize=2048)


def schedule_cache() -> BoundedCache:
    """The process-wide memoized-decompose cache (stats, tests)."""
    return _SCHEDULE_CACHE


def clear_schedule_cache() -> None:
    """Drop every memoized schedule (tests, post-topology-mutation)."""
    _SCHEDULE_CACHE.clear()


def cached_decompose(op: CollectiveOp, algorithm: str = "ring",
                     topo: Optional[MeshTopology] = None, *,
                     warn: bool = True,
                     cache: Optional[BoundedCache] = None
                     ) -> CollectiveSchedule:
    """Memoized :func:`decompose`: same signature -> the SAME schedule
    object.  Fallback warnings recorded at miss time are replayed through
    :func:`warn_fallback_once` on every warning hit, so the once-per-
    session diagnostics survive memoization."""
    cache = _SCHEDULE_CACHE if cache is None else cache
    key = op_signature(op, algorithm, topo)
    if key is None:
        return decompose(op, algorithm, topo, warn=warn)
    hit = cache.get(key)
    if hit is not None:
        sched, fallbacks = hit
        if warn:
            for kind, n, msg in fallbacks:
                warn_fallback_once(kind, n, msg, stacklevel=1)
        return sched
    records: list = []
    sched = decompose(op, algorithm, topo, warn=warn, _fallbacks=records)
    cache.put(key, (sched, tuple(records)))
    return sched


def schedules_for_ops(ops: Iterable[CollectiveOp], algorithm: str,
                      topo: Optional[MeshTopology] = None, *,
                      warn: bool = False,
                      cache: Optional[BoundedCache] = None
                      ) -> list[CollectiveSchedule]:
    """Schedules for an op stream, deduped by :func:`op_signature` before
    decomposing and fanned back out: ops sharing a signature share ONE
    schedule object, which edge/phase caches downstream key on ``id()``.
    A per-call dedupe map backs the bounded cache so even a thrashing
    cache cannot force duplicate work within one stream.  The cache
    lookup is inlined (rather than delegated to :func:`cached_decompose`)
    so each op pays for exactly ONE signature computation, and once the
    stream's distinct-shape count exceeds the cache bound the global
    get/put traffic stops: every further put would only evict an earlier
    key of the SAME stream (pure churn -- cross-call reuse for such a
    stream was already lost to eviction), so the local map carries the
    rest alone."""
    cache = _SCHEDULE_CACHE if cache is None else cache
    local: dict = {}
    out: list[CollectiveSchedule] = []
    spilled = False
    for op in ops:
        key = op_signature(op, algorithm, topo)
        if key is None:
            out.append(decompose(op, algorithm, topo, warn=warn))
            continue
        sched = local.get(key)
        if sched is None:
            hit = None if spilled else cache.get(key)
            if hit is not None:
                sched, fallbacks = hit
                if warn:
                    for kind, n, msg in fallbacks:
                        warn_fallback_once(kind, n, msg, stacklevel=1)
            else:
                records: list = []
                sched = decompose(op, algorithm, topo, warn=warn,
                                  _fallbacks=records)
                if not spilled:
                    cache.put(key, (sched, tuple(records)))
            local[key] = sched
            spilled = spilled or len(local) >= cache.maxsize
        out.append(sched)
    return out


class ScheduleBatch:
    """Columnar view over one op stream's schedules.

    Flat float64/bool/intp arrays across ALL phases of all ops --
    ``op_index`` / ``stream`` / ``is_dcn`` / ``max_bytes`` / ``hops``
    laid out op-major in schedule order, with ``op_phase_ptr`` (CSR-style,
    ``nops + 1``) delimiting each op's slice -- so timing and billing run
    as array expressions instead of per-phase Python.  ``schedules``
    holds the (deduped, shared) schedule objects aligned with ``ops``;
    ``edge_cache`` is the per-batch ``id(schedule) -> edge arrays`` memo
    ``comm_matrix`` fills, so the matrix build also pays per *distinct*
    schedule.  Every derived quantity is BITWISE identical to the per-op
    path: phase seconds use the same scalar expression elementwise,
    per-(op, stream, tier) sums run through unbuffered ``np.add.at`` in
    phase order (the exact float-addition sequence of the Python loop),
    and weighted totals reduce through a sequential Python sum.
    """

    __slots__ = ("ops", "algorithm", "topo", "schedules", "weight",
                 "op_index", "stream", "is_dcn", "max_bytes", "hops",
                 "op_phase_ptr", "edge_cache")

    def __init__(self, ops, schedules, algorithm: Optional[str] = None,
                 topo: Optional[MeshTopology] = None):
        self.ops = list(ops)
        self.schedules = list(schedules)
        if len(self.ops) != len(self.schedules):
            raise ValueError(
                f"{len(self.ops)} ops vs {len(self.schedules)} schedules")
        self.algorithm = algorithm
        self.topo = topo
        self.weight = np.asarray(
            [max(1.0, float(getattr(op, "weight", 1.0)))
             for op in self.ops], dtype=np.float64)
        self.edge_cache: dict = {}
        cols: dict = {}          # id(sched) -> per-phase column template
        op_idx, streams, dcn, mb, hops = [], [], [], [], []
        ptr = [0]
        total = 0
        for i, sched in enumerate(self.schedules):
            tmpl = cols.get(id(sched))
            if tmpl is None:
                k = len(sched.phases)
                tmpl = cols[id(sched)] = (
                    np.fromiter((ph.stream for ph in sched.phases),
                                dtype=np.intp, count=k),
                    np.fromiter((ph.tier == "dcn" for ph in sched.phases),
                                dtype=bool, count=k),
                    np.fromiter((ph.max_bytes_per_rank()
                                 for ph in sched.phases),
                                dtype=np.float64, count=k),
                    np.fromiter((ph.latency_hops for ph in sched.phases),
                                dtype=np.float64, count=k),
                )
            k = tmpl[0].size
            op_idx.append(np.full(k, i, dtype=np.intp))
            streams.append(tmpl[0])
            dcn.append(tmpl[1])
            mb.append(tmpl[2])
            hops.append(tmpl[3])
            total += k
            ptr.append(total)
        if total:
            self.op_index = np.concatenate(op_idx)
            self.stream = np.concatenate(streams)
            self.is_dcn = np.concatenate(dcn)
            self.max_bytes = np.concatenate(mb)
            self.hops = np.concatenate(hops)
        else:
            self.op_index = np.empty(0, dtype=np.intp)
            self.stream = np.empty(0, dtype=np.intp)
            self.is_dcn = np.empty(0, dtype=bool)
            self.max_bytes = np.empty(0, dtype=np.float64)
            self.hops = np.empty(0, dtype=np.float64)
        self.op_phase_ptr = np.asarray(ptr, dtype=np.intp)

    @classmethod
    def from_ops(cls, ops, algorithm: str,
                 topo: Optional[MeshTopology] = None, *,
                 warn: bool = False,
                 cache: Optional[BoundedCache] = None) -> "ScheduleBatch":
        ops = list(ops)
        scheds = schedules_for_ops(ops, algorithm, topo, warn=warn,
                                   cache=cache)
        return cls(ops, scheds, algorithm, topo)

    def __len__(self) -> int:
        return len(self.ops)

    @property
    def num_phases(self) -> int:
        return int(self.op_index.size)

    @property
    def num_distinct(self) -> int:
        """Distinct schedule objects (the work actually decomposed)."""
        return len({id(s) for s in self.schedules})

    def phase_slice(self, i: int) -> slice:
        """Column slice of op ``i``'s phases (aligned with
        ``self.schedules[i].phases``)."""
        return slice(int(self.op_phase_ptr[i]), int(self.op_phase_ptr[i + 1]))

    def phase_seconds(self, topo: Optional[MeshTopology] = None, *,
                      include_latency: bool = True) -> np.ndarray:
        """Per-phase streaming seconds, columnar: elementwise the exact
        scalar expression of :meth:`CommPhase.seconds`."""
        topo = self.topo if topo is None else topo
        if topo is None:
            raise ValueError("phase_seconds needs a topology")
        bw = np.where(self.is_dcn, topo.ring_bw_per_chip(True),
                      topo.ring_bw_per_chip(False))
        sec = self.max_bytes / bw
        if include_latency:
            lat = np.where(self.is_dcn, topo.hw.dcn_hop_latency_s,
                           topo.hw.ici_hop_latency_s)
            sec = sec + self.hops * lat
        return sec

    def time_split_per_op(self, topo: Optional[MeshTopology] = None, *,
                          include_latency: bool = True
                          ) -> tuple[np.ndarray, np.ndarray]:
        """``(ici, dcn)`` seconds per op for ONE execution -- the columnar
        :meth:`CollectiveSchedule.time_split`: phases of one stream sum
        (sequentially, in phase order), tiers take the max over streams."""
        nops = len(self.ops)
        ici = np.zeros(nops, dtype=np.float64)
        dcn = np.zeros(nops, dtype=np.float64)
        if self.op_index.size == 0:
            return ici, dcn
        sec = self.phase_seconds(topo, include_latency=include_latency)
        # compact (op, stream) ids; streams are per-op counters < 2**31
        pair = (self.op_index.astype(np.int64) << 31) \
            | self.stream.astype(np.int64)
        uniq, inv = np.unique(pair, return_inverse=True)
        acc = np.zeros((uniq.size, 2), dtype=np.float64)
        # np.add.at is unbuffered: within each (op, stream, tier) cell the
        # additions land in array order == phase order, reproducing the
        # per-op Python accumulation bitwise
        np.add.at(acc, (inv, self.is_dcn.astype(np.intp)), sec)
        op_of = (uniq >> 31).astype(np.intp)
        np.maximum.at(ici, op_of, acc[:, 0])
        np.maximum.at(dcn, op_of, acc[:, 1])
        return ici, dcn

    def total_time_split(self, topo: Optional[MeshTopology] = None, *,
                         include_latency: bool = True
                         ) -> tuple[float, float]:
        """Weighted ``(ici, dcn)`` totals over the stream.  The final
        reduction is a sequential Python sum in op order -- numpy's
        pairwise ``sum`` is faster but not bitwise-equal to the per-op
        accumulation loop this replaces."""
        ici_arr, dcn_arr = self.time_split_per_op(
            topo, include_latency=include_latency)
        iw = ici_arr * self.weight
        dw = dcn_arr * self.weight
        ici = 0.0
        dcn = 0.0
        for a, b in zip(iw.tolist(), dw.tolist()):
            ici += a
            dcn += b
        return ici, dcn
