"""Communication matrices -- the paper's central visualization (port of
``repro.core.comm_matrix``).

A ``(d+1) x (d+1)`` matrix where entry ``(i+1, j+1)`` is the number of bytes
device ``i`` sends to device ``j``; row/column 0 is reserved for the host
(paper Fig. 2).  Matrices are built from :class:`CollectiveOp` lists by
**placing the op's decomposition schedule**
(:func:`repro_torch.core.decompose.decompose`) -- the same phase IR that
drives billing and timing:

* ring phases stream **both directions** of their rings (half the phase's
  per-rank bytes to each neighbour),
* tree phases place per-role traffic on binary-tree edges,
* hierarchical schedules place intra-pod ring phases plus the cross-pod
  DCN shard exchange,
* collective-permute places its explicit source-target pairs,
* all-to-all places uniform pairwise traffic.

The matrix is accumulated on the host in numpy, op by op and edge by edge
in the reference's order (``np.add.at`` is unbuffered), so it is bitwise
equal to the reference's.  It is deliberately not built with
``torch.index_add_`` on a card: that adds with atomics in no fixed order.
``sparse=True`` builds the same entries in COO form
(:class:`~repro_torch.core.sparse.SparseCommMatrix`) without allocating
``(d+1)^2`` floats, which fleet-scale device counts need.

Any matrix can be **projected onto physical links** (:func:`project_links`):
each logical edge is routed over the ICI torus / DCN uplinks of a
:class:`~repro_torch.core.topology.MeshTopology`, one COO entry at a time
as the reference does, yielding per-link byte counts, the bottleneck link
and a contention-aware time bound.  The reference's legacy per-kind
placement oracle (``matrix_for_ops_reference``) is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import numpy as np

from .events import CollectiveOp, HostTransfer
from . import cost_models, decompose as decompose_mod
from .decompose import HierarchicalFallbackWarning, decompose  # noqa: F401
from .sparse import SparseAccumulator, SparseCommMatrix, is_sparse
from .topology import DCN_FABRIC, Link, MeshTopology


# ---------------------------------------------------------------------------
# Scalar edge placement: the schedule rendered as (src, dst, bytes) tuples.
# ---------------------------------------------------------------------------
def _ring_edges(group, per_rank: float) -> list[tuple[int, int, float]]:
    """Bidirectional ring: each member streams half its per-rank bytes to
    each ring neighbour (the torus ring algorithm uses both directions of
    the axis links -- the bandwidth ``ring_bw_per_chip`` credits).  On a
    2-member ring both halves reach the same peer and accumulate."""
    group = list(group)
    n = len(group)
    half = 0.5 * per_rank
    out: list[tuple[int, int, float]] = []
    for i in range(n):
        out.append((group[i], group[(i + 1) % n], half))
        out.append((group[i], group[(i - 1) % n], half))
    return out


def _tree_placement(group, kind: str,
                    s: float) -> list[tuple[int, int, float]]:
    """Per-edge bytes on the implicit binary tree (heap layout), resolved
    from the shared :func:`repro_torch.core.decompose.tree_edge_profile`."""
    group = list(group)
    n = len(group)
    up, down = decompose_mod.tree_edge_profile(kind, s, n)
    edges: list[tuple[int, int, float]] = []
    for i in range(1, n):
        parent, child = group[(i - 1) // 2], group[i]
        if up[i - 1]:
            edges.append((child, parent, float(up[i - 1])))
        if down[i - 1]:
            edges.append((parent, child, float(down[i - 1])))
    return edges


def _phase_edges(ph) -> list[tuple[int, int, float]]:
    """Scalar edges of ONE schedule phase.

    Vector phases (``bytes_per_rank`` is an ndarray, see
    :class:`~repro_torch.core.decompose.CommPhase`) place per-position amounts:
    ring members stream half their own per-rank bytes to each neighbour,
    a2a members send ``per_rank / (n-1)`` to each peer, and ``pair_bytes``
    overrides the uniform per-pair payload of ``structure="pairs"``.
    """
    if ph.structure == "pairs":
        if ph.pairs is None:
            return []
        if ph.pair_bytes is not None:
            return [(int(a), int(b), float(v))
                    for (a, b), v in zip(ph.pairs.tolist(),
                                         ph.pair_bytes.tolist())]
        return [(int(a), int(b), ph.payload) for a, b in ph.pairs]
    if ph.groups is None:
        return []
    G = np.atleast_2d(ph.groups)
    B = ph.byte_matrix()
    out: list[tuple[int, int, float]] = []
    if ph.structure == "ring":
        if B is not None:
            for row, brow in zip(G, B):
                members = row.tolist()
                n = len(members)
                for i, per in enumerate(brow.tolist()):
                    out.append((members[i], members[(i + 1) % n],
                                0.5 * per))
                    out.append((members[i], members[(i - 1) % n],
                                0.5 * per))
        else:
            for row in G:
                out += _ring_edges(row.tolist(), ph.bytes_per_rank)
    elif ph.structure == "tree":
        for row in G:
            out += _tree_placement(row.tolist(), ph.kind, ph.payload)
    elif ph.structure == "a2a":
        n = G.shape[1]
        if B is not None:
            for row, brow in zip(G, B):
                members = row.tolist()
                per_peer = (brow / (n - 1)).tolist()
                out += [(a, b, per_peer[i])
                        for i, a in enumerate(members)
                        for b in members if a != b]
        else:
            block = ph.payload / (n * n)
            for row in G:
                members = row.tolist()
                out += [(a, b, block) for a in members for b in members
                        if a != b]
    return out


def op_edges(op: CollectiveOp, algorithm: str = "ring",
             topo: Optional[MeshTopology] = None) -> list[tuple[int, int, float]]:
    """``(src, dst, bytes)`` edges for ONE execution of ``op`` (weight not
    applied) -- the scalar rendering of the op's decomposition schedule.

    Production matrix building goes through the vectorized
    :func:`op_edge_arrays`; both walk the same
    :func:`~repro_torch.core.decompose.decompose` output, and a property test
    pins their aggregate traffic equal.  A hierarchical request for a
    cross-pod group the shared predicate cannot decompose emits a
    :class:`HierarchicalFallbackWarning` and places flat ring edges
    instead (silently degenerating is exactly the matrix/model mismatch
    this module exists to expose).
    """
    sched = decompose_mod.cached_decompose(op, algorithm, topo)
    edges: list[tuple[int, int, float]] = []
    for ph in sched.phases:
        edges += _phase_edges(ph)
    return edges


# ---------------------------------------------------------------------------
# Vectorized edge generation: numpy COO arrays instead of per-edge tuples.
# ---------------------------------------------------------------------------
_EMPTY_EDGES = (np.empty(0, dtype=np.intp), np.empty(0, dtype=np.intp),
                np.empty(0, dtype=np.float64))


def _concat_edges(parts):
    if not parts:
        return _EMPTY_EDGES
    if len(parts) == 1:
        return parts[0]
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]),
            np.concatenate([p[2] for p in parts]))


# ring-size -> column indices of [next neighbour | previous neighbour],
# cached because every same-size ring shares them
_RING_IDX_CACHE: dict[int, np.ndarray] = {}


def _ring_neighbor_idx(n: int) -> np.ndarray:
    idx = _RING_IDX_CACHE.get(n)
    if idx is None:
        pos = np.arange(n)
        idx = _RING_IDX_CACHE.setdefault(
            n, np.concatenate([(pos + 1) % n, (pos - 1) % n]))
    return idx


def _ring_edges_arr(rings, per_rank):
    """Bidirectional ring edges for a batch of rings (one per row).

    The array form of :func:`_ring_edges`: each member streams half its
    per-rank bytes to each neighbour (cached neighbour-index gather along
    the row axis); on a 2-member ring both halves land on the same peer
    and accumulate.  ``per_rank`` may be an ndarray (1-D positional or
    ``(k, n)``): each member then streams half its *own* amount.
    """
    r = np.asarray(rings, dtype=np.intp)
    if r.ndim == 1:
        r = r[None, :]
    src = np.tile(r, (1, 2)).ravel()
    dst = r[:, _ring_neighbor_idx(r.shape[1])].ravel()
    if isinstance(per_rank, np.ndarray):
        B = np.broadcast_to(np.asarray(per_rank, dtype=np.float64),
                            r.shape)
        return src, dst, np.tile(0.5 * B, (1, 2)).ravel()
    return src, dst, np.full(src.size, 0.5 * per_rank)


def _tree_edges_arr(groups, kind: str, s: float):
    """Array form of :func:`_tree_placement` (same heap-layout tree) for a
    batch of same-size groups (one per row) -- the per-edge byte profile
    depends only on the tree *position*, so it is computed once per column
    and tiled over the batch."""
    G = np.asarray(groups, dtype=np.intp)
    if G.ndim == 1:
        G = G[None, :]
    k, n = G.shape
    pos = np.arange(1, n)
    parent = G[:, (pos - 1) // 2]                      # (k, n-1)
    child = G[:, 1:]
    up, down = decompose_mod.tree_edge_profile(kind, s, n)
    mu, md = up > 0, down > 0
    return (np.concatenate([child[:, mu].ravel(), parent[:, md].ravel()]),
            np.concatenate([parent[:, mu].ravel(), child[:, md].ravel()]),
            np.concatenate([np.tile(up[mu], k), np.tile(down[md], k)]))


def _a2a_edges_arr(groups, block: float, per_src=None):
    """Pairwise exchange for a batch of same-size groups: uniform
    ``block`` bytes per ordered pair, or -- when ``per_src`` (1-D
    positional or ``(k, n)``) is given -- each source's own
    ``per_src / (n-1)`` to every peer (skewed all-to-all)."""
    G = np.asarray(groups, dtype=np.intp)
    if G.ndim == 1:
        G = G[None, :]
    k, n = G.shape
    src = np.repeat(G, n, axis=1).ravel()
    dst = np.tile(G, (1, n)).ravel()
    keep = src != dst
    if per_src is not None:
        B = np.broadcast_to(np.asarray(per_src, dtype=np.float64),
                            G.shape)
        vals = np.repeat(B / (n - 1), n, axis=1).ravel()[keep]
        return src[keep], dst[keep], vals
    return src[keep], dst[keep], np.full(k * n * (n - 1), block)


def _phase_edge_arrays(ph):
    """COO arrays of ONE schedule phase (the vectorized
    :func:`_phase_edges`)."""
    if ph.structure == "pairs":
        if ph.pairs is None:
            return _EMPTY_EDGES
        if ph.pair_bytes is not None:
            return (ph.pairs[:, 0], ph.pairs[:, 1],
                    np.asarray(ph.pair_bytes, dtype=np.float64))
        return (ph.pairs[:, 0], ph.pairs[:, 1],
                np.full(len(ph.pairs), ph.payload))
    if ph.groups is None:
        return _EMPTY_EDGES
    if ph.structure == "ring":
        return _ring_edges_arr(ph.groups, ph.bytes_per_rank)
    if ph.structure == "tree":
        return _tree_edges_arr(ph.groups, ph.kind, ph.payload)
    if ph.structure == "a2a":
        n = int(np.atleast_2d(ph.groups).shape[1])
        if isinstance(ph.bytes_per_rank, np.ndarray):
            return _a2a_edges_arr(ph.groups, 0.0,
                                  per_src=ph.bytes_per_rank)
        return _a2a_edges_arr(ph.groups, ph.payload / (n * n))
    return _EMPTY_EDGES


def schedule_edge_arrays(sched):
    """``(src, dst, bytes)`` COO arrays of one whole schedule."""
    if not sched.phases:
        return _EMPTY_EDGES
    return _concat_edges([_phase_edge_arrays(ph) for ph in sched.phases])


def op_edge_arrays(op: CollectiveOp, algorithm: str = "ring",
                   topo: Optional[MeshTopology] = None):
    """``(src, dst, bytes)`` numpy arrays for ONE execution of ``op``.

    The vectorized twin of :func:`op_edges` -- identical aggregate traffic
    (property-tested), produced as COO arrays so :func:`matrix_for_ops`
    accumulates them without a per-edge Python loop.  The schedule already
    batches same-size replica groups into shared phases (an op with 32
    groups of 8 costs the same handful of numpy calls as one group would),
    and emits the same :class:`HierarchicalFallbackWarning` in the same
    refusal case.
    """
    return schedule_edge_arrays(
        decompose_mod.cached_decompose(op, algorithm, topo))


# flush threshold for the batched COO accumulation: large enough to amortize
# np.add.at, small enough to keep the edge buffers cache-resident
_FLUSH_EDGES = 32768


def matrix_for_ops(
    ops: Iterable[CollectiveOp],
    num_devices: int,
    algorithm: str = "ring",
    kinds: Optional[set[str]] = None,
    topo: Optional[MeshTopology] = None,
    sparse: bool = False,
):
    """Bytes-sent matrix, shape ``(d+1, d+1)``; row/col 0 = host.

    ``topo`` enables topology-faithful placement (per-axis ring phases for
    multi-axis groups, the hierarchical algorithm's pod decomposition);
    without it every schedule degenerates to flattened rings, matching
    ``wire_bytes_per_rank(..., pods=1)``.

    Accumulation is vectorized: per-op COO edge arrays
    (:func:`op_edge_arrays`, execution weights applied per op) are batched
    into buffers and flushed with one ``np.add.at`` per
    ``_FLUSH_EDGES``-sized batch.

    ``sparse=True`` returns a
    :class:`~repro_torch.core.sparse.SparseCommMatrix` instead of the dense
    array -- element-exact, built without ever allocating ``(d+1)^2``
    floats, which is what makes fleet-scale device counts
    (:mod:`repro_torch.scale`, 16k devices) tractable.
    """
    cost_models.validate_algorithm(algorithm)
    kept = [op for op in ops if kinds is None or op.kind in kinds]
    scheds = decompose_mod.schedules_for_ops(kept, algorithm, topo,
                                             warn=True)
    return _accumulate_edges(_edge_pairs(kept, scheds, None, {}),
                             num_devices, sparse=sparse)


def _edge_pairs(ops, schedules, kinds, edge_cache: dict):
    """``(op, (src, dst, val))`` pairs in op order, with edge arrays built
    once per *distinct* schedule object (``id``-keyed, which the deduped
    ``schedules_for_ops`` output makes meaningful).  Accumulation stays
    per-op so the float addition order -- and hence the matrix, bitwise --
    is identical to the uncached path."""
    for op, sched in zip(ops, schedules):
        if kinds is not None and op.kind not in kinds:
            continue
        e = edge_cache.get(id(sched))
        if e is None:
            e = edge_cache[id(sched)] = schedule_edge_arrays(sched)
        yield op, e


def matrix_for_schedules(
    ops, schedules, num_devices: int,
    kinds: Optional[set[str]] = None,
    sparse: bool = False,
):
    """Bytes-sent matrix from pre-built schedules (aligned with ``ops``).

    The entry point for callers that already hold the ops' decomposition
    schedules (e.g. a :class:`~repro_torch.core.views.CommView`'s memoized IR):
    identical accumulation to :func:`matrix_for_ops` without re-running
    :func:`~repro_torch.core.decompose.decompose` per op.  ``schedules`` may be
    the plain aligned list or a :class:`~repro_torch.core.decompose.
    ScheduleBatch` -- the batch's persistent ``edge_cache`` then carries
    rendered COO edge arrays across calls (the whole-matrix build and
    every per-primitive slice of one view pay edge generation once per
    distinct schedule).  ``sparse=True`` builds the COO
    :class:`~repro_torch.core.sparse.SparseCommMatrix` form.
    """
    if isinstance(schedules, decompose_mod.ScheduleBatch):
        edge_cache = schedules.edge_cache
        schedules = schedules.schedules
    else:
        edge_cache = {}
    return _accumulate_edges(
        _edge_pairs(ops, schedules, kinds, edge_cache),
        num_devices, sparse=sparse)


def _accumulate_edges_sparse(pairs, num_devices: int) -> SparseCommMatrix:
    """Sparse twin of :func:`_accumulate_edges`: same per-op COO edges,
    accumulated into a bounded-memory :class:`SparseAccumulator` -- no
    ``(d+1)^2`` allocation anywhere on this path."""
    acc = SparseAccumulator(num_devices)
    for op, (src, dst, val) in pairs:
        if src.size == 0:
            continue
        w = getattr(op, "weight", 1.0)
        keep = (src < num_devices) & (dst < num_devices)
        if not keep.all():
            src, dst, val = src[keep], dst[keep], val[keep]
        acc.add(src + 1, dst + 1, val * w if w != 1.0 else val)
    return acc.build()


def _accumulate_edges(pairs, num_devices: int,
                      sparse: bool = False):
    """Buffered COO accumulation over ``(op, (src, dst, val))`` pairs."""
    if sparse:
        return _accumulate_edges_sparse(pairs, num_devices)
    mat = np.zeros((num_devices + 1, num_devices + 1), dtype=np.float64)
    cap = _FLUSH_EDGES
    buf_src = np.empty(cap, dtype=np.intp)
    buf_dst = np.empty(cap, dtype=np.intp)
    buf_val = np.empty(cap, dtype=np.float64)
    pending = 0

    def apply(src, dst, val):
        keep = (src < num_devices) & (dst < num_devices)
        if not keep.all():
            src, dst, val = src[keep], dst[keep], val[keep]
        np.add.at(mat, (src + 1, dst + 1), val)

    def flush():
        nonlocal pending
        if pending:
            apply(buf_src[:pending], buf_dst[:pending], buf_val[:pending])
            pending = 0

    for op, (src, dst, val) in pairs:
        w = getattr(op, "weight", 1.0)   # execution count (loop trip counts)
        m = src.size
        if m == 0:
            continue
        if w != 1.0:
            val = val * w
        if m >= cap:                     # oversized op: apply directly
            flush()
            apply(src, dst, val)
            continue
        if pending + m > cap:
            flush()
        buf_src[pending:pending + m] = src
        buf_dst[pending:pending + m] = dst
        buf_val[pending:pending + m] = val
        pending += m
    flush()
    return mat


def add_host_transfers(mat, transfers: Iterable[HostTransfer]):
    """Accumulate host row/col traffic into a dense or sparse matrix."""
    if is_sparse(mat):
        transfers = list(transfers)
        src = np.array([0 if t.direction == "h2d" else t.device + 1
                        for t in transfers], dtype=np.int64)
        dst = np.array([t.device + 1 if t.direction == "h2d" else 0
                        for t in transfers], dtype=np.int64)
        val = np.array([t.nbytes for t in transfers], dtype=np.float64)
        return mat.add_entries(src, dst, val)
    for t in transfers:
        if t.direction == "h2d":
            mat[0, t.device + 1] += t.nbytes
        else:
            mat[t.device + 1, 0] += t.nbytes
    return mat


def per_primitive_matrices(
    ops: list[CollectiveOp], num_devices: int, algorithm: str = "ring",
    topo: Optional[MeshTopology] = None, sparse: bool = False,
) -> dict:
    """Paper Fig. 3: one matrix per collective primitive (ops partitioned
    by kind once instead of re-filtering the whole stream per kind)."""
    by_kind: dict[str, list[CollectiveOp]] = {}
    for op in ops:
        by_kind.setdefault(op.kind, []).append(op)
    return {
        k: matrix_for_ops(by_kind[k], num_devices, algorithm, topo=topo,
                          sparse=sparse)
        for k in sorted(by_kind)
    }


# ---------------------------------------------------------------------------
# Physical-link projection: where the bytes actually travel.
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class LinkUtilization:
    """Per-physical-link byte counts for one communication matrix.

    ``bytes_by_link`` covers every link of the topology (zero-traffic links
    included, so utilization denominators are meaningful).  Multi-hop
    logical edges charge every link on their route, so the sum over links
    can exceed the matrix total -- that is the point: it exposes transit
    traffic a logical matrix hides.  (Schedules that decompose per torus
    axis place neighbour-only edges, so their projection carries zero
    transit inflation inside a pod.)
    """

    topo: MeshTopology
    bytes_by_link: dict[Link, float]

    def seconds(self, link: Link) -> float:
        return self.bytes_by_link.get(link, 0.0) / self.topo.link_bandwidth(link)

    def total_bytes(self, kind: Optional[str] = None) -> float:
        return float(sum(b for l, b in self.bytes_by_link.items()
                         if kind is None or l.kind == kind))

    def bottleneck(self) -> Optional[tuple[Link, float]]:
        """(busiest link, seconds on it), by time -- None when no link
        carries any traffic (every link is pre-seeded at 0 bytes, so an
        emptiness check alone would name an arbitrary idle link)."""
        if not self.bytes_by_link or not any(self.bytes_by_link.values()):
            return None
        link = max(self.bytes_by_link, key=self.seconds)
        return link, self.seconds(link)

    def bottleneck_seconds(self) -> float:
        """Contention-aware time bound: max over links of bytes/bandwidth."""
        bn = self.bottleneck()
        return bn[1] if bn else 0.0

    def busy_seconds(self, kind: Optional[str] = None) -> float:
        """Per-tier busy time: max over links (of ``kind``, or all) of
        bytes/bandwidth -- how long that fabric tier is occupied if every
        link streams its traffic back-to-back.  Feeds the link-overlap
        roofline (``compute ∥ ICI ∥ DCN``): tiers are independent fabrics,
        so ``max(busy_seconds("ici"), busy_seconds("dcn"))`` bounds the
        overlapped communication time from below."""
        return max((self.seconds(l) for l in self.bytes_by_link
                    if kind is None or l.kind == kind), default=0.0)

    def tier_summary(self) -> dict:
        """Per-tier ``{kind: {bytes, busy_seconds}}`` (schema-v3 section)."""
        return {kind: {"bytes": self.total_bytes(kind),
                       "busy_seconds": self.busy_seconds(kind)}
                for kind in sorted({l.kind for l in self.bytes_by_link})}

    def matrix(self) -> np.ndarray:
        """The per-link utilization matrix, shape ``(d+1, d+1)``.

        Entry ``(i+1, j+1)`` is the bytes carried by the *physical* ICI
        link ``i -> j`` (only torus-neighbour entries can be nonzero).
        Row/col 0 is the **DCN tier**: ``(i+1, 0)`` is device ``i``'s DCN
        uplink, ``(0, j+1)`` device ``j``'s downlink -- the slot the
        logical matrix uses for the host plays the off-fabric role here.
        """
        d = self.topo.num_devices
        mat = np.zeros((d + 1, d + 1), dtype=np.float64)
        for link, nbytes in self.bytes_by_link.items():
            if link.kind == "ici":
                mat[link.src + 1, link.dst + 1] += nbytes
            elif link.dst == DCN_FABRIC:
                mat[link.src + 1, 0] += nbytes
            else:
                mat[0, link.dst + 1] += nbytes
        return mat

    def sparse_matrix(self) -> SparseCommMatrix:
        """The per-link utilization matrix in COO form -- same layout as
        :meth:`matrix` (row/col 0 = DCN tier) with O(links) memory, which
        is what the exporters read at fleet scale."""
        src = np.empty(len(self.bytes_by_link), dtype=np.int64)
        dst = np.empty(len(self.bytes_by_link), dtype=np.int64)
        val = np.empty(len(self.bytes_by_link), dtype=np.float64)
        for n, (link, nbytes) in enumerate(self.bytes_by_link.items()):
            if link.kind == "ici":
                src[n], dst[n] = link.src + 1, link.dst + 1
            elif link.dst == DCN_FABRIC:
                src[n], dst[n] = link.src + 1, 0
            else:
                src[n], dst[n] = 0, link.dst + 1
            val[n] = nbytes
        return SparseCommMatrix(self.topo.num_devices, src, dst, val)

    def summary(self) -> dict:
        """Per link-kind aggregates for tables and serialization."""
        out: dict[str, dict] = {}
        for link, nbytes in self.bytes_by_link.items():
            row = out.setdefault(link.kind, {
                "links": 0, "bytes": 0.0, "busiest_link": "",
                "busiest_bytes": 0.0, "bottleneck_seconds": 0.0})
            row["links"] += 1
            row["bytes"] += nbytes
            secs = self.seconds(link)
            if secs > row["bottleneck_seconds"]:
                row.update(busiest_link=link.name, busiest_bytes=nbytes,
                           bottleneck_seconds=secs)
        return out

    def rows(self) -> list[dict]:
        """One serializable row per link (schema-v2 ``links`` section)."""
        return [{"kind": l.kind, "src": l.src, "dst": l.dst, "axis": l.axis,
                 "bytes": float(b),
                 "bandwidth": self.topo.link_bandwidth(l),
                 "seconds": self.seconds(l)}
                for l, b in sorted(self.bytes_by_link.items(),
                                   key=lambda kv: -kv[1])]

    def table(self) -> str:
        """Terminal rendering of the per-kind aggregates."""
        from . import reporter
        rows = []
        summary = self.summary()
        for kind in sorted(summary):
            r = summary[kind]
            rows.append([kind, f"{r['links']}",
                         reporter.human_bytes(r["bytes"]),
                         r["busiest_link"],
                         reporter.human_bytes(r["busiest_bytes"]),
                         f"{r['bottleneck_seconds'] * 1e3:.3f}"])
        return reporter.format_table(rows, [
            "link kind", "links", "total bytes", "busiest link",
            "busiest bytes", "bottleneck ms"])


def project_links(mat, topo: MeshTopology) -> LinkUtilization:
    """Route a logical ``(d+1)^2`` matrix onto physical links.

    ``mat`` may be the dense ``np.ndarray`` form or a
    :class:`~repro_torch.core.sparse.SparseCommMatrix` -- both project to the
    identical link view (the sparse path iterates its coalesced COO
    entries instead of ``argwhere`` over a dense block, and never
    materializes the dense array).  Anything else raises ``TypeError``.

    The host row/col (index 0) is skipped -- host transfers ride PCIe, not
    the ICI/DCN fabric.  Each device-to-device entry is routed by
    :meth:`MeshTopology.route` (dimension-ordered wrap-aware torus routing,
    DCN uplink+downlink across pods) and its bytes charged to every hop.
    The matrices this module builds are schedule-derived
    (:func:`op_edge_arrays` renders :func:`~repro_torch.core.decompose.
    decompose` output), so the projection IS the schedule's link view.

    Every routed hop must be one of the enumerated physical links -- in
    particular, both directions around a size-2 torus axis are the SAME
    single collapsed link (``MeshTopology.links`` docstring); a hop outside
    the enumeration would silently invent fabric, so it raises.
    """
    if is_sparse(mat):
        srcs, dsts, vals = mat.device_entries()
        entries = zip(srcs.tolist(), dsts.tolist(), vals.tolist())
    elif isinstance(mat, np.ndarray):
        dev = mat[1:, 1:]
        entries = ((int(i), int(j), float(dev[i, j]))
                   for i, j in np.argwhere(dev > 0))
    else:
        raise TypeError(
            "project_links expects a dense (d+1)x(d+1) np.ndarray or a "
            f"SparseCommMatrix, not {type(mat).__name__}")
    bytes_by_link: dict[Link, float] = {l: 0.0 for l in topo.links()}
    for i, j, nbytes in entries:
        for link in topo.route(i, j):
            if link not in bytes_by_link:
                raise ValueError(
                    f"route({i}, {j}) emitted {link.name}, which is not an "
                    "enumerated physical link of the topology")
            bytes_by_link[link] += nbytes
    return LinkUtilization(topo=topo, bytes_by_link=bytes_by_link)


def link_utilization_for_ops(
    ops: list[CollectiveOp], topo: MeshTopology, algorithm: str = "ring",
    kinds: Optional[set[str]] = None, sparse: bool = False,
) -> LinkUtilization:
    """Place ``ops``' schedules and project onto physical links
    (``sparse=True`` routes the COO form, never building the dense
    matrix)."""
    mat = matrix_for_ops(ops, topo.num_devices, algorithm, kinds, topo=topo,
                         sparse=sparse)
    return project_links(mat, topo)
