"""Sparse communication matrices: the fleet-scale representation (port of
``repro.core.sparse``).

The paper's ``(d+1) x (d+1)`` dense matrix (row/col 0 = host) is O(d^2)
memory -- 2 GiB of float64 at 16k devices -- while the matrices this repo
builds are *schedule-derived*: ring phases touch torus neighbours, trees
touch heap edges, DCN exchanges touch pod representatives.  The number of
distinct (src, dst) pairs grows like O(d), not O(d^2), so fleet-scale
capacity planning (:mod:`repro_torch.scale`, 256 -> 16k devices) keeps the
same byte accounting in a COO triplet form and never materializes the
dense array.

:class:`SparseCommMatrix` is that form: coalesced, deduplicated
``(src, dst, val)`` arrays over the same (d+1)-indexed space as the dense
matrix (index 0 = host).  It answers everything downstream consumers ask
of a matrix -- totals, row sums, the coarsened heatmap block
(:meth:`coarsen`, bit-for-bit equal to ``reporter.coarsen_matrix`` of the
dense equivalent), link projection via :meth:`device_entries` -- and
converts exactly via :meth:`to_dense` for small meshes and tests.

:class:`SparseAccumulator` is the bounded-memory builder behind
``comm_matrix.matrix_for_ops(..., sparse=True)``: it buffers raw COO
chunks and coalesces (sort + reduce on encoded keys) whenever the pending
entry count crosses a threshold, so a long op stream costs
O(nnz + threshold) transient memory regardless of device count.

``SPARSE_DEVICE_THRESHOLD`` is the auto-cutover used by
:class:`~repro_torch.core.views.CommView`: at or below it views build dense
(cheap, fully general); above it they build sparse.  2048 devices puts the
dense matrix at ~32 MiB -- the last point where allocating it per view is
still reasonable.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

# CommView's auto mode builds dense matrices up to this many devices and
# sparse ones above it.
SPARSE_DEVICE_THRESHOLD = 2048

# raw (uncoalesced) entries buffered before an intermediate coalesce
_COALESCE_AT = 1 << 20

# counting-sort coalesce is used while side^2 float64 scratch stays modest
# (side = SPARSE_DEVICE_THRESHOLD + 1 -> ~34 MB); the argsort path takes
# over beyond that, preserving the O(nnz)-memory fleet guarantee
_COUNTING_MAX_SIDE = SPARSE_DEVICE_THRESHOLD + 1


def _coalesce(side: int, src: np.ndarray, dst: np.ndarray,
              val: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Group by (src, dst) and sum duplicates.  Encoded int64 keys: safe up
    to side ~ 3e9, far beyond any fleet.

    Two strategies, identical results: a counting sort via ``np.bincount``
    over the dense key space when ``side`` is modest (it dominated the
    sparse-vs-dense gap: a stable ``argsort`` over millions of edges is
    ~3x the cost of summing them), and the stable argsort + ``reduceat``
    beyond, where ``side^2`` scratch would defeat the point of sparse.
    Both accumulate each cell's contributions sequentially in array order,
    so dense/sparse bitwise equality holds on either path.  The counting
    path drops cells that sum to exactly 0.0 -- values here are
    non-negative bytes, so such a cell only ever held zero-byte edges,
    which no derived quantity reads.
    """
    if src.size == 0:
        return (np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64),
                np.empty(0, dtype=np.float64))
    key = src.astype(np.int64) * np.int64(side) + dst.astype(np.int64)
    if side <= _COUNTING_MAX_SIDE and key.size >= side:
        flat = np.bincount(key, weights=val, minlength=side * side)
        uk = np.flatnonzero(flat)
        return uk // side, uk % side, flat[uk]
    order = np.argsort(key, kind="stable")
    key = key[order]
    val = val[order]
    boundary = np.empty(key.size, dtype=bool)
    boundary[0] = True
    np.not_equal(key[1:], key[:-1], out=boundary[1:])
    starts = np.flatnonzero(boundary)
    uk = key[starts]
    sums = np.add.reduceat(val, starts)
    return uk // side, uk % side, sums.astype(np.float64, copy=False)


class SparseCommMatrix:
    """COO form of one ``(d+1) x (d+1)`` bytes-sent matrix.

    Indices live in the dense matrix's coordinate space: 0 is the host
    row/column, device ``i`` is index ``i + 1``.  Entries are kept
    coalesced (unique, sorted (src, dst), summed values); zero-valued
    entries may exist after accumulating zero-byte edges but never change
    any derived quantity.
    """

    __slots__ = ("side", "src", "dst", "val")

    def __init__(self, num_devices: int,
                 src: Optional[np.ndarray] = None,
                 dst: Optional[np.ndarray] = None,
                 val: Optional[np.ndarray] = None, *,
                 coalesced: bool = False):
        self.side = int(num_devices) + 1
        src = np.asarray([] if src is None else src, dtype=np.int64).ravel()
        dst = np.asarray([] if dst is None else dst, dtype=np.int64).ravel()
        val = np.asarray([] if val is None else val,
                         dtype=np.float64).ravel()
        if not (src.size == dst.size == val.size):
            raise ValueError(
                f"COO arrays disagree: {src.size}/{dst.size}/{val.size}")
        if src.size and (src.min() < 0 or dst.min() < 0
                         or src.max() >= self.side
                         or dst.max() >= self.side):
            raise ValueError(
                f"COO indices out of range for side {self.side}")
        if not coalesced:
            src, dst, val = _coalesce(self.side, src, dst, val)
        self.src, self.dst, self.val = src, dst, val

    # -- identity ----------------------------------------------------------
    @property
    def shape(self) -> tuple[int, int]:
        return (self.side, self.side)

    @property
    def num_devices(self) -> int:
        return self.side - 1

    @property
    def nnz(self) -> int:
        return int(self.src.size)

    def __repr__(self) -> str:
        return (f"SparseCommMatrix({self.num_devices} devices, "
                f"nnz={self.nnz}, total={self.sum():.4g} B)")

    # -- aggregates (all O(nnz) or O(d), never O(d^2)) ---------------------
    def sum(self) -> float:
        return float(self.val.sum())

    def max(self) -> float:
        return float(self.val.max()) if self.nnz else 0.0

    def row_sums(self) -> np.ndarray:
        """Per-index sent bytes, length ``d + 1`` (index 0 = host)."""
        return np.bincount(self.src, weights=self.val, minlength=self.side)

    def col_sums(self) -> np.ndarray:
        """Per-index received bytes, length ``d + 1`` (index 0 = host)."""
        return np.bincount(self.dst, weights=self.val, minlength=self.side)

    def entries(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The coalesced ``(src, dst, val)`` arrays (read-only by
        convention; indices include the host slot 0)."""
        return self.src, self.dst, self.val

    def device_entries(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Device-to-device entries only, with 0-based device ids -- the
        input :func:`~repro_torch.core.comm_matrix.project_links` routes."""
        keep = (self.src > 0) & (self.dst > 0) & (self.val > 0)
        return self.src[keep] - 1, self.dst[keep] - 1, self.val[keep]

    # -- mutation (matrix building only) -----------------------------------
    def add_entries(self, src, dst, val) -> "SparseCommMatrix":
        """Accumulate more COO entries (re-coalesces); used by
        ``add_host_transfers``.  Returns self."""
        self.src, self.dst, self.val = _coalesce(
            self.side,
            np.concatenate([self.src, np.asarray(src, dtype=np.int64)]),
            np.concatenate([self.dst, np.asarray(dst, dtype=np.int64)]),
            np.concatenate([self.val, np.asarray(val, dtype=np.float64)]))
        return self

    # -- conversions -------------------------------------------------------
    def to_dense(self) -> np.ndarray:
        """The equivalent dense ``(d+1) x (d+1)`` array.  O(d^2) memory by
        definition -- for small meshes, tests and round-trip checks; the
        fleet-scale paths never call it."""
        mat = np.zeros((self.side, self.side), dtype=np.float64)
        mat[self.src, self.dst] = self.val
        return mat

    def coarsen(self, max_devices: int = 32) -> tuple[np.ndarray, int]:
        """Block-summed small dense matrix for heatmaps, identical to
        ``reporter.coarsen_matrix(self.to_dense(), max_devices)`` without
        the dense detour.  Returns ``(matrix, block)``."""
        d = self.side
        if d <= max_devices + 1:
            return self.to_dense(), 1
        k = -(-(d - 1) // max_devices)          # ceil((d-1)/max_devices)
        nb = -(-(d - 1) // k)
        hm = np.zeros((nb + 1, nb + 1), dtype=np.float64)
        # host slot stays exact; device indices collapse onto blocks
        bsrc = np.where(self.src == 0, 0, (self.src - 1) // k + 1)
        bdst = np.where(self.dst == 0, 0, (self.dst - 1) // k + 1)
        np.add.at(hm, (bsrc, bdst), self.val)
        return hm, k

    def to_csv_rows(self) -> list[str]:
        """Long-form ``src,dst,bytes`` rows (host slot labelled ``host``,
        device ``i`` labelled ``gpu{i}``), nonzero entries only -- the
        fleet-scale CSV export (a (16k)^2 grid CSV would be absurd)."""
        def label(i: int) -> str:
            return "host" if i == 0 else f"gpu{i - 1}"
        return [f"{label(int(s))},{label(int(t))},{v:.0f}"
                for s, t, v in zip(self.src, self.dst, self.val) if v > 0]


def is_sparse(mat) -> bool:
    return isinstance(mat, SparseCommMatrix)


class SparseAccumulator:
    """Bounded-memory COO accumulation for matrix building.

    ``add`` takes raw (possibly duplicated) entry chunks; whenever the
    pending raw count crosses ``coalesce_at`` everything is coalesced down
    to unique entries, so peak memory is O(unique nnz + coalesce_at)
    however long the op stream runs.
    """

    def __init__(self, num_devices: int, coalesce_at: int = _COALESCE_AT):
        self.num_devices = int(num_devices)
        self.side = self.num_devices + 1
        self.coalesce_at = int(coalesce_at)
        # At modest device counts a flat side^2 float64 working array --
        # the dense builder's exact footprint and regime (the dense matrix
        # is affordable here by definition) -- accumulates via ``np.add.at``
        # on linearized keys: the same per-cell addition sequence as the
        # dense path, so bitwise equality is free, and no concatenate /
        # sort / bincount pass ever runs.  Beyond ``_COUNTING_MAX_SIDE``
        # the buffered-COO path below keeps memory O(nnz + coalesce_at).
        self._flat: Optional[np.ndarray] = (
            None if self.side > _COUNTING_MAX_SIDE else
            np.zeros(self.side * self.side, dtype=np.float64))
        self._src: list[np.ndarray] = []
        self._dst: list[np.ndarray] = []
        self._val: list[np.ndarray] = []
        self._pending = 0

    def add(self, src: np.ndarray, dst: np.ndarray, val: np.ndarray):
        if src.size == 0:
            return
        if self._flat is not None:
            key = (np.asarray(src, dtype=np.int64) * np.int64(self.side)
                   + np.asarray(dst, dtype=np.int64))
            np.add.at(self._flat, key, np.asarray(val, dtype=np.float64))
            return
        self._src.append(np.asarray(src, dtype=np.int64))
        self._dst.append(np.asarray(dst, dtype=np.int64))
        self._val.append(np.asarray(val, dtype=np.float64))
        self._pending += src.size
        if self._pending >= self.coalesce_at:
            self._squash()

    def _squash(self):
        src, dst, val = _coalesce(self.side,
                                  np.concatenate(self._src),
                                  np.concatenate(self._dst),
                                  np.concatenate(self._val))
        self._src, self._dst, self._val = [src], [dst], [val]
        self._pending = src.size

    def build(self) -> SparseCommMatrix:
        if self._flat is not None:
            # exact-0.0 cells drop here, same as the counting coalesce:
            # values are non-negative bytes, so such a cell only ever held
            # zero-byte edges, which no derived quantity reads
            uk = np.flatnonzero(self._flat)
            return SparseCommMatrix(self.num_devices, uk // self.side,
                                    uk % self.side, self._flat[uk],
                                    coalesced=True)
        if not self._src:
            return SparseCommMatrix(self.num_devices)
        self._squash()
        return SparseCommMatrix(self.num_devices, self._src[0],
                                self._dst[0], self._val[0], coalesced=True)


def from_dense(mat: np.ndarray) -> SparseCommMatrix:
    """Dense ``(d+1) x (d+1)`` array -> :class:`SparseCommMatrix` (exact)."""
    m = np.asarray(mat, dtype=np.float64)
    src, dst = np.nonzero(m)
    return SparseCommMatrix(m.shape[0] - 1, src, dst, m[src, dst],
                            coalesced=True)
