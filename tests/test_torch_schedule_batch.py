"""The port's batched schedule engine against its per-op path and against
the reference (``tests/test_schedule_batch.py``'s cases).

``cached_decompose``, the deduping ``schedules_for_ops`` and the columnar
``ScheduleBatch`` must give bitwise the artifacts of decomposing every op on
its own -- dense and sparse matrices, per-op and total per-tier seconds,
the link projection -- and bitwise the reference's on the same ops (the
port's ops are built from the reference's op dicts).  Then the cache
mechanics: LRU eviction, hit/miss counters, what the signature holds and
what it leaves out, and fallback warnings replayed through cache hits.
"""
import dataclasses
import warnings

import numpy as np
import pytest

from repro.core import comm_matrix as ref_cm
from repro.core import cost_models as ref_cost
from repro.core import decompose as ref_dec
from repro.core.export import serialize as ref_ser
from repro.core.topology import MeshTopology as RefTopo
from repro_torch.core import comm_matrix, cost_models
from repro_torch.core.decompose import (BoundedCache,
                                        HierarchicalFallbackWarning,
                                        ScheduleBatch, cached_decompose,
                                        clear_schedule_cache, decompose,
                                        op_signature, reset_fallback_warnings,
                                        schedule_cache, schedules_for_ops,
                                        topo_signature)
from repro_torch.core.events import CollectiveOp, Shape
from repro_torch.core.export import serialize as ser
from repro_torch.core.topology import MeshTopology

KINDS = ("all-reduce", "all-gather", "reduce-scatter",
         "collective-broadcast", "all-to-all", "collective-permute")
ALGS = ("ring", "tree", "hierarchical")
MESHES = {
    "1pod": (("data", "model"), (4, 2)),
    "2pod": (("pod", "data", "model"), (2, 4, 2)),
    "4pod": (("pod", "data", "model"), (4, 4, 2)),
}


def _topos(mesh_key):
    names, sizes = MESHES[mesh_key]
    return (MeshTopology(axis_names=names, axis_sizes=sizes),
            RefTopo(axis_names=names, axis_sizes=sizes))


def make_stream(mesh_key, seed, num_ops=6, skewed=False):
    """The reference test's mixed-kind stream (every shape twice, fresh
    names and weights), as (port ops, reference ops)."""
    d = int(np.prod(MESHES[mesh_key][1]))
    rng = np.random.default_rng(seed)
    protos = []
    for i in range(num_ops):
        kind = KINDS[int(rng.integers(len(KINDS)))]
        elems = int(rng.integers(1, 1 << 10))
        if kind == "collective-permute":
            perm = rng.permutation(d)
            pairs = [(int(perm[j]), int(perm[(j + 1) % d]))
                     for j in range(d)]
            protos.append(CollectiveOp(
                kind=kind, name=f"p{i}",
                result_shapes=[Shape("f32", (elems,))],
                replica_groups=[], source_target_pairs=pairs))
            continue
        gsize = int(rng.choice([s for s in (2, 4, 8, d) if s <= d]))
        devs = rng.permutation(d)
        groups = [sorted(int(x) for x in devs[k:k + gsize])
                  for k in range(0, d, gsize)]
        extra = {}
        if skewed and kind == "all-to-all":
            vec = rng.random(gsize) + 0.1
            vec[int(rng.integers(gsize))] *= 7.0
            vec = vec / vec.sum() * float(rng.integers(1 << 8, 1 << 16))
            extra["bytes_per_rank_vec"] = [float(x) for x in vec]
        protos.append(CollectiveOp(
            kind=kind, name=f"p{i}", result_shapes=[Shape("f32", (elems,))],
            replica_groups=groups, **extra))
    ops = [dataclasses.replace(p, name=f"op{rep}_{i}",
                               weight=float(rng.integers(1, 17)))
           for rep in range(2) for i, p in enumerate(protos)]
    return ops, [ref_ser.op_from_dict(ser.op_to_dict(op)) for op in ops]


def per_op_matrix(ops, d, alg, topo):
    """Every op decomposed and placed on its own, ``np.add.at`` in op
    order."""
    mat = np.zeros((d + 1, d + 1), dtype=np.float64)
    for op in ops:
        src, dst, val = comm_matrix.schedule_edge_arrays(
            decompose(op, alg, topo, warn=False))
        if src.size:
            keep = (src < d) & (dst < d)
            np.add.at(mat, (src[keep] + 1, dst[keep] + 1),
                      val[keep] * max(1.0, op.weight))
    return mat


def _links(lu):
    return {(l.kind, l.src, l.dst, l.axis): b
            for l, b in lu.bytes_by_link.items()}


GRID = [(mk, alg, skewed) for mk in MESHES for alg in ALGS
        for skewed in (False, True)]


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


@pytest.mark.parametrize("mesh_key,alg,skewed", GRID)
class TestBitwiseParity:
    def _setup(self, mesh_key, alg, skewed):
        clear_schedule_cache()
        cost_models.clear_billing_caches()
        topo, rtopo = _topos(mesh_key)
        ops, rops = make_stream(mesh_key, seed=sum(map(ord, mesh_key + alg)),
                                skewed=skewed)
        return topo, rtopo, topo.num_devices, ops, rops

    def test_dense_matrix(self, mesh_key, alg, skewed):
        topo, rtopo, d, ops, rops = self._setup(mesh_key, alg, skewed)
        got = comm_matrix.matrix_for_ops(ops, d, alg, topo=topo)
        assert np.array_equal(got, per_op_matrix(ops, d, alg, topo))
        assert np.array_equal(got, ref_cm.matrix_for_ops(rops, d, alg,
                                                         topo=rtopo))

    def test_sparse_matrix(self, mesh_key, alg, skewed):
        topo, rtopo, d, ops, rops = self._setup(mesh_key, alg, skewed)
        sp = comm_matrix.matrix_for_ops(ops, d, alg, topo=topo, sparse=True)
        want = ref_cm.matrix_for_ops(rops, d, alg, topo=rtopo, sparse=True)
        assert np.array_equal(sp.to_dense(), per_op_matrix(ops, d, alg, topo))
        for a in ("src", "dst", "val"):
            assert np.array_equal(getattr(sp, a), getattr(want, a))

    def test_time_split_per_op(self, mesh_key, alg, skewed):
        topo, rtopo, d, ops, rops = self._setup(mesh_key, alg, skewed)
        ici, dcn = ScheduleBatch.from_ops(ops, alg, topo).time_split_per_op()
        ref_ici, ref_dcn = ref_dec.ScheduleBatch.from_ops(
            rops, alg, rtopo).time_split_per_op()
        assert np.array_equal(ici, ref_ici) and np.array_equal(dcn, ref_dcn)
        for k, op in enumerate(ops):
            assert (float(ici[k]), float(dcn[k])) == decompose(
                op, alg, topo, warn=False).time_split(topo)

    def test_total_time_split(self, mesh_key, alg, skewed):
        topo, rtopo, d, ops, rops = self._setup(mesh_key, alg, skewed)
        got = cost_models.total_time_split(ops, topo, alg)
        ici = dcn = 0.0
        for op in ops:
            i, dd = decompose(op, alg, topo, warn=False).time_split(topo)
            ici += i * max(1.0, op.weight)
            dcn += dd * max(1.0, op.weight)
        assert got == (ici, dcn) == ref_cost.total_time_split(rops, rtopo,
                                                              alg)

    def test_project_links(self, mesh_key, alg, skewed):
        topo, rtopo, d, ops, rops = self._setup(mesh_key, alg, skewed)
        got = comm_matrix.project_links(
            comm_matrix.matrix_for_ops(ops, d, alg, topo=topo), topo)
        assert got.bytes_by_link == comm_matrix.project_links(
            per_op_matrix(ops, d, alg, topo), topo).bytes_by_link
        assert _links(got) == _links(ref_cm.project_links(
            ref_cm.matrix_for_ops(rops, d, alg, topo=rtopo), rtopo))


class TestBoundedCache:
    def test_eviction_order_is_lru(self):
        c = BoundedCache(maxsize=2)
        c.put("a", 1)
        c.put("b", 2)
        assert c.get("a") == 1            # refreshes "a"
        c.put("c", 3)                     # evicts "b", the stalest
        assert "b" not in c and "a" in c and "c" in c
        assert len(c) == 2

    def test_hit_miss_counters_and_clear(self):
        c = BoundedCache(maxsize=4)
        assert c.get("x") is None and c.misses == 1
        c.put("x", 7)
        assert c.get("x") == 7 and c.hits == 1
        c.clear()
        assert len(c) == 0 and c.hits == 0 and c.misses == 0

    def test_stream_larger_than_cache_still_dedupes(self):
        """Past the cache bound the per-call map carries the stream alone:
        every shape is decomposed once and shared."""
        topo, _ = _topos("1pod")
        ops = [CollectiveOp(kind="all-reduce", name=f"a{i}",
                            result_shapes=[Shape("f32", (16 + i % 5,))],
                            replica_groups=[list(range(8))])
               for i in range(20)]
        cache = BoundedCache(maxsize=3)
        scheds = schedules_for_ops(ops, "ring", topo, cache=cache)
        assert len({id(s) for s in scheds}) == 5
        assert all(scheds[i] is scheds[i % 5] for i in range(20))
        assert len(cache) == 3


class TestSignature:
    def test_equal_device_count_topologies_do_not_collide(self):
        t42 = MeshTopology(axis_names=("data", "model"), axis_sizes=(4, 2))
        t24 = MeshTopology(axis_names=("data", "model"), axis_sizes=(2, 4))
        assert topo_signature(t42) != topo_signature(t24)
        op = CollectiveOp(kind="all-reduce", name="ar",
                          result_shapes=[Shape("f32", (64,))],
                          replica_groups=[list(range(8))])
        assert op_signature(op, "ring", t42) != op_signature(op, "ring", t24)

    def test_weight_name_and_phase_not_in_signature(self):
        op = CollectiveOp(kind="all-reduce", name="a", weight=1.0,
                          result_shapes=[Shape("f32", (64,))],
                          replica_groups=[list(range(8))])
        twin = dataclasses.replace(op, name="b", weight=64.0, phase="x")
        assert op_signature(op) == op_signature(twin)
        assert op_signature(op, "ring") != op_signature(op, "tree")

    def test_byte_vector_and_groups_in_signature(self):
        base = dict(kind="all-to-all", name="a",
                    result_shapes=[Shape("f32", (1,))])
        flat = CollectiveOp(bytes_per_rank_vec=[4.0] * 4,
                            replica_groups=[[0, 1, 2, 3]], **base)
        skew = dataclasses.replace(flat, bytes_per_rank_vec=[13.0, 1.0, 1.0,
                                                             1.0])
        moved = dataclasses.replace(flat, replica_groups=[[0, 2, 4, 6]])
        assert len({op_signature(o) for o in (flat, skew, moved)}) == 3

    @pytest.mark.parametrize("mesh_key", list(MESHES))
    def test_signature_equals_reference(self, mesh_key):
        """The same key as the reference's for every op of a stream, and
        the same dedup: ops share a schedule exactly where the
        reference's do."""
        topo, rtopo = _topos(mesh_key)
        ops, rops = make_stream(mesh_key, seed=11, skewed=True)
        for op, rop in zip(ops, rops):
            assert op_signature(op, "ring", topo) == \
                ref_dec.op_signature(rop, "ring", rtopo)
        got = schedules_for_ops(ops, "ring", topo)
        want = ref_dec.schedules_for_ops(rops, "ring", rtopo)
        share = [[a is b for b in got] for a in got]
        assert share == [[a is b for b in want] for a in want]
        assert [s.summary() for s in got] == [s.summary() for s in want]

    def test_cached_decompose_shares_schedule_objects(self):
        clear_schedule_cache()
        topo, _ = _topos("1pod")
        op = CollectiveOp(kind="all-gather", name="a",
                          result_shapes=[Shape("f32", (64,))],
                          replica_groups=[list(range(8))])
        twin = dataclasses.replace(op, name="b", weight=3.0)
        s1 = cached_decompose(op, "ring", topo, warn=False)
        s2 = cached_decompose(twin, "ring", topo, warn=False)
        assert s1 is s2
        scheds = schedules_for_ops([op, twin, op], "ring", topo)
        assert scheds[0] is scheds[1] is scheds[2]
        assert schedule_cache().hits >= 1

    def test_fallback_warning_replays_through_cache_hits(self):
        clear_schedule_cache()
        topo, _ = _topos("2pod")
        op = CollectiveOp(kind="all-reduce", name="odd",
                          result_shapes=[Shape("f32", (64,))],
                          replica_groups=[[0, 1, 8]])
        for _ in range(2):            # a miss records, a hit replays
            reset_fallback_warnings()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                cached_decompose(op, "hierarchical", topo)
            assert any(issubclass(w.category, HierarchicalFallbackWarning)
                       for w in caught)
        reset_fallback_warnings()


class TestScheduleBatchLayout:
    def test_columns_align_with_schedules(self):
        topo, _ = _topos("2pod")
        ops, _ = make_stream("2pod", seed=5)
        batch = ScheduleBatch.from_ops(ops, "ring", topo)
        assert len(batch) == len(ops)
        assert batch.op_phase_ptr[0] == 0
        assert batch.op_phase_ptr[-1] == batch.num_phases
        for i, sched in enumerate(batch.schedules):
            sl = batch.phase_slice(i)
            assert sl.stop - sl.start == len(sched.phases)
            for j, ph in enumerate(sched.phases):
                k = sl.start + j
                assert batch.is_dcn[k] == (ph.tier == "dcn")
                assert batch.max_bytes[k] == ph.max_bytes_per_rank()
                assert batch.hops[k] == ph.latency_hops
        assert batch.num_distinct <= len(ops) // 2

    def test_phase_seconds_match_scalar_path(self):
        topo, _ = _topos("4pod")
        ops, _ = make_stream("4pod", seed=9, skewed=True)
        batch = ScheduleBatch.from_ops(ops, "ring", topo)
        sec = batch.phase_seconds(topo)
        k = 0
        for sched in batch.schedules:
            for ph in sched.phases:
                assert float(sec[k]) == ph.seconds(topo)
                k += 1

    def test_empty_stream(self):
        topo, _ = _topos("1pod")
        batch = ScheduleBatch.from_ops([], "ring", topo)
        assert batch.total_time_split() == (0.0, 0.0)
        assert batch.num_phases == 0


class TestBillingCaches:
    @pytest.mark.parametrize("kind", KINDS)
    def test_cached_equals_fresh_and_reference(self, kind):
        for n in (2, 4, 8):
            cost_models.clear_billing_caches()
            cold = (cost_models.wire_bytes_per_rank(kind, 4096.0, n, "ring"),
                    cost_models.wire_bytes_group_total(kind, 4096.0, n,
                                                       "ring"))
            warm = (cost_models.wire_bytes_per_rank(kind, 4096.0, n, "ring"),
                    cost_models.wire_bytes_group_total(kind, 4096.0, n,
                                                       "ring"))
            assert cold == warm == (
                ref_cost.wire_bytes_per_rank(kind, 4096.0, n, "ring"),
                ref_cost.wire_bytes_group_total(kind, 4096.0, n, "ring"))

    def test_vector_ops_do_not_contaminate_the_scalar_cache(self):
        vec = np.asarray([1000.0, 10.0, 10.0, 10.0])
        cost_models.clear_billing_caches()
        args = ("all-to-all", float(vec.sum()), 4, "ring")
        v1 = cost_models.wire_bytes_group_total(*args, vec=vec)
        s1 = cost_models.wire_bytes_group_total(*args)
        v2 = cost_models.wire_bytes_group_total(*args, vec=vec)
        cost_models.clear_billing_caches()
        assert v1 == v2 == cost_models.wire_bytes_group_total(*args, vec=vec)
        assert s1 == cost_models.wire_bytes_group_total(*args)
        assert (v1, s1) == (ref_cost.wire_bytes_group_total(*args, vec=vec),
                            ref_cost.wire_bytes_group_total(*args))


def test_view_schedules_come_from_the_batch():
    """A view's schedules, per-op seconds and totals all read its one
    memoized batch, as the reference's view does."""
    from repro.core.views import CommView as RefView
    from repro_torch.core.views import CommView

    topo, rtopo = _topos("2pod")
    ops, rops = make_stream("2pod", seed=3, skewed=True)
    v = CommView(ops, 16, algorithm="hierarchical", topo=topo)
    rv = RefView(rops, 16, algorithm="hierarchical", topo=rtopo)
    assert v.schedules() is v.schedule_batch().schedules
    assert v.schedule_summaries() == rv.schedule_summaries()
    assert v.op_seconds() == rv.op_seconds()
    assert v.collective_seconds_split() == rv.collective_seconds_split()
    assert v.collective_overlap_seconds() == rv.collective_overlap_seconds()
