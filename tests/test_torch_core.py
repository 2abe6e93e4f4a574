"""The port's monitor core (``repro_torch.core``) against the reference.

The committed fixtures' ops are loaded through the reference's
``report_from_dict`` and handed to both packages.  Everything below is float64
numpy logic copied over, so the results must be element-exact (``==``, not a
tolerance): decompose schedules, summaries, the dense matrix and the
per-primitive matrices, the per-tier time split, under ring, tree and
hierarchical, on 1- and 2-pod meshes.  The views time through the same
columnar ``ScheduleBatch`` as the reference's, so their seconds are held
with ``==`` too.
"""
import json
import warnings
from pathlib import Path

import numpy as np
import pytest

from repro.core import comm_matrix as ref_cm
from repro.core import cost_models as ref_cost
from repro.core import decompose as ref_dec
from repro.core import hlo_parser as ref_hlo
from repro.core import views as ref_views
from repro.core.events import CollectiveOp as RefOp
from repro.core.events import HostTransfer as RefHostTransfer
from repro.core.events import Shape as RefShape
from repro.core.export import serialize as ref_ser
from repro.core.topology import MeshTopology as RefTopo
from repro_torch.core import comm_matrix as cm
from repro_torch.core import cost_models as cost
from repro_torch.core import decompose as dec
from repro_torch.core import summary
from repro_torch.core import views
from repro_torch.core.events import HostTransfer
from repro_torch.core.export import serialize as ser
from repro_torch.core.topology import MeshTopology

FIXTURES = Path(__file__).parent / "fixtures"
ALGORITHMS = ("ring", "tree", "hierarchical")
KINDS = ("all-reduce", "all-gather", "reduce-scatter",
         "collective-broadcast", "all-to-all", "collective-permute",
         "mystery-kind")
# (axis names, sizes) of 8-device meshes: no topology, one pod, two pods
MESHES = {
    "none": None,
    "1pod_4x2": (("data", "model"), (4, 2)),
    "2pod_2x2x2": (("pod", "data", "model"), (2, 2, 2)),
}


def _topos(mesh):
    if MESHES[mesh] is None:
        return None, None
    names, sizes = MESHES[mesh]
    return (RefTopo(axis_names=names, axis_sizes=sizes),
            MeshTopology(axis_names=names, axis_sizes=sizes))


_OPS: dict = {}


def _fixture_ops(name):
    """(reference ops, port ops) of a committed report, the port's built
    from the reference's op dicts."""
    if name not in _OPS:
        d = json.loads((FIXTURES / f"{name}_report.json").read_text())
        ref_ops = ref_ser.report_from_dict(d).compiled_ops
        port_ops = [ser.op_from_dict(ref_ser.op_to_dict(op)) for op in ref_ops]
        _OPS[name] = (ref_ops, port_ops)
    return _OPS[name]


def _sched_summaries(ops, mod, algorithm, topo):
    return [mod.decompose(op, algorithm, topo, warn=False).summary()
            for op in ops]


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


@pytest.mark.parametrize("fixture", ["serve", "translation"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("algorithm", ALGORITHMS)
class TestFixtureOps:
    def test_schedules(self, fixture, mesh, algorithm):
        ref_ops, ops = _fixture_ops(fixture)
        rt, pt = _topos(mesh)
        assert _sched_summaries(ops, dec, algorithm, pt) == \
            _sched_summaries(ref_ops, ref_dec, algorithm, rt)

    def test_summary(self, fixture, mesh, algorithm):
        ref_ops, ops = _fixture_ops(fixture)
        rt, pt = _topos(mesh)
        assert summary.summarize(ops, algorithm, pt) == \
            ref_hlo.summarize(ref_ops, algorithm, rt)
        assert summary.total_wire_bytes(ops, algorithm, pt) == \
            ref_hlo.total_wire_bytes(ref_ops, algorithm, rt)
        assert summary.count_by_opname(ops) == \
            ref_hlo.count_by_opname(ref_ops)

    def test_matrix(self, fixture, mesh, algorithm):
        ref_ops, ops = _fixture_ops(fixture)
        rt, pt = _topos(mesh)
        got = cm.matrix_for_ops(ops, 8, algorithm, topo=pt)
        want = ref_cm.matrix_for_ops(ref_ops, 8, algorithm, topo=rt)
        assert got.dtype == np.float64 and np.array_equal(got, want)
        got = cm.per_primitive_matrices(ops, 8, algorithm, topo=pt)
        want = ref_cm.per_primitive_matrices(ref_ops, 8, algorithm, topo=rt)
        assert sorted(got) == sorted(want)
        for kind in want:
            assert np.array_equal(got[kind], want[kind]), kind

    def test_op_edges(self, fixture, mesh, algorithm):
        ref_ops, ops = _fixture_ops(fixture)
        rt, pt = _topos(mesh)
        for op, rop in zip(ops[::7], ref_ops[::7]):
            assert cm.op_edges(op, algorithm, pt) == \
                ref_cm.op_edges(rop, algorithm, rt)

    def test_view(self, fixture, mesh, algorithm):
        ref_ops, ops = _fixture_ops(fixture)
        rt, pt = _topos(mesh)
        phases = sorted({op.phase for op in ref_ops if op.phase})
        for phase in [None] + phases[:1]:
            kw = dict(phase=phase, known_phases=phases, label="t")
            got = views.build_view(ops, 8, algorithm, pt, [], **kw)
            want = ref_views.build_view(ref_ops, 8, algorithm, rt, [], **kw)
            assert got.summary == want.summary
            assert np.array_equal(got.matrix, want.matrix)
            assert got.total_wire_bytes() == want.total_wire_bytes()
            if pt is not None:
                assert got.collective_seconds_split() == \
                    want.collective_seconds_split()
                assert got.collective_overlap_seconds() == \
                    want.collective_overlap_seconds()
                assert got.op_seconds() == want.op_seconds()


@pytest.mark.parametrize("fixture", ["serve", "translation"])
@pytest.mark.parametrize("mesh", ["1pod_4x2", "2pod_2x2x2"])
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_time_split(fixture, mesh, algorithm):
    """Per-tier (ICI, DCN) seconds; timing needs a topology."""
    ref_ops, ops = _fixture_ops(fixture)
    rt, pt = _topos(mesh)
    for lat in (True, False):
        assert cost.total_time_split(ops, pt, algorithm,
                                     include_latency=lat) == \
            ref_cost.total_time_split(ref_ops, rt, algorithm,
                                      include_latency=lat)
    for op, rop in zip(ops[::5], ref_ops[::5]):
        assert cost.collective_time_split(op, pt, algorithm) == \
            ref_cost.collective_time_split(rop, rt, algorithm)


def _pair_op(kind, elems, groups, weight, dtype="f32"):
    rop = RefOp(kind=kind, name="t", result_shapes=[RefShape(dtype, (elems,))],
                replica_groups=groups)
    rop.weight = weight
    return rop, ser.op_from_dict(ref_ser.op_to_dict(rop))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_single_op_grid(kind, algorithm, mesh):
    """Every kind on a full 8-group, pairs and quads, weighted."""
    rt, pt = _topos(mesh)
    for groups in ([list(range(8))], [[0, 1], [2, 3], [4, 5], [6, 7]],
                   [[0, 2, 4, 6], [1, 3, 5, 7]], [[0, 4], [1, 5], [2, 6],
                                                  [3, 7]]):
        if kind == "collective-permute":
            groups = [[0, 1], [1, 2], [2, 3], [3, 0]]
        rop, op = _pair_op(kind, 1000, groups, 3.0)
        assert dec.decompose(op, algorithm, pt, warn=False).summary() == \
            ref_dec.decompose(rop, algorithm, rt, warn=False).summary()
        assert np.array_equal(cm.matrix_for_ops([op], 8, algorithm, topo=pt),
                              ref_cm.matrix_for_ops([rop], 8, algorithm,
                                                    topo=rt))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_wire_bytes_per_rank(kind, algorithm):
    for pods in (1, 2, 4):
        for s in (1.0, 1000.0, 12345.0):
            assert cost.wire_bytes_per_rank(kind, s, 8, algorithm,
                                            pods=pods) == \
                ref_cost.wire_bytes_per_rank(kind, s, 8, algorithm,
                                             pods=pods)


@pytest.mark.parametrize("algorithm", ["ring", "tree", "collnet"])
def test_table1(algorithm):
    for n in (2, 4, 8, 16):
        for role in ("root", "other"):
            assert cost.table1_allreduce_bytes(n, 4096.0, algorithm, role) \
                == ref_cost.table1_allreduce_bytes(n, 4096.0, algorithm, role)
    for kind in KINDS[:5]:
        assert cost.latency_model(kind, 8, algorithm) == \
            ref_cost.latency_model(kind, 8, algorithm)


def test_validate_algorithm():
    for alg in ALGORITHMS:
        assert cost.validate_algorithm(alg) == ref_cost.validate_algorithm(alg)
    with pytest.raises(ValueError):
        cost.validate_algorithm("butterfly")


def test_host_transfers_add_to_row_and_column_zero():
    mat = np.zeros((9, 9))
    ref_mat = np.zeros((9, 9))
    ts = [(4096, 2, "h2d"), (128, 5, "d2h"), (7, 2, "h2d")]
    cm.add_host_transfers(mat, [HostTransfer(nbytes=b, device=d, direction=r)
                                for b, d, r in ts])
    ref_cm.add_host_transfers(ref_mat, [RefHostTransfer(nbytes=b, device=d,
                                                        direction=r)
                                        for b, d, r in ts])
    assert np.array_equal(mat, ref_mat)


@pytest.mark.parametrize("num_devices,sparse", [(8, True), (4096, None)])
def test_sparse_view_matches_reference(num_devices, sparse):
    """Above ``SPARSE_DEVICE_THRESHOLD`` devices (or with ``sparse=True``)
    the view's matrices are COO, entry for entry the reference's."""
    ref_ops, ops = _fixture_ops("serve")
    kw = dict(phase=None, known_phases=[], label="t", sparse=sparse)
    got = views.build_view(ops, num_devices, "ring", None, [], **kw)
    want = ref_views.build_view(ref_ops, num_devices, "ring", None, [], **kw)
    assert got.use_sparse and want.use_sparse
    pairs = [(got.matrix, want.matrix)] + [
        (got.per_primitive[k], want.per_primitive[k])
        for k in want.per_primitive]
    assert sorted(got.per_primitive) == sorted(want.per_primitive)
    for g, w in pairs:
        assert g.side == w.side == num_devices + 1
        for a in ("src", "dst", "val"):
            assert np.array_equal(getattr(g, a), getattr(w, a))
    dense = views.build_view(ops, num_devices, "ring", None, [],
                             **dict(kw, sparse=False))
    if num_devices == 8:
        assert np.array_equal(got.matrix.to_dense(), dense.matrix)
