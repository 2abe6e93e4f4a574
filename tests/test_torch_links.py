"""The port's physical links (``topology.Link``, ``route``) and link
projection (``project_links``, ``LinkUtilization``) against the reference.

Topologies are those of ``tests/test_link_consistency.py`` (8 devices on
one, two and four pods) plus a 4x4 torus and a 2x2x2 single pod with
size-2 axes.  Every pair's route, the link enumeration and each link's
bandwidth must equal the reference's.  The projection of the same matrix --
dense, and its COO form -- must give the reference's ``bytes_by_link``,
bottleneck, tier summary, per-kind summary, rows and link matrix, all
element-exact float64: the matrices of the committed fixtures' ops and of
single ops of every kind, under ring, tree and hierarchical.
"""
import json
import warnings
from pathlib import Path

import numpy as np
import pytest

from repro.core import comm_matrix as ref_cm
from repro.core import cost_models as ref_cost
from repro.core.events import CollectiveOp as RefOp
from repro.core.events import Shape as RefShape
from repro.core.export import serialize as ref_ser
from repro.core.topology import MeshTopology as RefTopo
from repro_torch.core import comm_matrix as cm
from repro_torch.core import cost_models as cost
from repro_torch.core.events import CollectiveOp, Shape
from repro_torch.core.export import serialize as ser
from repro_torch.core.sparse import from_dense
from repro_torch.core.topology import DCN_FABRIC, Link, MeshTopology

FIXTURES = Path(__file__).parent / "fixtures"
ALGORITHMS = ("ring", "tree", "hierarchical")
KINDS = ("all-reduce", "all-gather", "reduce-scatter",
         "collective-broadcast", "all-to-all")
TOPOLOGIES = {
    "one_pod": (("data",), (8,)),
    "two_pod": (("pod", "data", "model"), (2, 2, 2)),
    "four_pod": (("pod", "data"), (4, 2)),
    "torus_4x4": (("data", "model"), (4, 4)),
    "cube_2x2x2": (("data", "model", "seq"), (2, 2, 2)),
}


def _topos(name):
    names, sizes = TOPOLOGIES[name]
    return (MeshTopology(axis_names=names, axis_sizes=sizes),
            RefTopo(axis_names=names, axis_sizes=sizes))


def _key(link):
    return (link.kind, link.src, link.dst, link.axis)


def _assert_lu_equal(got, want):
    assert [(_key(l), b) for l, b in got.bytes_by_link.items()] == \
        [(_key(l), b) for l, b in want.bytes_by_link.items()]
    bg, bw = got.bottleneck(), want.bottleneck()
    assert (bg is None) == (bw is None)
    if bg is not None:
        assert (bg[0].name, bg[1]) == (bw[0].name, bw[1])
    assert got.tier_summary() == want.tier_summary()
    assert got.summary() == want.summary()
    assert got.rows() == want.rows()
    assert np.array_equal(got.matrix(), want.matrix())
    sg, sw = got.sparse_matrix(), want.sparse_matrix()
    for a in ("src", "dst", "val"):
        assert np.array_equal(getattr(sg, a), getattr(sw, a))
    assert got.table() == want.table()


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


@pytest.mark.parametrize("name", list(TOPOLOGIES))
def test_links_and_routes_equal_reference(name):
    topo, rtopo = _topos(name)
    links = topo.links()
    assert [_key(l) for l in links] == [_key(l) for l in rtopo.links()]
    assert [l.name for l in links] == [l.name for l in rtopo.links()]
    for l, rl in zip(links, rtopo.links()):
        assert topo.link_multiplicity(l) == rtopo.link_multiplicity(rl)
        assert topo.link_bandwidth(l) == rtopo.link_bandwidth(rl)
    assert topo.ici_axes == rtopo.ici_axes
    enumerated = set(links)
    for i in range(topo.num_devices):
        for j in range(topo.num_devices):
            route = topo.route(i, j)
            assert [_key(l) for l in route] == \
                [_key(l) for l in rtopo.route(i, j)]
            assert all(l in enumerated for l in route)
            if topo._pod_index(i) == topo._pod_index(j):
                assert len(route) == topo.torus_distance(i, j) == \
                    rtopo.torus_distance(i, j)


def test_neighbor_and_device_at():
    topo, rtopo = _topos("torus_4x4")
    for d in range(16):
        assert topo.device_at(topo.coords(d)) == d
        for axis in ("data", "model"):
            for step in (1, -1, 3):
                assert topo.neighbor(d, axis, step) == \
                    rtopo.neighbor(d, axis, step)
    assert not topo.is_dcn_axis("data") and _topos("two_pod")[0].is_dcn_axis(
        "pod")


def test_cross_pod_route_is_uplink_plus_downlink():
    topo, _ = _topos("two_pod")
    assert topo.route(0, 7) == [Link("dcn", 0, DCN_FABRIC, "dcn"),
                                Link("dcn", DCN_FABRIC, 7, "dcn")]
    assert topo.route(3, 3) == []


def _op_pair(kind, elems=256, group=None, weight=1.0):
    group = group or list(range(8))
    op = CollectiveOp(kind=kind, name="t",
                      result_shapes=[Shape("f32", (elems,))],
                      replica_groups=[group], weight=weight)
    rop = RefOp(kind=kind, name="t",
                result_shapes=[RefShape("f32", (elems,))],
                replica_groups=[group], weight=weight)
    return op, rop


@pytest.mark.parametrize("topo_name", ["one_pod", "two_pod", "four_pod"])
@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("kind", KINDS)
def test_single_op_projection(kind, algorithm, topo_name):
    topo, rtopo = _topos(topo_name)
    op, rop = _op_pair(kind, weight=3.0)
    for sparse in (False, True):
        got = cm.link_utilization_for_ops([op], topo, algorithm,
                                          sparse=sparse)
        want = ref_cm.link_utilization_for_ops([rop], rtopo, algorithm,
                                               sparse=sparse)
        _assert_lu_equal(got, want)
    assert cost.contention_time([op], topo, algorithm) == \
        ref_cost.contention_time([rop], rtopo, algorithm)


_OPS: dict = {}


def _fixture_ops(name):
    if name not in _OPS:
        d = json.loads((FIXTURES / f"{name}_report.json").read_text())
        ref_ops = ref_ser.report_from_dict(d).compiled_ops
        _OPS[name] = (ref_ops, [ser.op_from_dict(ref_ser.op_to_dict(o))
                                for o in ref_ops])
    return _OPS[name]


@pytest.mark.parametrize("fixture", ["serve", "translation"])
@pytest.mark.parametrize("topo_name", ["one_pod", "two_pod", "four_pod"])
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_fixture_projection_dense_and_coo(fixture, topo_name, algorithm):
    ref_ops, ops = _fixture_ops(fixture)
    topo, rtopo = _topos(topo_name)
    dense = cm.matrix_for_ops(ops, 8, algorithm, topo=topo)
    coo = cm.matrix_for_ops(ops, 8, algorithm, topo=topo, sparse=True)
    want = ref_cm.project_links(
        ref_cm.matrix_for_ops(ref_ops, 8, algorithm, topo=rtopo), rtopo)
    from_d = cm.project_links(dense, topo)
    from_s = cm.project_links(coo, topo)
    _assert_lu_equal(from_d, want)
    _assert_lu_equal(from_s, want)
    assert from_d.bytes_by_link == from_s.bytes_by_link
    assert cm.project_links(from_dense(dense), topo).bytes_by_link == \
        from_d.bytes_by_link


def test_projection_charges_transit_hops_and_skips_the_host():
    topo, _ = _topos("one_pod")
    mat = np.zeros((9, 9))
    mat[1, 4] = 10.0            # 0 -> 3: three hops on an 8-ring
    mat[0, 3] = 999.0           # host -> device: never on the fabric
    lu = cm.project_links(mat, topo)
    assert lu.total_bytes() == 30.0 and lu.total_bytes("ici") == 30.0
    assert cm.project_links(np.zeros((9, 9)), topo).bottleneck() is None


def test_project_links_rejects_other_types_and_foreign_links():
    topo, _ = _topos("one_pod")
    with pytest.raises(TypeError, match="not list"):
        cm.project_links([[0.0] * 9] * 9, topo)

    class BadTopo(MeshTopology):
        def route(self, src, dst):
            return [Link("ici", src, dst, "ghost-axis")]

    mat = np.zeros((9, 9))
    mat[1, 5] = 64.0
    with pytest.raises(ValueError, match="not an enumerated"):
        cm.project_links(mat, BadTopo(axis_names=("data",), axis_sizes=(8,)))


def test_report_link_views_and_text_equal_reference():
    """``CommReport.link_utilization`` / ``link_matrix`` / ``link_seconds``
    / ``link_table`` and the render's physical-links section, on the serve
    fixture loaded by both packages."""
    from repro_torch.core import CommReport

    d = json.loads((FIXTURES / "serve_report.json").read_text())
    ref = ref_ser.report_from_dict(d)
    rep = CommReport.load(str(FIXTURES / "serve_report.json"))
    _assert_lu_equal(rep.link_utilization(), ref.link_utilization())
    assert np.array_equal(rep.link_matrix(), ref.link_matrix())
    assert rep.link_seconds() == ref.link_seconds()
    assert rep.link_table() == ref.link_table()
    assert rep.view().collective_overlap_seconds() == \
        ref.collective_overlap_seconds()
    assert "-- physical links --\n" + rep.link_table() in rep.render()
    for alg in ALGORITHMS:
        _assert_lu_equal(rep.link_utilization(alg),
                         ref.link_utilization(alg))
