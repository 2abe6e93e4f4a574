"""The port's fleet-scale projection (``repro_torch.scale``) against the
reference's ``repro.scale``.

``scale_op`` / ``scale_ops`` must project every op as the reference does
(block expansion of groups, scaled permute pairs, pod-sized all-to-all
chunks, tiled and renormalized byte vectors).  ``ScalePoint.row()`` --
every column but ``build_ms``, a host time -- must equal the reference's,
element-exact float64, on the serve fixture (a port ``CommReport`` loaded
from the committed file) at 256 and 1024 devices and on DDP-shaped op
streams at 256, 1024 and 4096.  At 4096 devices the fixture's full stream
routes about a million COO entries one at a time on each side, so the
4096 point takes the fixture without its all-to-alls.  The 16384-device
point must stay under the reference's memory bound: nothing dense.
"""
import dataclasses
import json
import tracemalloc
from pathlib import Path

import numpy as np
import pytest

from repro import scale as ref_scale
from repro.core.events import CollectiveOp as RefOp
from repro.core.events import Shape as RefShape
from repro.core.export import serialize as ref_ser
from repro.core.topology import MeshTopology as RefTopo
from repro_torch import scale
from repro_torch.core import CommReport
from repro_torch.core.events import CollectiveOp, Shape
from repro_torch.core.export import serialize as ser
from repro_torch.core.topology import MeshTopology

FIXTURE = Path(__file__).parent / "fixtures" / "serve_report.json"


def ddp_ops(num_ops=8, base=8, op=CollectiveOp, shape=Shape):
    """The reference test's DDP-shaped stream: whole-mesh all-reduces and
    all-gathers, weights 1-4."""
    return [op(kind="all-reduce" if i % 3 else "all-gather", name=f"d{i}",
               result_shapes=[shape("f32", (4096 + 512 * i,))],
               replica_groups=[list(range(base))], weight=float(1 + i % 4))
            for i in range(num_ops)]


class FakeReport:
    """The slice of ``CommReport`` the scale engine reads."""

    def __init__(self, ops, base=8, algorithm="ring", config="ddp_test"):
        self.compiled_ops = ops
        self.num_devices = base
        self.algorithm = algorithm
        self.name = config
        self.meta = {"config": config}


def _to_ref(op):
    return ref_ser.op_from_dict(ser.op_to_dict(op))


def _op_key(op):
    return ser.op_to_dict(op)


def _rows(points):
    out = []
    for p in points:
        r = p.row()
        r.pop("build_ms")
        out.append(r)
    return out


@pytest.mark.parametrize("d", [1, 8, 100, 256, 512, 1024, 4096, 16384])
def test_fleet_topology_equals_reference(d):
    t, rt = scale.fleet_topology(d), ref_scale.fleet_topology(d)
    assert (t.axis_names, t.axis_sizes, t.num_pods) == \
        (rt.axis_names, rt.axis_sizes, rt.num_pods)


def test_fleet_rejects_bad_sizes():
    for d in (0, 300):
        with pytest.raises(ValueError):
            MeshTopology.fleet(d)
        with pytest.raises(ValueError):
            RefTopo.fleet(d)


def _projection_cases():
    base = [
        CollectiveOp(kind="all-reduce", name="ar",
                     result_shapes=[Shape("f32", (8,))],
                     replica_groups=[[0, 1], [2, 3]]),
        CollectiveOp(kind="collective-permute", name="p",
                     result_shapes=[Shape("bf16", (64,))],
                     replica_groups=[],
                     source_target_pairs=[(0, 1), (1, 2), (2, 3), (3, 0)]),
        CollectiveOp(kind="all-to-all", name="a2a",
                     result_shapes=[Shape("f32", (32,))],
                     replica_groups=[list(range(8))]),
        CollectiveOp(kind="all-gather", name="agv",
                     result_shapes=[Shape("f32", (4,))],
                     replica_groups=[[0, 1, 2, 3]],
                     bytes_per_rank_vec=[40.0, 4.0, 4.0, 4.0]),
        CollectiveOp(kind="all-to-all", name="skew",
                     result_shapes=[Shape("f32", (1,))],
                     replica_groups=[list(range(8))],
                     bytes_per_rank_vec=[800.0] + [10.0] * 7),
    ]
    return [(op, f) for op in base for f in (1, 2, 64, 128, 2048)]


@pytest.mark.parametrize("op,factor", _projection_cases(),
                         ids=lambda x: getattr(x, "name", str(x)))
def test_scale_op_equals_reference(op, factor):
    got = scale.scale_op(op, factor)
    want = ref_scale.scale_op(_to_ref(op), factor)
    assert isinstance(got, list) == isinstance(want, list)
    got = got if isinstance(got, list) else [got]
    want = want if isinstance(want, list) else [want]
    assert [_op_key(o) for o in got] == [ref_ser.op_to_dict(o) for o in want]
    if factor == 1:
        assert got == [op]


def test_scale_op_rules():
    ar, perm, a2a, _, skew = [op for op, f in _projection_cases()[::5]]
    out = scale.scale_op(ar, 4)
    assert out.replica_groups == [list(range(8)), list(range(8, 16))]
    assert scale.scale_op(perm, 3).source_target_pairs == [
        (0, 3), (3, 6), (6, 9), (9, 0)]
    chunks = scale.scale_op(a2a, 2048).replica_groups   # 8 -> 16384
    assert all(len(g) == scale.POD_DEVICES for g in chunks)
    assert sum(len(g) for g in chunks) == 16384
    hot = scale.scale_op(skew, 64)          # 512 devices: two pod chunks
    assert isinstance(hot, list) and len(hot) == 2
    assert hot[0].byte_vector().sum() > hot[1].byte_vector().sum()
    with pytest.raises(ValueError):
        scale.scale_ops([ar], 8, 100)
    assert len(scale.scale_ops([ar, skew], 8, 512)) == 3


_POINTS: dict = {}


def _fixture_reports(subset=None):
    port = CommReport.load(str(FIXTURE))
    ref = ref_ser.report_from_dict(json.loads(FIXTURE.read_text()))
    if subset is not None:
        port = dataclasses.replace(port, compiled_ops=[
            op for op in port.compiled_ops if subset(op)])
        ref = dataclasses.replace(ref, compiled_ops=[
            op for op in ref.compiled_ops if subset(op)])
    return port, ref


def _no_a2a(op):
    return op.kind != "all-to-all"


CASES = {
    "serve": (lambda: _fixture_reports(), (256, 1024)),
    "serve_no_a2a": (lambda: _fixture_reports(_no_a2a), (4096,)),
    "ddp": (lambda: (FakeReport(ddp_ops()),
                     FakeReport(ddp_ops(op=RefOp, shape=RefShape))),
            (256, 1024, 4096)),
    "ddp_tree": (lambda: (FakeReport(ddp_ops(), algorithm="tree"),
                          FakeReport(ddp_ops(op=RefOp, shape=RefShape),
                                     algorithm="tree")), (1024,)),
}


def _points(case):
    if case not in _POINTS:
        make, sizes = CASES[case]
        port, ref = make()
        _POINTS[case] = (scale.scale_curve([port], sizes),
                         ref_scale.scale_curve([ref], sizes))
    return _POINTS[case]


@pytest.mark.parametrize("case", list(CASES))
def test_scale_points_equal_reference(case):
    got, want = _points(case)
    assert len(got) == len(want) == len(CASES[case][1])
    assert _rows(got) == _rows(want)
    assert scale.scale_table(got) == ref_scale.scale_table(want)
    for p in got:
        assert p.nnz > 0 and p.bottleneck_link != "-" and p.build_ms >= 0


def test_scale_points_grow_monotonically():
    pts = sorted(_points("ddp")[0], key=lambda p: p.devices)
    bn = [p.bottleneck_ms for p in pts]
    assert all(b1 >= b0 * (1 - 1e-9) for b0, b1 in zip(bn, bn[1:]))
    assert all(w1 > w0 for w0, w1 in zip(
        [p.wire_bytes for p in pts], [p.wire_bytes for p in pts][1:]))


def test_sparse_point_equals_dense_point():
    """At 256 devices the scaled serve stream's COO matrix equals the
    dense one entry for entry, and their link projections are equal."""
    from repro_torch.core import comm_matrix as cm

    port, _ = _fixture_reports()
    ops = scale.scale_ops(port.compiled_ops, 8, 256)
    topo = scale.fleet_topology(256)
    coo = cm.matrix_for_ops(ops, 256, "ring", topo=topo, sparse=True)
    dense = cm.matrix_for_ops(ops, 256, "ring", topo=topo)
    assert np.array_equal(coo.to_dense(), dense)
    assert cm.project_links(coo, topo).bytes_by_link == \
        cm.project_links(dense, topo).bytes_by_link


def test_skips_non_multiples():
    logged = []
    pts = scale.scale_curve([FakeReport(ddp_ops())], (100,),
                            log=logged.append)
    assert pts == [] and any("skip" in m for m in logged)


def test_16k_point_peak_memory_bounded():
    rep = FakeReport(ddp_ops(num_ops=6))
    tracemalloc.start()
    p = scale.scale_point(rep, 16384)
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    peak_mb = peak / 2**20
    # the dense (16385)^2 float64 matrix alone is ~2100 MiB
    assert peak_mb < 300, f"16k-device point peaked at {peak_mb:.0f} MiB"
    assert p.devices == 16384 and p.pods == 64
    assert p.nnz > 0 and p.dcn_ms > 0
    assert p.bottleneck_link.startswith(("dcn:", "ici:"))
