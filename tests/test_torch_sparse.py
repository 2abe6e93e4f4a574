"""The port's sparse (COO) matrices against the reference.

``matrix_for_ops(..., sparse=True)`` on the committed fixtures' ops (serve,
translation), under ring, tree and hierarchical, on 1- and 2-pod 8-device
meshes and above ``SPARSE_DEVICE_THRESHOLD``: the coalesced ``(src, dst,
val)`` arrays equal the reference's, element-exact float64, and the dense
matrix entry for entry.  Then ``SparseCommMatrix`` itself (coalescing,
accessors, ``from_dense``, ``coarsen``, CSV rows, the bounded
accumulator), and the schema-v6 COO JSON both ways: the reference's
``report_from_dict`` loads a sparse report the port saved, the port loads
the reference's, and both write the same dict for the same report.
"""
import dataclasses
import json
import warnings
from pathlib import Path

import numpy as np
import pytest

from repro.core import comm_matrix as ref_cm
from repro.core import sparse as ref_sparse
from repro.core.export import serialize as ref_ser
from repro.core.reporter import ascii_heatmap as ref_heatmap
from repro.core.reporter import coarsen_matrix as ref_coarsen
from repro.core.topology import MeshTopology as RefTopo
from repro_torch.core import CommReport, CommView
from repro_torch.core import comm_matrix as cm
from repro_torch.core import sparse as sparse_mod
from repro_torch.core.events import CollectiveOp, Shape
from repro_torch.core.export import serialize as ser
from repro_torch.core.reporter import ascii_heatmap, coarsen_matrix
from repro_torch.core.sparse import (SPARSE_DEVICE_THRESHOLD,
                                     SparseAccumulator, SparseCommMatrix,
                                     from_dense, is_sparse)
from repro_torch.core.topology import MeshTopology

FIXTURES = Path(__file__).parent / "fixtures"
ALGORITHMS = ("ring", "tree", "hierarchical")
MESHES = {
    "1pod_4x2": (("data", "model"), (4, 2)),
    "2pod_2x2x2": (("pod", "data", "model"), (2, 2, 2)),
}

_OPS: dict = {}


def _fixture(name):
    """(reference report, port ops built from its op dicts)."""
    if name not in _OPS:
        d = json.loads((FIXTURES / f"{name}_report.json").read_text())
        ref = ref_ser.report_from_dict(d)
        _OPS[name] = (ref, [ser.op_from_dict(ref_ser.op_to_dict(o))
                            for o in ref.compiled_ops])
    return _OPS[name]


def _same_coo(got, want):
    assert is_sparse(got) and ref_sparse.is_sparse(want)
    assert got.side == want.side
    for a in ("src", "dst", "val"):
        g, w = getattr(got, a), getattr(want, a)
        assert g.dtype == w.dtype and np.array_equal(g, w), a


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


@pytest.mark.parametrize("fixture", ["serve", "translation"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_coo_entries_equal_reference(fixture, mesh, algorithm):
    ref, ops = _fixture(fixture)
    names, sizes = MESHES[mesh]
    topo = MeshTopology(axis_names=names, axis_sizes=sizes)
    rtopo = RefTopo(axis_names=names, axis_sizes=sizes)
    got = cm.matrix_for_ops(ops, 8, algorithm, topo=topo, sparse=True)
    want = ref_cm.matrix_for_ops(ref.compiled_ops, 8, algorithm, topo=rtopo,
                                 sparse=True)
    _same_coo(got, want)
    assert np.array_equal(got.to_dense(),
                          cm.matrix_for_ops(ops, 8, algorithm, topo=topo))
    per = cm.per_primitive_matrices(ops, 8, algorithm, topo=topo,
                                    sparse=True)
    rper = ref_cm.per_primitive_matrices(ref.compiled_ops, 8, algorithm,
                                         topo=rtopo, sparse=True)
    assert sorted(per) == sorted(rper)
    for kind in per:
        _same_coo(per[kind], rper[kind])


@pytest.mark.parametrize("fixture", ["serve", "translation"])
def test_coo_above_the_threshold(fixture):
    """A view wider than ``SPARSE_DEVICE_THRESHOLD`` devices builds COO on
    its own, with the reference's entries and host transfers."""
    from repro.core.events import HostTransfer as RefTransfer
    from repro.core.views import CommView as RefView
    from repro_torch.core.events import HostTransfer

    ref, ops = _fixture(fixture)
    n = 2 * SPARSE_DEVICE_THRESHOLD
    tr = [(4096, 2, "h2d"), (128, 5, "d2h")]
    v = CommView(ops, n, algorithm="tree", host_transfers=[
        HostTransfer(nbytes=b, device=d, direction=r) for b, d, r in tr])
    rv = RefView(ref.compiled_ops, n, algorithm="tree", host_transfers=[
        RefTransfer(nbytes=b, device=d, direction=r) for b, d, r in tr])
    assert v.use_sparse and not CommView(ops, SPARSE_DEVICE_THRESHOLD
                                         ).use_sparse
    _same_coo(v.matrix, rv.matrix)
    assert v.matrix.shape == (n + 1, n + 1)


def test_coalesce_and_accessors():
    m = SparseCommMatrix(4, np.array([1, 2, 1, 0]), np.array([2, 1, 2, 3]),
                         np.array([5.0, 7.0, 3.0, 2.0]))
    assert m.nnz == 3 and m.sum() == 17.0 and m.max() == 8.0
    assert m.shape == (5, 5) and m.num_devices == 4
    dense = m.to_dense()
    assert dense[1, 2] == 8.0 and dense[2, 1] == 7.0
    np.testing.assert_array_equal(m.row_sums(), dense.sum(axis=1))
    np.testing.assert_array_equal(m.col_sums(), dense.sum(axis=0))
    src, dst, val = m.device_entries()
    assert (src.tolist(), dst.tolist(), val.tolist()) == ([0, 1], [1, 0],
                                                          [8.0, 7.0])
    with pytest.raises(ValueError):
        SparseCommMatrix(2, np.array([5]), np.array([0]), np.array([1.0]))
    with pytest.raises(ValueError):
        SparseCommMatrix(2, np.array([0]), np.array([-1]), np.array([1.0]))


@pytest.mark.parametrize("d,seed", [(4, 0), (8, 1), (33, 2), (100, 3)])
def test_from_dense_and_coarsen_equal_reference(d, seed):
    rng = np.random.default_rng(seed)
    dense = np.where(rng.random((d + 1, d + 1)) < 0.3,
                     rng.random((d + 1, d + 1)) * 1e9, 0.0)
    sp, rsp = from_dense(dense), ref_sparse.from_dense(dense)
    _same_coo(sp, rsp)
    assert np.array_equal(sp.to_dense(), dense)
    hm, k = sp.coarsen(8)
    rhm, rk = rsp.coarsen(8)
    assert k == rk and np.array_equal(hm, rhm)
    # the heatmap path: COO coarsened straight from its entries, the same
    # blocks as coarsening the dense form (to float64 rounding of sums)
    dhm, dk = coarsen_matrix(dense, max_devices=8)
    hm2, k2 = coarsen_matrix(sp, max_devices=8)
    assert (dk, k2) == (rk, k) and np.array_equal(hm2, hm)
    np.testing.assert_allclose(hm, dhm, rtol=1e-12)
    rdhm, _ = ref_coarsen(dense, max_devices=8)
    assert np.array_equal(dhm, rdhm)
    assert ascii_heatmap(sp, title="t") == ref_heatmap(rsp, title="t")


def test_csv_rows_and_accumulator():
    m = SparseCommMatrix(2, np.array([0, 1]), np.array([1, 2]),
                         np.array([4.0, 8.0]))
    assert m.to_csv_rows() == ["host,gpu0,4", "gpu0,gpu1,8"]
    acc = SparseAccumulator(4, coalesce_at=3)     # squashes as it goes
    racc = ref_sparse.SparseAccumulator(4, coalesce_at=3)
    rng = np.random.default_rng(0)
    for _ in range(10):
        src, dst = rng.integers(0, 5, 4), rng.integers(0, 5, 4)
        val = rng.random(4) * 1e3
        acc.add(src, dst, val)
        racc.add(src, dst, val)
    _same_coo(acc.build(), racc.build())


def _sparse_copy(report, mod):
    """The same report with COO matrices (``mod``: either package's sparse
    module)."""
    return dataclasses.replace(
        report, matrix=mod.from_dense(report.matrix),
        per_primitive={k: mod.from_dense(m)
                       for k, m in report.per_primitive.items()})


def _dumps(d) -> str:
    return json.dumps(d, sort_keys=True)


@pytest.mark.parametrize("fixture", ["serve", "translation"])
def test_coo_json_cross_loads(fixture, tmp_path):
    ref = _fixture(fixture)[0]
    port = CommReport.load(str(FIXTURES / f"{fixture}_report.json"))
    ref_sp = _sparse_copy(ref, ref_sparse)
    port_sp = _sparse_copy(port, sparse_mod)
    # the same report writes the same dict, link sections included
    pd, rd = ser.report_to_dict(port_sp), ref_ser.report_to_dict(ref_sp)
    assert _dumps(pd) == _dumps(rd)
    assert pd["matrix"]["format"] == "coo" and "link_matrix" not in pd
    assert all(r["bytes"] > 0 for r in pd["links"])
    assert _dumps(ser.report_to_dict(port)) == \
        _dumps(ref_ser.report_to_dict(ref))
    # port -> file -> reference
    path = tmp_path / "port.json"
    port_sp.save(str(path))
    back_ref = ref_ser.report_from_dict(json.loads(path.read_text()))
    _same_coo(port_sp.matrix, back_ref.matrix)
    assert back_ref.link_utilization().rows() == \
        port_sp.link_utilization().rows()
    # reference -> dict -> port
    back = ser.report_from_dict(json.loads(json.dumps(rd)))
    _same_coo(back.matrix, ref_sp.matrix)
    for k in ref_sp.per_primitive:
        _same_coo(back.per_primitive[k], ref_sp.per_primitive[k])
    assert back.view().use_sparse and is_sparse(back.view("tree").matrix)
    assert back.link_utilization().rows() == ref_sp.link_utilization().rows()
    assert "device blocks" not in back.heatmap()


def test_unknown_matrix_format_raises():
    with pytest.raises(ValueError, match="unknown matrix format"):
        ser.matrix_from_jsonable({"format": "csr"})


def test_view_sparse_mode():
    """``sparse=True`` binds a COO view, and rebinding keeps it; ``None``
    goes COO above the threshold only."""
    op = CollectiveOp(kind="all-reduce", name="x",
                      result_shapes=[Shape("f32", (8,))],
                      replica_groups=[[0, 1]])
    assert CommView([op], 8).use_sparse is False
    assert is_sparse(CommView([op], 8, sparse=True).matrix)
    assert CommView([op], 8, sparse=True).rebind("tree").use_sparse
    assert CommView([op], 4096).use_sparse is True
    assert CommView([op], 4096, sparse=False).use_sparse is False
