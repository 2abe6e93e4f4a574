"""Point-to-point and rooted collectives in the port's capture.

The gate: the reference's ``ppermute`` ring program (the shape of
``tests/test_interceptor.py``: a ``psum`` over ``data``, an ``all_gather``
over ``model``, a ``ppermute`` ring over ``data``) and its torch analogue
on the fake 4x2 (data x model) mesh give equal per-kind tables -- calls and
payload bytes of the traced events and of the recorded ops -- and equal
ops.  The torch ring is written three ways: ``batch_isend_irecv``, plain
``dist.send`` + ``dist.recv``, and the recv before the send.

Pinned here as well: rooted collectives (``dist.reduce``, ``gather``,
``scatter``) give trace events and no op, with one warning per kind (the
schedule IR has no rooted kind; the reference's ``pgather`` gives no
compiled op either), and ``funcol.permute_tensor`` is recorded as the
all-to-all it lowers to.
"""
import warnings

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from jax.sharding import PartitionSpec as P

from repro.compat import shard_map
from repro.core import monitor_fn as ref_monitor_fn
from repro_torch.core import MonitorSession
from torch_fixtures import mesh_4x2


def _ref_report(mesh8):
    def f(x):
        y = jax.lax.psum(x, "data")
        z = jax.lax.all_gather(y, "model")
        w = jax.lax.ppermute(x, "data", [(i, (i + 1) % 4) for i in range(4)])
        return y.sum() + z.sum() + w.sum()

    prog = jax.jit(shard_map(f, mesh=mesh8, in_specs=P("data"),
                             out_specs=P(), check_vma=False))
    return ref_monitor_fn(prog, jax.ShapeDtypeStruct((8, 16), jnp.float32),
                          mesh=mesh8)


def _ring(style, x, g):
    """One ring step over group ``g``: send to the next group rank,
    receive from the previous one (this process is group rank 0)."""
    buf = torch.empty_like(x)
    n = dist.get_world_size(g)
    nxt, prv = (dist.get_global_rank(g, r) for r in (1 % n, (n - 1) % n))
    if style == "batch":
        ops = [dist.P2POp(dist.isend, x, nxt, g),
               dist.P2POp(dist.irecv, buf, prv, g)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    elif style == "send_recv":
        dist.send(x, nxt, group=g)
        dist.recv(buf, prv, group=g)
    else:
        dist.recv(buf, prv, group=g)
        dist.send(x, nxt, group=g)
    return buf


def _port_report(style):
    mesh = mesh_4x2()
    data, model = mesh.get_group("data"), mesh.get_group("model")

    def f(x):
        y = funcol.all_reduce(x, "sum", data)
        z = funcol.all_gather_tensor(y.unsqueeze(0), 0, model)
        w = _ring(style, x, data)
        return y.sum() + z.sum() + w.sum()

    sess = MonitorSession(mesh=mesh, name="ring")
    with sess.fake_mode:
        x = torch.empty(2, 16)
    sess.capture(f, x)
    return sess.report()


def _ops_key(rep):
    return sorted((op.kind, tuple(str(s) for s in op.result_shapes),
                   [list(g) for g in op.replica_groups],
                   [tuple(p) for p in op.source_target_pairs],
                   op.payload_bytes)
                  for op in rep.compiled_ops)


@pytest.mark.parametrize("style", ["batch", "send_recv", "recv_first"])
def test_ring_tables_equal_reference(mesh8, style):
    ref = _ref_report(mesh8)
    rep = _port_report(style)
    assert rep.traced_summary == ref.traced_summary
    assert rep.compiled_summary == ref.compiled_summary
    assert _ops_key(rep) == _ops_key(ref)
    assert rep.traced_summary["SendRecv"] == {"calls": 1,
                                              "payload_bytes": 128}


def test_ring_pairs_cover_every_group():
    rep = _port_report("batch")
    (perm,) = [op for op in rep.compiled_ops
               if op.kind == "collective-permute"]
    assert perm.source_target_pairs == [(0, 2), (2, 4), (4, 6), (6, 0),
                                        (1, 3), (3, 5), (5, 7), (7, 1)]
    assert perm.op_name == "c10d.send[data]"


def test_two_ring_steps_are_two_transfers():
    mesh = mesh_4x2()
    data = mesh.get_group("data")

    def f(x):
        _ring("batch", x, data)
        _ring("batch", x, data)

    sess = MonitorSession(mesh=mesh)
    with sess.fake_mode:
        x = torch.empty(2, 16)
    sess.capture(f, x)
    assert sess.report().traced_summary == {
        "SendRecv": {"calls": 2, "payload_bytes": 256}}


def test_lone_send_and_shifted_recv():
    """A send without its recv is a transfer of its own; a recv of another
    shift does not pair with it."""
    mesh = mesh_4x2()
    data = mesh.get_group("data")

    def f(x):
        dist.send(x, dist.get_global_rank(data, 2), group=data)   # shift 2
        dist.recv(torch.empty_like(x), dist.get_global_rank(data, 1),
                  group=data)                                     # shift 3

    sess = MonitorSession(mesh=mesh)
    with sess.fake_mode:
        x = torch.empty(4)
    sess.capture(f, x)
    ops = sess.report().compiled_ops
    assert [op.source_target_pairs[:4] for op in ops] == [
        [(0, 4), (2, 6), (4, 0), (6, 2)], [(0, 6), (2, 0), (4, 2), (6, 4)]]


@pytest.mark.parametrize("kind", ["reduce", "gather", "scatter"])
def test_rooted_collectives_are_events_without_ops(kind):
    mesh = mesh_4x2()
    data = mesh.get_group("data")

    def f(x):
        parts = [torch.empty_like(x) for _ in range(4)]
        if kind == "reduce":
            dist.reduce(x, 0, group=data)
        elif kind == "gather":
            dist.gather(x, parts, dst=0, group=data)
        else:
            dist.scatter(x, parts, src=0, group=data)

    sess = MonitorSession(mesh=mesh)
    with sess.fake_mode:
        x = torch.empty(2, 16)
    with pytest.warns(UserWarning, match=f"c10d.{kind}_ .* trace event only"):
        sess.capture(f, x)
    rep = sess.report()
    name = {"reduce": "Reduce", "gather": "Gather", "scatter": "Scatter"}
    assert rep.traced_summary == {name[kind]: {"calls": 1,
                                               "payload_bytes": 128}}
    assert rep.compiled_ops == []
    assert rep.traced[0].axis_size == 4


def test_rooted_warning_once_per_capture():
    mesh = mesh_4x2()
    data = mesh.get_group("data")

    def f(x):
        dist.reduce(x, 0, group=data)
        dist.reduce(x, 0, group=data)

    sess = MonitorSession(mesh=mesh)
    with sess.fake_mode:
        x = torch.empty(8)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sess.capture(f, x)
    assert sum("trace event only" in str(w.message) for w in caught) == 1
    assert sess.report().traced_summary["Reduce"]["calls"] == 2


def test_permute_tensor_is_recorded_as_all_to_all():
    """``funcol.permute_tensor`` lowers to ``all_to_all_single`` with one
    nonzero split each way.  At dispatch it cannot be told from a skewed
    all-to-all, so it is recorded as the all-to-all that runs (billed as
    one over the group), not as a collective-permute."""
    mesh = mesh_4x2()
    data = mesh.get_group("data")
    sess = MonitorSession(mesh=mesh)
    with sess.fake_mode:
        x = torch.empty(32)
    sess.capture(lambda t: funcol.permute_tensor(t, [1, 2, 3, 0], data), x)
    rep = sess.report()
    assert [op.kind for op in rep.compiled_ops] == ["all-to-all"]
    assert rep.compiled_ops[0].replica_groups == [[0, 2, 4, 6], [1, 3, 5, 7]]
    assert rep.traced_summary == {"AllToAll": {"calls": 1,
                                               "payload_bytes": 128}}
