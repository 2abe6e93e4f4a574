"""Collective interception -- the LD_PRELOAD analogue for PyTorch (port of
``repro.core.interceptor``).

The paper's ComScribe preloads a shim over ``ncclAllReduce`` & friends.  A
PyTorch program reaches its process group through the ``c10d`` operators:
the functional ``_c10d_functional.*`` ops (what DTensor and
``torch.distributed._functional_collectives`` issue), the in-place
``c10d.*`` ops (what ``torch.distributed.all_reduce`` & co. issue), and
DTensor's own ``_dtensor.shard_dim_alltoall`` (its shard-to-shard
redistribution on a non-CPU mesh, which reaches no ``c10d`` op under
``FakeTensorMode``).
:class:`CollectiveInterceptor` is a ``TorchDispatchMode`` that records each
of them as it runs: its kind, per-device result shapes and dtype, and the
replica groups of the mesh dimension it ran on.

Point-to-point transfers (``c10d.send`` / ``c10d.recv_``, which
``dist.send``, ``dist.recv`` and ``batch_isend_irecv`` reach) are recorded
as the reference records ``ppermute``: one SendRecv, a
``collective-permute`` whose ``source_target_pairs`` cover the whole group.
A capture runs one rank, so the pairs come from its peer under the SPMD
reading that every rank issues the same shift: a send to group rank
``dst`` from group rank ``rank`` gives ``(r, (r + dst - rank) mod n)`` for
every ``r``, in every group of the mesh dimension.  A send and a recv of
the same shift, group and shape are one transfer (a ring step), so the
second of the two adds nothing.

The rooted collectives (``c10d.reduce_``, ``gather_``, ``scatter_``) are
recorded as trace events under their NCCL names (Reduce, Gather, Scatter)
and give no op: the schedule IR has no rooted kind, as the reference's HLO
kinds have none (its ``pgather`` is a Gather trace event that gives no
compiled op).  Each kind warns once per interceptor that it was left out of
the op stream.

When a DTensor is involved the mode steps aside (``NotImplemented``) so
DTensor first lowers the op to local ops and collectives, which then reach
the mode -- so resharding the program never asked for is recorded too, the
way the reference reads GSPMD's resharding from the compiled HLO.  An
``AsyncCollectiveTensor`` (a functional collective's pending result) lowers
the same way: its ``wait_tensor`` reaches the mode before the op that reads
it.  ``wait_tensor`` is not a collective and is not recorded.

With ``defuse=True`` the interceptor also keeps a def-use record of every
op it sees (:mod:`repro_torch.core.defuse`), which the lint's def-use rules
walk.
"""
from __future__ import annotations

import itertools
import math
import warnings
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .defuse import DefUseRecorder
from .events import CollectiveOp, Shape, TraceEvent, torch_shape

# op name (overload packet) -> (HLO kind, NCCL-style name)
_FUNCTIONAL = {
    "all_reduce": ("all-reduce", "AllReduce"),
    "all_reduce_": ("all-reduce", "AllReduce"),
    "all_reduce_coalesced": ("all-reduce", "AllReduce"),
    "all_reduce_coalesced_": ("all-reduce", "AllReduce"),
    "all_gather_into_tensor": ("all-gather", "AllGather"),
    "all_gather_into_tensor_out": ("all-gather", "AllGather"),
    "all_gather_into_tensor_coalesced": ("all-gather", "AllGather"),
    "reduce_scatter_tensor": ("reduce-scatter", "ReduceScatter"),
    "reduce_scatter_tensor_out": ("reduce-scatter", "ReduceScatter"),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", "ReduceScatter"),
    "all_to_all_single": ("all-to-all", "AllToAll"),
    "broadcast": ("collective-broadcast", "Broadcast"),
    "broadcast_": ("collective-broadcast", "Broadcast"),
}
_C10D = {
    "allreduce_": ("all-reduce", "AllReduce"),
    "allreduce_coalesced_": ("all-reduce", "AllReduce"),
    "allgather_": ("all-gather", "AllGather"),
    "_allgather_base_": ("all-gather", "AllGather"),
    "allgather_into_tensor_coalesced_": ("all-gather", "AllGather"),
    "reduce_scatter_": ("reduce-scatter", "ReduceScatter"),
    "_reduce_scatter_base_": ("reduce-scatter", "ReduceScatter"),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", "ReduceScatter"),
    "alltoall_": ("all-to-all", "AllToAll"),
    "alltoall_base_": ("all-to-all", "AllToAll"),
    "broadcast_": ("collective-broadcast", "Broadcast"),
    "send": ("collective-permute", "SendRecv"),
    "recv_": ("collective-permute", "SendRecv"),
    "reduce_": (None, "Reduce"),
    "gather_": (None, "Gather"),
    "scatter_": (None, "Scatter"),
}
_DTENSOR = {
    "shard_dim_alltoall": ("all-to-all", "AllToAll"),
}


def traced_summary(events) -> dict:
    """Paper Table-2 style logical summary over trace events, keyed by the
    NCCL-style name (the reference's spelling)."""
    table: dict[str, dict] = {}
    for ev in events:
        name = getattr(ev, "nccl_name", ev.primitive)
        row = table.setdefault(name, {"calls": 0, "payload_bytes": 0})
        row["calls"] += 1
        row["payload_bytes"] += ev.payload_bytes
    return table


def _tensors(x) -> list[torch.Tensor]:
    """Tensors in an argument or result, list operands unpacked (the
    in-place ``c10d`` ops carry theirs in lists, nested for allgather)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for item in x for t in _tensors(item)]
    return []


def _group_name(func, args, kwargs) -> str:
    """The process group's name: a string operand of the functional ops,
    a ``ProcessGroup`` script object of the in-place ones."""
    from torch.distributed.distributed_c10d import ProcessGroup

    for a in list(args) + list((kwargs or {}).values()):
        if isinstance(a, ProcessGroup):
            return a.group_name
        if isinstance(a, torch.ScriptObject):
            pg = ProcessGroup.unbox(a)
            return pg.group_name
    schema_names = [arg.name for arg in func._schema.arguments]
    if "group_name" in schema_names:
        i = schema_names.index("group_name")
        return args[i] if i < len(args) else kwargs["group_name"]
    raise ValueError(f"{func}: no process group operand")


class CollectiveInterceptor(TorchDispatchMode):
    """Scoped recorder of every collective that reaches a process group.

    ``mesh`` (a ``DeviceMesh``) names the dimension each group belongs to
    and gives all of that dimension's groups as the op's replica groups
    (the program runs as one rank, but every rank issues the same op); a
    group of a flattened submesh, such as ``(pod, data)``, is matched to
    those dimensions together and named ``pod_data``, as torch names it.  A
    group is matched to a dimension by its ranks, not by its name: DTensor
    caches sharding decisions across meshes of equal layout, so a second
    mesh built like an earlier one may issue collectives on the earlier
    mesh's groups.  A group outside the mesh dims is recorded with its own
    ranks.  ``defuse=True`` keeps :attr:`defuse`, a
    :class:`~repro_torch.core.defuse.DefUseRecorder` of every op.
    """

    def __init__(self, mesh=None, defuse: bool = False):
        super().__init__()
        self.defuse = DefUseRecorder() if defuse else None
        self.events: list[TraceEvent] = []
        self.ops: list[CollectiveOp] = []
        self._groups: dict[str, tuple[str, list[list[int]]]] = {}
        # point-to-point records still waiting for their other side:
        # direction -> (axis, shift, shape) -> count
        self._unpaired = {"send": Counter(), "recv_": Counter()}
        self._warned: set[str] = set()
        self._dims: list[tuple[str, list[list[int]]]] = []
        if mesh is not None:
            from torch._subclasses.fake_tensor import unset_fake_temporarily

            names = mesh.mesh_dim_names
            with unset_fake_temporarily():   # the mesh's rank table is real
                ranks = mesh.mesh
                for r in range(1, len(names) + 1):
                    for dims in itertools.combinations(range(len(names)), r):
                        rest = [d for d in range(len(names)) if d not in dims]
                        self._dims.append((
                            "_".join(names[d] for d in dims),
                            ranks.permute(*rest, *dims)
                            .reshape(-1, math.prod(mesh.shape[d]
                                                   for d in dims))
                            .tolist()))

    def _groups_of(self, group_name: str) -> tuple[str, list[list[int]]]:
        if group_name not in self._groups:
            import torch.distributed as dist
            from torch.distributed.distributed_c10d import \
                _resolve_process_group

            ranks = sorted(dist.get_process_group_ranks(
                _resolve_process_group(group_name)))
            self._groups[group_name] = next(
                ((name, rings) for name, rings in self._dims
                 if ranks in rings), (group_name, [ranks]))
        return self._groups[group_name]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed._functional_collectives import \
            AsyncCollectiveTensor
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, (DTensor, AsyncCollectiveTensor))
               for t in types):
            return NotImplemented      # let the subclass lower to local ops
        out = func(*args, **kwargs)
        ns = func.namespace
        name = func._overloadpacket.__name__
        kind = {"_c10d_functional": _FUNCTIONAL, "c10d": _C10D,
                "_dtensor": _DTENSOR}.get(ns, {}).get(name)
        n_ops = len(self.ops)
        if kind is not None:
            self._record(func, kind, args, kwargs, out)
        if self.defuse is not None:
            self.defuse.record(func, args, kwargs, out,
                               self.ops[-1].name if len(self.ops) > n_ops
                               else "")
        return out

    def _record(self, func, kind, args, kwargs, out) -> None:
        hlo_kind, nccl = kind
        axis, groups = self._groups_of(_group_name(func, args, kwargs))
        name = func._overloadpacket.__name__
        if name in ("send", "recv_"):
            self._record_p2p(func, name, args, axis, groups)
            return
        if hlo_kind is None:
            self._record_rooted(func, name, nccl, args, axis, groups)
            return
        if func.namespace in ("_c10d_functional", "_dtensor"):
            inputs = _tensors(args[0])
            results = [torch_shape(t) for t in _tensors(out)]
        elif name in ("allgather_", "alltoall_"):
            # outputs: one tensor per peer (a list per input for allgather_);
            # the per-device result is their concatenation
            inputs = _tensors(args[1])
            per_input = (args[0] if name == "allgather_" else [args[0]])
            results = [_concat_shape(_tensors(outs)) for outs in per_input]
        elif name in ("allreduce_", "allreduce_coalesced_", "broadcast_"):
            inputs = _tensors(args[0])          # in place
            results = [torch_shape(t) for t in inputs]
        else:                                   # (output(s), input(s), ...)
            inputs = _tensors(args[1])
            results = [torch_shape(t) for t in _tensors(args[0])]
        ev = TraceEvent(primitive=name, axis_name=axis,
                        arg_shapes=[torch_shape(t) for t in inputs],
                        axis_size=len(groups[0]))
        ev.nccl_name = nccl
        self.events.append(ev)
        self.ops.append(CollectiveOp(
            kind=hlo_kind,
            name=f"{name}.{len(self.ops)}",
            result_shapes=results,
            replica_groups=[list(g) for g in groups],
            op_name=f"{func.namespace}.{name}[{axis}]"))

    def _record_p2p(self, func, name, args, axis, groups) -> None:
        """``send(tensors, pg, dst, tag)`` / ``recv_(tensors, pg, src,
        tag)``, ``dst``/``src`` a group rank: one SendRecv per transfer."""
        import torch.distributed as dist
        from torch.distributed.distributed_c10d import ProcessGroup

        (t,) = _tensors(args[0])
        pg = args[1]
        if not isinstance(pg, ProcessGroup):
            pg = ProcessGroup.unbox(pg)
        n = len(groups[0])
        rank = dist.get_rank(pg)
        peer = int(args[2])
        shift = (peer - rank) % n if name == "send" else (rank - peer) % n
        shape = torch_shape(t)
        key = (axis, shift, shape.dtype, shape.dims)
        other = "recv_" if name == "send" else "send"
        if self._unpaired[other][key]:
            self._unpaired[other][key] -= 1    # the other half of a transfer
            return
        self._unpaired[name][key] += 1
        ev = TraceEvent(primitive=name, axis_name=axis, arg_shapes=[shape],
                        axis_size=n)
        ev.nccl_name = "SendRecv"
        self.events.append(ev)
        self.ops.append(CollectiveOp(
            kind="collective-permute",
            name=f"{name}.{len(self.ops)}",
            result_shapes=[shape],
            replica_groups=[],
            source_target_pairs=[(g[i], g[(i + shift) % n])
                                 for g in groups for i in range(n)],
            op_name=f"{func.namespace}.{name}[{axis}]"))

    def _record_rooted(self, func, name, nccl, args, axis, groups) -> None:
        """``reduce_(tensors, ...)``, ``gather_(outputs, inputs, ...)``,
        ``scatter_(outputs, inputs, ...)``: a trace event of what one rank
        contributes (reduce, gather) or receives (scatter), and no op."""
        part = args[1] if name == "gather_" else args[0]
        ev = TraceEvent(primitive=name, axis_name=axis,
                        arg_shapes=[torch_shape(t) for t in _tensors(part)],
                        axis_size=len(groups[0]))
        ev.nccl_name = nccl
        self.events.append(ev)
        if name not in self._warned:
            self._warned.add(name)
            warnings.warn(
                f"{func.namespace}.{name} ({nccl}) is recorded as a trace "
                "event only: the schedule IR has no rooted collective, so "
                "it adds no op to the matrices or the modeled times",
                stacklevel=2)


def _concat_shape(parts: list[torch.Tensor]) -> Shape:
    """Shape of ``torch.cat(parts)`` without building it."""
    first = torch_shape(parts[0])
    return Shape(dtype=first.dtype,
                 dims=(sum(int(t.shape[0]) for t in parts),) + first.dims[1:])
