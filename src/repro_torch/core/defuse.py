"""Def-use record of a capture: the port's counterpart of the reference
lint's ``_ModuleIndex`` over compiled HLO text.

The reference's def-use lint rules (all-gather consumed only through
slices, the same collective twice on one value, f32 on the wire inside a
bf16 chain) walk the SSA graph of the compiled module.  A PyTorch capture
has no compiled module, but the
:class:`~repro_torch.core.interceptor.CollectiveInterceptor` sees every
aten op the program dispatches under ``FakeTensorMode``.  With
``defuse=True`` it keeps a :class:`DefUseRecorder`, which notes for each op
its name, the values it reads and the values it defines, with their dtypes
and bytes, and which :class:`~repro_torch.core.events.CollectiveOp` a
collective node recorded.  The result is one :class:`DefUseGraph` a capture.

A *value* is a tensor object at one write version of its storage: an
in-place op (``add_``, ``copy_``, an in-place ``c10d`` collective) reads
the value it overwrites and defines a new one, so the graph stays SSA as
the reference's HLO is, and a write through a view gives every alias of the
storage a new value.  Tensors are held for the recorder's life, so Python
never reuses an ``id`` inside one capture.

The walk looks through the ops that forward a value unchanged
(:data:`PASSTHROUGH_OPS`: ``wait_tensor``, reshaping views, same-dtype
copies -- the reference's ``get-tuple-element``/``copy``/``bitcast``/
``reshape``).  A dtype-changing copy (``_to_copy``, ``copy_``) is recorded
as the opcode ``convert``, as in HLO, and is never passed through.  Values
the captured function returns, or writes into its arguments, escape: their
consumers are unknown, as a ROOT value's are.  Values nobody reads (a
``split`` output dropped on the floor) are dead, as if XLA had removed
them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .events import TORCH_DTYPE_NAMES, DTYPE_BYTES

#: ops that forward their operand's value: the walk looks through them
PASSTHROUGH_OPS = frozenset({
    "wait_tensor", "view", "_unsafe_view", "reshape", "_reshape_alias",
    "alias", "detach", "squeeze", "unsqueeze", "flatten", "unflatten",
    "view_as", "reshape_as", "clone", "contiguous", "lift_fresh",
    "lift_fresh_copy", "_to_copy", "copy", "copy_",
})
#: ops that keep part of their operand (HLO ``slice``/``dynamic-slice``)
SLICE_OPS = frozenset({
    "slice", "select", "narrow", "split", "split_with_sizes", "chunk",
    "unsafe_split", "unsafe_split_with_sizes", "unsafe_chunk",
})
#: splits whose parts, all concatenated again by one ``cat``, are a layout
#: change: ``all_gather_tensor`` on a dim other than 0 gathers on dim 0 and
#: moves the blocks with split + cat, where XLA's all-gather takes the dim
_REGROUP_OPS = frozenset({"split", "split_with_sizes", "chunk",
                          "unsafe_split", "unsafe_chunk"})
#: copies that become ``convert`` when they change the dtype
_COPY_OPS = frozenset({"_to_copy", "copy", "copy_"})
CONVERT = "convert"


@dataclasses.dataclass
class Node:
    """One dispatched op: ``opcode`` is the aten overload packet's name
    (``convert`` for a dtype-changing copy); ``operands``/``results`` are
    value names, ``dtypes``/``nbytes`` those of the results; ``collective``
    names the :class:`~repro_torch.core.events.CollectiveOp` the node
    recorded, if any."""

    name: str
    opcode: str
    operands: list[str]
    results: list[str]
    dtypes: list[str]
    nbytes: list[int]
    collective: str = ""


class DefUseGraph:
    """Def-use tables of one capture (see the module docstring)."""

    def __init__(self, nodes: list[Node], outputs: set[str]):
        self.nodes = {n.name: n for n in nodes}
        self.outputs = set(outputs)
        self.producer: dict[str, str] = {}
        self.users: dict[str, list[str]] = {}
        for n in nodes:
            for v in n.results:
                self.producer[v] = n.name
            for v in n.operands:
                self.users.setdefault(v, []).append(n.name)
        self.collective_nodes = [n for n in nodes if n.collective]
        self.ops_by_name: dict = {}

    def bind_ops(self, ops) -> None:
        """The capture's final ops (after any ``op_transform``), found by
        the name each collective node carries."""
        self.ops_by_name = {op.name: op for op in ops}

    def producer_of(self, value: str) -> Optional[Node]:
        name = self.producer.get(value)
        return None if name is None else self.nodes[name]

    def result_dtype(self, node: str) -> Optional[str]:
        """dtype of ``node``'s first result, None when it has none."""
        n = self.nodes.get(node)
        return n.dtypes[0] if n is not None and n.dtypes else None

    def value_dtype(self, value: str) -> Optional[str]:
        n = self.producer_of(value)
        if n is None:
            return None
        return n.dtypes[n.results.index(value)]

    def result_bytes(self, node: str) -> int:
        """Bytes of ``node``'s live results: those read by another node or
        escaping the capture (a ``split``'s dropped parts count nothing)."""
        n = self.nodes.get(node)
        if n is None:
            return 0
        return sum(b for v, b in zip(n.results, n.nbytes)
                   if v in self.users or v in self.outputs)

    def effective_users(self, node: str) -> Optional[list[tuple[str, str]]]:
        """Terminal ``(node, opcode)`` consumers of ``node``'s results,
        looking through :data:`PASSTHROUGH_OPS` (a dtype-changing copy is a
        ``convert``, a consumer) and through a split whose parts one ``cat``
        joins again.  ``None`` when a value escapes the capture
        or nothing reads the results at all -- the conservative answer for
        rules that need the full consumer set, as the reference returns for
        a ROOT value."""
        out: list[tuple[str, str]] = []
        frontier = list(self.nodes[node].results)
        seen = {node}
        while frontier:
            v = frontier.pop()
            if v in self.outputs:
                return None            # escapes: consumers unknowable
            for u in self.users.get(v, ()):
                if u in seen:
                    continue
                seen.add(u)
                d = self.nodes[u]
                if d.opcode in PASSTHROUGH_OPS:
                    frontier.extend(d.results)
                elif (cat := self._regrouped_by(d)) is not None:
                    seen.add(cat.name)
                    frontier.extend(cat.results)
                else:
                    out.append((u, d.opcode))
        return out or None

    def _regrouped_by(self, node: Node) -> Optional[Node]:
        """The ``cat`` that joins every part of the split ``node`` again
        and reads nothing else, if there is one."""
        if node.opcode not in _REGROUP_OPS or not node.results:
            return None
        users = {u for v in node.results for u in self.users.get(v, [None])}
        if len(users) != 1 or None in users:
            return None
        cat = self.nodes[users.pop()]
        if cat.opcode != "cat" or sorted(cat.operands) != sorted(node.results):
            return None
        return cat


def _tensors(x) -> list[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for item in x for t in _tensors(item)]
    if isinstance(x, dict):
        return [t for item in x.values() for t in _tensors(item)]
    return []


def local_tensors(x) -> list[torch.Tensor]:
    """The plain tensors behind ``x`` (any pytree): a DTensor's local
    shard, an ``AsyncCollectiveTensor``'s result."""
    from torch.distributed._functional_collectives import \
        AsyncCollectiveTensor
    from torch.distributed.tensor import DTensor

    out = []
    for t in _tensors(x):
        while isinstance(t, (DTensor, AsyncCollectiveTensor)):
            t = t._local_tensor if isinstance(t, DTensor) else t.elem
        out.append(t)
    return out


def _dtype_name(t: torch.Tensor) -> str:
    return TORCH_DTYPE_NAMES.get(t.dtype, str(t.dtype))


class DefUseRecorder:
    """Accumulates the :class:`Node`s of one capture, in dispatch order."""

    def __init__(self):
        self.nodes: list[Node] = []
        self._keep: list[torch.Tensor] = []      # no id reuse in a capture
        self._num: dict[int, int] = {}           # id(tensor) -> number
        self._version: dict[int, int] = {}       # storage -> write version
        self._inputs: dict[int, tuple[torch.Tensor, str]] = {}

    def _storage(self, t: torch.Tensor) -> int:
        try:
            return t.untyped_storage()._cdata
        except (RuntimeError, NotImplementedError):
            return id(t)               # no storage (a nested subclass)

    def value(self, t: torch.Tensor) -> str:
        key = id(t)
        if key not in self._num:
            self._num[key] = len(self._num)
            self._keep.append(t)
        return f"v{self._num[key]}.{self._version.get(self._storage(t), 0)}"

    def _write(self, t: torch.Tensor) -> None:
        s = self._storage(t)
        self._version[s] = self._version.get(s, 0) + 1

    def note_inputs(self, args) -> None:
        """The captured function's tensor arguments: their final values
        escape when the function wrote them."""
        for t in local_tensors(args):
            self._inputs[id(t)] = (t, self.value(t))

    def record(self, func, args, kwargs, out, collective: str = "") -> None:
        if func.namespace == "prim":
            return                     # metadata queries (prim::device)
        name = func._overloadpacket.__name__
        arg_ts = _tensors(list(args)) + _tensors(dict(kwargs or {}))
        operands = [self.value(t) for t in arg_ts]
        if func.namespace == "c10d":
            # in-place collectives write their first argument (the tensors,
            # or the output buffers); a send only reads
            written = [] if name == "send" else _tensors(args[0])
        else:
            written = [t for a, x in zip(func._schema.arguments, args)
                       if a.alias_info is not None and a.alias_info.is_write
                       for t in _tensors(x)]
            written += [t for k, x in (kwargs or {}).items()
                        if k == "out" for t in _tensors(x)]
        for t in written:
            self._write(t)
        res_ts = list(written)
        res_ts += [t for t in _tensors(out)
                   if not any(t is w for w in written)]
        results, dtypes, nbytes = [], [], []
        for t in res_ts:
            v = self.value(t)
            if v in operands or v in results:
                continue           # returns its operand: no new definition
            results.append(v)
            dtypes.append(_dtype_name(t))
            nbytes.append(t.numel() * DTYPE_BYTES.get(dtypes[-1], 4))
        opcode = name
        if name in _COPY_OPS and results and arg_ts:
            # copy(self, src) / copy_(self, src) take the values of src
            src = arg_ts[1] if name != "_to_copy" and len(arg_ts) > 1 \
                else arg_ts[0]
            if _dtype_name(src) != dtypes[0]:
                opcode = CONVERT
        if name in ("copy", "copy_"):
            operands = operands[1:2]   # the destination's values are not read
        self.nodes.append(Node(f"{name}.{len(self.nodes)}", opcode, operands,
                               results, dtypes, nbytes, collective))

    def graph(self, returned=None) -> DefUseGraph:
        """The finished graph; ``returned`` is what the function returned."""
        outputs = {self.value(t) for t in local_tensors(returned)}
        for t, first in self._inputs.values():
            now = self.value(t)
            if now != first:
                outputs.add(now)       # written into an argument: escapes
        return DefUseGraph(self.nodes, outputs)
