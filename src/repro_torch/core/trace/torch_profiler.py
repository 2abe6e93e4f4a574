"""``torch.profiler`` Chrome-trace frontend: the port's counterpart of the
jax-profiler branch of the Perfetto parser.

Reads what ``torch.profiler.profile(...).export_chrome_trace(path)`` writes
(Kineto's JSON: ``schemaVersion``, ``deviceProperties``, optional
``distributedInfo``, then ``traceEvents``), recorded with
``record_shapes=True``.  One collective shows up as several nested host
events on the thread that issued it: the functional op
(``_c10d_functional::all_reduce``), the in-place ``c10d`` op it calls
(``c10d::allreduce_``), NCCL's ``record_param_comms`` (dtype, element
counts, group size and ranks) and the backend's annotation
(``nccl:all_reduce``, ``gloo:all_reduce``).  Each outermost collective
event and everything nested in it on that thread become one
:class:`~repro_torch.core.events.CollectiveOp`:

* **kind**: the outermost event's name, through the interceptor's tables of
  ``c10d`` and functional ops (rooted ``reduce``/``gather``/``scatter``
  have no IR kind and are skipped, as the interceptor skips them);
* **payload**: ``record_param_comms``'s element counts and dtype where
  NCCL recorded them, else the recorded ``Input Dims`` of the outermost
  op's payload argument, its dtype from the first event of the cluster
  that names one (a ``TensorList`` argument names none);
* **measured seconds**, from the first source that exists: the NCCL device
  kernels (``ncclDevKernel_*``/``ncclKernel_*``) linked to the cluster by
  ``External id`` or by the ``correlation`` of a runtime call inside it
  (``nccl_kernel``); the backend annotation's span on the device timeline
  (``gpu_annotation``); the backend annotation's host span
  (``cpu_annotation``); the outermost op's host span (``cpu_op``).
  ``meta["timing"]`` counts the ops each source timed.

Backend annotations that are not nested in an op (gloo runs its work on a
thread of its own) stand for a collective only in a trace that has no
``c10d`` op at all; otherwise one lends its dtype to the first op of its
kind issued before it that records none.  A collective whose size cannot
be read raises :class:`~.base.TraceParseError` naming the event: bytes are
never invented, and a zero-byte op is never made.
"""
from __future__ import annotations

import json
import math
from typing import Optional

from ..events import DTYPE_BYTES
from ..interceptor import _C10D, _FUNCTIONAL
from .base import TraceImport, TraceParseError, TraceSource
from .normalize import collective_kind, measured_op

# ``Input type`` strings (c10 scalar type names) and ``record_param_comms``
# dtypes -> HLO dtype names
_TYPE_NAMES = {
    "float": "f32", "double": "f64", "c10::Half": "f16",
    "c10::BFloat16": "bf16", "int": "s32", "long int": "s64",
    "short int": "s16", "signed char": "s8", "unsigned char": "u8",
    "bool": "pred", "c10::complex<float>": "c64",
    "c10::complex<double>": "c128", "c10::Float8_e4m3fn": "f8e4m3fn",
    "c10::Float8_e5m2": "f8e5m2",
    "Float": "f32", "Double": "f64", "Half": "f16", "BFloat16": "bf16",
    "Int": "s32", "Long": "s64", "Short": "s16", "Char": "s8",
    "Byte": "u8", "Bool": "pred", "ComplexFloat": "c64",
    "ComplexDouble": "c128", "Float8_e4m3fn": "f8e4m3fn",
    "Float8_e5m2": "f8e5m2",
}
# the argument holding the payload, and whether the payload is that
# argument times the group size (the functional all-gather's input is the
# local shard; an all-to-all's S is the exchanged set, local bytes x n)
_PAYLOAD_ARG = {
    "all_gather_into_tensor": (0, True),
    "all_gather_into_tensor_out": (0, True),
    "all_gather_into_tensor_coalesced": (0, True),
    "all_to_all_single": (0, True),
    "reduce_scatter_": (1, False),
    "_reduce_scatter_base_": (1, False),
    "reduce_scatter_tensor_coalesced_": (1, False),
    "alltoall_": (1, True),        # (outputs, inputs, ...)
    "alltoall_base_": (1, True),
}
# the functional ops' ``group_size`` argument
_GROUP_SIZE_ARG = {"all_gather_into_tensor": 1,
                   "all_gather_into_tensor_out": 1,
                   "all_gather_into_tensor_coalesced": 1,
                   "reduce_scatter_tensor": 2,
                   "reduce_scatter_tensor_out": 2,
                   "reduce_scatter_tensor_coalesced": 2}
_BACKENDS = ("nccl:", "gloo:")
_PARAM_COMMS = "record_param_comms"


def _base(name: str) -> str:
    """``_c10d_functional::all_reduce`` / ``nccl:all_reduce`` ->
    ``all_reduce``."""
    return name.split("::")[-1].split(":")[-1]


def _kind(name: str):
    """(is a collective, HLO kind or None for a rooted one)."""
    base = _base(name)
    if name.startswith(("c10d::", "_c10d_functional::")):
        table = _C10D if name.startswith("c10d::") else _FUNCTIONAL
        if base in table:
            return True, table[base][0]
        return False, None
    if name.startswith(_BACKENDS):
        if base in ("send", "recv", "recv_anysource"):
            return True, "collective-permute"
        if base in ("reduce", "gather", "scatter"):
            return True, None
        kind = collective_kind(base)
        return kind is not None, kind
    return False, None


def _is_nccl_kernel(name: str) -> bool:
    return name.startswith(("ncclDevKernel", "ncclKernel"))


def _numel(dims) -> int:
    """Elements of a recorded ``Input Dims`` entry: one shape, or a list
    of shapes (a ``TensorList``), nested as recorded."""
    if not isinstance(dims, list):
        return 0
    if all(isinstance(d, int) for d in dims):
        return math.prod(dims)
    return sum(_numel(d) for d in dims)


def _dtype(type_name) -> Optional[str]:
    return _TYPE_NAMES.get(type_name) if isinstance(type_name, str) else None


class TorchProfilerSource(TraceSource):
    """``torch.profiler``'s Chrome trace (see module docstring)."""

    format = "torch"
    extensions = ()

    @classmethod
    def sniff(cls, path: str, head: str) -> bool:
        return '"schemaVersion"' in head and '"deviceProperties"' in head

    @classmethod
    def parse(cls, path: str, *, num_devices: Optional[int] = None,
              name: Optional[str] = None, **_opts) -> TraceImport:
        with open(path) as f:
            try:
                doc = json.load(f)
            except json.JSONDecodeError as e:
                raise TraceParseError(
                    f"truncated or invalid JSON ({e.msg}, line {e.lineno})",
                    path=path) from e
        events = doc.get("traceEvents") if isinstance(doc, dict) else None
        if not isinstance(events, list):
            raise TraceParseError("no traceEvents array in trace document",
                                  path=path)
        dist = doc.get("distributedInfo") or {}
        world = dist.get("world_size")
        ndev = num_devices or (int(world) if world else None)

        colls, kernels, gpu_notes, runtime = [], [], [], []
        for i, e in enumerate(events):
            if not isinstance(e, dict) or e.get("ph") != "X":
                continue
            ename, cat = str(e.get("name", "")), e.get("cat")
            if cat in ("cpu_op", "user_annotation"):
                is_coll, _ = _kind(ename)
                if is_coll or ename == _PARAM_COMMS:
                    colls.append((i, e))
            elif cat == "kernel" and _is_nccl_kernel(ename):
                kernels.append(e)
            elif cat == "gpu_user_annotation" and ename.startswith(_BACKENDS):
                gpu_notes.append(e)
            elif cat in ("cuda_runtime", "cuda_driver"):
                runtime.append(e)

        clusters = _clusters(colls, path)
        has_ops = any(not c[0][1]["name"].startswith(_BACKENDS)
                      for c in clusters)
        # annotations of a backend thread (gloo's), when ops stand for the
        # collectives: their dtype is lent to an op that records none
        spare = [c[0] for c in clusters
                 if has_ops and c[0][1]["name"].startswith(_BACKENDS)]
        n_spare = len(spare)
        ops, timing = [], {}
        rooted = lent = 0
        for members in clusters:
            i0, outer = members[0]
            oname = outer["name"]
            if has_ops and oname.startswith(_BACKENDS):
                continue
            _, kind = _kind(oname)
            if kind is None:
                rooted += 1
                continue
            where = f"event {i0} ({oname!r})"
            payload, groups, borrowed = _payload(kind, members, ndev, spare,
                                                 where, path)
            lent += borrowed
            secs, source = _measured(members, kernels, gpu_notes, runtime,
                                     outer)
            timing[source] = timing.get(source, 0) + 1
            pairs = None
            if kind == "collective-permute":
                g = groups[0]          # the trace names no peer: a ring
                pairs = [(g[j], g[(j + 1) % len(g)])
                         for j in range(len(g))] if len(g) > 1 else []
            ops.append(measured_op(
                kind, payload_bytes=payload, groups=groups,
                name=f"{oname}#{len(ops)}", measured_s=secs, op_name=oname,
                pairs=pairs))
        if not ops:
            raise TraceParseError(
                "no collective in trace (no c10d / _c10d_functional op and "
                "no nccl: / gloo: annotation); was it recorded with "
                "record_shapes=True around a collective?", path=path)
        if ndev is None:
            ndev = 1 + max(d for op in ops for g in op.replica_groups
                           for d in g)
        for op in ops:
            for g in op.replica_groups:
                bad = [d for d in g if not 0 <= d < ndev]
                if bad:
                    raise TraceParseError(
                        f"group ranks {bad} out of range for {ndev} "
                        "devices", path=path, record=op.name)
        return TraceImport(
            name=name or str(doc.get("traceName") or "torch-trace"),
            num_devices=int(ndev), ops=ops,
            meta={"source": "torch", "path": path,
                  "backend": dist.get("backend"), "rank": dist.get("rank"),
                  "world_size": world, "num_events": len(events),
                  "timing": timing, "backend_thread_annotations": n_spare,
                  "dtype_from_backend_thread": lent,
                  "rooted_skipped": rooted, "exact_reimport": False})


def _clusters(colls: list, path: str) -> list[list]:
    """Group the collective host events into one list a collective: each
    outermost event with everything nested in its span on its thread."""
    for i, e in colls:
        ts, dur = e.get("ts"), e.get("dur", 0)
        if not isinstance(ts, (int, float)) or \
                not isinstance(dur, (int, float)) or dur < 0:
            raise TraceParseError(f"bad ts/dur (ts={ts!r}, dur={dur!r})",
                                  path=path,
                                  record=f"event {i} ({e.get('name')!r})")
    out: list[list] = []
    open_: dict = {}          # (pid, tid) -> (end, cluster)
    for i, e in sorted(colls, key=lambda c: (
            str(c[1].get("pid")), str(c[1].get("tid")), c[1]["ts"],
            -c[1].get("dur", 0))):
        ts, dur = e["ts"], e.get("dur", 0)
        thread = (e.get("pid"), e.get("tid"))
        cur = open_.get(thread)
        if cur is not None and ts + dur <= cur[0]:
            cur[1].append((i, e))
            continue
        if e["name"] == _PARAM_COMMS:
            continue                   # a wait's, or outside any collective
        cluster = [(i, e)]
        out.append(cluster)
        open_[thread] = (ts + dur, cluster)
    out.sort(key=lambda c: float(c[0][1]["ts"]))
    return out


def _payload(kind: str, members: list, ndev: Optional[int], spare: list,
             where: str, path: str):
    """(payload bytes, replica groups, 1 if the dtype came from a backend
    thread's annotation else 0) of one cluster.  ``spare`` holds the
    backend thread's annotations not yet lent: the first of the same kind
    that starts after the op lends its dtype to an op that records none
    (gloo's ``c10d::allreduce_`` takes a ``TensorList``)."""
    outer = members[0][1]
    args = outer.get("args") or {}
    comms = next((e.get("args") or {} for _i, e in members
                  if e["name"] == _PARAM_COMMS
                  and (e.get("args") or {}).get("Collective name")
                  != "wait"), None)
    ranks = None
    if comms is not None and isinstance(
            comms.get("Process Group Ranks"), str):
        try:
            ranks = [int(r) for r in json.loads(comms["Process Group Ranks"])]
        except (ValueError, TypeError):
            ranks = None
    n = None
    if comms is not None and isinstance(comms.get("Group size"), int):
        n = comms["Group size"]
    base = _base(outer["name"])
    if n is None and base in _GROUP_SIZE_ARG:
        try:
            n = int(args.get("Concrete Inputs", [])[_GROUP_SIZE_ARG[base]])
        except (IndexError, ValueError, TypeError):
            n = None
    if n is None:
        n = len(ranks) if ranks else (ndev or 1)
    groups = [ranks] if ranks and len(ranks) == n else [list(range(n))]

    arg, times_n = _PAYLOAD_ARG.get(base, (0, False))
    if comms is not None and _dtype(comms.get("dtype")) is not None:
        nelems = (comms.get("In msg nelems") if kind in (
            "reduce-scatter", "all-to-all") else comms.get("Out msg nelems"))
        if isinstance(nelems, int) and nelems > 0:
            size = nelems * DTYPE_BYTES[_dtype(comms["dtype"])]
            return (size * n if kind == "all-to-all" else size), groups, 0
    dims = args.get("Input Dims")
    numel = _numel(dims[arg]) if isinstance(dims, list) and \
        len(dims) > arg else 0
    types = args.get("Input type") or []
    dtype = _dtype(types[arg]) if len(types) > arg else None
    if dtype is None:
        for _i, e in members:
            t = (e.get("args") or {}).get("Input type") or []
            dtype = _dtype(t[0]) if t else None
            if dtype is not None:
                break
    borrowed = 0
    if dtype is None:
        for j, (_i, note) in enumerate(spare):
            t = (note.get("args") or {}).get("Input type") or []
            if _kind(note["name"])[1] == kind and t and _dtype(t[0]) \
                    and float(note["ts"]) >= float(outer["ts"]):
                dtype, borrowed = _dtype(t[0]), 1
                del spare[j]
                break
    if numel <= 0 or dtype is None:
        raise TraceParseError(
            f"{kind} has no size: no record_param_comms counts, and its "
            f"recorded inputs give {numel} elements of dtype {dtype} "
            "(profile with record_shapes=True)", path=path, record=where)
    size = numel * DTYPE_BYTES[dtype]
    return (size * n if times_n else size), groups, borrowed


def _measured(members: list, kernels: list, gpu_notes: list, runtime: list,
              outer: dict) -> tuple[float, str]:
    """(measured seconds, timing source) of one cluster."""
    ext = {(e.get("args") or {}).get("External id") for _i, e in members}
    ext.discard(None)
    t0 = float(outer["ts"])
    t1 = t0 + float(outer.get("dur", 0))
    thread = (outer.get("pid"), outer.get("tid"))
    corr = {(r.get("args") or {}).get("correlation") for r in runtime
            if (r.get("pid"), r.get("tid")) == thread
            and t0 <= float(r.get("ts", 0)) <= t1}
    corr.discard(None)
    linked = [k for k in kernels
              if (k.get("args") or {}).get("External id") in ext
              or (k.get("args") or {}).get("correlation") in corr]
    if linked:
        return sum(float(k.get("dur", 0)) for k in linked) * 1e-6, \
            "nccl_kernel"
    notes = [g for g in gpu_notes
             if (g.get("args") or {}).get("External id") in ext]
    if notes:
        return sum(float(g.get("dur", 0)) for g in notes) * 1e-6, \
            "gpu_annotation"
    backend = next((e for _i, e in members
                    if e["name"].startswith(_BACKENDS)), None)
    if backend is not None:
        return float(backend.get("dur", 0)) * 1e-6, "cpu_annotation"
    return float(outer.get("dur", 0)) * 1e-6, "cpu_op"
