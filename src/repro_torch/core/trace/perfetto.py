"""Perfetto / Chrome trace-event JSON frontend (port of
``repro.core.trace.perfetto``).  ``torch.profiler``'s Chrome traces have a
frontend of their own (:mod:`.torch_profiler`), sniffed first.

Two dialects of one format:

* **Our own exports** (:mod:`repro_torch.core.export.perfetto`).  Each process
  carries a ``repro_report`` metadata event (devices, algorithm,
  topology, phases, host transfers) and every collective event embeds
  its full serialized op (``args.repro_op``), so the import rebuilds the
  originating report *exactly* -- the comm matrix round-trips bitwise.
  The event's rendered duration becomes ``measured_s`` when the op
  carries none of its own.

* **Generic profiler traces** (the jax profiler's trace-viewer JSON and
  friends): ``X`` duration events whose names alias a collective kind,
  one process or thread lane per device.  Events are normalized through
  :mod:`.normalize` -- device ids parsed from process labels
  (``/device:TPU:3``), per-device observations of one collective
  clustered by name occurrence (measured duration = worst rank), byte
  counts read from ``args`` (``payload_bytes`` / ``bytes`` / ``size``).
  A collective event with no byte annotation raises
  :class:`~.base.TraceParseError` -- bytes cannot be invented, and a
  silent skip would fake a zero-row matrix.

Timestamps/durations follow the Chrome convention (microseconds).
"""
from __future__ import annotations

import json
from typing import Optional

from ..export import serialize
from ..export.perfetto import REPORT_META_EVENT
from .base import TraceImport, TraceParseError, TraceSource
from .normalize import DeviceMap, collective_kind, measured_op

_BYTE_KEYS = ("payload_bytes", "bytes", "size", "bytes_accessed",
              "tensor_bytes")

# cats our own exporter writes for non-collective lanes
_SKIP_CATS = ("tier", "phase")


class PerfettoSource(TraceSource):
    """Chrome trace-event JSON (Perfetto UI, jax profiler, our exports)."""

    format = "perfetto"
    extensions = (".json",)

    @classmethod
    def sniff(cls, path: str, head: str) -> bool:
        s = head.lstrip()
        return "traceEvents" in head or s.startswith("[")

    @classmethod
    def parse(cls, path: str, *, num_devices: Optional[int] = None,
              device_map: Optional[dict] = None,
              name: Optional[str] = None, pid: Optional[int] = None,
              **_opts) -> TraceImport:
        with open(path) as f:
            try:
                doc = json.load(f)
            except json.JSONDecodeError as e:
                raise TraceParseError(
                    f"truncated or invalid JSON ({e.msg}, line {e.lineno})",
                    path=path) from e
        if isinstance(doc, dict):
            events = doc.get("traceEvents")
            if not isinstance(events, list):
                raise TraceParseError(
                    "no traceEvents array in trace document", path=path)
        elif isinstance(doc, list):
            events = doc
        else:
            raise TraceParseError(
                f"expected a trace object or event array,"
                f" got {type(doc).__name__}", path=path)

        # partition by process; our exports hold one report per pid
        pids = []
        for e in events:
            p = e.get("pid", 0) if isinstance(e, dict) else 0
            if p not in pids:
                pids.append(p)
        use_pid = pid if pid is not None else (pids[0] if pids else 0)
        if pid is not None and pid not in pids:
            raise TraceParseError(
                f"pid {pid} not in trace (processes: {pids})", path=path)
        evs = [e for e in events
               if isinstance(e, dict) and e.get("pid", 0) == use_pid]

        meta_ev = next((e for e in evs if e.get("ph") == "M"
                        and e.get("name") == REPORT_META_EVENT), None)
        if meta_ev is not None:
            imp = _parse_own_export(evs, meta_ev, path)
        else:
            imp = _parse_generic(evs, path, num_devices=num_devices,
                                 device_map=device_map)
        imp.meta.update({"source": "perfetto", "path": path,
                         "pid": use_pid, "num_processes": len(pids)})
        if name:
            imp.name = name
        return imp


def _parse_own_export(evs: list, meta_ev: dict, path: str) -> TraceImport:
    """Exact re-import of our own exporter's output (bitwise matrix)."""
    meta = meta_ev.get("args") or {}
    ops = []
    for e in evs:
        if e.get("ph") != "X" or e.get("cat") in _SKIP_CATS:
            continue
        args = e.get("args") or {}
        if "repro_op" not in args:
            continue
        try:
            op = serialize.op_from_dict(args["repro_op"])
        except (KeyError, TypeError, ValueError) as exc:
            raise TraceParseError(
                f"bad repro_op record ({exc})", path=path,
                record=f"event {e.get('name')!r}") from exc
        if op.measured_s is None and e.get("dur") is not None:
            op.measured_s = float(e["dur"]) * 1e-6
        ops.append(op)
    try:
        topo = serialize.topo_from_dict(meta.get("topo"))
        phases = [serialize.phase_from_dict(p)
                  for p in meta.get("phases", [])]
        transfers = [serialize.transfer_from_dict(t)
                     for t in meta.get("host_transfers", [])]
    except (KeyError, TypeError, ValueError) as exc:
        raise TraceParseError(
            f"bad {REPORT_META_EVENT} metadata ({exc})", path=path,
            record=REPORT_META_EVENT) from exc
    return TraceImport(
        name=str(meta.get("name", "perfetto-trace")),
        num_devices=int(meta.get("num_devices", 1)),
        ops=ops, host_transfers=transfers, topo=topo,
        algorithm=str(meta.get("algorithm", "ring")),
        phases=phases, sparse=bool(meta.get("sparse")) or None,
        meta={"exact_reimport": True})


def _device_of_label(label: str) -> Optional[int]:
    """Device id from a process/thread label when it names one
    (``/device:TPU:3``, ``GPU 2 stream``, ``Tesla ... (5)``); None for
    non-device lanes (``python``, ``Steps``)."""
    import re

    for pat in (r"/?device:[a-z_]+:(\d+)", r"\bgpu[ :]?(\d+)\b",
                r"\btpu[ :]?(\d+)\b", r"\((\d+)\)\s*$"):
        m = re.search(pat, label, re.I)
        if m:
            return int(m.group(1))
    return None


def _parse_generic(evs: list, path: str, *,
                   num_devices: Optional[int],
                   device_map: Optional[dict]) -> TraceImport:
    proc_label: dict = {}
    for e in evs:
        if e.get("ph") == "M" and e.get("name") in ("process_name",
                                                    "thread_name"):
            label = (e.get("args") or {}).get("name", "")
            proc_label[(e.get("pid", 0), e.get("tid", 0),
                        e.get("name"))] = label

    devmap = DeviceMap(num_devices, device_map, path=path)
    clusters: dict = {}
    order: list = []
    occ: dict = {}
    trace_name = "perfetto-trace"
    for i, e in enumerate(evs):
        if e.get("ph") != "X" or e.get("cat") in _SKIP_CATS:
            continue
        kind = collective_kind(e.get("name", ""))
        if kind is None:
            continue
        where = f"event {i} ({e.get('name')!r})"
        args = e.get("args") or {}
        ts, dur = e.get("ts", 0), e.get("dur", 0)
        if (isinstance(ts, (int, float)) and ts < 0) or \
                (isinstance(dur, (int, float)) and dur < 0):
            raise TraceParseError(
                f"negative timestamp/duration (ts={ts}, dur={dur})",
                path=path, record=where)
        nbytes = next((args[k] for k in _BYTE_KEYS
                       if isinstance(args.get(k), (int, float))), None)
        if nbytes is None or nbytes < 0:
            raise TraceParseError(
                "collective event carries no byte annotation"
                f" (looked for {list(_BYTE_KEYS)} in args)",
                path=path, record=where)
        dev = None
        if args.get("device") is not None:
            dev = devmap.resolve(args["device"], record=where)
        else:
            for mkey in ((e.get("pid", 0), e.get("tid", 0),
                          "thread_name"),
                         (e.get("pid", 0), 0, "process_name")):
                d = _device_of_label(proc_label.get(mkey, ""))
                if d is not None:
                    dev = devmap.resolve(d, record=where)
                    break
        group = args.get("group") or args.get("replica_group")
        groups = args.get("replica_groups") or \
            ([group] if group else None)
        ename = str(e.get("name", kind))
        k = occ.get((ename, dev), 0)
        occ[(ename, dev)] = k + 1
        key = (ename, k)
        c = clusters.get(key)
        if c is None:
            c = {"kind": kind, "name": ename, "dur": float(dur) * 1e-6,
                 "bytes": float(nbytes), "devices": set(),
                 "groups": groups,
                 "phase": str(args.get("phase", ""))}
            clusters[key] = c
            order.append(key)
        else:
            c["dur"] = max(c["dur"], float(dur) * 1e-6)
            c["bytes"] = max(c["bytes"], float(nbytes))
            c["groups"] = c["groups"] or groups
        if dev is not None:
            c["devices"].add(dev)

    ndev = num_devices
    if ndev is None:
        hi = max(devmap.seen, default=-1)
        for c in clusters.values():
            for g in c["groups"] or []:
                hi = max(hi, max(g))
        ndev = hi + 1 if hi >= 0 else 1
    devmap.num_devices = ndev

    ops = []
    for key in order:
        c = clusters[key]
        if c["groups"]:
            groups = [list(g) for g in c["groups"]]
        elif len(c["devices"]) > 1:
            groups = [sorted(c["devices"])]
        else:
            groups = [list(range(ndev))]
        pairs = None
        if c["kind"] == "collective-permute":
            g = groups[0]
            pairs = [(g[j], g[(j + 1) % len(g)])
                     for j in range(len(g))] if len(g) > 1 else []
        ops.append(measured_op(
            c["kind"], payload_bytes=c["bytes"], groups=groups,
            name=c["name"], measured_s=c["dur"], phase=c["phase"],
            pairs=pairs))
    label = proc_label.get((evs[0].get("pid", 0), 0, "process_name"),
                           "") if evs else ""
    return TraceImport(name=label or trace_name, num_devices=int(ndev),
                       ops=ops, meta={"exact_reimport": False})
