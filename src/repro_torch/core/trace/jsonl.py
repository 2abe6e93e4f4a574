"""Generic JSONL trace frontend: one JSON event object per line (port of
``repro.core.trace.jsonl``).

The house schema for tools that are neither Perfetto nor nvprof -- small
enough to emit from a shell one-liner, strict enough to catch malformed
records.  One object per line:

* **Header** (optional, first line)::

      {"trace": {"name": "run1", "num_devices": 8, "time_unit": "us",
                 "clock_align": "global"}}

* **Collective event** -- ``kind`` (any alias
  :func:`~.normalize.collective_kind` understands) plus ``bytes`` and
  ``dur`` are required::

      {"kind": "all-reduce", "name": "ar.3", "device": 0, "ts": 10.0,
       "dur": 250.0, "bytes": 4194304, "group": [0,1,2,3], "corr": 7,
       "phase": "fwd", "weight": 1}

  Rows sharing a ``corr`` id are one collective observed from several
  ranks: they merge into a single op whose measured duration is the
  *worst rank's* (max) and whose replica group defaults to the sorted
  participating devices.

* **Host transfer** -- ``kind`` of ``h2d`` / ``d2h`` with ``device`` and
  ``bytes``.

``ts``/``dur`` are in ``time_unit`` (default seconds).  Timestamps are
validated per device: negative times and overlapping events on one
device's stream raise :class:`~.base.TraceParseError` naming the line --
this frontend's schema defines a device's events as sequential.
"""
from __future__ import annotations

import json
from typing import Optional

from ..events import HostTransfer
from .base import TraceImport, TraceParseError, TraceSource
from .normalize import DeviceMap, align_clocks, collective_kind, measured_op

_TIME_UNITS = {"s": 1.0, "ms": 1e-3, "us": 1e-6, "ns": 1e-9}


def _num(rec: dict, key: str, line: int, path: str, *,
         required: bool = False, minimum: Optional[float] = None):
    if key not in rec or rec[key] is None:
        if required:
            raise TraceParseError(f"missing required field {key!r}",
                                  path=path, record=f"line {line}")
        return None
    v = rec[key]
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise TraceParseError(f"field {key!r} is not a number: {v!r}",
                              path=path, record=f"line {line}")
    if minimum is not None and v < minimum:
        raise TraceParseError(f"field {key!r} is negative: {v!r}",
                              path=path, record=f"line {line}")
    return float(v)


class JsonlSource(TraceSource):
    """The generic JSONL event schema (see module docstring)."""

    format = "jsonl"
    extensions = (".jsonl", ".ndjson")

    @classmethod
    def sniff(cls, path: str, head: str) -> bool:
        first = head.lstrip().splitlines()[0] if head.strip() else ""
        if not first.startswith("{"):
            return False
        try:
            rec = json.loads(first)
        except Exception:
            # a single-line object truncated by the head window still
            # counts; multi-line JSON documents (perfetto exports, saved
            # reports) have a newline inside the head and do not
            return "\n" not in head.strip("\n") and \
                "traceEvents" not in head
        return isinstance(rec, dict) and "traceEvents" not in rec

    @classmethod
    def parse(cls, path: str, *, num_devices: Optional[int] = None,
              device_map: Optional[dict] = None,
              name: Optional[str] = None, **_opts) -> TraceImport:
        with open(path) as f:
            lines = f.read().splitlines()

        header: dict = {}
        events: list[tuple[int, dict]] = []
        for i, line in enumerate(lines, start=1):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise TraceParseError(
                    f"truncated or invalid JSON ({e.msg})",
                    path=path, record=f"line {i}") from e
            if not isinstance(rec, dict):
                raise TraceParseError(
                    f"expected a JSON object, got {type(rec).__name__}",
                    path=path, record=f"line {i}")
            if "trace" in rec and not events and not header:
                header = dict(rec["trace"] or {})
                continue
            events.append((i, rec))

        unit = header.get("time_unit", "s")
        if unit not in _TIME_UNITS:
            raise TraceParseError(
                f"unknown time_unit {unit!r}; expected one of"
                f" {sorted(_TIME_UNITS)}", path=path, record="header")
        scale = _TIME_UNITS[unit]
        ndev = num_devices or header.get("num_devices")
        devmap = DeviceMap(ndev, device_map, path=path)

        transfers: list[HostTransfer] = []
        coll: list[dict] = []
        spans: dict[int, list[tuple[float, float, int]]] = {}
        for i, rec in events:
            kind_raw = rec.get("kind") or rec.get("name") or ""
            where = f"line {i}"
            if str(kind_raw).lower() in ("h2d", "d2h"):
                dev = devmap.resolve(rec.get("device", 0), record=where)
                nbytes = _num(rec, "bytes", i, path, required=True,
                              minimum=0)
                transfers.append(HostTransfer(
                    direction=str(kind_raw).lower(), device=dev,
                    nbytes=int(nbytes), label=str(rec.get("name", "")),
                    phase=str(rec.get("phase", ""))))
                continue
            kind = collective_kind(kind_raw)
            if kind is None:
                raise TraceParseError(
                    f"unknown collective kind {kind_raw!r}",
                    path=path, record=where)
            nbytes = _num(rec, "bytes", i, path, required=True, minimum=0)
            dur = _num(rec, "dur", i, path, required=True, minimum=0)
            ts = _num(rec, "ts", i, path, minimum=0)
            dev = None
            if rec.get("device") is not None:
                dev = devmap.resolve(rec["device"], record=where)
                if ts is not None:
                    spans.setdefault(dev, []).append(
                        (ts * scale, (ts + dur) * scale, i))
            coll.append({
                "line": i, "kind": kind, "bytes": nbytes,
                "dur": dur * scale, "ts": None if ts is None else ts * scale,
                "device": dev, "corr": rec.get("corr"),
                "name": str(rec.get("name", "")),
                "phase": str(rec.get("phase", "")),
                "weight": _num(rec, "weight", i, path, minimum=0) or 1.0,
                "group": rec.get("group"), "groups": rec.get("groups"),
                "pairs": rec.get("pairs"),
            })

        # per-device streams are sequential by schema: overlap is malformed
        for dev, sp in spans.items():
            sp.sort()
            for (s0, e0, l0), (s1, _e1, l1) in zip(sp, sp[1:]):
                if s1 < e0 - 1e-12:
                    raise TraceParseError(
                        f"overlapping events on device {dev}"
                        f" (lines {l0} and {l1})",
                        path=path, record=f"line {l1}")

        if ndev is None:
            ndev = _infer_devices(coll, devmap)
        devmap.num_devices = ndev

        ops = [_build_op(c, ndev) for c in _cluster(coll)]
        shifts = align_clocks(
            {d: [s for s, _e, _l in sp] for d, sp in spans.items()},
            header.get("clock_align", "global"))
        meta = {
            "source": "jsonl", "path": path,
            "time_unit": unit, "num_events": len(events),
            "clock_align": header.get("clock_align", "global"),
            "clock_shifts_s": {str(d): s for d, s in shifts.items()},
        }
        return TraceImport(
            name=name or header.get("name") or "jsonl-trace",
            num_devices=int(ndev), ops=ops, host_transfers=transfers,
            meta=meta)


def _infer_devices(coll: list[dict], devmap: DeviceMap) -> int:
    hi = max(devmap.seen, default=-1)
    for c in coll:
        for g in (c.get("groups") or
                  ([c["group"]] if c.get("group") else [])):
            hi = max(hi, max(g))
    return hi + 1 if hi >= 0 else 1


def _cluster(coll: list[dict]) -> list[dict]:
    """Merge per-rank observations of one collective (shared ``corr``)
    into one record carrying the worst rank's duration."""
    out: list[dict] = []
    by_corr: dict = {}
    for c in coll:
        if c["corr"] is None:
            out.append(c)
            continue
        key = (c["kind"], c["corr"])
        base = by_corr.get(key)
        if base is None:
            c = dict(c, devices={c["device"]} - {None})
            by_corr[key] = c
            out.append(c)
        else:
            base["dur"] = max(base["dur"], c["dur"])
            base["bytes"] = max(base["bytes"], c["bytes"])
            if c["device"] is not None:
                base["devices"].add(c["device"])
            base["name"] = base["name"] or c["name"]
            base["phase"] = base["phase"] or c["phase"]
    return out


def _build_op(c: dict, num_devices: int):
    if c.get("groups"):
        groups = [list(g) for g in c["groups"]]
    elif c.get("group"):
        groups = [list(c["group"])]
    elif c.get("devices"):
        groups = [sorted(c["devices"])]
    else:
        groups = [list(range(num_devices))]
    pairs = c.get("pairs")
    if c["kind"] == "collective-permute" and not pairs:
        g = groups[0]
        pairs = [(g[i], g[(i + 1) % len(g)]) for i in range(len(g))] \
            if len(g) > 1 else []
    return measured_op(
        c["kind"], payload_bytes=c["bytes"], groups=groups,
        name=c["name"] or f"{c['kind']}.l{c['line']}",
        measured_s=c["dur"] * max(1.0, c["weight"]),
        weight=c["weight"], phase=c["phase"], pairs=pairs)
