"""ComScribe-style nvprof GPU-trace CSV frontend (port of
``repro.core.trace.nvprof``).

Parses the ``nvprof --print-gpu-trace --csv`` shape the paper's tool
consumes: ``==``-prefixed banner lines, a quoted header row, an optional
units row (``ms`` / ``us`` / ``MB`` / ``B`` ...), then one row per kernel
or memcpy.  The rows that matter here:

* ``[CUDA memcpy HtoD]`` / ``[CUDA memcpy DtoH]`` -> host transfers
  (the comm matrix's row/col 0).
* ``[CUDA memcpy PtoP]`` -> device-to-device copies; rows sharing a
  correlation id merge into one ``collective-permute`` carrying all the
  observed (src, dst) pairs.
* ``nccl*Kernel`` rows (``ncclAllReduceRingLLKernel_sum_f32(...)``) ->
  collectives.  NCCL launches one kernel per participating device, so
  rows are clustered into one logical collective by ``(kind,
  correlation id)`` when the file has a correlation column, else by
  ``(kind, per-device occurrence index)``; the measured duration is the
  **worst rank's** (max over the cluster) and the payload is the
  cluster's max ``Size``.

A CSV without a byte column (``Size``/``Bytes``) cannot produce a comm
matrix and raises :class:`~.base.TraceParseError` up front, as do
negative durations and unmappable device labels -- never a silent
zero-row matrix.
"""
from __future__ import annotations

import csv
import io
from typing import Optional

from ..events import HostTransfer
from .base import TraceImport, TraceParseError, TraceSource
from .normalize import DeviceMap, collective_kind, measured_op

_DUR_UNITS = {"s": 1.0, "ms": 1e-3, "us": 1e-6, "ns": 1e-9}
_SIZE_UNITS = {"b": 1.0, "kb": 1024.0, "mb": 1024.0 ** 2,
               "gb": 1024.0 ** 3}

# nvprof's own defaults when the units row is absent
_DEFAULT_DUR_UNIT = "ms"
_DEFAULT_SIZE_UNIT = "mb"


def _norm(h: str) -> str:
    return "".join(ch for ch in h.lower() if ch.isalnum())


_COLS = {
    "start": ("start",),
    "duration": ("duration", "dur"),
    "size": ("size", "bytes"),
    "device": ("device", "dev"),
    "srcdev": ("srcdev", "srcdevice", "sourcedevice"),
    "dstdev": ("dstdev", "dstdevice", "destinationdevice"),
    "name": ("name", "kernel"),
    "corr": ("correlationid", "correlation", "corrid"),
}


def _find_cols(header: list[str], path: str) -> dict:
    normed = [_norm(h) for h in header]
    cols = {}
    for key, aliases in _COLS.items():
        for a in aliases:
            if a in normed:
                cols[key] = normed.index(a)
                break
    if "name" not in cols or "duration" not in cols:
        raise TraceParseError(
            f"header row lacks Name/Duration columns (got {header!r})",
            path=path, record="header")
    return cols


def _cell(row: list[str], idx: Optional[int]) -> str:
    if idx is None or idx >= len(row):
        return ""
    return row[idx].strip()


def _float(s: str, what: str, where: str, path: str, *,
           minimum: Optional[float] = None) -> float:
    try:
        v = float(s)
    except ValueError:
        raise TraceParseError(f"bad {what} value {s!r}",
                              path=path, record=where) from None
    if minimum is not None and v < minimum:
        raise TraceParseError(f"negative {what}: {s!r}",
                              path=path, record=where)
    return v


class NvprofCsvSource(TraceSource):
    """The nvprof/ComScribe GPU-trace CSV format (see module docstring)."""

    format = "nvprof"
    extensions = (".csv",)

    @classmethod
    def sniff(cls, path: str, head: str) -> bool:
        for line in head.splitlines():
            if not line.strip() or line.startswith("=="):
                continue
            n = _norm(line)
            return "duration" in n and ("name" in n or "kernel" in n)
        return False

    @classmethod
    def parse(cls, path: str, *, num_devices: Optional[int] = None,
              device_map: Optional[dict] = None,
              name: Optional[str] = None, **_opts) -> TraceImport:
        with open(path) as f:
            text = f.read()
        data_lines = [ln for ln in text.splitlines()
                      if ln.strip() and not ln.startswith("==")]
        if not data_lines:
            raise TraceParseError("no CSV rows (banner only?)", path=path)
        rows = list(csv.reader(io.StringIO("\n".join(data_lines))))
        cols = _find_cols(rows[0], path)
        body = rows[1:]

        dur_scale = _DUR_UNITS[_DEFAULT_DUR_UNIT]
        size_scale = _SIZE_UNITS[_DEFAULT_SIZE_UNIT]
        if body and _is_units_row(body[0], cols):
            units = body.pop(0)
            du = _cell(units, cols["duration"]).lower()
            dur_scale = _DUR_UNITS.get(du, dur_scale)
            if "size" in cols:
                su = _cell(units, cols.get("size")).lower()
                size_scale = _SIZE_UNITS.get(su, size_scale)

        devmap = DeviceMap(num_devices, device_map, path=path)
        transfers: list[HostTransfer] = []
        clusters: dict = {}
        order: list = []
        occ: dict = {}   # (kind, device) -> occurrence count
        for rnum, row in enumerate(body, start=2):
            rname = _cell(row, cols["name"])
            where = f"row {rnum} ({rname or 'unnamed'})"
            if not rname:
                continue
            low = rname.lower()
            if "memcpy" in low:
                _parse_memcpy(low, row, cols, rnum, rname, devmap,
                              dur_scale, size_scale, path, transfers,
                              clusters, order, occ)
                continue
            kind = collective_kind(rname)
            if kind is None:
                continue           # compute kernel, memset, ... -- not comm
            if "size" not in cols:
                raise TraceParseError(
                    "collective rows but no byte column (Size/Bytes) in"
                    " the header -- cannot build a comm matrix",
                    path=path, record=where)
            dur = _float(_cell(row, cols["duration"]), "duration", where,
                         path, minimum=0) * dur_scale
            size = _float(_cell(row, cols["size"]), "size", where, path,
                          minimum=0) * size_scale
            dev = None
            if _cell(row, cols.get("device")):
                dev = devmap.resolve(_cell(row, cols["device"]),
                                     record=where)
            corr = _cell(row, cols.get("corr"))
            if corr:
                key = (kind, "corr", corr)
            else:
                k = occ.get((kind, dev), 0)
                occ[(kind, dev)] = k + 1
                key = (kind, "occ", k)
            c = clusters.get(key)
            if c is None:
                c = {"kind": kind, "name": rname.split("(")[0],
                     "dur": dur, "bytes": size, "devices": set(),
                     "pairs": [], "row": rnum}
                clusters[key] = c
                order.append(key)
            else:
                c["dur"] = max(c["dur"], dur)
                c["bytes"] = max(c["bytes"], size)
            if dev is not None:
                c["devices"].add(dev)

        ndev = num_devices
        if ndev is None:
            ndev = max(devmap.seen, default=0) + 1
        devmap.num_devices = ndev

        ops = []
        for key in order:
            c = clusters[key]
            devs = sorted(c["devices"])
            # a single-process profile often sees one device; the logical
            # group is then the whole job
            group = devs if len(devs) > 1 else list(range(ndev))
            pairs = c["pairs"] or None
            if c["kind"] == "collective-permute" and pairs:
                group = sorted({d for p in pairs for d in p})
            ops.append(measured_op(
                c["kind"], payload_bytes=c["bytes"], groups=[group],
                name=f"{c['name']}.r{c['row']}", measured_s=c["dur"],
                pairs=pairs, op_name=c["name"]))

        return TraceImport(
            name=name or "nvprof-trace", num_devices=int(ndev), ops=ops,
            host_transfers=transfers,
            meta={"source": "nvprof", "path": path,
                  "num_rows": len(body),
                  "duration_scale_s": dur_scale,
                  "size_scale_bytes": size_scale})


def _is_units_row(row: list[str], cols: dict) -> bool:
    du = _cell(row, cols["duration"]).lower()
    return du in _DUR_UNITS


def _parse_memcpy(low: str, row: list[str], cols: dict, rnum: int,
                  rname: str, devmap: DeviceMap, dur_scale: float,
                  size_scale: float, path: str, transfers: list,
                  clusters: dict, order: list, occ: dict) -> None:
    where = f"row {rnum} ({rname})"
    if "size" not in cols:
        raise TraceParseError(
            "memcpy rows but no byte column (Size/Bytes) in the header",
            path=path, record=where)
    size = _float(_cell(row, cols["size"]), "size", where, path,
                  minimum=0) * size_scale
    dur = _float(_cell(row, cols["duration"]), "duration", where, path,
                 minimum=0) * dur_scale
    if "htod" in low or "dtoh" in low:
        direction = "h2d" if "htod" in low else "d2h"
        dev = 0
        if _cell(row, cols.get("device")):
            dev = devmap.resolve(_cell(row, cols["device"]), record=where)
        transfers.append(HostTransfer(direction=direction, device=dev,
                                      nbytes=int(round(size)),
                                      label="cuda-memcpy"))
        return
    if "ptop" not in low:
        return                       # DtoD on one device moves no wire bytes
    src_s = _cell(row, cols.get("srcdev")) or _cell(row, cols.get("device"))
    dst_s = _cell(row, cols.get("dstdev"))
    if not src_s or not dst_s:
        raise TraceParseError(
            "PtoP memcpy without src/dst device columns",
            path=path, record=where)
    src = devmap.resolve(src_s, record=where)
    dst = devmap.resolve(dst_s, record=where)
    corr = _cell(row, cols.get("corr"))
    if corr:
        key = ("collective-permute", "corr", corr)
    else:
        k = occ.get(("ptop", None), 0)
        occ[("ptop", None)] = k + 1
        key = ("collective-permute", "occ-p2p", k)
    c = clusters.get(key)
    if c is None:
        c = {"kind": "collective-permute", "name": "cuda-memcpy-ptop",
             "dur": dur, "bytes": size, "devices": set(),
             "pairs": [], "row": rnum}
        clusters[key] = c
        order.append(key)
    else:
        c["dur"] = max(c["dur"], dur)
        c["bytes"] = max(c["bytes"], size)
    c["pairs"].append((src, dst))
    c["devices"].update((src, dst))
