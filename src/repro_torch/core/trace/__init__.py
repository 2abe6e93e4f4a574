"""Trace ingestion: import real device traces onto the event model (port of
``repro.core.trace``).

Four frontends behind one :class:`~.base.TraceSource` interface:

* :class:`~.torch_profiler.TorchProfilerSource` -- ``torch.profiler``'s
  Chrome trace (``export_chrome_trace``): ``c10d`` and functional
  collectives timed by their NCCL kernels where the card ran one;
* :class:`~.perfetto.PerfettoSource` -- Perfetto / Chrome trace-event
  JSON, both generic profiler output and the port's own exporter's (the
  latter re-imports *exactly*: bitwise comm-matrix round-trip);
* :class:`~.nvprof.NvprofCsvSource` -- ComScribe-style nvprof GPU-trace
  CSV (NCCL kernels, PtoP/HtoD/DtoH memcpys);
* :class:`~.jsonl.JsonlSource` -- the generic one-JSON-object-per-line
  schema.

:func:`load_trace` sniffs the format and returns a
:class:`~.base.TraceImport`; ``.report()`` turns it into a regular
:class:`~repro_torch.core.monitor.CommReport` whose ops carry *measured*
seconds (``measured_s``, schema v9) next to the modeled ones, and
:func:`~.compare.compare` pins the two against each other::

    from repro_torch.core.trace import load_trace
    measured = load_trace("step.pt.trace.json").report()
    print(measured.compare(capture_report).table())

Malformed input raises :class:`~.base.TraceParseError` naming the
offending record; silent zero-row matrices are a bug by contract.
"""
from __future__ import annotations

import os
from typing import Optional

from .base import TraceImport, TraceParseError, TraceSource
from .compare import CompareResult, CompareRow, compare
from .jsonl import JsonlSource
from .normalize import DeviceMap, align_clocks, collective_kind, measured_op
from .nvprof import NvprofCsvSource
from .perfetto import PerfettoSource
from .torch_profiler import TorchProfilerSource

#: sniff order matters: the CSV test is the cheapest and most specific, the
#: torch profiler's trace is also Chrome trace-event JSON, so it goes before
#: the generic Perfetto test, and the JSONL test would also accept some
#: single-line JSON documents
SOURCES: tuple = (NvprofCsvSource, TorchProfilerSource, PerfettoSource,
                  JsonlSource)

FORMATS = tuple(s.format for s in SOURCES)

_SNIFF_BYTES = 4096


def source_for(fmt: str) -> type:
    """The :class:`TraceSource` registered under ``fmt``."""
    for src in SOURCES:
        if src.format == fmt:
            return src
    raise ValueError(
        f"unknown trace format {fmt!r}; valid formats: {list(FORMATS)}")


def sniff_format(path: str) -> Optional[str]:
    """Best-guess format name for ``path`` (content first, extension as
    tie-break); None when nothing matches."""
    try:
        with open(path, errors="replace") as f:
            head = f.read(_SNIFF_BYTES)
    except OSError:
        return None
    for src in SOURCES:
        try:
            if src.sniff(path, head):
                return src.format
        except Exception:
            continue
    ext = os.path.splitext(path)[1].lower()
    for src in SOURCES:
        if ext in src.extensions:
            return src.format
    return None


def load_trace(path: str, fmt: Optional[str] = None, **opts) -> TraceImport:
    """Parse a device trace into a :class:`TraceImport`.

    ``fmt`` forces a frontend (one of :data:`FORMATS`); by default the
    file's head is sniffed.  Keyword options are passed to the frontend:
    every frontend takes ``num_devices`` and ``name``; the nvprof, JSONL and
    Perfetto frontends take ``device_map`` (explicit label -> id pins);
    :class:`PerfettoSource` additionally takes ``pid`` (process to import
    from a multi-report export).
    """
    if not os.path.exists(path):
        raise FileNotFoundError(f"trace file not found: {path}")
    if fmt is None:
        fmt = sniff_format(path)
        if fmt is None:
            raise TraceParseError(
                f"cannot determine trace format; pass fmt= one of"
                f" {list(FORMATS)}", path=path)
    return source_for(fmt).parse(path, **opts)


__all__ = [
    "TraceImport", "TraceParseError", "TraceSource",
    "CompareResult", "CompareRow", "compare",
    "JsonlSource", "NvprofCsvSource", "PerfettoSource",
    "TorchProfilerSource",
    "DeviceMap", "align_clocks", "collective_kind", "measured_op",
    "SOURCES", "FORMATS", "source_for", "sniff_format", "load_trace",
]
