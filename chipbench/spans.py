"""The port's spans over the device trace: each kernel's device time and
each idle gap on the device, put down to the span of the program
(``repro_torch.spans``) whose work it is.

Kineto gives each kernel a correlation id, and the CUDA runtime call that
launched it (``cudaLaunchKernel`` and its kin) the same id, a host
timestamp on the clock the spans use (Unix nanoseconds) and the launching
thread (its ``pthread_t`` cut to 32 bits, :func:`thread_key`).  So:

* a kernel's device time goes to the innermost span open on its launching
  thread at its launch; on a thread with none open, to the main thread's
  innermost open span (autograd's device thread launches the backward
  while the main thread waits in ``train.backward``);
* an idle gap goes to the innermost span open on the host, on any thread,
  when the gap began: its label becomes ``<marker label>/<span>``
  (``train_step/train.optimizer``), and stays the marker's where no span
  was open.

:class:`SpanTrace` is :class:`devtrace.DeviceTrace` with the port's spans
recording through the window.  ``busy_s``, ``by_name``, the gaps' lengths
and the markers are ``devtrace.reduce_events``' over the very events
``DeviceTrace`` reads.  It checks its clock in every traced run: at least
:data:`MATCHED` of the kernels' device time must find its launch, and
every launch of the port's attention kernels must fall inside an
``attention`` span.  Where either fails, :func:`share` reads None.
"""
from __future__ import annotations

import sys
import threading

from chipbench import devtrace
from chipbench.readers import KERNELS

MATCHED = 0.99
# the port's kernels that only an ``attention`` span launches
ATTENTION_KERNELS = KERNELS["flash_attention"] + KERNELS["flash_decode"]
# per-layer metrics read from the spans: the span whose device time over
# the window's busy time each one is
SHARES = {"attention_share.train": "attention",
          "optimizer_share.train": "train.optimizer",
          "moe_share.serve": "moe"}


def recorder():
    """The port's span recorder, or None where the port has none."""
    try:
        from repro_torch import spans
    except ImportError:
        return None
    return spans


def thread_key(ident: int) -> int:
    """A Python thread identifier as kineto's runtime events carry it (their
    ``device_resource_id``): cut to a signed 32-bit integer."""
    v = ident & 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


class SpanTrace(devtrace.DeviceTrace):
    """``DeviceTrace`` with the port's spans on from :meth:`start` to
    :meth:`stop`, also where the device is not traced (the spans' own
    cost, against a run without them)."""

    def __init__(self, enabled: bool):
        super().__init__(enabled)
        self.rec = recorder()
        self.recorded = 0

    def start(self) -> None:
        super().start()
        if self.rec is not None:
            self.rec.enable()

    def stop(self, window_s: float) -> dict | None:
        if self.enabled:
            import torch
            torch.cuda.synchronize()
        recs = None
        if self.rec is not None:
            self.rec.disable()
            recs = self.rec.drain()
            self.recorded = len(recs)
        if not self.enabled:
            return None
        self.prof.__exit__(None, None, None)
        events, corrs, launches = read_events(
            self.prof.profiler.kineto_results.events())
        self.prof = None
        self.result = devtrace.reduce_events(events, self.labels, window_s)
        if self.result is not None and recs is not None:
            main = thread_key(threading.main_thread().ident)
            self.result["spans"] = attribute(self.result, events, corrs,
                                             launches, recs, main)
            c = self.result["spans"]["clock"]
            print(f"[spans] {len(recs)} spans; kernel time matched to its "
                  f"launch {100 * c['matched']:.3f}% (at least "
                  f"{100 * MATCHED:g}%); attention kernels launched inside "
                  f"an attention span {c['inside'][0]} of {c['inside'][1]}; "
                  f"clock {'ok' if c['ok'] else 'FAILED'}",
                  file=sys.stderr, flush=True)
        return self.result


def read_events(raw) -> tuple:
    """Kineto's events -> ``events`` (``start_ns, end_ns, name`` of the
    device activities, as ``DeviceTrace`` keeps them), their correlation
    ids in the same order, and ``{correlation id: (start_ns, thread)}`` of
    the CUDA API calls (names ``cu...``)."""
    from torch.autograd import DeviceType
    events, corrs, launches = [], [], {}
    for e in raw:
        if e.device_type() == DeviceType.CUDA:
            if e.duration_ns() > 0 and not e.is_user_annotation():
                events.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                               e.name()))
                corrs.append(e.correlation_id())
        elif e.name().startswith("cu") and e.correlation_id():
            launches.setdefault(e.correlation_id(),
                                (e.start_ns(), e.device_resource_id()))
    return events, corrs, launches


def open_at(recs, times, depth: dict) -> list:
    """The innermost of ``recs`` (one thread's spans, which nest) open at
    each of ``times``, bounds included; None where none is."""
    ev = [(s.start_ns, 0, depth[s.id], s) for s in recs]
    ev += [(s.end_ns, 2, -depth[s.id], s) for s in recs]
    ev += [(t, 1, 0, i) for i, t in enumerate(times)]
    ev.sort(key=lambda x: x[:3])
    out: list = [None] * len(times)
    stack: list = []
    for _, kind, _, x in ev:
        if kind == 0:
            stack.append(x)
        elif kind == 2:
            if stack[-1] is x:
                stack.pop()
            else:
                stack.remove(x)
        elif stack:
            out[x] = stack[-1]
    return out


def _depths(recs) -> dict:
    by_id = {s.id: s for s in recs}
    depth: dict = {}
    for s in recs:
        chain = []
        while s is not None and s.id not in depth:
            chain.append(s)
            s = by_id.get(s.parent) if s.parent is not None else None
        d = depth[s.id] if s is not None else -1
        for c in reversed(chain):
            d += 1
            depth[c.id] = d
    return depth


def _paths(recs) -> dict:
    """Each span's name and its ancestors' names, by id."""
    by_id = {s.id: s for s in recs}
    paths: dict = {}
    for s in recs:
        names, p = set(), s
        while p is not None:
            names.add(p.name)
            p = by_id.get(p.parent) if p.parent is not None else None
        paths[s.id] = names
    return paths


def _gap_starts(work) -> list:
    """The start of each idle gap between the device activities ``work``,
    as ``devtrace.reduce_events`` finds them."""
    starts = []
    cur_e = work[0][1]
    for s, e, *_ in work[1:]:
        if s > cur_e:
            starts.append(cur_e)
        cur_e = max(cur_e, e)
    return starts


def attribute(result: dict, events, corrs, launches: dict, recs,
              main: int) -> dict:
    """Put the window's kernels and idle gaps down to the spans ``recs``
    (see the module's docstring); ``main`` is the main thread's key.
    Relabels ``result["gaps"]`` in place (their lengths unchanged) and
    returns the clock check, device seconds by span name (``device_s``:
    a span's kernels and its descendants'; ``self_s``: its own, ``-`` for
    none), and idle seconds by label (``idle_s``)."""
    work = sorted((s, e, n, c) for (s, e, n), c in zip(events, corrs)
                  if devtrace.MARKER not in n)
    depth, paths = _depths(recs), _paths(recs)
    threads: dict = {}
    for s in recs:
        threads.setdefault(thread_key(s.ident), []).append(s)

    # each kernel's launch -> the innermost span open on its thread
    total = matched = 0
    asked: dict = {}
    for i, (s, e, _, c) in enumerate(work):
        total += e - s
        if c in launches:
            matched += e - s
            t, key = launches[c]
            asked.setdefault(key, []).append((i, t))
    span_of: list = [None] * len(work)
    orphans = []
    for key, qs in asked.items():
        found = open_at(threads.get(key, []), [t for _, t in qs], depth)
        for (i, t), sp in zip(qs, found):
            span_of[i] = sp
            if sp is None and key != main:
                orphans.append((i, t))
    found = open_at(threads.get(main, []), [t for _, t in orphans], depth)
    for (i, _), sp in zip(orphans, found):
        span_of[i] = sp

    device_s: dict = {}
    self_s: dict = {}
    inside = [0, 0]
    for (s, e, n, _), sp in zip(work, span_of):
        sec = (e - s) * 1e-9
        own = sp.name if sp is not None else "-"
        self_s[own] = self_s.get(own, 0.0) + sec
        for name in (paths[sp.id] if sp is not None else ()):
            device_s[name] = device_s.get(name, 0.0) + sec
        if any(k in n for k in ATTENTION_KERNELS):
            inside[1] += 1
            inside[0] += int(own == "attention")

    # each idle gap -> the innermost span open on the host as it began
    starts = _gap_starts(work) if work else []
    if len(starts) != len(result["gaps"]):
        raise RuntimeError(f"{len(starts)} gaps found, "
                           f"{len(result['gaps'])} reduced")
    best: list = [None] * len(starts)
    for own in threads.values():
        for i, sp in enumerate(open_at(own, starts, depth)):
            if sp is not None and (best[i] is None
                                   or depth[sp.id] > depth[best[i].id]):
                best[i] = sp
    result["gaps"] = [(f"{label}/{sp.name}" if sp is not None else label,
                       sec) for (label, sec), sp in zip(result["gaps"], best)]
    idle_s: dict = {}
    for label, sec in result["gaps"]:
        idle_s[label] = idle_s.get(label, 0.0) + sec

    share = matched / total if total else 0.0
    ok = share >= MATCHED and inside[0] == inside[1]
    return {"recorded": len(recs),
            "clock": {"matched": share, "inside": inside, "ok": ok},
            "device_s": device_s, "self_s": self_s, "idle_s": idle_s}


def share(trace: dict | None, span: str):
    """Per cent: the device time of the kernels launched under ``span``
    spans (their descendants' included) over the window's busy time; None
    without a trace, without spans, where the clock check failed, or
    where no such span launched a kernel."""
    sp = (trace or {}).get("spans")
    if not sp or not sp["clock"]["ok"] or span not in sp["device_s"]:
        return None
    return 100.0 * sp["device_s"][span] / trace["busy_s"]
