"""The traced window: ``torch.profiler`` tracing the device alone (host
tracing inflates the window's wall time), read from the raw kineto events.

The benchmark's spans (``prefill``, ``decode``, ``train_step`` and the
host's time between calls) are marked on the device's own timeline: at
each span's start the benchmark queues a tiny marker kernel
(``torch.cuda._sleep(0)``, ``spin_kernel``, which the program never
launches) and notes the span's name.  An idle gap on the device is then
labelled by the last marker before it: the span whose work surrounds it.
Markers are left out of every sum.
"""
from __future__ import annotations

MARKER = "spin_kernel"
TOP = 10


class DeviceTrace:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.labels: list = []
        self.prof = None
        self.result = None

    def mark(self, label: str) -> None:
        if self.enabled:
            import torch
            torch.cuda._sleep(0)
            self.labels.append(label)

    def start(self) -> None:
        if not self.enabled:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()

    def stop(self, window_s: float) -> dict | None:
        """Close the profiler and reduce its events; None when it traced
        no device time."""
        if not self.enabled:
            return None
        import torch
        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        from torch.autograd import DeviceType
        events = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0 \
                    and not e.is_user_annotation():
                events.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                               e.name()))
        self.prof = None
        self.result = reduce_events(events, self.labels, window_s)
        return self.result


def reduce_events(events, labels, window_s: float) -> dict | None:
    """``events``: ``(start_ns, end_ns, name)`` of device activities.
    Returns busy seconds (the union of the activities' intervals), seconds
    and calls by name, and the idle gaps by the span they fall in."""
    events = sorted(events)
    marks = [e for e in events if MARKER in e[2]]
    work = [e for e in events if MARKER not in e[2]]
    if not work:
        return None
    by_name: dict = {}
    for s, e, n in work:
        sec, cnt = by_name.get(n, (0.0, 0))
        by_name[n] = (sec + (e - s) * 1e-9, cnt + 1)
    # union of intervals, and the gaps between them
    busy_ns, gaps = 0, []
    cur_s, cur_e = work[0][0], work[0][1]
    for s, e, _ in work[1:]:
        if s > cur_e:
            busy_ns += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy_ns += cur_e - cur_s
    labelled = label_gaps(gaps, [m[0] for m in marks], labels)
    return {"busy_s": busy_ns * 1e-9, "window_s": window_s,
            "by_name": by_name, "gaps": labelled,
            "markers": (len(marks), len(labels))}


def label_gaps(gaps, mark_starts, labels) -> list:
    """``(label, seconds)`` of each gap: the label of the last marker that
    started before it (``unlabelled`` if the markers on the device do not
    match the spans noted, or none came before)."""
    ok = len(mark_starts) == len(labels)
    out, j = [], -1
    for a, b in gaps:
        while ok and j + 1 < len(mark_starts) and mark_starts[j + 1] <= a:
            j += 1
        out.append((labels[j] if ok and j >= 0 else "unlabelled",
                    (b - a) * 1e-9))
    return out


def breakdown(result: dict) -> dict:
    """The device operations that took most time, and the idle time by
    span (each span's summed gaps, then its longest single gap), ten
    entries at most each."""
    ops = sorted(((n[:160], s) for n, (s, _) in result["by_name"].items()),
                 key=lambda r: -r[1])[:TOP]
    total: dict = {}
    longest: dict = {}
    for label, sec in result["gaps"]:
        total[label] = total.get(label, 0.0) + sec
        longest[label] = max(longest.get(label, 0.0), sec)
    idle = sorted(([f"{k} total", v] for k, v in total.items()),
                  key=lambda r: -r[1])
    idle += sorted(([f"{k} longest", v] for k, v in longest.items()),
                   key=lambda r: -r[1])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": idle[:TOP]}


def device_seconds(result: dict, patterns) -> tuple[float, int]:
    """Seconds and calls of the device activities whose names hold any
    of ``patterns``."""
    sec, cnt = 0.0, 0
    for name, (s, c) in result["by_name"].items():
        if any(p in name for p in patterns):
            sec += s
            cnt += c
    return sec, cnt
