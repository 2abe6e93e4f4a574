"""The port's spans laid over the device trace (``chipbench/spans.py``):
on synthetic events, device time and idle gaps land on the right
innermost span across two threads, the clock check fails where a launch
lies outside its span, and ``devtrace``'s own readings do not move; on
the CPU the traced run still reads no device metric; on the card a span
contains its launch, and the span shares read in (0, 100].

    PYTHONPATH=src python -m pytest -q chipbench/tests/test_chipbench_spans.py
    python -m pytest -q -m chip chipbench/tests/test_chipbench_spans.py
"""
from __future__ import annotations

import json
import subprocess
import sys
from types import SimpleNamespace

import pytest

from chipbench import devtrace, harness, spans

from .conftest import ROOT, SEED

MAIN, GRAD = 0x7F3A_1234_5740, 0x7F39_B0FF_F640   # two pthread_t values
FA = "void flash_attention_tc_kernel<bf16>"


def rec(i, name, ident, start, end, parent=None):
    return SimpleNamespace(id=i, name=name, ident=ident, start_ns=start,
                           end_ns=end, parent=parent)


def _spans():
    """A train step on the main thread; its backward's attention on
    autograd's thread, whose parent is the main thread's ``backward``."""
    return [rec(0, "train.step", MAIN, 0, 2000),
            rec(1, "train.backward", MAIN, 100, 900, 0),
            rec(2, "attention", GRAD, 200, 300, 1),
            rec(3, "train.optimizer", MAIN, 900, 1000, 0)]


def _trace(attention_launch=250, unmatched=True):
    """Device events (start, end, name), their correlation ids and the
    runtime launches ``{corr: (start, thread)}``."""
    g, m = spans.thread_key(GRAD), spans.thread_key(MAIN)
    kernels = [(40, 45, devtrace.MARKER, 0, (35, m)),
               (60, 70, "elementwise", 1, (50, m)),       # train.step
               (300, 350, FA, 2, (attention_launch, g)),  # attention
               (360, 400, "gemm", 3, (400, g)),     # grad thread, no span
               (1000, 1100, "adam", 5, (950, m)),          # optimizer
               (2100, 2110, "gemm", 6, (2050, m))]         # after the step
    if unmatched:
        kernels.append((2200, 2210, "memcpy", 7, None))
    events = [k[:3] for k in kernels]
    corrs = [k[3] for k in kernels]
    launches = {k[3]: k[4] for k in kernels if k[4] is not None}
    return events, corrs, launches


def _attributed(**kw):
    events, corrs, launches = _trace(**kw)
    labels = ["train_step"]                  # the one marker's label
    before = devtrace.reduce_events(events, labels, 1e-5)
    result = devtrace.reduce_events(events, labels, 1e-5)
    out = spans.attribute(result, events, corrs, launches, _spans(),
                          spans.thread_key(MAIN))
    result["spans"] = out
    return before, result, out


def test_device_time_lands_on_the_innermost_span_of_its_thread():
    _, _, out = _attributed()
    assert out["self_s"] == pytest.approx({
        "train.step": 10e-9, "attention": 50e-9, "train.backward": 40e-9,
        "train.optimizer": 100e-9, "-": 20e-9})
    # a span's device time holds its descendants'
    assert out["device_s"] == pytest.approx({
        "train.step": 200e-9, "train.backward": 90e-9, "attention": 50e-9,
        "train.optimizer": 100e-9})


def test_idle_gaps_land_on_the_innermost_span_open_as_they_began():
    before, result, out = _attributed()
    # gaps begin at 70 (step), 350 (attention closed at 300: backward),
    # 400 (backward), 1100 (step), 2110 (no span open)
    assert [label for label, _ in result["gaps"]] == [
        "train_step/train.step", "train_step/train.backward",
        "train_step/train.backward", "train_step/train.step", "train_step"]
    assert out["idle_s"]["train_step/train.backward"] == pytest.approx(
        610e-9)


def test_reduced_readings_do_not_move():
    before, result, _ = _attributed()
    assert result["busy_s"] == before["busy_s"]
    assert result["by_name"] == before["by_name"]
    assert result["markers"] == before["markers"]
    assert [s for _, s in result["gaps"]] == [s for _, s in before["gaps"]]


def test_clock_check_passes_and_shares_read():
    _, result, out = _attributed(unmatched=False)
    assert out["clock"] == {"matched": 1.0, "inside": [1, 1], "ok": True}
    busy = result["busy_s"]
    assert spans.share(result, "attention") == pytest.approx(
        100 * 50e-9 / busy)
    assert spans.share(result, "train.optimizer") == pytest.approx(
        100 * 100e-9 / busy)
    assert 0 < spans.share(result, "train.step") <= 100


@pytest.mark.parametrize("kw", [dict(attention_launch=150),
                                dict(attention_launch=320),
                                dict(unmatched=True)],
                         ids=["launch_before", "launch_after", "unmatched"])
def test_clock_check_fails_and_shares_read_none(kw):
    """An attention kernel launched outside its span, or kernel time
    without a launch (here 20 of 220 ns), fails the check."""
    kw.setdefault("unmatched", False)
    _, result, out = _attributed(**kw)
    assert not out["clock"]["ok"]
    assert spans.share(result, "attention") is None


def test_share_reads_none_without_trace_spans_or_span():
    _, result, _ = _attributed(unmatched=False)
    assert spans.share(None, "attention") is None
    assert spans.share({k: v for k, v in result.items() if k != "spans"},
                       "attention") is None
    assert spans.share(result, "moe") is None


def test_thread_key_is_the_identifier_cut_to_signed_32_bits():
    assert spans.thread_key(0x7F3A_2260_0740) == 0x2260_0740
    assert spans.thread_key(0x7F3A_B1FF_F640) == 0xB1FF_F640 - (1 << 32)


def test_open_at_takes_the_innermost_with_bounds_included():
    r = [rec(0, "a", MAIN, 0, 10), rec(1, "b", MAIN, 2, 5, 0),
         rec(2, "c", MAIN, 5, 7, 0)]
    depth = {0: 0, 1: 1, 2: 1}
    got = spans.open_at(r, [0, 2, 5, 6, 8, 10, 11], depth)
    assert [g.name if g else None for g in got] == [
        "a", "b", "c", "c", "a", "a", None]


def test_span_trace_on_the_cpu_records_and_reads_no_device_metric(
        tiny_root, monkeypatch):
    """The traced tiny run with the spans on: the spans record, nothing
    is traced on the CPU, and no device metric reads."""
    made = []

    def trace(enabled):
        made.append(spans.SpanTrace(enabled))
        return made[-1]

    monkeypatch.setattr(devtrace, "DeviceTrace", trace)
    r = harness.run_cell("tiny.serve", SEED + 3, 0.3, True, root=tiny_root,
                         device="cpu")
    assert made[-1].recorded > 0 and made[-1].result is None
    assert "idle_share.serve" not in r["metrics"]
    assert r["device"]["busy_s"] == 0.0 and "breakdown" not in r
    assert spans.recorder().drain() == []


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.chip
def test_span_contains_its_launch_on_the_card(chip):
    """A span around a known launch holds that launch's runtime event on
    the span's own thread, and the attribution finds it there."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import spans as recorder
    from repro_torch.kernels.flash_attention import ops

    q = torch.randn(2, 128, 4, 64, device="cuda", dtype=torch.bfloat16)
    x = torch.randn(512, 512, device="cuda")
    ops.attend(q, q, q)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        recorder.enable()
        with recorder.span("train.step"):
            for _ in range(3):
                x = x @ x
                ops.attend(q, q, q)
        recorder.disable()
        torch.cuda.synchronize()
    recs = recorder.drain()
    events, corrs, launches = spans.read_events(
        prof.profiler.kineto_results.events())
    att = [s for s in recs if s.name == "attention"]
    fa = [c for (_, _, n), c in zip(events, corrs)
          if "flash_attention" in n]
    assert len(att) == len(fa) == 3
    for s, c in zip(sorted(att, key=lambda s: s.start_ns), fa):
        t, thread = launches[c]
        assert s.start_ns <= t <= s.end_ns, (s, t)
        assert thread == spans.thread_key(s.ident), (thread, s.ident, s.tid)
    result = devtrace.reduce_events(events, [], 1.0)
    out = spans.attribute(result, events, corrs, launches, recs,
                          spans.thread_key(recs[0].ident))
    assert out["clock"]["ok"] and out["clock"]["inside"] == [3, 3]


CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_span_shares_read_on_the_card(chip, cell):
    p = subprocess.run([sys.executable, "chipbench/spanrun.py", "--workload",
                        cell, "--seed", "2147483701", "--seconds", "5",
                        "--trace", "1"], cwd=ROOT, capture_output=True,
                       text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    sp = r["spans"]
    assert sp["clock"]["ok"], sp["clock"]
    assert "[spans]" in p.stderr
    assert sp["metrics"]
    for name, value in sp["metrics"].items():
        assert value is not None and 0 < value <= 100, (name, value)
