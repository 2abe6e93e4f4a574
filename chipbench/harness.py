"""One run of one cell: set-up, the measured window, the traced window's
reduction, the correctness check against the plain reference, and the
result line.

The order is fixed: the window closes, the device's peak memory is read,
the program's state is freed, and only then does the reference run (a
process's peak never falls, so a reference run first would set it).
"""
from __future__ import annotations

import gc
import math
import sys
import time
from types import SimpleNamespace

from chipbench import counts, devtrace
from chipbench.registry import Registry

# top-level module names that may not be loaded once the window closes:
# JAX and the JAX package (``repro``) with its benchmark suite
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, the part before the first dot,
    is one of :data:`FORBIDDEN` (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             root=None, device: str = "cuda", start_time: float | None = None,
             control: bool = False) -> dict:
    """Run ``workload`` once.  Returns the result line's dict; with
    ``control`` the control's numbers are read too and judged by the same
    limits (under ``control_numbers`` and ``control_correct``), which the
    benchmark's own runs never do."""
    import torch

    t_start = time.perf_counter() if start_time is None else start_time
    reg = Registry(root)
    cell = reg.cell(workload)
    config = reg.config(cell["config"])
    traffic = reg.traffic(cell["traffic"])
    dev = torch.device(device)
    ctx = SimpleNamespace(cell=cell, config=config, run=config["run"],
                          traffic=traffic, seed=seed, device=dev, log=log,
                          clock=lambda: time.perf_counter() - t_start)
    loop = reg.loop(traffic["kind"]).Loop(ctx)
    log(f"[run] {workload} seed {seed}: {counts.power_limit() or device}")

    loop.setup()
    setup_s = time.perf_counter() - t_start
    log(f"[run] set-up {setup_s:.3f} s")

    from chipbench import port
    before = port.read_counters()
    tr = devtrace.DeviceTrace(trace and dev.type == "cuda")
    tr.start()
    t0 = time.perf_counter()
    units = []
    while True:
        units.append(loop.unit(tr))
        if units[-1]["end"] - t0 >= seconds:
            break
    window_s = units[-1]["end"] - t0
    t_trace = time.perf_counter()
    traced = tr.stop(window_s)
    if trace:
        log(f"[run] trace read in {time.perf_counter() - t_trace:.3f} s")
    after = port.read_counters()
    loop.audit(units)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    refuse_forbidden()
    log(f"[run] window {window_s:.3f} s, {len(units)} units")

    loop.finish()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t_ref = time.perf_counter()
    numbers = loop.check()
    log(f"[run] reference {time.perf_counter() - t_ref:.3f} s")
    control_numbers = loop.control() if control else None

    run = SimpleNamespace(
        cell=cell, config=config, run_cfg=config["run"], traffic=traffic,
        seed=seed, setup_s=setup_s, t0=t0, window_s=window_s, units=units,
        trace=traced, counters={k: after[k] - before[k] for k in after},
        loop=loop, device=dev)
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in reg.metrics(workload, section):
        value = reg.reader(m["name"]).read(run)
        if value is None:
            log(f"[run] {m['name']}: nothing to read")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    limits = reg.limits(workload)
    checks, correct = judge(numbers, limits)
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct,
              "attempted": sum(u["requests"] for u in units),
              "failed": sum(u["failed"] for u in units),
              "metrics": metrics, "device": device_info}
    if trace:
        if traced is not None:
            device_info["busy_s"] = traced["busy_s"]
            device_info["window_s"] = traced["window_s"]
            result["breakdown"] = devtrace.breakdown(traced)
        else:
            device_info["busy_s"] = 0.0
            device_info["window_s"] = window_s
    result["numbers"] = {k: v for k, v in numbers.items()
                         if k not in checks}
    if control_numbers is not None:
        result["control_numbers"] = control_numbers
        result["control_correct"] = judge(control_numbers, limits)[1]
    result["checks"] = checks
    return result


def judge(numbers: dict, limits: dict) -> tuple:
    """Each number compared beside its limit, and whether all are within
    them: a number missing or not finite is not."""
    checks = {name: {"value": numbers.get(name), "limit": lim}
              for name, lim in limits.items()}
    correct = bool(checks) and all(
        c["value"] is not None and math.isfinite(c["value"])
        and c["value"] <= c["limit"] for c in checks.values())
    return checks, correct


def refuse_forbidden() -> None:
    """Raise :class:`ForbiddenModules` where JAX or the JAX package is
    loaded."""
    bad = forbidden_modules()
    if bad:
        raise ForbiddenModules(bad)


class ForbiddenModules(RuntimeError):
    def __init__(self, names):
        super().__init__("loaded after the window: " + ", ".join(names))
        self.names = names


def print_checks(checks: dict) -> None:
    """Each number compared beside its limit, as the last lines on
    standard error."""
    for name, c in checks.items():
        log(f"check {name} {c['value']} limit {c['limit']}")
