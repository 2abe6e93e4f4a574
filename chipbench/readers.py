"""The arithmetic the metric readers in ``chipbench/metrics/`` share.
Each reader returns a number, or None when its cell gives it nothing to
read; none returns 0 for a share it could not measure."""
from __future__ import annotations

import sys

from chipbench import counts, devtrace, stats


def tokens_per_s(run):
    return stats.rate(sum(u["tokens"] for u in run.units), run.t0,
                      [u["end"] for u in run.units])


def per_request(run, fn) -> list:
    """``fn(unit)`` once for each request of each unit."""
    return [fn(u) for u in run.units for _ in range(u["requests"])]


def idle_share(run):
    """Per cent of the traced window with nothing running on the device."""
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


# the port's kernels a roofline counts, by the op that launches them, and
# the device names their launches trace under
KERNELS = {"flash_attention": ("flash_attention_tc_kernel",
                               "flash_attention_f32_kernel"),
           "flash_decode": ("flash_decode_split_kernel",
                            "flash_decode_combine_kernel"),
           "rmsnorm": ("rmsnorm_lanes_kernel", "rmsnorm_block_kernel",
                       "rmsnorm_scalar_kernel")}


def kernel_roofline(run, kernels: dict = KERNELS):
    """Per cent: the least time of the port's kernel calls in the window,
    worked out from the cell's shapes, over their device time.  Silent
    where the program's launch counters disagree with the schedule the
    least times assume, or the trace has none of them."""
    if run.trace is None:
        return None
    calls = [c for c in run.loop.kernel_calls(run.units)
             if c[0] in kernels]
    want = counts.calls_count(calls)
    got = {op: run.counters.get(op, 0) for op in want}
    if want != got:
        print(f"[roofline] launches {got} differ from the schedule's {want}",
              file=sys.stderr)
        return None
    least = sum(counts.calls_least(calls).values())
    device, _ = devtrace.device_seconds(
        run.trace, [n for op in want for n in kernels[op]])
    return 100.0 * least / device if device > 0 else None


def train_mfu(run):
    """Per cent of the bf16 peak: the window's model FLOPs over its time."""
    flops = run.loop.step_flops() * len(run.units)
    return 100.0 * flops / run.window_s / counts.PEAK_FLOPS[
        run.run_cfg["compute_dtype"]]


def serve_mfu(run):
    """Per cent: each step's least time (model FLOPs at peak, or least
    bytes at the HBM rate, whichever is longer), summed over the window's
    steps, over the window's time."""
    return 100.0 * sum(run.loop.step_least(run.units)) / run.window_s
