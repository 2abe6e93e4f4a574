"""The readings a cell's correctness limits are set from, many seeds in
one process (set-up is long); the benchmark's own runs never run this.

    python3 chipbench/readings.py --workload granite-3-2b.train \\
        --seeds 11,12,13 --control-seeds 11,12,13 --seconds 5 \\
        --out readings.jsonl
    python3 chipbench/readings.py --workload grok-1.decode \\
        --seeds 21,22,23 --faults stale_cache,altered_token --seconds 2

Each seed is one whole run of the cell (set-up, a short window at the
cell's own load, the reference); a control seed also reads the control
(the reference's linear layers in FP8, put in the program's place) and
judges it by the cell's limits (``control_correct``); with ``--faults``
each seed runs once with each fault planted (``chipbench/faults.py``).
One JSON line a run: the numbers compared, the other numbers, the
control's, the metrics and the seconds the run took.
"""
import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="",
                    help="comma-separated names of chipbench/faults.py")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from chipbench import faults, harness

    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None
    runs = [(seed, fault) for seed in (int(s) for s in args.seeds.split(","))
            for fault in (args.faults.split(",") if args.faults else [None])]
    for seed, fault in runs:
        t = time.perf_counter()
        plant = (faults.planted(fault) if fault
                 else contextlib.nullcontext())
        with plant:
            r = harness.run_cell(args.workload, seed, args.seconds, False,
                                 root=ROOT, start_time=t,
                                 control=seed in ctrl)
        line = {"workload": args.workload, "seed": seed, "fault": fault,
                "correct": r["correct"], "checks": r["checks"],
                "numbers": r["numbers"],
                "control": r.get("control_numbers"),
                "control_correct": r.get("control_correct"),
                "metrics": r["metrics"], "device": r["device"],
                "seconds": time.perf_counter() - t}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        del r
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
