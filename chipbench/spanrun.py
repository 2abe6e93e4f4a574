"""Run one cell as ``chipbench/run.py`` does, with the port's spans
(``repro_torch.spans``) recording through the window.

    python3 chipbench/spanrun.py --workload granite-3-2b.train --seed 7 \\
        --seconds 50 --trace 1

With ``--trace 1`` the last line is ``run.py --trace 1``'s result line,
its idle gaps labelled by span (``train_step/train.optimizer``), with one
more key, ``spans``: the clock check, the span shares of
``chipbench/spans.py``'s ``SHARES`` that the cell's kind reads
(``attention_share.train``, ``optimizer_share.train``,
``moe_share.serve``), and device and idle seconds by span.  With
``--trace 0`` the spans record and no profiler runs: the end-to-end
metrics with spans on, to set against ``run.py --trace 0`` on the same
seed for what recording costs.  The clock check is printed on standard
error.  Exit codes are ``run.py``'s.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOP = 15


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch
    if not torch.cuda.is_available():
        print("chipbench: spanrun needs a CUDA device", file=sys.stderr)
        return 3

    from chipbench import devtrace, harness, spans
    from chipbench.registry import Registry

    kind = Registry(ROOT).traffic(
        Registry(ROOT).cell(args.workload)["traffic"])["kind"]
    made = []

    def trace(enabled):
        made.append(spans.SpanTrace(enabled))
        return made[-1]

    plain, devtrace.DeviceTrace = devtrace.DeviceTrace, trace
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), root=ROOT,
                                  start_time=T_START)
        harness.refuse_forbidden()
    except harness.ForbiddenModules as e:
        print(f"chipbench: {e}", file=sys.stderr)
        return 4
    finally:
        devtrace.DeviceTrace = plain
    tr = made[-1]
    out = {"recorded": tr.recorded}
    sp = (tr.result or {}).get("spans")
    if sp:
        out["clock"] = sp["clock"]
        out["metrics"] = {m: spans.share(tr.result, name)
                          for m, name in spans.SHARES.items()
                          if m.endswith("." + kind)}
        for key in ("device_s", "self_s", "idle_s"):
            out[key] = dict(sorted(sp[key].items(),
                                   key=lambda kv: -kv[1])[:TOP])
    result["spans"] = out
    harness.print_checks(result["checks"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
