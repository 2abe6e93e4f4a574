"""Run one cell of the benchmark once, on the machine it is started on.

    python3 chipbench/run.py --workload granite-3-2b.train --seed 7 \\
        --seconds 30 --trace 0

From the root of a checkout.  Set-up (imports, building the port's
kernels on a checkout's first run, drawing the weights, warming up every
shape the cell uses) counts as ``setup_s``; then the window measures for
``--seconds``; then the plain reference checks what the window produced.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
its per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit.
Everything else goes to standard error.

Exits 2 on bad arguments, 3 without the CUDA devices the cell needs (no
result printed), 4 when JAX or the JAX package is loaded once the window
has closed, 5 where the port (``src/repro_torch``) is missing.  The port
builds its kernels into ``build/torch_kernels/`` inside the checkout.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chipbench: the port is not in this checkout "
              f"({ROOT / 'src' / 'repro_torch'})", file=sys.stderr)
        return 5

    from chipbench.registry import Registry
    chips = Registry(ROOT).cell(args.workload)["chips"]

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"chipbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    return measure(args)


def measure(args, device: str = "cuda") -> int:
    """Run the cell and print its result, unless JAX or the JAX package
    is loaded once the window has closed or at any later point before the
    result would be printed (the reference, the metric readers and the
    limits load after the window)."""
    from chipbench import harness
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), root=ROOT, device=device,
                                  start_time=T_START)
        harness.refuse_forbidden()
    except harness.ForbiddenModules as e:
        print(f"chipbench: {e}", file=sys.stderr)
        return 4
    harness.print_checks(result["checks"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
