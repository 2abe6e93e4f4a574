#!/usr/bin/env python3
"""Time and check the RG-LRU kernels of a source tree on one NVIDIA GPU.

    python3 tools/rglru_bench.py [--src DIR] [--sweep] [--ptxas]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (by
default this checkout's), for example that of an unpacked ``git archive`` of
another commit, so that two versions of the kernels are timed in one run on
one card; a tree whose wrapper has no backward kernel is timed forward
only.  For each of ``chip_smoke.py``'s RG-LRU cases in both input regimes
it prints the forward kernel's error against ``rglru_ref`` and, where there
is a backward kernel, each backward output's error against ``rglru_bwd``
(relative to max(1, max|ref|)) and whether the kernels' outputs equal the
sequence-split mirror (``ref.rglru_split_ref`` / ``rglru_bwd_split_ref``,
run on the card) bit for bit; then the kernels' median times beside their
bytes bounds.  ``--sweep`` also times every launch plan of a cluster of 1
to 8 at each shape (this checkout's wrapper only), each checked against the
plain versions.  ``--ptxas`` compiles ``rglru.cu`` once more with
``-Xptxas -v`` and prints what ptxas reports.  The last line is one JSON
object with every number.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def plans(rg_ops, shape) -> list:
    """The walk (forward only), then every split plan of a cluster of 1, 2, 4 or 8 and 1,
    2, 4 or 8 warps, at the rows a sub-chunk that cover a CTA's share in
    one round (at most 16) and at fewer (4 and 8: more rounds, each next
    tile loading while this one is scanned)."""
    b, s, d = shape
    out = [rg_ops.WALK]
    for cluster in (1, 2, 4, 8):
        share = -(-s // cluster)
        for warps in (1, 2, 4, 8):
            steps = min(rg_ops.MAX_STEPS, -(-share // warps))
            if warps > 1 and steps < 2:
                continue
            for st in sorted({steps, min(steps, 8), min(steps, 4)}):
                out.append(rg_ops.Plan("split", cluster, warps, st))
    return list(dict.fromkeys(out))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("rglru_bench: no CUDA device")
    sys.path.insert(0, str(args.src.resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.rglru import ops as rg_ops
    from repro_torch.kernels.rglru import ref as rg_ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    build.build_all()
    cs.log(f"[rglru_bench] {rg_ops.__file__} on {smi}")
    if args.ptxas:
        out = subprocess.run(
            [build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             "/dev/null", str(build.CSRC / "rglru.cu")],
            capture_output=True, text=True)
        cs.log("[rglru_bench] ptxas:\n" + out.stdout + out.stderr)
    has_bwd = hasattr(rg_ops, "_launch_bwd")
    gen = torch.Generator(device="cuda").manual_seed(0)
    report = {"src": str(args.src), "card": smi, "cases": [], "sweep": []}
    for case, shape, with_h0 in cs.rglru_cases():
        for regime in cs.RGLRU_REGIMES:
            x, la, h0, dy = cs.rglru_inputs(shape, with_h0, regime, gen)
            h = rg_ref.rglru_ref(x, la, h0)
            row = {"case": case, "regime": regime}
            out = rg_ops.rglru_scan(x, la, h0)
            row["fwd_err"] = (out - h).abs().max().item()
            # timed before the checks below, so that two trees' times
            # follow the same work on the card
            t = (cs.rglru_times(x, la, h0, dy, plain=False) if has_bwd else
                 dict(ms=cs.time_ms(lambda: rg_ops.rglru_scan(x, la, h0))))
            if has_bwd:
                plan = rg_ops.plan_for(x)
                bplan = rg_ops.plan_for(x, backward=True)
                row["plan"], row["bwd_plan"] = list(plan), list(bplan)
                split = rg_ref.rglru_split_ref(x, la, h0, plan)
                row["fwd_bitwise_split"] = bool(torch.equal(out, split))
                got = torch.ops.repro_torch.rglru_scan_bwd(dy, la, h, h0)
                want = rg_ref.rglru_bwd(dy, la, h, h0)
                mirror = rg_ref.rglru_bwd_split_ref(dy, la, h, h0, bplan)
                row["bwd_rel_err"] = max(
                    (g - w).abs().max().item()
                    / max(1.0, w.abs().max().item())
                    for g, w in zip(got, want) if w is not None)
                row["bwd_bitwise_split"] = all(
                    bool(torch.equal(g, m)) for g, m in zip(got, mirror)
                    if m is not None)
            row.update(t)
            report["cases"].append(row)
            cs.log(f"[rglru_bench] {case} {regime}: " + ", ".join(
                f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
                for k, v in row.items() if k not in ("case", "regime")))
            if args.sweep and has_bwd and regime == "softplus":
                dx = rg_ref.rglru_bwd(dy, la, h, h0)[0]
                for plan in plans(rg_ops, shape):
                    split = plan.variant == "split"
                    f = rg_ops._launch(x, la, h0, plan)
                    e = (f - h).abs().max().item()
                    ms = cs.time_ms(lambda: rg_ops._launch(x, la, h0, plan))
                    bms = None
                    if split:
                        g = rg_ops._launch_bwd(dy, la, h, h0, plan)
                        e = max(e, (g[0] - dx).abs().max().item())
                        bms = cs.time_ms(
                            lambda: rg_ops._launch_bwd(dy, la, h, h0, plan))
                    report["sweep"].append(dict(case=case, plan=list(plan),
                                                ms=ms, bwd_ms=bms, err=e))
                    cs.log(f"[rglru_bench]   plan {tuple(plan)}: forward "
                           f"{ms:.4f} ms, backward "
                           + (f"{bms:.4f} ms" if split else "n/a")
                           + f", max_abs_err {e:.3e}")
            del x, la, h0, dy, h, out
    cs.log(json.dumps(report))


if __name__ == "__main__":
    main()
