#!/usr/bin/env python3
"""Time the RMSNorm kernel of a source tree at the serve paths' shapes on one
NVIDIA GPU.

    python3 tools/rmsnorm_bench.py [--src DIR] [--sweep]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (by
default this checkout's), for example that of an unpacked ``git archive`` of
another commit, so that two versions of the kernel are timed in one run on
one card.  For each of ``chip_smoke.py``'s bf16 serve-path RMSNorm cases
(prefill and decode rows of Qwen3-8B and RecurrentGemma-2B, Qwen's qk-norm
rows) it prints the wrapper's median time, warm (the same input every
launch) and, for the prefill shapes, cold (inputs rotated through more than
the L2 cache), beside the bytes bound, the plain version's and
``F.rms_norm``'s times and the error against the plain version; then the
launch floor (an 8-element in-place add).  ``--sweep`` also times every
launch plan the lanes and block kernels take at each shape (this checkout's
wrapper only), each checked against the plain version.  The last line is
one JSON object with every number.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("rmsnorm_bench: no CUDA device")
    sys.path.insert(0, str(args.src.resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.rmsnorm import ops as rn_ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    build.build_all()
    cs.log(f"[rmsnorm_bench] {rn_ops.__file__} on {smi}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    report = {"src": str(args.src), "card": smi, "cases": [], "sweep": []}
    for case, shape, dtype, kind, offset in cs.rmsnorm_cases():
        if kind not in ("prefill", "decode"):
            continue
        prefill = kind == "prefill"
        x, w = cs.rmsnorm_inputs(shape, dtype, offset, gen)
        ref = rmsnorm_ref(x, w, 1e-6).float()
        err = (rn_ops.rmsnorm(x, w, 1e-6).float() - ref).abs().max().item()
        t = dict(cs.rmsnorm_times(x, w, cold=prefill), case=case,
                 max_abs_err=err)
        report["cases"].append(t)
        cs.log(f"[rmsnorm_bench] {case}: kernel {t['ms']:.4f} ms"
               + (f" (cold {t['cold_ms']:.4f})" if prefill else "")
               + f" | bound {t['bound_ms']:.4g} ms | plain "
               f"{t['plain_ms']:.4f} ms | F.rms_norm {t['library_ms']:.4f} ms"
               + (f" (cold {t['library_cold_ms']:.4f})" if prefill else "")
               + f" | max_abs_err {err:.3e}")
        if args.sweep:
            for plan in plans(rn_ops, x):
                out = rn_ops._launch(x, w, 1e-6, plan)
                e = (out.float() - ref).abs().max().item()
                ms = cs.time_ms(lambda: rn_ops._launch(x, w, 1e-6, plan))
                report["sweep"].append(dict(case=case, plan=plan._asdict(),
                                            ms=ms, max_abs_err=e))
                cs.log(f"[rmsnorm_bench]   plan {tuple(plan)}: {ms:.4f} ms, "
                       f"max_abs_err {e:.3e}"
                       + (" (the wrapper's)" if plan == rn_ops.plan_for(x, w)
                          else ""))
    report["launch_floor_ms"] = cs.launch_floor_ms()
    cs.log(f"[rmsnorm_bench] launch floor {report['launch_floor_ms']:.4f} ms "
           "(8-element in-place add, a library op)")
    print(json.dumps(report), flush=True)


def plans(rn_ops, x) -> list:
    """Every plan the lanes or block kernel takes for x's rows: the lanes
    kernel at each CTA size, the block kernel at each vector count a thread
    with 1 to 8 rows a CTA."""
    d = x.shape[-1]
    rows, nvec = x.numel() // d, d * x.element_size() // 16
    if nvec <= 32:
        lanes = 1 << (nvec - 1).bit_length()
        return [rn_ops.Plan("lanes", t, 1, t // lanes)
                for t in (32, 64, 128, 256)]
    out = []
    for vpt, cap in rn_ops.MAX_THREADS.items():
        threads = rn_ops._warps(-(-nvec // vpt))
        if threads <= cap:
            out += [rn_ops.Plan("block", threads, vpt, rpc)
                    for rpc in (1, 2, 4, 8) if rpc <= rows]
    return out


if __name__ == "__main__":
    main()
