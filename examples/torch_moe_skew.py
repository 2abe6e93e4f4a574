"""Irregular collectives on the PyTorch port: a skewed MoE all-to-all,
monitored per phase.

Expert-parallel MoE routes token buffers between ranks with an all-to-all;
when the router runs hot (one expert drawing most of the tokens), the
per-rank byte counts become *irregular* -- and a scalar per-op byte model
flattens the hot expert into the group mean.  This walkthrough captures a
small expert-parallel dispatch/combine program (one expert a rank, two
``all_to_all_single`` calls) on a fake 8-rank mesh, once as it is and
once with the measured routing skew entered through the capture's
``op_transform`` hook, and shows what reads the per-rank byte vector:

* the Table-2 summary (its skew column),
* the comm-matrix heatmap (the hot expert's row glows),
* the timed schedule (the collective finishes at the hot rank's pace),
* the ``skewed-a2a`` lint finding (priced against a balanced routing).

Run:  PYTHONPATH=src python examples/torch_moe_skew.py [--device cpu]

The mesh is ``cuda`` unless ``--device cpu`` is given; nothing is
allocated and no NCCL call runs either way (the capture runs under
``FakeTensorMode`` on a fake process group).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.core import MonitorSession, fake_mesh  # noqa: E402
from repro_torch.core.reporter import (ascii_heatmap, lint_table,  # noqa: E402
                                       primitive_usage_table)
from repro_torch.launch.serve import resolve_device  # noqa: E402
from repro_torch.sweep import hot_expert, moe_skew_step  # noqa: E402

N_EXPERTS = 8          # one expert per rank
CAP = 64               # tokens per (source, expert) capacity slot
D = 128                # token width
# hot_expert gives expert 0 sweep.MOE_SKEW_HOT (60%) of all tokens


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="the fake mesh's device type (cuda or cpu)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device).type

    mesh = fake_mesh((N_EXPERTS,), ("data",), device=dev)
    step = moe_skew_step(mesh.get_group("data"), N_EXPERTS, CAP, D)
    sess = MonitorSession(mesh=mesh, name="moe")
    with sess.fake_mode:
        tokens = torch.empty(N_EXPERTS, CAP, D, device=dev)
        wi = torch.empty(D, 2 * D, device=dev)
        wo = torch.empty(2 * D, D, device=dev)
    # the balanced baseline (no transform: scalar bytes), then the same
    # program with the measured hot routing
    with sess.phase("balanced"):
        sess.capture(step, tokens, wi, wo, name="moe_balanced")
    with sess.phase("skewed"):
        sess.capture(step, tokens, wi, wo, name="moe_skewed",
                     op_transform=hot_expert)

    for phase in ("balanced", "skewed"):
        view = sess.view(phase=phase)
        print()
        print(primitive_usage_table(view.summary, title=f"{phase} dispatch"))
        print()
        print(ascii_heatmap(view.matrix, title=f"{phase} comm matrix"))

    # the skewed phase's a2a finishes when rank 0 does; the balanced one
    # spreads the same bytes evenly
    bal = sess.view(phase="balanced").collective_seconds()
    skw = sess.view(phase="skewed").collective_seconds()
    print(f"\nmodeled collective time: balanced {bal * 1e6:.2f} us, "
          f"skewed {skw * 1e6:.2f} us "
          f"({skw / bal:.2f}x -- the hot rank is the straggler)")

    # the lint prices exactly that gap as the rebalancing savings
    findings = [f for f in sess.view().lint() if f.rule_id == "skewed-a2a"]
    print()
    print(lint_table(findings, title="skewed-a2a findings"))
    return findings


if __name__ == "__main__":
    main()
