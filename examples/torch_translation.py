"""Paper §4.1 on the PyTorch port: a machine-translation model (GNMT-style),
data-parallel and monitored **per phase**, with per-primitive communication
matrices (paper Fig. 3) and the Table-2 breakdown split fwd / bwd / optim.

Trains the seq2seq model on a synthetic copy-reverse task (AdamW, gradients
all-reduced in the paper's 1 MiB DDP buckets) until it learns, then
monitors the step as a three-phase :class:`~repro_torch.core.session.
MonitorSession` on a fake 8-rank ``data`` mesh, each rank a shard of the
batch:

* ``fwd``   -- loss forward pass (+ the loss-average all-reduce),
* ``bwd``   -- backward pass with the paper's bucketed gradient AllReduce,
* ``optim`` -- the AdamW update (local math: zero collectives -- visible as
  an empty row in the per-phase table, the point the paper's Table 2 cannot
  make because NCCL interception sees the whole step as one blob).

The training runs on one device, the whole global batch on one rank of a
process group of its own (NCCL on the card, gloo on the CPU), destroyed
before the capture; the capture allocates nothing and runs no NCCL call.

Run:  PYTHONPATH=src python examples/torch_translation.py [--steps 150] \\
          [--device cpu]
"""
import argparse
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.core import MonitorSession, fake_mesh  # noqa: E402
from repro_torch.data import SyntheticSeq2Seq  # noqa: E402
from repro_torch.launch.paper import open_group  # noqa: E402
from repro_torch.launch.serve import resolve_device  # noqa: E402
from repro_torch.models import GNMT  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_unflatten  # noqa: E402
from repro_torch.optim import OptConfig, apply_updates, init_opt_state  # noqa: E402
from repro_torch.train import ddp  # noqa: E402

REPLICAS = 8      # the monitored mesh's data-parallel ranks


def train(model, data, ocfg, steps: int, dev, group) -> dict:
    """``steps`` data-parallel AdamW steps over ``group``.  Returns the
    losses and each step's ms after the first (host clock ending in a
    synchronize)."""
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    # drawn on the CPU from seed 0, so every device starts from the same
    # weights, then moved
    params = model.init(0, device="cpu")
    params = tree_unflatten(params, [p.to(dev) for p in tree_leaves(params)])
    opt = init_opt_state(params, ocfg)

    def step(params, opt, i, batch):
        (loss, _), grads = ddp.value_and_grad(model.loss_fn, params, batch)
        # the paper's DDP pattern: bucketed AllReduce of every gradient
        grads, _ = ddp.allreduce_bucketed(grads, group, bucket_mb=1.0)
        loss = ddp.pmean(loss, group)
        params, opt, _ = apply_updates(params, grads, opt, ocfg, i)
        return params, opt, loss

    losses, step_ms = [], []
    for i in range(steps):
        batch = data.batch_at(i, dev)
        sync()
        t = time.perf_counter()
        params, opt, loss = step(params, opt, i, batch)
        losses.append(float(loss))
        if i:
            step_ms.append((time.perf_counter() - t) * 1e3)
        if i % 25 == 0 or i == steps - 1:
            print(f"step {i:4d} loss {losses[-1]:.4f}", flush=True)
    return {"losses": losses, "step_ms": step_ms,
            "median_step_ms": statistics.median(step_ms) if step_ms else None}


def monitor(model, data, ocfg, dev):
    """One step, captured in three phases on a fake ``REPLICAS``-rank data
    mesh: each rank's shard of the batch, stand-ins for the parameters,
    gradients and optimizer state (nothing is allocated)."""
    mesh = fake_mesh((REPLICAS,), ("data",), device=dev.type)
    group = mesh.get_group("data")

    def fwd(params, batch):
        loss, _ = model.loss_fn(params, batch)
        return ddp.pmean(loss, group)

    def bwd(params, batch):
        _, grads = ddp.value_and_grad(model.loss_fn, params, batch)
        grads, _ = ddp.allreduce_bucketed(grads, group, bucket_mb=1.0)
        return grads

    def optim(params, grads, opt, i):
        params, opt, _ = apply_updates(params, grads, opt, ocfg, i)
        return params, opt

    session = MonitorSession(mesh=mesh, name="GNMT-MT")
    with session.fake_mode:
        params = model.shapes(dev.type)
        grads_like = model.shapes(dev.type)   # the grads' shapes
        opt = init_opt_state(params, ocfg)
        per_rank = data.global_batch // REPLICAS
        batch = {k: torch.empty((per_rank, data.src_len), dtype=torch.int32,
                                device=dev.type)
                 for k in ("src", "tgt", "labels")}
        step0 = torch.zeros((), dtype=torch.int32, device=dev.type)
    with session.phase("fwd"):
        session.capture(fwd, params, batch)
    with session.phase("bwd"):
        session.capture(bwd, params, batch)
    with session.phase("optim"):
        session.capture(optim, params, grads_like, opt, step0)
    return session.report()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    model = GNMT(vocab=64, d=128, layers=2)
    data = SyntheticSeq2Seq(vocab_size=64, src_len=12, tgt_len=12,
                            global_batch=32)
    ocfg = OptConfig(peak_lr=3e-3, warmup_steps=10,
                     decay_steps=max(500, args.steps))

    group = open_group(dev)
    try:
        res = train(model, data, ocfg, args.steps, dev, group)
    finally:
        dist.destroy_process_group()
    l0, loss = res["losses"][0], res["losses"][-1]
    assert loss < l0 * 0.7, "translation model failed to learn"

    # ------------------------------------------------------------------
    # one monitored step, split into its phases: fwd / bwd / optim
    # ------------------------------------------------------------------
    rep = monitor(model, data, ocfg, dev)
    print()
    print(rep.phase_table())               # Table 2, per phase
    print()
    print(rep.phase_diff("fwd", "bwd"))    # where the bytes come from
    for phase in rep.phase_names():
        view = rep.view(phase=phase)
        if view.total_wire_bytes() == 0:
            print(f"\nphase {phase}: no collective communication "
                  "(local math only)")
            continue
        print()
        print(rep.heatmap(phase=phase))
    os.makedirs("artifacts", exist_ok=True)
    rep.save("artifacts/torch_translation_report.json")
    print(f"\ntranslation example OK (loss {l0:.3f} -> {loss:.3f})")
    return dict(res, report=rep)


if __name__ == "__main__":
    main()
