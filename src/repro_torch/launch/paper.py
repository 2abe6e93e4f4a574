"""Entry point of the paper's applications: DDP training on one GPU, then
the monitored communication of one step on a fake 8-rank mesh.

    PYTHONPATH=src python -m repro_torch.launch.paper --app resnet
    PYTHONPATH=src python -m repro_torch.launch.paper --app gnmt \\
        --steps 10 --report gnmt_report.json
    PYTHONPATH=src python -m repro_torch.launch.paper --app paper \\
        --device cpu

``--app`` is one of the applications *Monitoring Collective Communication
Among GPUs* evaluates, at the repo's paper configs' sizes:

* ``paper``  -- the DDP microbenchmark, a 2-layer MLP of width 256, global
  batch 32 of synthetic regression pairs;
* ``gnmt``   -- GNMT (``configs.paper.gnmt_model()``: vocab 4096, d 256, 2
  layers) on ``GNMT_DATA`` (source and target 48 tokens, global batch 32);
  a startup Broadcast (all-gather, then rank 0's copy), DDP steps, and an
  all-gather of the step losses at the end;
* ``resnet`` -- ResNet-18 at its published widths, 200 classes, on
  ``RESNET_DATA`` (global batch 64 of 64x64 images).

First it trains ``--steps`` DDP steps in fp32 on ``--device`` (default
``cuda``; there is no quiet fallback to the CPU), the whole global batch on
this one rank, with the port's explicit 1 MiB gradient buckets over a
one-rank process group (NCCL on the card, gloo on the CPU), from random
weights drawn on the CPU from ``--seed``.  It prints the median step time
after one warm-up step, samples/s and peak memory.  It destroys that group,
then captures one step of the same program on a fake ``--mesh`` (default 8,
data) under ``FakeTensorMode`` -- each rank's shard of the global batch --
and prints the per-primitive tables and the ``(d+1)^2`` heatmap (the
paper's Tables 2/3 and Figs. 2/3).  ``--report`` saves the schema-v9 report
both packages load.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import sweep
from repro_torch.configs import paper as paper_cfg
from repro_torch.core.interceptor import CollectiveInterceptor
from repro_torch.data import SyntheticImageData, SyntheticSeq2Seq
from repro_torch.launch.serve import resolve_device
from repro_torch.models.common import init_params, tree_leaves, tree_unflatten
from repro_torch.train import ddp

APPS = ("paper", "gnmt", "resnet")
MLP_WIDTH, MLP_BATCH = 256, 32


@dataclasses.dataclass
class MLPData:
    """Synthetic regression pairs for the microbenchmark: ``y = sin(x)``,
    drawn with numpy from ``(seed, step)``."""

    d: int
    global_batch: int
    seed: int = 0

    def batch_at(self, step: int, device="cuda") -> dict:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        x = rng.standard_normal((self.global_batch, self.d)).astype(
            np.float32)
        return {"x": torch.from_numpy(x).to(device),
                "y": torch.from_numpy(np.sin(x)).to(device)}


@dataclasses.dataclass
class App:
    """One application: its parameters, data, learning rate, live step
    and monitored program."""

    name: str
    specs: object                # the parameter specs
    loss_fn: Callable            # (params, batch) -> (loss, metrics)
    data: object                 # .batch_at(step, device), .global_batch
    lr: float
    build: Callable              # (mesh, per_rank_batch) -> dict(fn=, args=)

    def step_fn(self, group) -> Callable:
        """``step(params, batch) -> (params, loss)`` over ``group``: the
        GNMT epoch's inner step, or :func:`ddp.make_ddp_train_step`'s (its
        loss averaged over the group)."""
        if self.name == "gnmt":
            return sweep.gnmt_step(self.loss_fn, group, self.lr)
        step = ddp.make_ddp_train_step(self.loss_fn, group,
                                       bucket_mb=sweep.BUCKET_MB, lr=self.lr)
        return lambda params, batch: step(params, None, batch)[::2]


def make_app(name: str, seed: int = 0) -> App:
    if name == "paper":
        return App(name, sweep.mlp_specs(MLP_WIDTH), sweep.mlp_loss,
                   MLPData(MLP_WIDTH, MLP_BATCH, seed), 1e-3,
                   lambda mesh, b: sweep._build_paper(
                       mesh, d=MLP_WIDTH, per_rank_batch=b))
    if name == "gnmt":
        model, data = paper_cfg.gnmt_model(), paper_cfg.GNMT_DATA
        return App(name, model.specs(), model.loss_fn,
                   SyntheticSeq2Seq(**data, seed=seed), 1e-2,
                   lambda mesh, b: sweep._build_gnmt(
                       mesh, vocab=model.vocab, d=model.d,
                       layers=model.layers, steps=1, seq=data["src_len"],
                       per_rank_batch=b))
    if name == "resnet":
        model, data = paper_cfg.resnet18_model(), paper_cfg.RESNET_DATA
        return App(name, model.specs(), model.loss_fn,
                   SyntheticImageData(**data, seed=seed), 2e-2,
                   lambda mesh, b: sweep._build_resnet(
                       mesh, num_classes=model.num_classes,
                       image_size=data["image_size"], per_rank_batch=b))
    raise ValueError(f"unknown app {name!r}; want one of {APPS}")


def open_group(device) -> dist.ProcessGroup:
    """A one-rank process group for training: NCCL on the card, gloo on
    the CPU.  The caller destroys it (``dist.destroy_process_group()``)."""
    dev = torch.device(device)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            world_size=1, rank=0, store=dist.HashStore())
    return dist.group.WORLD


def init_app_params(app: App, seed: int, device):
    """Random fp32 parameters drawn on the CPU from ``seed`` (so every
    device starts from the same values), then moved to ``device``."""
    params = init_params(app.specs, torch.Generator().manual_seed(seed),
                         device="cpu")
    return tree_unflatten(params, [p.to(device) for p in tree_leaves(params)])


def train(app: App, group, *, steps: int = 10, device="cuda",
          seed: int = 0) -> dict:
    """``steps`` DDP steps of ``app`` on ``device`` over ``group``.

    Step 1 is the warm-up: it runs under the collective interceptor, which
    counts the all-reduces one step issues, and its updated parameters are
    kept (on the CPU) for comparison with another device.  Steps 2.. are
    timed one by one, each ending in a synchronize.  Returns the losses,
    step times, their median, samples/s, peak memory (``None`` on the
    CPU), the all-reduces of one step and the first step's parameters."""
    dev = resolve_device(str(device))
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = init_app_params(app, seed, dev)
    step = app.step_fn(group)
    if app.name == "gnmt":
        params = sweep.broadcast_params(params, group)
    with CollectiveInterceptor() as icpt:
        params, loss = step(params, app.data.batch_at(0, dev))
        sync()
    losses, times = [loss], []
    first = tree_unflatten(params, [p.detach().cpu()
                                    for p in tree_leaves(params)])
    for i in range(1, steps):
        batch = app.data.batch_at(i, dev)
        sync()
        t0 = time.perf_counter()
        params, loss = step(params, batch)
        sync()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
    if app.name == "gnmt":
        sweep.gather_metrics(losses, group)
    step_ms = statistics.median(times) * 1e3 if times else None
    return {
        "losses": [float(v) for v in losses],
        "step_ms": [t * 1e3 for t in times],
        "median_step_ms": step_ms,
        "samples_per_s": (app.data.global_batch / (step_ms / 1e3)
                          if step_ms else None),
        "max_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                             if dev.type == "cuda" else None),
        "allreduce_calls": sum(op.kind == "all-reduce" for op in icpt.ops),
        "first_params": first,
    }


def monitor(app: App, *, mesh_spec: str = "8", device="cuda"):
    """One step of ``app`` captured on a fake ``mesh_spec`` mesh (each
    replica takes its shard of the global batch) under
    ``FakeTensorMode``: nothing is allocated.  GNMT's capture is its epoch
    of one step: broadcast, the step, the metrics all-gather."""
    dev = resolve_device(str(device))
    mesh = sweep.build_mesh(mesh_spec, device=dev.type)
    shape, axes = sweep.parse_mesh(mesh_spec)
    replicas = shape[axes.index("data")] * (
        shape[axes.index("pod")] if "pod" in axes else 1)
    per_rank = app.data.global_batch // replicas
    return sweep._monitor_cell(lambda m: app.build(m, per_rank), mesh,
                               f"{app.name}[{mesh_spec}]")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--app", default="resnet", choices=APPS)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default="8",
                    help="monitored fake mesh: 8 (data), 4x2 (data x "
                         "model) or 2x2x2 (pod x data x model)")
    ap.add_argument("--report", default="", help="save the report here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    app = make_app(args.app, args.seed)
    group = open_group(resolve_device(args.device))
    try:
        res = train(app, group, steps=args.steps, device=args.device,
                    seed=args.seed)
    finally:
        dist.destroy_process_group()
    mem = res["max_memory_bytes"]
    print(f"[train] {app.name} on {args.device}, {args.steps} DDP steps of "
          f"global batch {app.data.global_batch}: loss {res['losses'][0]:.4f}"
          f" -> {res['losses'][-1]:.4f} | median step "
          + (f"{res['median_step_ms']:.2f} ms, "
             f"{res['samples_per_s']:.1f} samples/s"
             if res["median_step_ms"] else "n/a")
          + (f" | max memory {mem / 2**30:.2f} GiB" if mem else "")
          + f" | {res['allreduce_calls']} all-reduces a step")

    rep = monitor(app, mesh_spec=args.mesh, device=args.device)
    print(rep.logical_table())
    print(rep.usage_table())
    print(rep.heatmap())
    if args.report:
        rep.save(args.report)
        print(f"[train] report saved to {args.report}")
    return res, rep


if __name__ == "__main__":
    main()
