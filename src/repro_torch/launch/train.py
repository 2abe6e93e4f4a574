"""Training entry point: LM training on one GPU with deterministic data,
checkpoint/resume and async checkpoints, then the monitored communication
of the same train step on a fake mesh (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch recurrentgemma_2b --steps 10 --global-batch 8 \\
        --seq-len 1024 --microbatches 8
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --device cpu --steps 4 --ckpt-dir /tmp/ck --resume --report r.json

It builds ``--arch`` (``qwen3_8b`` or ``recurrentgemma_2b``) at its
published width and depth (``--layers`` cuts the depth, ``--reduced``
takes the test-scale config), fp32 parameters from ``--seed`` drawn on the
device, AdamW (peak ``--lr``, 10 warm-up steps, cosine decay over
``max(100, --steps)``), and trains ``--steps`` steps of
``SyntheticLMData`` through the port's kernels on ``--device`` (default
``cuda``; there is no quiet fallback to the CPU).  It prints the
reference's ``[train] step ... loss ... lr ... gnorm`` lines and ``done:
loss a -> b``, and the median step time (steps after the first), tokens/s
and peak memory.  With ``--ckpt-dir`` it saves every ``--ckpt-every`` steps
on a background thread; ``--resume`` restarts from the latest checkpoint.

Where it differs from the reference: the reference trains live on a forced
2x2 host mesh under GSPMD and always takes the reduced config.  The port
trains live on one device (``Sharder()``), then captures the same train
step on a fake ``--mesh`` (default ``2x2``, data x model) under
``FakeTensorMode``, as ``launch.serve`` and ``launch.paper`` do; it trains
first because the fake process group refuses a second world size in one
process.  ``--report`` saves the capture's schema-v9 report, which both
packages load.
"""
from __future__ import annotations

import argparse
import statistics
import time
from typing import Callable, Optional

import torch

from repro_torch import sweep
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint)
from repro_torch.core import fake_mesh
from repro_torch.data import SyntheticLMData, host_transfer_log
from repro_torch.launch.serve import model_config, resolve_device
from repro_torch.models import build_model
from repro_torch.optim import OptConfig
from repro_torch.parallel import Sharder
from repro_torch.train import TrainConfig, init_train_state, make_train_step

WARMUP_STEPS = 10     # the reference launcher's warm-up


def opt_config(lr: float, steps: int) -> OptConfig:
    """The reference launcher's schedule: 10 warm-up steps, cosine decay
    over ``max(100, steps)``."""
    return OptConfig(peak_lr=lr, warmup_steps=WARMUP_STEPS,
                     decay_steps=max(100, steps))


def train(cfg, *, steps: int, global_batch: int, seq_len: int,
          ocfg: OptConfig, tcfg: TrainConfig, seed: int = 0,
          device: str = "cuda", ckpt_dir: str = "", ckpt_every: int = 20,
          resume: bool = False, state: Optional[dict] = None,
          log: Callable[[str], None] = print) -> dict:
    """Train ``cfg`` for steps ``[start, steps)`` on ``device``: from
    ``state`` when given, else from the latest checkpoint with ``resume``,
    else from fresh parameters drawn from ``seed`` on the device.

    Each step is timed on the host clock ending in a synchronize.  Returns
    the losses, grad norms and lrs of the steps run, their times, the
    median step ms and tokens/s over the steps after the first, peak
    memory (``None`` on the CPU), the first step run, and the model and
    final state."""
    dev = resolve_device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    model = build_model(cfg)
    if state is None:
        state = init_train_state(model, ocfg, seed, device=dev)
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=seq_len,
                           global_batch=global_batch, seed=seed)
    step_fn = make_train_step(model, ocfg, tcfg, Sharder())

    start, ckpt = 0, None
    if ckpt_dir:
        ckpt = AsyncCheckpointer(ckpt_dir)
        last = latest_step(ckpt_dir) if resume else None
        if last is not None:
            state = restore_checkpoint(ckpt_dir, last, state)
            start = last
            log(f"[train] resumed from step {last}")

    out = {"losses": [], "grad_norms": [], "lrs": [], "step_ms": []}
    t0 = time.perf_counter()
    for step in range(start, steps):
        batch = data.batch_at(step, dev)
        sync()
        ts = time.perf_counter()
        state, metrics = step_fn(state, batch)
        sync()
        out["step_ms"].append((time.perf_counter() - ts) * 1e3)
        for key, name in (("losses", "loss"), ("grad_norms", "grad_norm"),
                          ("lrs", "lr")):
            out[key].append(float(metrics[name]))
        if step % 10 == 0 or step == steps - 1:
            log(f"[train] step {step:5d} loss {out['losses'][-1]:.4f} "
                f"lr {out['lrs'][-1]:.2e} gnorm {out['grad_norms'][-1]:.3f} "
                f"({time.perf_counter() - t0:.1f}s)")
        if ckpt and (step + 1) % ckpt_every == 0:
            ckpt.save(step + 1, state)
    if ckpt:
        ckpt.wait()
    timed = out["step_ms"][1:]
    median = statistics.median(timed) if timed else None
    return dict(
        out, start=start, model=model, state=state, median_step_ms=median,
        tokens_per_s=(global_batch * seq_len / (median / 1e3)
                      if median else None),
        max_memory_bytes=(torch.cuda.max_memory_allocated(dev)
                          if dev.type == "cuda" else None))


def monitor(cfg, *, ocfg: OptConfig, tcfg: TrainConfig, mesh_shape=(2, 2),
            global_batch: int, seq_len: int, device: str = "cuda",
            name: str = ""):
    """One train step captured on a fake ``data x model`` mesh under
    ``FakeTensorMode`` (nothing allocated), with the data's host transfers.
    Returns the session's :class:`~repro_torch.core.CommReport`."""
    dev = resolve_device(device)
    names = ("data", "model")[:len(mesh_shape)]
    mesh = fake_mesh(mesh_shape, names, device=dev.type)

    def build(m):
        cell = sweep.train_cell(m, cfg, global_batch=global_batch,
                                seq_len=seq_len, opt_cfg=ocfg,
                                train_cfg=tcfg)
        # capture(..., host_transfers=) fills the matrix's host row
        return dict(cell, kwargs={"host_transfers": host_transfer_log()})

    return sweep._monitor_cell(build, mesh, name or f"train[{cfg.name}]")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="recurrentgemma_2b",
                    choices=("qwen3_8b", "recurrentgemma_2b"))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh", default="2x2",
                    help="monitored fake mesh, data x model")
    ap.add_argument("--report", default="", help="write the report here")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: published)")
    ap.add_argument("--reduced", action="store_true",
                    help="the architecture's test-scale config")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = model_config(args.arch, args.layers or None, args.reduced)
    ocfg = opt_config(args.lr, args.steps)
    tcfg = TrainConfig(microbatches=args.microbatches)
    res = train(cfg, steps=args.steps, global_batch=args.global_batch,
                seq_len=args.seq_len, ocfg=ocfg, tcfg=tcfg, seed=args.seed,
                device=args.device, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, resume=args.resume)
    losses, mem = res["losses"], res["max_memory_bytes"]
    if res["median_step_ms"]:
        print(f"[train] {cfg.name} {cfg.n_layers}L on {args.device}: median "
              f"step {res['median_step_ms']:.2f} ms, "
              f"{res['tokens_per_s']:.1f} tokens/s"
              + (f", max memory {mem / 2**30:.2f} GiB" if mem else ""))
    del res["state"]           # free the live state before the capture

    shape = tuple(int(x) for x in args.mesh.split("x"))
    rep = monitor(cfg, ocfg=ocfg, tcfg=tcfg, mesh_shape=shape,
                  global_batch=args.global_batch, seq_len=args.seq_len,
                  device=args.device, name=f"train[{args.arch}]")
    print(rep.render())
    if args.report:
        rep.save(args.report)
    if losses:
        print(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    else:
        print(f"[train] nothing to do (resumed at step {res['start']})")
    return losses


if __name__ == "__main__":
    main()
