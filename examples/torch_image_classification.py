"""Paper §4.2 on the PyTorch port: data-parallel ResNet-18 image
classification, monitored.

End-to-end example: REALLY trains ResNet-18 on synthetic images with the
port's explicit DDP gradient sync (bucketed all-reduce at 25 MiB with
error feedback), then explains the communication with the paper's Table-3
accounting: the all-reduces one step issues, counted by the collective
interceptor around the first step.  On one device the whole global batch
runs on one rank of a process group of its own (NCCL on the card, gloo on
the CPU), opened before the run and destroyed after it.

Run:  PYTHONPATH=src python examples/torch_image_classification.py \\
          [--steps 30] [--image-size 64] [--device cpu]

The paper uses 64x64 images (``--image-size 64``, what the card runs);
the default 32 keeps a CPU run short.
"""
import argparse
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.core.interceptor import CollectiveInterceptor  # noqa: E402
from repro_torch.data import SyntheticImageData  # noqa: E402
from repro_torch.launch.paper import open_group  # noqa: E402
from repro_torch.launch.serve import resolve_device  # noqa: E402
from repro_torch.models import ResNet18  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_unflatten  # noqa: E402
from repro_torch.train import ddp  # noqa: E402


def train(args, dev, group) -> dict:
    """``args.steps`` DDP steps over ``group``; the first runs under the
    interceptor.  Returns the losses, the last accuracy, the all-reduces
    a step and each timed step's ms (every step but the first, each ending
    in a synchronize)."""
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    model = ResNet18(num_classes=args.classes)
    # drawn on the CPU from seed 0, so every device starts from the same
    # weights, then moved
    params = model.init(0, device="cpu")
    params = tree_unflatten(params, [p.to(dev) for p in tree_leaves(params)])
    data = SyntheticImageData(num_classes=args.classes,
                              global_batch=args.batch,
                              image_size=args.image_size)
    ef = ddp.init_error_feedback(params)
    step = ddp.make_ddp_train_step(model.loss_fn, group, mode="bucketed",
                                   bucket_mb=25.0, lr=5e-2)

    def eval_acc(params, batch):
        with torch.no_grad():
            return float(model.loss_fn(params, batch)[1]["acc"])

    t0 = time.perf_counter()
    acc, losses, step_ms = None, [], []
    for i in range(args.steps):
        batch = data.batch_at(i, dev)
        sync()
        t = time.perf_counter()
        if i == 0:
            # count application-issued collectives exactly as the paper
            # does: the all-reduces of one step
            with CollectiveInterceptor() as icpt:
                params, ef, loss = step(params, ef, batch)
            ar_per_step = sum(op.kind == "all-reduce" for op in icpt.ops)
        else:
            params, ef, loss = step(params, ef, batch)
        loss = float(loss)  # a sync before anything else touches the device
        if i:
            step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(loss)
        if i % 10 == 0 or i == args.steps - 1:
            acc = eval_acc(params, batch)
            print(f"step {i:4d} loss {loss:.4f} acc {acc:.2f} "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
    return {"losses": losses, "acc": acc, "allreduce_calls": ar_per_step,
            "step_ms": step_ms,
            "median_step_ms": statistics.median(step_ms) if step_ms else None}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--classes", type=int, default=8)
    ap.add_argument("--image-size", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    group = open_group(dev)
    try:
        res = train(args, dev, group)
    finally:
        dist.destroy_process_group()
    ar_per_step, acc = res["allreduce_calls"], res["acc"]
    print(f"\nAllReduce calls per step (bucketed, 25 MiB): {ar_per_step}")
    print(f"-> one epoch of {args.steps} steps issues "
          f"{ar_per_step * args.steps} AllReduce calls "
          "(paper Table 3 accounting)")
    assert acc is not None and acc > 0.5, "model failed to learn"
    print("image classification example OK")
    return res


if __name__ == "__main__":
    main()
