"""Quickstart on the PyTorch port: monitor the collective communication of
any torch function over a device mesh.

The one-call workflow (paper Fig. 1, PyTorch edition):

    report = monitor_fn(step, *args, mesh=mesh)
    print(report.render())

The step here is the value and gradient of a 2-layer tensor-parallel MLP
on a fake (data 4, model 2) mesh: ``w1`` split by column over ``model``,
``w2`` by row, the batch over ``data``.  The inputs are DTensors made under
``FakeTensorMode`` and the mesh's process group is fake, so nothing is
allocated and no NCCL call runs: the capture works at any model size.  It
prints the report, the three-term roofline and writes the report as JSON,
HTML and a Perfetto timeline under ``artifacts/``.

Run:  python -m repro_torch monitor examples/torch_quickstart.py
(or directly: PYTHONPATH=src python examples/torch_quickstart.py; on a
machine without a GPU add ``--device cpu``, after ``--`` in the CLI form)
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.distributed.tensor import (Replicate, Shard,  # noqa: E402
                                      distribute_tensor)

from repro_torch.core import export, fake_mesh, monitor_fn, roofline_of  # noqa: E402
from repro_torch.launch.serve import resolve_device  # noqa: E402

OUT = "artifacts/torch_quickstart_report"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="the fake mesh's device type (cuda or cpu)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device).type

    # an 8-rank (data=4, model=2) mesh over a fake process group
    mesh = fake_mesh((4, 2), ("data", "model"), device=dev)

    def shard(t, *spec):
        """``t`` laid out as the reference's ``PartitionSpec(*spec)``: dim
        ``i`` split over the mesh axis ``spec[i]`` names, replicated over
        the others.  No data moves: each rank keeps its own slice."""
        return distribute_tensor(t, mesh, [
            Shard(spec.index(name)) if name in spec else Replicate()
            for name in mesh.mesh_dim_names], src_data_rank=None)

    # a model-parallel train step the user wants to understand
    def train_step(w1, w2, x):
        h = torch.relu(x @ w1)           # w1 column-sharded (TP)
        y = h @ w2                       # w2 row-sharded -> all-reduce
        return (y ** 2).mean()

    def value_and_grad(w1, w2, x):
        """The loss and its gradients in ``w1`` and ``w2``, laid out as the
        reference's jitted ``value_and_grad`` returns them: the loss
        replicated, each gradient split as its weight."""
        leaves = [w.detach().requires_grad_() for w in (w1, w2)]
        loss = train_step(*leaves, x)
        grads = torch.autograd.grad(loss, leaves)
        return (loss.redistribute(mesh, [Replicate()] * mesh.ndim),
                tuple(g.redistribute(mesh, w.placements)
                      for g, w in zip(grads, leaves)))

    # fake tensors: nothing is allocated -- works at any model size
    with FakeTensorMode():
        w1 = shard(torch.empty(1024, 4096, device=dev), None, "model")
        w2 = shard(torch.empty(4096, 1024, device=dev), "model", None)
        x = shard(torch.empty(512, 1024, device=dev), "data", None)
    report = monitor_fn(value_and_grad, w1, w2, x, mesh=mesh,
                        name="quickstart")

    print(report.render())

    # the three-term roofline of the capture's counted FLOPs and bytes
    rl = roofline_of(report, arch="2-layer-mlp", mesh_name="4x2",
                     model_flops=6 * (1024 * 4096 * 2) * 512)
    print()
    print(f"roofline: compute {rl.compute_s:.3e}s | memory "
          f"{rl.memory_s:.3e}s | collective {rl.collective_s:.3e}s")
    print(rl.one_liner())

    # persist + browser/Perfetto renderings via the export subsystem;
    # re-export later without capturing again:
    #   python -m repro_torch report artifacts/torch_quickstart_report.json
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    report.save(f"{OUT}.json")
    export.export_html(report, f"{OUT}.html")
    export.export_perfetto(report, f"{OUT}.trace.json")
    print(f"\nreport written to {OUT}.{{json,html,trace.json}}")
    return report, rl


if __name__ == "__main__":
    main()
