"""Sweepable-config registry (port of the registry half of
``repro.sweep``): the paper's own applications -- the DDP microbenchmark,
GNMT and ResNet-18 -- as monitorable programs on a fake mesh.

A config's builder takes a ``DeviceMesh`` and returns ``dict(fn=, args=)``;
:func:`_monitor_cell` calls it under the session's ``FakeTensorMode``, so
its stand-ins allocate nothing, and captures ``fn(*args)``.  Each builder's
defaults are the reference's sweep sizes; ``launch.paper`` calls the same
builders at the paper configs' sizes.  The sweep engine itself (the report
cache, ``run_sweep``, ``--jobs``) waits for a later port slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import MonitorSession, fake_mesh
from repro_torch.models.common import (Spec, param_shapes, tree_leaves,
                                      tree_unflatten)
from repro_torch.models.gnmt import GNMT
from repro_torch.models.resnet import ResNet18
from repro_torch.train import ddp

DEFAULT_MESHES = ("4x2",)
BUCKET_MB = 1.0          # the paper apps' gradient buckets (all three cells)

# ---------------------------------------------------------------------------
# mesh specs
# ---------------------------------------------------------------------------
_MESH_AXES = {1: ("data",), 2: ("data", "model"), 3: ("pod", "data", "model")}


def parse_mesh(spec: str):
    """``"8"`` -> (8,) data  |  ``"4x2"`` -> (4,2) data,model  |
    ``"2x2x2"`` -> (2,2,2) pod,data,model."""
    shape = tuple(int(p) for p in spec.lower().split("x"))
    if len(shape) not in _MESH_AXES:
        raise ValueError(f"mesh spec {spec!r}: want 1-3 'x'-separated ints")
    return shape, _MESH_AXES[len(shape)]


def mesh_id(spec: str) -> str:
    shape, axes = parse_mesh(spec)
    return "x".join(map(str, shape)) + ":" + ",".join(axes)


def build_mesh(spec: str, device: str = "cuda"):
    """A ``DeviceMesh`` of ``spec`` over the fake process group."""
    shape, axes = parse_mesh(spec)
    return fake_mesh(shape, axes, device=device)


# ---------------------------------------------------------------------------
# sweepable-config registry
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """One sweepable workload: ``build(mesh)`` returns ``dict(fn=, args=,
    kwargs=)``, called under the capturing session's ``FakeTensorMode``."""

    name: str
    description: str
    version: str                 # part of the cache key: bump to invalidate
    build: Callable              # (mesh) -> dict(fn=, args=, kwargs=)

    @property
    def config_id(self) -> str:
        return f"{self.name}/{self.version}"


def _data_axis_size(mesh) -> int:
    if "data" not in mesh.mesh_dim_names:
        raise ValueError(f"config needs a 'data' mesh axis; got "
                         f"{tuple(mesh.mesh_dim_names)}")
    return mesh.size(mesh.mesh_dim_names.index("data"))


def _replica_group(mesh):
    """The process group of data parallelism: ``data``'s, or on a mesh
    with a ``pod`` axis the flattened ``(pod, data)`` submesh's, so the
    gradient all-reduce crosses pods."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    _data_axis_size(mesh)
    if "pod" not in mesh.mesh_dim_names:
        return mesh.get_group("data")
    with unset_fake_temporarily():     # the mesh's rank table is real
        return mesh["pod", "data"]._flatten().get_group()


def _f32(*shape, device):
    return torch.empty(shape, dtype=torch.float32, device=device)


def mlp_loss(params, batch):
    """The microbenchmark's 2-layer MLP regression loss."""
    h = torch.tanh(batch["x"] @ params["w1"] + params["b1"])
    return ((h @ params["w2"] - batch["y"]) ** 2).mean(), {}


def mlp_specs(d: int):
    """The microbenchmark's parameters: (d, 4d), (4d,), (4d, d)."""
    return {"w1": Spec((d, 4 * d), (None, "mlp")),
            "b1": Spec((4 * d,), ("mlp",), init="zeros"),
            "w2": Spec((4 * d, d), ("mlp", None))}


def _build_paper(mesh, d: int = 256, per_rank_batch: int = 4):
    """Paper §4 microbenchmark: DDP 2-layer MLP, bucketed all-reduce over
    the replica group (``("pod", "data")`` on a 3-axis mesh)."""
    group = _replica_group(mesh)
    dev = mesh.device_type
    step = ddp.make_ddp_train_step(mlp_loss, group, mode="bucketed",
                                   bucket_mb=BUCKET_MB)
    params = param_shapes(mlp_specs(d), device=dev)
    batch = {"x": _f32(per_rank_batch, d, device=dev),
             "y": _f32(per_rank_batch, d, device=dev)}
    return {"fn": step, "args": (params, ddp.init_error_feedback(params),
                                 batch)}


def broadcast_params(params, group):
    """The startup Broadcast of the paper's GNMT app, modelled as the
    reference models it: an all-gather of each parameter over ``group``,
    then rank 0's copy."""
    with torch.no_grad():
        return tree_unflatten(params, [
            ddp.all_gather(p, group)[:p.shape[0]]
            for p in tree_leaves(params)])


def gnmt_step(loss_fn: Callable, group, lr: float):
    """One DDP step of the GNMT app: gradients, bucketed all-reduce, SGD.
    No loss average (the epoch gathers the step losses at its end).
    Returns ``step(params, batch) -> (params, loss)``."""

    def step(params, batch):
        (loss, _), grads = ddp.value_and_grad(loss_fn, params, batch)
        grads, _ = ddp.allreduce_bucketed(grads, group, bucket_mb=BUCKET_MB)
        return ddp.sgd(params, grads, lr), loss

    return step


def gather_metrics(losses, group):
    """The epoch's metrics all-gather of the step losses."""
    return ddp.all_gather(torch.stack(losses), group)


def _build_gnmt(mesh, vocab: int = 1024, d: int = 64, layers: int = 2,
                steps: int = 4, seq: int = 16, per_rank_batch: int = 2):
    """Paper §4.1 app: a data-parallel GNMT epoch (startup broadcast,
    ``steps`` DDP steps, metrics all-gather).  The reference scans the
    steps and so traces one step's all-reduces; this loop issues every
    step's."""
    group = _replica_group(mesh)
    dev = mesh.device_type
    model = GNMT(vocab=vocab, d=d, layers=layers)
    one = gnmt_step(model.loss_fn, group, lr=1e-2)

    def epoch(params, batches):
        params = broadcast_params(params, group)
        losses = []
        for t in range(steps):
            params, loss = one(params, {k: v[t] for k, v in batches.items()})
            losses.append(loss)
        return params, gather_metrics(losses, group)

    batches = {k: torch.empty((steps, per_rank_batch, seq),
                              dtype=torch.int32, device=dev)
               for k in ("src", "tgt", "labels")}
    return {"fn": epoch, "args": (model.shapes(dev), batches)}


def _build_resnet(mesh, num_classes: int = 100, image_size: int = 32,
                  per_rank_batch: int = 2):
    """Paper §4.2 app: a ResNet-18 DDP step with PyTorch-style bucketing."""
    group = _replica_group(mesh)
    dev = mesh.device_type
    model = ResNet18(num_classes=num_classes)
    step = ddp.make_ddp_train_step(model.loss_fn, group, mode="bucketed",
                                   bucket_mb=BUCKET_MB)
    params = model.shapes(dev)
    batch = {"images": _f32(per_rank_batch, image_size, image_size, 3,
                            device=dev),
             "labels": torch.empty((per_rank_batch,), dtype=torch.int32,
                                   device=dev)}
    return {"fn": step, "args": (params, ddp.init_error_feedback(params),
                                 batch)}


def _registry() -> dict[str, SweepSpec]:
    specs = [
        SweepSpec("paper", "paper §4 DDP microbenchmark (2-layer MLP, "
                  "bucketed AllReduce)", "v2:d=256,bucket=1,pod-dp",
                  _build_paper),
        SweepSpec("gnmt", "paper §4.1 GNMT machine translation, DDP epoch "
                  "(broadcast + AllReduce + AllGather)",
                  "v1:d=64,layers=2,steps=4", _build_gnmt),
        SweepSpec("resnet", "paper §4.2 ResNet-18 image classification, DDP "
                  "step (PyTorch-style bucketing)",
                  "v1:classes=100,bucket=1", _build_resnet),
    ]
    return {s.name: s for s in specs}


def available_configs() -> dict[str, SweepSpec]:
    """Name -> spec for every sweepable config of the port."""
    return _registry()


def _monitor_cell(build: Callable, mesh, name: str,
                  algorithm: str = "ring"):
    """Monitor one cell: ``build(mesh)`` under the session's fake mode,
    then one capture of its ``fn(*args, **kwargs)``.  Returns the :class:`~repro_torch.core.CommReport`."""
    sess = MonitorSession(mesh=mesh, name=name, algorithm=algorithm)
    with sess.fake_mode:
        built = build(mesh)
    sess.capture(built["fn"], *built.get("args", ()), name=name,
                 **built.get("kwargs", {}))
    return sess.report()


__all__ = ["DEFAULT_MESHES", "SweepSpec", "available_configs",
           "build_mesh", "mesh_id", "parse_mesh"]
