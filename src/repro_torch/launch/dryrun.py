"""Multi-pod dry run (port of ``repro.launch.dryrun``).

For every (architecture x input shape x mesh) cell this captures the real
step function (train step / prefill / decode) under ``FakeTensorMode`` on
a fake production mesh (:mod:`repro_torch.launch.mesh`) -- nothing is
allocated and no NCCL call runs -- and records:

* ``memory``: bytes per device, worked out from the fake tensors (below);
* ``cost``: the step's counted FLOPs and bytes, one device's
  (:mod:`repro_torch.core.op_cost`);
* the collectives the interceptor recorded, by kind; and
* the three-term roofline row (:func:`repro_torch.core.roofline.analyze`).

Usage (the CLI forwards ``python -m repro_torch dryrun ...`` here)::

    python -m repro_torch dryrun --arch qwen3_8b --shape decode_32k --mesh both
    python -m repro_torch dryrun --all --mesh both --skip-existing
    python -m repro_torch dryrun --arch qwen3_8b --shape train_4k --device cpu
    python -m repro_torch dryrun --arch qwen3_8b,granite_20b \
        --shape prefill_32k,decode_32k

Where the port differs from the reference:

* Eager torch has no compile step: ``compile_s`` is 0.0 and ``trace_s`` is
  the capture's seconds.
* ``memory`` is eager order, not XLA's buffer assignment.
  ``argument_bytes`` sums the local shards of the step's inputs (the state
  or parameters, the cache, the batch as ``batch_shardings`` lays it out);
  ``output_bytes`` the local shards of what the step returns;
  ``alias_bytes`` those of its outputs it updated in place (the train
  state, the decode cache); ``temp_bytes`` the peak of the storages the
  step allocated, alive at once (a ``TorchDispatchMode`` under DTensor
  adds each new storage's bytes and drops them when the storage dies, so
  autograd's saved tensors count until their backward), less the fresh
  outputs among them.  ``total_bytes`` is the reference's formula,
  ``argument + output + temp - alias``.
* The train step's microbatch loop runs in Python: its collectives are
  recorded once a microbatch, where the reference's HLO parser counts its
  scan body once.
* ``--save-hlo`` has no HLO to save: it writes the capture's recorded ops
  and traced events, ``<stem>.ops.json.gz``, in its place.
* The fake process group takes one world size a process, so the single-pod
  and multi-pod cells run in separate processes: ``--mesh both`` runs
  ``--mesh single`` and ``--mesh multi`` as children, and opens no
  process group itself.
* ``--sp`` is refused: the port's models keep the activations' ``seq``
  unsharded (the rotary positions, the q/k/v layouts), so a train or
  prefill step cannot take the Sharder's ``enable_sp`` rule (the
  reference's), and a decode step's one-token sequence would capture
  exactly as without it.
* ``--arch`` and ``--shape`` also take comma lists (every arch with every
  shape), so one process captures several cells of a mesh.
* Output goes to ``artifacts/dryrun_torch/``; the reference's
  ``artifacts/dryrun/`` is never written.
"""
from __future__ import annotations

import argparse
import dataclasses
import gzip
import json
import math
import os
import subprocess
import sys
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs
from repro_torch.core import roofline
from repro_torch.core.interceptor import CollectiveInterceptor
from repro_torch.core.op_cost import in_sharding_propagation
from repro_torch.core.topology import MeshTopology
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.models.common import SHAPES_BY_NAME, tree_leaves
from repro_torch.optim import OptConfig
from repro_torch.parallel import Sharder
from repro_torch.serve import ServeConfig, make_decode_step, make_prefill_step
from repro_torch.train.train import (batch_shardings, make_train_step,
                                     train_state_shapes,
                                     train_state_shardings)

ARTIFACT_DIR = str(Path(__file__).resolve().parents[3] / "artifacts"
                   / "dryrun_torch")
# how ``--mesh both`` starts a child for one mesh
CHILD = [sys.executable, "-m", "repro_torch", "dryrun"]


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t._local_tensor if isinstance(t, DTensor) else t


def _storage_key(t: torch.Tensor) -> int:
    return _local(t).untyped_storage()._cdata


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _local_bytes(t: torch.Tensor, shd: Sharder = None, axes=None) -> int:
    """One device's bytes of ``t``: its local shard for a DTensor; for a
    whole tensor that the step lays out by ``axes``, its share."""
    loc = _local(t)
    n = loc.numel() * loc.element_size()
    if axes is None or loc is not t:
        return n
    parts = math.prod(
        shd.axis_size(a) for e in shd.spec(t.shape, axes)
        for a in ((e,) if isinstance(e, str) else e or ()))
    return n // parts


class LiveBytes(TorchDispatchMode):
    """Peak bytes of the storages a step allocates, alive at once.

    Sees the local ops DTensor lowers to (it steps aside for a DTensor);
    each output storage not seen before, and not one of the ``external``
    storages (the step's arguments), adds its bytes; they drop when the
    last tensor of the step's that holds it dies (storages are keyed by
    address, so a key stays in ``held`` only while its storage lives).
    ``wait_tensor`` returns its input on a real process group, but a fresh
    fake tensor under ``FakeTensorMode``: the input's bytes move to the
    output's storage, so a collective's result is counted once.  The runs
    of DTensor's sharding propagator on global-shape stand-ins are no part
    of the program and are left out."""

    WAIT = torch.ops._c10d_functional.wait_tensor.default

    def __init__(self, external):
        super().__init__()
        self.external = set(external)
        self.held: dict[int, list] = {}     # storage -> [tensors, bytes]
        self.live = self.peak = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed._functional_collectives import \
            AsyncCollectiveTensor
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, (DTensor, AsyncCollectiveTensor))
               for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if not in_sharding_propagation():
            if func is self.WAIT:
                rec = self.held.get(_storage_key(args[0]))
                if rec is not None:
                    self.live -= rec[1]
                    rec[1] = 0
            for t in _tensors(out):
                self._note(t)
        return out

    def _note(self, t: torch.Tensor) -> None:
        key = _storage_key(t)
        if key in self.external:
            return
        rec = self.held.get(key)
        if rec is None:
            rec = self.held[key] = [0, t.untyped_storage().nbytes()]
            self.live += rec[1]
            self.peak = max(self.peak, self.live)
        rec[0] += 1
        weakref.finalize(t, self._drop, key)

    def _drop(self, key: int) -> None:
        rec = self.held[key]
        rec[0] -= 1
        if rec[0] == 0:
            self.live -= rec[1]
            del self.held[key]


def capture_cell(arch: str, shape_name: str, mesh, *, opt_name=None,
                 train_overrides=None) -> dict:
    """Capture one cell's step on ``mesh`` (the reference's
    ``lower_cell``).  Returns ``{"cfg", "shape", "model_flops", "ops",
    "events", "cost", "memory", "trace_s"}``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = configs.config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    model = build_model(cfg)
    shd = Sharder(mesh)
    dev = mesh.device_type
    b, s = shape.global_batch, shape.seq_len
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    with fake:
        batch = configs.input_specs(cfg, shape, dev)
        if shape.kind == "train":
            tcfg = configs.train_config(arch)
            if train_overrides:
                tcfg = dataclasses.replace(tcfg, **train_overrides)
            ocfg = OptConfig(name=opt_name or cfg.optimizer,
                             state_dtype=cfg.opt_state_dtype)
            step = make_train_step(model, ocfg, tcfg, shd)
            args = (shd.shard_tree(train_state_shapes(model, ocfg, dev),
                                   train_state_shardings(model, ocfg)),
                    batch)
            model_flops = roofline.train_model_flops(cfg.n_params_active,
                                                     b * s)
        else:
            scfg = ServeConfig(max_len=s, batch=b)
            params = shd.shard_tree(model.shapes(dev), model.axes())
            if shape.kind == "prefill":
                step = make_prefill_step(model, shd, scfg)
                args = (params, batch)
                model_flops = roofline.forward_model_flops(
                    cfg.n_params_active, b * s)
            else:
                step = make_decode_step(model, shd, scfg)
                cache = shd.shard_tree(model.cache_shapes(b, s, dev),
                                       model.cache_axes())
                # a plain device scalar, as the serve path keeps it
                cache["len"] = torch.full((), s - 1, dtype=torch.int32,
                                          device=dev)
                args = (params, cache, batch)
                model_flops = roofline.forward_model_flops(
                    cfg.n_params_active, b)
        b_axes = batch_shardings(batch)
        arg_bytes = sum(_local_bytes(t) for t in _tensors(args[:-1])) + sum(
            _local_bytes(t, shd, b_axes[k]) for k, t in batch.items())
        external = {_storage_key(t) for t in _tensors(args)}

    t0 = time.perf_counter()
    with fake, CollectiveInterceptor(mesh, cost=True) as icpt, \
            LiveBytes(external) as live:
        out = step(*args)
    trace_s = time.perf_counter() - t0

    with fake:
        outs = {_storage_key(t): _local_bytes(t) for t in _tensors(out)}
    out_bytes = sum(outs.values())
    alias = sum(n for k, n in outs.items() if k in external)
    temp = max(0, live.peak - (out_bytes - alias))
    memory = {
        "argument_bytes": int(arg_bytes),
        "output_bytes": int(out_bytes),
        "temp_bytes": int(temp),
        "alias_bytes": int(alias),
        "total_bytes": int(arg_bytes + out_bytes + temp - alias),
    }
    return {"cfg": cfg, "shape": shape, "model_flops": model_flops,
            "ops": icpt.ops, "events": icpt.events,
            "cost": icpt.cost.cost(), "memory": memory, "trace_s": trace_s}


def cache_bytes_per_device(cfg, shape, mesh_shape, axis_names) -> int:
    """One device's bytes of ``cfg``'s decode cache at ``shape`` (batch
    ``global_batch``, ``seq_len`` slots, bf16) on a mesh of
    ``mesh_shape``, by arithmetic: each leaf's bytes over the mesh axes
    the Sharder gives its dims (the decode cell's ``alias_bytes``)."""
    from types import SimpleNamespace

    shd = Sharder(SimpleNamespace(mesh_dim_names=tuple(axis_names),
                                  shape=tuple(mesh_shape)))
    model = build_model(cfg)
    shapes = tree_leaves(model.cache_shapes(shape.global_batch,
                                            shape.seq_len, device="meta"))
    axes = tree_leaves(model.cache_axes())
    return sum(_local_bytes(t, shd, ax) for t, ax in zip(shapes, axes))


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             save_hlo: bool = False, out_dir: str = ARTIFACT_DIR,
             tag: str = "", train_overrides=None,
             device: str = "cuda") -> dict:
    """Capture one cell on the production mesh and write its JSON, with the
    reference's keys."""
    from repro_torch.core.export.serialize import event_to_dict, op_to_dict

    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    mname = "multi" if multi_pod else "single"
    cell = capture_cell(arch, shape_name, mesh,
                        train_overrides=train_overrides)
    topo = MeshTopology.from_mesh(mesh)
    rl = roofline.analyze(
        arch=arch, mesh_name=mname, cost=cell["cost"], ops=cell["ops"],
        topo=topo, model_flops=cell["model_flops"],
        memory_stats=cell["memory"])
    result = {
        "arch": arch, "shape": shape_name, "mesh": mname,
        "devices": topo.num_devices,
        "ok": True,
        "trace_s": cell["trace_s"], "compile_s": 0.0,
        "memory": cell["memory"],
        "cost": {k: cell["cost"].get(k, 0.0)
                 for k in ("flops", "bytes accessed")},
        "collectives": rl.collective_breakdown,
        "roofline": roofline.to_row(rl),
        "tag": tag,
    }
    os.makedirs(out_dir, exist_ok=True)
    stem = f"{arch}_{shape_name}_{mname}" + (f"_{tag}" if tag else "")
    with open(os.path.join(out_dir, stem + ".json"), "w") as f:
        json.dump(result, f, indent=1)
    if save_hlo:
        with gzip.open(os.path.join(out_dir, stem + ".ops.json.gz"),
                       "wt") as f:
            json.dump({"ops": [op_to_dict(o) for o in cell["ops"]],
                       "traced": [event_to_dict(e)
                                  for e in cell["events"]]}, f)
    return result


def _children(args) -> int:
    """``--mesh both``: one child process a mesh (each opens its own fake
    process group); 1 if any failed."""
    fwd = ["--arch", args.arch] if args.arch else []
    fwd += ["--shape", args.shape] if args.shape else []
    fwd += [f for f, on in (("--all", args.all),
                            ("--skip-existing", args.skip_existing),
                            ("--save-hlo", args.save_hlo)) if on]
    fwd += ["--tag", args.tag, "--out", args.out, "--device", args.device]
    failed = []
    for mname in ("single", "multi"):
        rc = subprocess.run(CHILD + fwd + ["--mesh", mname]).returncode
        if rc:
            failed.append((mname, rc))
    if failed:
        print(f"\nmeshes with failures: {failed}")
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch dryrun")
    ap.add_argument("--arch", help="an arch, or a comma list")
    ap.add_argument("--shape", help="a shape, or a comma list")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--save-hlo", action="store_true",
                    help="no HLO exists: write the capture's recorded ops "
                         "and traced events (<stem>.ops.json.gz) instead")
    ap.add_argument("--sp", action="store_true",
                    help="sequence parallelism: refused, the models keep "
                         "seq unsharded")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    ap.add_argument("--device", default="cuda",
                    help="the fake mesh's device type (cuda needs a GPU)")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    if args.sp:
        ap.error("--sp: sequence parallelism is not ported; the models "
                 "keep the activations' seq unsharded")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise ValueError("no CUDA device for a cuda capture mesh; pass "
                         "--device cpu to capture on a CPU mesh")
    if args.mesh == "both":
        return _children(args)

    todo = configs.cells() if args.all else [
        (a, s) for a in args.arch.split(",") for s in args.shape.split(",")]
    mp = args.mesh == "multi"
    failures = []
    for arch, shape in todo:
        stem = f"{arch}_{shape}_{args.mesh}" + \
            (f"_{args.tag}" if args.tag else "")
        if args.skip_existing and os.path.exists(
                os.path.join(args.out, stem + ".json")):
            print(f"[skip] {stem}")
            continue
        print(f"[dryrun] {arch} x {shape} @ {args.mesh} ...", flush=True)
        try:
            r = run_cell(arch, shape, mp, save_hlo=args.save_hlo,
                         out_dir=args.out, tag=args.tag,
                         device=args.device)
            mem = r["memory"]["total_bytes"] / 2**30
            rl = r["roofline"]
            print(f"  ok: mem/dev={mem:.2f} GiB "
                  f"compute={rl['compute_s']:.3e}s "
                  f"memory={rl['memory_s']:.3e}s "
                  f"collective={rl['collective_s']:.3e}s "
                  f"dominant={rl['dominant']} "
                  f"(trace {r['trace_s']:.1f}s compile "
                  f"{r['compile_s']:.1f}s)", flush=True)
        except Exception as e:
            failures.append((arch, shape, args.mesh, repr(e)))
            print(f"  FAIL: {e}\n{traceback.format_exc()}", flush=True)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        return 1
    print("\nall dry-run cells passed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
