"""Config-sweep engine (port of ``repro.sweep``): monitor many (config x
mesh x algorithm) cells and emit the comparative artifact set.

The registry holds the paper's own applications -- the DDP microbenchmark,
GNMT and ResNet-18 --, the ``serve`` cell (reduced Qwen3-8B prefill and
decode as two phases of one session) and one train-step cell per ported
architecture (``qwen3_8b``, ``recurrentgemma_2b``: the reduced config,
global batch ``2 x data``, sequence 64).  A config's builder takes a
``DeviceMesh`` and returns ``dict(fn=, args=, kwargs=, op_transform=)`` or
``dict(captures=[dict(phase=, name=, fn=, args=, kwargs=), ...])``;
:func:`_monitor_cell` calls it under the session's ``FakeTensorMode``, so
its stand-ins allocate nothing, and captures each function.  Each
builder's defaults are the reference's sweep sizes; ``launch.paper`` and
``launch.serve`` call the same builders at their own sizes.

:func:`run_sweep` keeps iteration fast as the reference's does:

* **cache**: finished reports land in the on-disk
  :class:`~repro_torch.core.report_cache.ReportCache`, keyed by (config,
  mesh, algorithm, torch version, mesh device type) -- a second run
  captures nothing;
* **algorithm derivation**: the capture does not depend on the algorithm,
  so extra algorithms of a captured cell are derived from a sibling
  report (``CommReport.rebound``) without recapture;
* **jobs**: ``jobs > 1`` evaluates cells on a thread pool.  Each thread
  has its own dispatch-mode stack and its session its own
  ``FakeTensorMode``; meshes are built under a lock (the fake process
  group is process-global), and results are assembled in the serial
  order, so the output equals ``jobs=1``'s.  A capture is Python and holds
  the GIL, so threads do not make it faster; they keep ``--jobs`` what it
  is in the reference, invisible in the output.

Capture meshes are ``cuda`` unless the caller passes ``device="cpu"``.
The reference's ``moe-skew`` cell and its other eight architectures' cells
wait for the port's MoE layer and those models.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import os
import threading
import time
from typing import Callable, Optional

import torch

from repro_torch.core import MonitorSession, fake_mesh
from repro_torch.core.decompose import ALGORITHMS, validate_algorithm
from repro_torch.core.report_cache import ReportCache, cache_key
from repro_torch.core.reporter import format_table, human_bytes
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


def serve_cell(mesh, cfg, *, batch: int, prompt_len: int, max_len: int,
               dtype: Optional[torch.dtype] = None) -> dict:
    """Prefill (the whole prompt, filling a ``max_len`` KV cache) and one
    decode step against that cache, as the two phases of one session:
    ``dict(captures=[...])``.  Parameters are ``cfg``'s ``param_dtype``
    unless ``dtype`` is given.  Called under the session's fake mode."""
    from repro_torch.models import build_model
    from repro_torch.parallel import Sharder

    dev = mesh.device_type
    shd = Sharder(mesh)
    model = build_model(cfg)
    params = shd.shard_tree(model.shapes(dev, dtype), model.axes())
    cache = shd.shard_tree(model.cache_shapes(batch, max_len, dev),
                           model.cache_axes())
    cache["len"] = torch.full((), prompt_len, dtype=torch.int32, device=dev)
    prompts = torch.zeros((batch, prompt_len), dtype=torch.long, device=dev)
    step_tokens = torch.zeros((batch, 1), dtype=torch.long, device=dev)
    return {"captures": [
        {"phase": "prefill", "name": "prefill",
         "fn": lambda p, b: model.prefill(p, b, shd, max_len=max_len),
         "args": (params, {"tokens": prompts})},
        {"phase": "decode", "name": "decode",
         "fn": lambda p, c, b: model.decode_step(p, c, b, shd),
         "args": (params, cache, {"tokens": step_tokens})},
    ]}


def _build_serve(mesh):
    """Prefill/decode serve cells: the reduced ``qwen3_8b`` config, batch
    ``2 x data``, prompt 32, cache 48, one two-phase session per cell
    (``sweep --by-phase`` shows the prefill profile next to the decode
    one)."""
    from repro_torch import configs

    return serve_cell(mesh, configs.config("qwen3_8b", reduced=True),
                      batch=2 * _data_axis_size(mesh), prompt_len=32,
                      max_len=48)


def train_cell(mesh, cfg, *, global_batch: int, seq_len: int,
               opt_cfg=None, train_cfg=None) -> dict:
    """One LM train step of ``cfg`` (the port's
    :func:`~repro_torch.train.train.make_train_step`) on ``mesh``: the
    state placed by the Sharder from its logical axes (FSDP over ``data``,
    TP over ``model``), a ``(global_batch, seq_len)`` token batch.  Called
    under the session's fake mode."""
    from repro_torch.models import build_model
    from repro_torch.models.common import ShapeConfig
    from repro_torch.optim import OptConfig
    from repro_torch.parallel import Sharder
    from repro_torch.train.train import (TrainConfig, make_train_step,
                                         train_state_shapes,
                                         train_state_shardings)
    from repro_torch import configs

    dev = mesh.device_type
    shd = Sharder(mesh)
    model = build_model(cfg)
    ocfg = opt_cfg or OptConfig(name=cfg.optimizer,
                                state_dtype=cfg.opt_state_dtype)
    step = make_train_step(model, ocfg, train_cfg or TrainConfig(), shd)
    state = shd.shard_tree(train_state_shapes(model, ocfg, dev),
                           train_state_shardings(model, ocfg))
    shape = ShapeConfig("train", seq_len=seq_len, global_batch=global_batch,
                        kind="train")
    return {"fn": step, "args": (state, configs.input_specs(cfg, shape, dev))}


def _arch_builder(arch: str):
    """Reduced-scale train step for one ported architecture (the
    reference's ``_arch_builder``): global batch ``2 x data``, sequence 64,
    the config's optimizer, ``TrainConfig()``."""

    def build(mesh):
        from repro_torch import configs

        return train_cell(mesh, configs.config(arch, reduced=True),
                          global_batch=2 * _data_axis_size(mesh),
                          seq_len=64)

    return build


def _registry() -> dict[str, SweepSpec]:
    from repro_torch import configs

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
        SweepSpec("serve", "prefill/decode serve cells: one multi-phase "
                  "session per cell (qwen3_8b reduced; use --by-phase)",
                  "v1:qwen3,prompt=32,max=48", _build_serve),
    ]
    for arch in configs.ARCH_IDS:
        specs.append(SweepSpec(
            arch, f"reduced-scale {arch} train step (Sharder-sharded)",
            "v1:reduced,seq=64", _arch_builder(arch)))
    return {s.name: s for s in specs}


def available_configs() -> dict[str, SweepSpec]:
    """Name -> spec for every sweepable config of the port."""
    return _registry()


def _monitor_cell(build: Callable, mesh, name: str,
                  algorithm: str = "ring"):
    """Monitor one cell: ``build(mesh)`` under the session's fake mode,
    then one capture of its ``fn`` (phase ``main``) or one capture a
    ``captures`` entry under that entry's phase, each through the
    builder's ``op_transform`` (an entry's own wins).  Returns the
    session's :class:`~repro_torch.core.CommReport`."""
    sess = MonitorSession(mesh=mesh, name=name, algorithm=algorithm)
    with sess.fake_mode:
        built = build(mesh)
    for cap in built.get("captures", [dict(built, name=name)]):
        phase = (sess.phase(cap["phase"]) if cap.get("phase")
                 else contextlib.nullcontext())
        with phase:
            sess.capture(cap["fn"], *cap.get("args", ()),
                         name=cap.get("name"),
                         op_transform=cap.get("op_transform",
                                              built.get("op_transform")),
                         **cap.get("kwargs", {}))
    return sess.report()


@dataclasses.dataclass
class SweepResult:
    reports: list                        # CommReport, one per finished cell
    failures: list[dict]                 # {config, mesh, error}
    cache_hits: int
    captures: int
    artifacts: dict[str, str] = dataclasses.field(default_factory=dict)

    def summary_table(self, by_link: bool = False,
                      by_phase: bool = False,
                      lint: bool = False) -> str:
        """One row per cell; ``by_link=True`` adds the busiest physical
        link, its contention-aware ms and the tier-overlapped time;
        ``by_phase=True`` one row per session phase (statistics from that
        phase's view); ``lint=True`` the finding count (worst severity) and
        the total modeled savings -- the reference's columns."""
        from repro_torch.core.lint import max_severity
        rows = []
        for rep in self.reports:
            targets = [(None, rep.view())]
            if by_phase and rep.phase_names():
                targets = [(ph, rep.view(phase=ph))
                           for ph in rep.phase_names()]
            for ph, view in targets:
                summary = view.summary
                total_wire = sum(r.get("wire_bytes", 0.0)
                                 for r in summary.values())
                calls = sum(r.get("calls", 0) for r in summary.values())
                dominant = max(
                    summary,
                    key=lambda k: summary[k].get("wire_bytes", 0.0),
                ) if summary else "-"
                row = [
                    rep.meta.get("config", rep.name),
                    rep.meta.get("mesh", f"{rep.num_devices}dev"),
                    rep.algorithm,
                ]
                if by_phase:
                    row.append(ph or "-")
                row += [
                    f"{rep.num_devices}",
                    f"{calls:,}",
                    human_bytes(total_wire),
                    f"{view.collective_seconds() * 1e3:.3f}",
                    dominant,
                    rep.meta.get("source", "?"),
                ]
                if by_link:
                    lu = view.link_utilization()
                    bn = lu.bottleneck() if lu is not None else None
                    overlap = view.collective_overlap_seconds()
                    row[-1:-1] = ([bn[0].name, f"{bn[1] * 1e3:.3f}",
                                   f"{overlap * 1e3:.3f}"]
                                  if bn else ["-", "-", "-"])
                if lint:
                    findings = rep.lint(phase=ph)
                    sev = max_severity(findings)
                    row[-1:-1] = [
                        f"{len(findings)}" + (f" ({sev})" if sev else ""),
                        f"{sum(f.est_savings_s for f in findings) * 1e3:.3f}",
                    ]
                rows.append(row)
        header = ["config", "mesh", "algorithm"] \
            + (["phase"] if by_phase else []) \
            + ["devices", "collective calls", "wire bytes", "collective ms",
               "dominant primitive", "source"]
        if by_link:
            header[-1:-1] = ["busiest link", "link ms", "overlap ms"]
        if lint:
            header[-1:-1] = ["lint findings", "lint savings ms"]
        return format_table(rows, header)


def run_scale_curve(
    config_names: list[str],
    mesh_specs: list[str] = DEFAULT_MESHES,
    algorithms: list[str] = ("ring",),
    *,
    device_counts: Optional[list[int]] = None,
    cache: Optional[ReportCache] = None,
    use_cache: bool = True,
    jobs: int = 1,
    device: str = "cuda",
    log: Callable[[str], None] = print,
):
    """``sweep --scale-curve``: monitor each cell once at its base mesh
    (the cache rules of :func:`run_sweep`), then project its ops onto
    synthetic fleets per device count (:mod:`repro_torch.scale`), all
    sparse, no recapture.  Returns ``(SweepResult, list[ScalePoint])``."""
    from repro_torch import scale

    result = run_sweep(config_names, mesh_specs, algorithms, cache=cache,
                       use_cache=use_cache, jobs=jobs, device=device,
                       log=log)
    points = scale.scale_curve(
        result.reports,
        device_counts if device_counts else scale.DEFAULT_SCALE_POINTS,
        log=log)
    return result, points


def resolve_jobs(jobs) -> int:
    """Normalize a ``--jobs`` value: int-like, or ``"auto"`` -> cpu count."""
    if isinstance(jobs, str):
        if jobs.strip().lower() == "auto":
            return max(1, os.cpu_count() or 1)
        jobs = int(jobs)
    return max(1, int(jobs))


def run_sweep(
    config_names: list[str],
    mesh_specs: list[str] = DEFAULT_MESHES,
    algorithms: list[str] = ("ring",),
    *,
    cache: Optional[ReportCache] = None,
    use_cache: bool = True,
    jobs: int = 1,
    device: str = "cuda",
    log: Callable[[str], None] = print,
) -> SweepResult:
    """Monitor every (config, mesh) cell, derive every algorithm, cache all.

    Per cell: try the cache for each requested algorithm; if at least one
    entry exists, derive the missing algorithms from it; only a fully cold
    cell is captured, once, whatever the number of algorithms.  Workers
    only *read* the cache; every write and the assembly of reports and
    failures happen afterwards on the calling thread in the serial order,
    so ``jobs > 1`` gives what ``jobs=1`` gives.
    """
    registry = _registry()
    unknown = [c for c in config_names if c not in registry]
    if unknown:
        raise KeyError(
            f"unknown config(s) {unknown}; known: {sorted(registry)}")
    for alg in algorithms:
        validate_algorithm(alg)
    cache = cache or ReportCache()
    result = SweepResult(reports=[], failures=[], cache_hits=0, captures=0)
    jobs = resolve_jobs(jobs)
    meshes: dict = {}
    mesh_lock = threading.Lock()

    def mesh_for(spec: str):
        with mesh_lock:       # the fake process group is process-global
            if spec not in meshes:
                meshes[spec] = build_mesh(spec, device=device)
            return meshes[spec]

    def key_for(spec: SweepSpec, mid: str, alg: str) -> str:
        return cache_key(spec.config_id, mid, alg, device=device)

    def eval_cell(cname: str, mspec: str):
        """One (config, mesh) cell: probe the cache, capture if cold,
        derive the missing algorithms.  Returns ``(cell, keys, failure,
        cache_hits, captures)`` for the caller to merge in order."""
        spec = registry[cname]
        mid = mesh_id(mspec)
        keys = {alg: key_for(spec, mid, alg) for alg in algorithms}
        cell: dict[str, object] = {}
        hits = 0
        captures = 0
        if use_cache:
            for alg, key in keys.items():
                rep = cache.get(key)
                if rep is not None:
                    log(f"[cache] hit config={cname} mesh={mspec} "
                        f"algorithm={alg} key={key}")
                    rep.meta["source"] = "cache"
                    cell[alg] = rep
                    hits += 1
        missing = [a for a in algorithms if a not in cell]
        sibling = None
        if missing and not cell and use_cache:
            # an entry for an unrequested algorithm still spares the
            # capture: every algorithm derives from the same ops
            for alg in ALGORITHMS:
                if alg in keys:
                    continue
                rep = cache.get(key_for(spec, mid, alg))
                if rep is not None:
                    log(f"[cache] sibling hit config={cname} "
                        f"mesh={mspec} algorithm={alg} -- deriving "
                        "requested algorithms without recapture")
                    rep.meta["source"] = "cache"
                    sibling = rep
                    break
        if missing and not cell and sibling is None:
            alg0 = missing[0]
            log(f"[sweep] capture config={cname} mesh={mspec} "
                f"algorithm={alg0} ...")
            t0 = time.perf_counter()
            try:
                rep = _monitor_cell(spec.build, mesh_for(mspec),
                                    f"{cname}@{mspec}", alg0)
            except Exception as e:  # noqa: BLE001 -- keep sweeping
                log(f"[sweep] FAIL config={cname} mesh={mspec}: {e!r}")
                return cell, keys, {"config": cname, "mesh": mspec,
                                    "error": repr(e)}, hits, captures
            captures += 1
            log(f"[sweep] captured config={cname} mesh={mspec} in "
                f"{time.perf_counter() - t0:.1f}s "
                f"({len(rep.compiled_ops)} collectives)")
            rep.meta.update(config=cname, mesh=mspec, source="captured")
            cell[alg0] = rep
            missing = [a for a in algorithms if a not in cell]
        if missing and (cell or sibling):
            base = next(iter(cell.values())) if cell else sibling
            for alg in missing:
                rep = base.rebound(alg)
                rep.meta = dict(base.meta, source="derived", algorithm=alg)
                log(f"[sweep] derive config={cname} mesh={mspec} "
                    f"algorithm={alg} (no recapture)")
                cell[alg] = rep
        return cell, keys, None, hits, captures

    cells = [(cname, mspec) for cname in config_names
             for mspec in mesh_specs]
    if jobs > 1 and len(cells) > 1:
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=min(jobs, len(cells))) as pool:
            futures = [pool.submit(eval_cell, cn, ms) for cn, ms in cells]
            outcomes = [f.result() for f in futures]
    else:
        outcomes = [eval_cell(cn, ms) for cn, ms in cells]

    for (cname, mspec), (cell, keys, failure, hits, captures) in zip(
            cells, outcomes):
        result.cache_hits += hits
        result.captures += captures
        if failure is not None:
            result.failures.append(failure)
            continue
        for alg in algorithms:
            if alg not in cell:
                continue
            rep = cell[alg]
            rep.meta.update(config=cname, mesh=mspec, algorithm=alg)
            result.reports.append(rep)
            if use_cache and rep.meta.get("source") != "cache":
                cache.put(keys[alg], rep, meta=rep.meta)
    return result


__all__ = ["DEFAULT_MESHES", "SweepResult", "SweepSpec", "available_configs",
           "build_mesh", "mesh_id", "parse_mesh", "resolve_jobs",
           "run_scale_curve", "run_sweep", "serve_cell"]
