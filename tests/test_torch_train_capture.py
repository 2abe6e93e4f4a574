"""Capture parity of the LM train step: the port's per-architecture sweep
cells (``sweep._arch_builder``, the reduced ``qwen3_8b`` and
``recurrentgemma_2b`` train steps) on ``torch_fixtures.mesh_4x2()``
beside the reference's cells on its 4x2 host mesh, their FLOPs, the bf16
gradient option, and the ``optim`` phase of the translation fixture.

Why the per-kind tables differ (both pinned):

* **DTensor against GSPMD** (ROADMAP queue 3 item 6): DTensor gathers an
  FSDP-sharded weight where it is used and reduce-scatters its gradient
  (``all-gather``/``reduce-scatter``); on a CPU mesh a shard-to-shard move
  is an all-gather and a chunk.  XLA's partitioner instead moves
  activations (``all-to-all``, ``collective-permute``) and keeps more of
  the weights sharded, with other payloads.
* **Scalars**: each cell issues five 4-byte all-reduces (over ``data``
  and over ``model``), whether it has 13 parameter leaves or 39: DTensor
  adds the leaves' partial sums of squares for the gradient norm without
  communicating, so the norm costs no all-reduce a leaf; the reference's
  scalar reductions are fused into its other all-reduces.
* **Recomputation**: a recomputed forward re-issues its own collectives
  in the backward: the ``qwen3_8b`` cell gathers 69 times with remat
  ``none``, 73 with the cell's ``dots`` (which keeps the matmuls' outputs)
  and 93 with ``full``.

FLOPs (``report.cost``, one device) differ from the reference's
``analyze_hlo`` by pinned amounts, each from the shapes: the port's chunked
loss recomputes its logits in the backward (``torch.utils.checkpoint``
per chunk: ``2 * 128 tokens * d 64 * V/tp 256`` a device); its attention
counts the flash-attention formula (full score blocks) and the plain
backward's fp32 einsums, where XLA counts its chunked attention's dots
under remat; and DTensor runs part of the attention projections on
operands replicated over the ``model`` axis, so one device's count on the
mesh exceeds an eighth of the single-device count.
"""
import dataclasses
import json
from pathlib import Path

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as ref_configs
from repro import sweep as ref_sweep
from repro.core import hlo_cost as ref_hlo_cost
from repro.core.export import serialize as ref_ser
from repro.models import build_model as ref_build_model
from repro.models.common import ShapeConfig as RefShapeConfig
from repro.optim import OptConfig as RefOptConfig
from repro.parallel import Sharder as RefSharder
from repro.train import TrainConfig as RefTrainConfig
from repro.train.train import batch_shardings as ref_batch_shardings
from repro.train.train import make_train_step as ref_make_step
from repro.train.train import train_state_shapes as ref_state_shapes
from repro.train.train import train_state_shardings as ref_state_shardings
from repro_torch import configs, sweep
from repro_torch.core import MonitorSession
from repro_torch.core.op_cost import OpCostMode
from repro_torch.models import build_model
from repro_torch.models.gnmt import GNMT
from repro_torch.optim import OptConfig, apply_updates, init_opt_state
from repro_torch.parallel import Sharder
from repro_torch.train import TrainConfig, make_train_step
from repro_torch.train.train import train_state_shapes
from torch_fixtures import mesh_4x2

ARCHS = ("qwen3_8b", "recurrentgemma_2b")
FIXTURE = Path(__file__).parent / "fixtures" / "translation_report.json"

# the port's cells on the CPU 4x2 mesh: kind -> (calls, payload bytes)
PORT_CALLS = {
    "qwen3_8b": {"all-gather": (73, 9902080), "all-reduce": (30, 1445960),
                 "reduce-scatter": (26, 1572864)},
    "recurrentgemma_2b": {"all-gather": (117, 14899200),
                          "all-reduce": (72, 3021896),
                          "reduce-scatter": (50, 4210688)},
}
# the reference's cells on its 4x2 host mesh (GSPMD)
REF_CALLS = {
    "qwen3_8b": {"all-gather": (53, 2625536), "all-reduce": (30, 2435280),
                 "collective-permute": (17, 1049088),
                 "all-to-all": (14, 8912896)},
    "recurrentgemma_2b": {"all-gather": (85, 4755456),
                          "all-reduce": (43, 4348064),
                          "collective-permute": (37, 1597952),
                          "all-to-all": (38, 13500416)},
}
# one device's FLOPs: the reference's analyze_hlo, and the port's extra
# (attention formulas against XLA's attention dots; DTensor's replicated
# projection work)
REF_FLOPS = {"qwen3_8b": 130_023_424, "recurrentgemma_2b": 173_539_328}
ATTENTION_EXTRA = {"qwen3_8b": 4_194_304, "recurrentgemma_2b": 2_097_152}
DTENSOR_EXTRA = {"qwen3_8b": 8_388_608, "recurrentgemma_2b": 12_582_912}

_REPORTS = {}


def _kinds(summary):
    return {k: (r["calls"], r["payload_bytes"]) for k, r in summary.items()}


def _port(arch, **over):
    key = ("port", arch, tuple(sorted(over.items())))
    if key not in _REPORTS:
        if over:
            cfg = configs.config(arch, reduced=True)
            tcfg = TrainConfig(grad_dtype=over.pop("grad_dtype", "float32"))
            cfg = dataclasses.replace(cfg, **over)
            build = lambda m: sweep.train_cell(  # noqa: E731
                m, cfg, global_batch=8, seq_len=64, train_cfg=tcfg)
        else:
            build = sweep.available_configs()[arch].build
        _REPORTS[key] = sweep._monitor_cell(build, mesh_4x2(), arch)
    return _REPORTS[key]


def _ref(arch, **over):
    key = ("ref", arch, tuple(sorted(over.items())))
    if key not in _REPORTS:
        mesh = ref_sweep.build_mesh("4x2")
        if over:
            tcfg = RefTrainConfig(grad_dtype=over.pop("grad_dtype",
                                                      "float32"))
            cfg = dataclasses.replace(ref_configs.config(arch, reduced=True),
                                      **over)
            model, shd = ref_build_model(cfg), RefSharder(mesh)
            ocfg = RefOptConfig(name=cfg.optimizer,
                                state_dtype=cfg.opt_state_dtype)
            batch = ref_configs.input_specs(
                cfg, RefShapeConfig("s", 64, 8, "train"))
            built = {"fn": ref_make_step(model, ocfg, tcfg, shd),
                     "args": (ref_state_shapes(model, ocfg), batch),
                     "kwargs": {"in_shardings": (
                         ref_state_shardings(model, ocfg, shd),
                         ref_batch_shardings(batch, shd))}}
        else:
            built = ref_sweep.available_configs()[arch].build(mesh)
        _REPORTS[key] = ref_sweep._monitor_cell(built, mesh, arch, "ring")
    return _REPORTS[key]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cell_tables(arch):
    """One phase (``main``) a cell; the port's and the reference's per-kind
    tables pinned side by side (the module docstring says why they
    differ)."""
    port, ref = _port(arch), _ref(arch)
    assert port.phase_names() == ref.phase_names() == ["main"]
    assert _kinds(port.view(phase="main").summary) == PORT_CALLS[arch]
    assert _kinds(port.compiled_summary) == PORT_CALLS[arch]
    assert _kinds(ref.compiled_summary) == REF_CALLS[arch]
    assert port.num_devices == ref.num_devices == 8
    scalar = [op.op_name.split("[")[-1] for op in port.compiled_ops
              if op.kind == "all-reduce" and op.payload_bytes == 4]
    assert sorted(scalar) == ["data]"] * 3 + ["model]"] * 2


def _single_device_flops(arch):
    """One device's share of the same step on one device: the whole step
    counted by OpCostMode under FakeTensorMode, over 8."""
    cfg = configs.config(arch, reduced=True)
    model = build_model(cfg)
    with FakeTensorMode():
        state = train_state_shapes(model, OptConfig(), device="cpu")
        batch = {k: torch.zeros((8, 64), dtype=torch.int32)
                 for k in ("tokens", "labels")}
        with OpCostMode() as oc:
            make_train_step(model, OptConfig(), TrainConfig(),
                            Sharder())(state, batch)
    return oc.cost()["flops"] / 8


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cell_flops_against_analyze_hlo(arch):
    """``report.cost`` FLOPs against the reference's ``analyze_hlo``: equal
    but for the pinned amounts of the module docstring.  The logits'
    recompute is computed from the shapes: 128 tokens a device, d 64, a
    vocab shard of 256."""
    ref = sum(ref_hlo_cost.analyze_hlo(t).flops
              for t in _ref(arch)._hlo_texts)
    assert ref == REF_FLOPS[arch]
    logits = 2 * 128 * 64 * 256
    single = _single_device_flops(arch)
    assert single == ref + logits + ATTENTION_EXTRA[arch]
    assert _port(arch).cost["flops"] == single + DTENSOR_EXTRA[arch]


@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
def test_bf16_gradients_leave_the_gathers_as_they_are(compute):
    """``grad_dtype="bfloat16"`` casts the fp32 weights to bf16 on their
    sharded side before the loss; in both packages the model then casts
    each weight to the compute dtype, also on its sharded side, before the
    FSDP gather.  So the gathered bytes are the compute dtype's either way:
    bf16 compute already gathers bf16 with fp32 gradients, and fp32 compute
    gathers the bf16 copy cast back to fp32.  Neither package halves the
    all-gather bytes of these cells; each gathers the same with either
    gradient dtype."""
    arch = "qwen3_8b"
    for package in (_port, _ref):
        f32 = _kinds(package(arch, compute_dtype=compute).compiled_summary)
        bf16 = _kinds(package(arch, compute_dtype=compute,
                              grad_dtype="bfloat16").compiled_summary)
        assert f32["all-gather"] == bf16["all-gather"]
        assert f32 == bf16
    if compute == "bfloat16":
        assert _kinds(_port(arch, compute_dtype=compute).compiled_summary) \
            == PORT_CALLS[arch]


def test_translation_fixture_optim_phase_reproduced():
    """The fixture's third phase, ``optim``: the AdamW update of GNMT
    (vocab 64, d 128) with replicated parameters, local math on each rank
    of the 8-way data mesh -- no collective in the fixture and none from
    the port's ``apply_updates``; the phase's view is empty in both."""
    fixture = json.loads(FIXTURE.read_text())
    assert [p["name"] for p in fixture["phases"]] == ["fwd", "bwd", "optim"]
    assert not [e for e in fixture["traced"] if e["phase"] == "optim"]
    assert not [op for op in fixture["ops"] if op.get("phase") == "optim"]
    mesh = sweep.build_mesh("8", device="cpu")
    model = GNMT(vocab=64, d=128, layers=2)
    ocfg = OptConfig(peak_lr=3e-3, warmup_steps=10, decay_steps=500)
    sess = MonitorSession(mesh=mesh, name="GNMT-MT")
    with sess.fake_mode:
        params = model.shapes(device="cpu")
        grads = model.shapes(device="cpu")
        opt = init_opt_state(params, ocfg)
        step = torch.zeros((), dtype=torch.int32)

    def optim(params, grads, opt, i):
        params, opt, _ = apply_updates(params, grads, opt, ocfg, i)
        return params, opt

    with sess.phase("optim"):
        cap = sess.capture(optim, params, grads, opt, step)
    assert cap.ops == [] and cap.traced == []
    rep = sess.report()
    back = ref_ser.report_from_dict(fixture)
    assert rep.view(phase="optim").summary == \
        back.view(phase="optim").summary == {}
    assert _kinds(rep.compiled_summary) == {}
