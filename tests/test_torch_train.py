"""The port's LM training path against the reference on the CPU: the loss,
both LMs' ``loss_fn`` and its gradients under every remat policy, the
train step, the LM data stream, the kernel launches a train step makes,
and the ``launch.train`` entry point.

The same seeded numpy inputs go through both packages; the reference's
weights cross over with :func:`repro_torch.weights.from_jax_params`.
Tolerances (stated per test):

* the loss alone (``cross_entropy_loss``, ``chunked_lm_loss``): ``1e-6``
  -- fp32 log-sum-exp over the same logits, summed in another order;
* ``loss_fn`` and its parameter gradients: ``test_torch_grad.py``'s
  ``MODEL_TOL`` (``1e-4``) in fp32 compute;
* the train step: losses ``1e-5`` relative, parameters ``2e-6 *
  max(1, |p|)`` in fp32 (one fp32 rounding of the updates, which differ by
  ulps through the norm and the schedule); with bf16 gradients
  ``3 * lr * 2**-7``: a gradient whose fp32 values differ by an ulp can
  round to bf16 either way, moving that step's update by a bf16 ulp.  The
  optimizer's ``eps`` is ``1e-3`` there: Adam's first steps move a weight
  by ``lr * g / (|g| + eps)``, which for ``eps = 1e-8`` is ``lr * sign(g)``
  wherever ``|g| >> eps``, so a gradient within rounding of zero could
  step ``2 * lr`` apart on the two sides; a larger ``eps`` keeps the
  update continuous in the gradient.
"""
import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as ref_configs
from repro.compat import make_mesh
from repro.core.export import serialize as ref_ser
from repro.data import SyntheticLMData as RefLMData
from repro.data import host_transfer_log as ref_transfer_log
from repro.models import build_model as ref_build_model
from repro.models import common as ref_common
from repro.models import layers as ref_layers
from repro.optim import OptConfig as RefOptConfig
from repro.parallel import Sharder as RefSharder
from repro.train import TrainConfig as RefTrainConfig
from repro.train.train import init_train_state as ref_init_state
from repro.train.train import make_train_step as ref_make_step
from repro_torch import configs
from repro_torch.data import SyntheticLMData, host_transfer_log
from repro_torch.models import build_model, common, layers
from repro_torch.models.common import tree_leaves
from repro_torch.optim import OptConfig, init_opt_state
from repro_torch.parallel import Sharder
from repro_torch.train import TrainConfig, make_train_step
from repro_torch.weights import from_jax_params

ROOT = Path(__file__).resolve().parents[1]
MODEL_TOL = 1e-4


def _ref_shd():
    return RefSharder(make_mesh((1, 1), ("data", "model")))


def _cfgs(arch, n_layers, compute="float32"):
    over = dict(n_layers=n_layers)
    rcfg = dataclasses.replace(ref_configs.reduce_config(
        ref_configs.config(arch), **over), compute_dtype=compute)
    pcfg = dataclasses.replace(configs.reduce_config(
        configs.config(arch), **over), compute_dtype=compute)
    return rcfg, pcfg


def _labels(rng, b, s, vocab):
    """Labels with about a tenth ignored (-1)."""
    lab = rng.integers(0, vocab, (b, s), dtype=np.int32)
    lab[rng.random((b, s)) < 0.1] = -1
    return lab


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------
def test_cross_entropy_loss_matches_reference():
    """Ignored labels (< 0) included; 1e-6."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 3
    lab = _labels(rng, 3, 7, 50)
    want = float(ref_common.cross_entropy_loss(jnp.asarray(logits),
                                               jnp.asarray(lab)))
    got = float(common.cross_entropy_loss(torch.from_numpy(logits),
                                          torch.from_numpy(lab)))
    assert abs(got - want) <= 1e-6


@pytest.mark.parametrize("s", [1024, 600, 64])
def test_chunked_lm_loss_and_grads_match_reference(s):
    """Two 512-token chunks (1024), one chunk when 512 does not divide the
    sequence (600, 64); ignored labels; the loss and its gradients with
    respect to the hidden states and the head to 1e-6."""
    rng = np.random.default_rng(s)
    rcfg, pcfg = _cfgs("qwen3_8b", 2)
    d, v = rcfg.d_model, rcfg.vocab_size
    h = rng.standard_normal((2, s, d)).astype(np.float32)
    w = (rng.standard_normal((d, v)) / np.sqrt(d)).astype(np.float32)
    lab = _labels(rng, 2, s, v)

    def ref(h_, w_):
        return ref_layers.chunked_lm_loss({"w": w_}, {}, h_, jnp.asarray(lab),
                                          rcfg, _ref_shd())

    want, (dh, dw) = jax.value_and_grad(ref, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    th, tw = (torch.from_numpy(a.copy()).requires_grad_() for a in (h, w))
    got = layers.chunked_lm_loss({"w": tw}, {}, th, torch.from_numpy(lab),
                                 pcfg, Sharder())
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= 1e-6
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(dh), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(dw), rtol=0,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# loss_fn: the loss and every parameter gradient, each remat policy
# ---------------------------------------------------------------------------
_GRADS = {}


def _port_loss_grads(arch, n_layers, remat):
    key = (arch, n_layers, remat)
    if key not in _GRADS:
        rcfg, pcfg = _cfgs(arch, n_layers)
        rparams = ref_build_model(rcfg).init(jax.random.PRNGKey(5))
        params = from_jax_params(jax.tree.map(np.asarray, rparams), pcfg,
                                 device="cpu")
        rng = np.random.default_rng(6)
        toks = rng.integers(0, rcfg.vocab_size, (2, 12), dtype=np.int32)
        lab = _labels(rng, 2, 12, rcfg.vocab_size)
        leaves = [t.requires_grad_() for t in tree_leaves(params)]
        loss, metrics = build_model(pcfg).loss_fn(
            params, {"tokens": torch.from_numpy(toks),
                     "labels": torch.from_numpy(lab)}, Sharder(),
            remat=remat)
        loss.backward()
        _GRADS[key] = (rcfg, rparams, toks, lab, float(loss.detach()),
                       metrics, params, [t.grad.clone() for t in leaves])
    return _GRADS[key]


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("arch,n_layers", [("qwen3_8b", 2),
                                           ("recurrentgemma_2b", 4)])
def test_loss_fn_and_grads_match_reference(arch, n_layers, remat):
    """``loss_fn`` and every parameter gradient against
    ``jax.value_and_grad`` of the reference's, fp32 compute, MODEL_TOL."""
    rcfg, rparams, toks, lab, loss, metrics, params, _ = _port_loss_grads(
        arch, n_layers, remat)
    rmodel = ref_build_model(rcfg)
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(lab)}
    (rloss, rmet), rgrads = jax.value_and_grad(
        lambda p: rmodel.loss_fn(p, batch, _ref_shd(), remat=remat),
        has_aux=True)(rparams)
    assert abs(loss - float(rloss)) <= MODEL_TOL
    assert set(metrics) == set(rmet) == {"xent", "aux"}
    assert float(metrics["aux"]) == float(rmet["aux"]) == 0.0
    flat = jax.tree_util.tree_leaves_with_path(rgrads)
    assert len(flat) == len(tree_leaves(params))
    for path, g in flat:
        node = params
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node.grad.numpy(), np.asarray(g), rtol=0,
                                   atol=MODEL_TOL,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch,n_layers", [("qwen3_8b", 2),
                                           ("recurrentgemma_2b", 4)])
def test_remat_policies_agree(arch, n_layers):
    """Recomputation changes no value on the CPU: the three policies give
    the same loss and gradients, bit for bit."""
    base = _port_loss_grads(arch, n_layers, "none")
    for remat in ("full", "dots"):
        other = _port_loss_grads(arch, n_layers, remat)
        assert other[4] == base[4]
        for a, b in zip(other[7], base[7]):
            assert torch.equal(a, b)


def test_unknown_remat_policy_raises():
    _, pcfg = _cfgs("qwen3_8b", 2)
    model = build_model(pcfg)
    params = model.init(0, device="cpu")
    batch = {k: torch.zeros((1, 4), dtype=torch.int32)
             for k in ("tokens", "labels")}
    with pytest.raises(ValueError, match="remat"):
        model.loss_fn(params, batch, Sharder(), remat="everything")


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
OPT = dict(peak_lr=1e-2, warmup_steps=2, decay_steps=10, eps=1e-3)


@pytest.mark.parametrize("arch,n_layers,microbatches,grad_dtype", [
    ("qwen3_8b", 2, 1, "float32"),
    ("qwen3_8b", 2, 2, "float32"),
    ("qwen3_8b", 2, 2, "bfloat16"),
    ("recurrentgemma_2b", 4, 1, "float32"),
    ("recurrentgemma_2b", 4, 2, "bfloat16")])
def test_train_step_matches_reference(arch, n_layers, microbatches,
                                      grad_dtype):
    """Three steps against the reference's step under ``jax.jit`` on a 1x1
    mesh: losses (1e-5 relative), metrics and every parameter (see the
    module docstring's tolerances)."""
    rcfg, pcfg = _cfgs(arch, n_layers)
    kw = dict(microbatches=microbatches, remat="full", grad_dtype=grad_dtype)
    rstate = ref_init_state(ref_build_model(rcfg), RefOptConfig(**OPT),
                            jax.random.PRNGKey(3))
    params = from_jax_params(jax.tree.map(np.asarray, rstate["params"]),
                             pcfg, device="cpu")
    state = {"params": params, "opt": init_opt_state(params, OptConfig(**OPT)),
             "step": torch.zeros((), dtype=torch.int32)}
    rstep = jax.jit(ref_make_step(ref_build_model(rcfg), RefOptConfig(**OPT),
                                  RefTrainConfig(**kw), _ref_shd()))
    step = make_train_step(build_model(pcfg), OptConfig(**OPT),
                           TrainConfig(**kw), Sharder())
    tol = 3 * OPT["peak_lr"] * 2 ** -7 if grad_dtype == "bfloat16" else 2e-6
    for i in range(3):
        rng = np.random.default_rng(i)
        toks = rng.integers(0, rcfg.vocab_size, (4, 16), dtype=np.int32)
        lab = _labels(rng, 4, 16, rcfg.vocab_size)
        rstate, rmet = rstep(rstate, {"tokens": jnp.asarray(toks),
                                      "labels": jnp.asarray(lab)})
        state, met = step(state, {"tokens": torch.from_numpy(toks),
                                  "labels": torch.from_numpy(lab)})
        assert set(met) == set(rmet)
        for k in ("loss", "xent"):
            np.testing.assert_allclose(float(met[k]), float(rmet[k]),
                                       rtol=1e-5)
        np.testing.assert_allclose(float(met["lr"]), float(rmet["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(met["grad_norm"]),
                                   float(rmet["grad_norm"]), rtol=1e-4)
        for path, want in jax.tree_util.tree_leaves_with_path(
                rstate["params"]):
            node = state["params"]
            for k in path:
                node = node[k.key]
            want = np.asarray(want)
            np.testing.assert_allclose(
                node.numpy(), want, rtol=0,
                atol=tol * max(1.0, np.abs(want).max()),
                err_msg=jax.tree_util.keystr(path))
    assert int(state["step"]) == int(rstate["step"]) == 3


def test_train_step_accumulates_into_the_gradients_of_one_batch():
    """Two microbatches of one sequence each give the gradients of the
    whole batch: the same step with ``microbatches=1`` moves every
    parameter to within fp32 rounding of it (the means split differently),
    and the accumulation leaves no ``.grad`` on the parameters."""
    _, pcfg = _cfgs("qwen3_8b", 2)
    model = build_model(pcfg)
    ocfg = OptConfig(**OPT)
    rng = np.random.default_rng(9)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, pcfg.vocab_size, (2, 16), dtype=np.int32)),
        "labels": torch.from_numpy(rng.integers(
            0, pcfg.vocab_size, (2, 16), dtype=np.int32))}
    out = []
    for a in (1, 2):
        params = model.init(0, device="cpu")
        state = {"params": params, "opt": init_opt_state(params, ocfg),
                 "step": torch.zeros((), dtype=torch.int32)}
        state, _ = make_train_step(model, ocfg, TrainConfig(microbatches=a),
                                   Sharder())(state, batch)
        assert all(p.grad is None for p in tree_leaves(state["params"]))
        out.append(tree_leaves(state["params"]))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# configs: presets, cells, input stand-ins, batch layout
# ---------------------------------------------------------------------------
def test_train_presets_cells_and_input_specs_match_reference():
    """``TRAIN`` presets, the (arch, shape) cells of the ported
    architectures, and each shape's batch stand-ins (shapes and dtypes)."""
    from repro.models.common import SHAPES_BY_NAME as REF_SHAPES
    from repro_torch.models.common import SHAPES_BY_NAME
    from repro_torch.train.train import batch_shardings

    assert configs.cells() == [c for c in ref_configs.cells()
                               if c[0] in configs.ARCH_IDS]
    assert configs.cells(include_long=False) == [
        c for c in ref_configs.cells(include_long=False)
        if c[0] in configs.ARCH_IDS]
    assert set(configs.LONG_CONTEXT_ARCHS) == set(
        ref_configs.LONG_CONTEXT_ARCHS) & set(configs.ARCH_IDS)
    for arch in configs.ARCH_IDS:
        assert dataclasses.asdict(configs.train_config(arch)) == \
            dataclasses.asdict(ref_configs.train_config(arch))
        for name, shape in SHAPES_BY_NAME.items():
            assert dataclasses.asdict(shape) == dataclasses.asdict(
                REF_SHAPES[name])
            got = configs.input_specs(configs.config(arch), shape,
                                      device="meta")
            want = ref_configs.input_specs(ref_configs.config(arch),
                                           REF_SHAPES[name])
            assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                    for k, v in got.items()} == \
                {k: (v.shape, str(v.dtype)) for k, v in want.items()}
            assert batch_shardings(got) == {
                k: ("batch", "seq", None) if k == "embeds"
                else ("batch", "seq") for k in got}


# ---------------------------------------------------------------------------
# the data stream
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,host,num_hosts", [(0, 0, 1), (7, 1, 2),
                                                 (123, 3, 4)])
def test_lm_data_is_the_reference_bit_for_bit(seed, host, num_hosts):
    """Tokens and labels at several steps, equal to the reference's; each
    batch logged as the reference logs it (label, bytes, order)."""
    kw = dict(vocab_size=1000, seq_len=33, global_batch=8, seed=seed,
              host_id=host, num_hosts=num_hosts)
    ours, theirs = SyntheticLMData(**kw), RefLMData(**kw)
    for step in (0, 1, 17):
        n0, r0 = len(host_transfer_log()), len(ref_transfer_log())
        got = ours.batch_at(step, device="cpu")
        want = theirs.batch_at(step)
        assert sorted(got) == sorted(want) == ["labels", "tokens"]
        for k in got:
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        new = [(t.label, t.nbytes, t.direction)
               for t in host_transfer_log()[n0:]]
        assert new == [(t.label, t.nbytes, t.direction)
                       for t in ref_transfer_log()[r0:]]
        assert new[0][0] == f"lm_batch[{step}]"


# ---------------------------------------------------------------------------
# kernel launches of a train step
# ---------------------------------------------------------------------------
class _OpCount(TorchDispatchMode):
    """Calls of the kernel ops a train step makes, RG-LRU's backward op
    included (on the CPU they run their plain versions; on the card each
    call is one launch)."""

    OPS = {"rmsnorm": "repro_torch.rmsnorm.default",
           "flash_attention": "repro_torch.flash_attention.default",
           "flash_decode": "repro_torch.flash_decode.default",
           "flash_decode_partial": "repro_torch.flash_decode_partial.default",
           "rglru": "repro_torch.rglru_scan.default",
           "rglru_bwd": "repro_torch.rglru_scan_bwd.default"}

    def __init__(self):
        super().__init__()
        self.counts = dict.fromkeys(self.OPS, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        for name, op in self.OPS.items():
            if str(func) == op:
                self.counts[name] += 1
        return func(*args, **(kwargs or {}))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch,tcfg", [
    ("qwen3_8b", dict(microbatches=2, remat="full")),
    ("qwen3_8b", dict(microbatches=1, remat="none")),
    ("qwen3_8b", dict(microbatches=1, remat="dots")),
    ("recurrentgemma_2b", dict(microbatches=2, remat="full")),
    ("recurrentgemma_2b", dict(microbatches=1, remat="none"))])
def test_train_step_kernel_calls_equal_chip_smoke_expectation(arch, tcfg):
    """One reduced train step's kernel-op calls (recomputed forwards call
    again, per microbatch) equal ``chip_smoke.expected_train_launches``,
    which the card's launch counters are held to."""
    cfg = configs.config(arch, reduced=True)
    model, tcfg = build_model(cfg), TrainConfig(**tcfg)
    ocfg = OptConfig()
    params = model.init(0, device="cpu")
    state = {"params": params, "opt": init_opt_state(params, ocfg),
             "step": torch.zeros((), dtype=torch.int32)}
    batch = {k: torch.zeros((2, 16), dtype=torch.int32)
             for k in ("tokens", "labels")}
    with _OpCount() as mode:
        make_train_step(model, ocfg, tcfg, Sharder())(state, batch)
    assert mode.counts == _chip_smoke().expected_train_launches(cfg, tcfg)


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------
def _launch(*args):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--device", "cpu", *args], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_launch_train_trains_resumes_and_reports(tmp_path):
    """Two steps and a checkpoint, then a resumed run to step 4 with a
    report: finite losses, the resume line, and a report the reference
    loads into the same views."""
    ck, rep = tmp_path / "ck", tmp_path / "rep.json"
    first = _launch("--steps", "2", "--ckpt-dir", str(ck), "--ckpt-every",
                    "2", "--mesh", "2x2")
    assert (ck / "step_2" / "manifest.json").exists()
    second = _launch("--steps", "4", "--ckpt-dir", str(ck), "--resume",
                     "--report", str(rep))
    assert "[train] resumed from step 2" in second
    losses = [float(line.split()[4]) for line in (first + second).splitlines()
              if line.startswith("[train] step ")]
    assert len(losses) == 3 and all(math.isfinite(v) for v in losses)
    assert "[train] done: loss" in second
    back = ref_ser.report_from_dict(json.loads(rep.read_text()))
    assert back.num_devices == 4
    kinds = {k: r["calls"] for k, r in back.compiled_summary.items()}
    assert kinds.get("all-gather", 0) > 0 and kinds.get("all-reduce", 0) > 0
    assert any(t.label.startswith("lm_batch[") for t in back.host_transfers)
