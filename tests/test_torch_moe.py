"""The Mixture-of-Experts slice against the reference: ``models/moe.py``,
``grok_1_314b`` (8 experts, top-2) and ``llama4_maverick_400b_a17b`` (128
experts, top-1) on the transformer backbone, and the ``moe-skew`` sweep
cell.

Numerics run in fp32 with the reference's weights carried across by
:func:`repro_torch.weights.from_jax_params` and inputs made with numpy.
Tolerances: ``moe_block``'s output and aux ``2e-5``, its gradients (x,
router, wi, wo) against ``jax.vjp`` ``1e-4``; the reduced models' loss and
every gradient ``1e-4``, prefill logits and decode steps over an fp32
cache ``2e-5``, the bf16 prefill cache one bf16 rounding, decode steps
over it ``2e-2`` (those of ``test_torch_configs_transformer.py``).  The
router's top-k is a discrete choice: each case asserts that no two of a
token's probabilities tie at its k-th choice, so ``torch.topk`` and
``jax.lax.top_k`` cannot order a tie differently.

On a mesh the block runs on local shards (the module docstring of
``models/moe.py`` says how); a real 4-rank gloo group holds its output,
aux and gradients to the plain computation in both of the reference's
layouts: experts over ``model`` (EP) and, where ``model`` does not divide
them, the hidden dim (TP-experts).

The captures: each reduced config's train step (the sweep cell), prefill
and decode (batch 8, prompt 32, cache 48) on the fake 4x2 mesh beside the
reference's on its 4x2 host mesh, per-kind (calls, payload bytes) pinned
side by side.  Neither package all-to-alls the tokens: the reference's
einsum dispatch is batched products that GSPMD partitions, the port's a
local step a shard.  The port all-gathers each weight where it is used
(the router over ``data`` and ``model``, ``wi`` and ``wo`` over ``data``:
4 a block), all-reduces the experts' shares over ``model`` (1 a block) and,
in training, reduces the gradients the shards share; GSPMD moves
activations (all-to-alls, collective-permutes) and scans the layers.
"""
import dataclasses
import importlib.util
import json
import math
import re
import socket
import subprocess
import sys
import types
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro import sweep as ref_sweep
from repro.compat import make_mesh
from repro.models import build_model as ref_build_model
from repro.models import moe as ref_moe
from repro.models.common import ModelConfig as RefModelConfig
from repro.parallel import Sharder as RefSharder
from repro_torch import configs, sweep
from repro_torch.launch import dryrun
from repro_torch.models import TransformerLM, build_model, moe
from repro_torch.models.common import (ModelConfig, SHAPES_BY_NAME, Spec,
                                       init_params, tree_leaves)
from repro_torch.parallel import Sharder
from repro_torch.weights import from_jax_params
from test_torch_train import _chip_smoke, _OpCount
from torch_fixtures import mesh_4x2, ref_serve_cell, ref_train_cell

ARCHS = ("grok_1_314b", "llama4_maverick_400b_a17b")
B, S = 2, 8
FP32_TOL, BF16_TOL, MODEL_TOL = 2e-5, 2e-2, 1e-4
# the reference's parameter counts of the published configs
# (``build_model(cfg).shapes()``); Llama-4's puts 128 experts in each of
# its 48 layers, 778 B rather than the name's 400 B
PARAMS = {"grok_1_314b": 316_489_340_928,
          "llama4_maverick_400b_a17b": 778_214_937_600}


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# ---------------------------------------------------------------------------
# configs and specs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_config_modules_match_reference(arch):
    """``CONFIG``, ``REDUCED`` and ``TRAIN`` field for field, the
    published parameter count, and a ``TransformerLM`` with MoE blocks."""
    mod, ref = configs.get(arch), ref_configs.get(arch)
    for name in ("CONFIG", "REDUCED", "TRAIN"):
        assert dataclasses.asdict(getattr(mod, name)) == \
            dataclasses.asdict(getattr(ref, name)), name
    model = build_model(mod.CONFIG)
    assert isinstance(model, TransformerLM)
    assert set(model.specs()["layers"]) == {"norm1", "attn", "norm2", "moe"}
    n = sum(t.numel() for t in tree_leaves(model.shapes(device="meta")))
    ref_n = sum(math.prod(s.shape) for s in jax.tree.leaves(
        ref_build_model(ref.CONFIG).shapes()))
    assert n == ref_n == PARAMS[arch]


def test_arch_ids_in_the_references_order():
    """The two MoE configs come first, as in the reference; with xLSTM
    ported ``ARCH_IDS`` is the reference's tuple, and so are
    ``LONG_CONTEXT_ARCHS`` and the dry run's ``cells()``."""
    assert configs.ARCH_IDS[:2] == ARCHS
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert configs.LONG_CONTEXT_ARCHS == ref_configs.LONG_CONTEXT_ARCHS
    for long in (True, False):
        assert configs.cells(long) == ref_configs.cells(long)


def _moe_cfgs(e: int, k: int, d: int = 32, f: int = 48):
    kw = dict(name="moe-test", family="moe", n_layers=1, d_model=d,
              n_heads=2, n_kv_heads=2, d_ff=f, vocab_size=64, n_experts=e,
              top_k=k)
    return RefModelConfig(**kw), ModelConfig(**kw)


@pytest.mark.parametrize("e,k,group", [(8, 2, 512), (128, 1, 512),
                                       (4, 2, 24), (4, 1, 1), (8, 2, 1),
                                       (3, 2, 16), (128, 1, 128),
                                       (8, 2, 128)])
def test_moe_spec_and_group_capacity(e, k, group):
    """Each leaf's shape, axes, init and scale, stacked and not, and the
    capacity of a group, its floor of 4 included (a decode step's one
    token, Llama-4's 128 experts over a 128-token prompt)."""
    rcfg, pcfg = _moe_cfgs(e, k)
    for stacked in (0, 3):
        ref = ref_moe.moe_spec(rcfg, stacked=stacked)
        got = moe.moe_spec(pcfg, stacked=stacked)
        assert set(got) == set(ref) == {"router", "wi", "wo"}
        for name in ref:
            r, p = ref[name], got[name]
            assert (p.shape, p.axes, p.init, p.scale, p.dtype) == \
                (r.shape, r.axes, r.init, r.scale, r.dtype)
    c = moe.group_capacity(pcfg, group)
    assert c == ref_moe.group_capacity(rcfg, group)
    assert c == max(4, math.ceil(1.25 * k * group / e))
    if 1.25 * k * group / e <= 3:
        assert c == 4


# ---------------------------------------------------------------------------
# moe_block against the reference
# ---------------------------------------------------------------------------
def _block_inputs(e: int, s: int, seed: int, hot: float = 0.0):
    """Weights and (2, s, 32) activations from ``seed``; with ``hot`` every
    token shares a component along one direction, which expert 0's router
    column takes ``hot`` times over (every token then prefers it)."""
    rng = np.random.default_rng(seed)
    p = {"router": rng.standard_normal((32, e)).astype(np.float32),
         "wi": (rng.standard_normal((e, 32, 96)) * 0.2).astype(np.float32),
         "wo": (rng.standard_normal((e, 48, 32)) * 0.2).astype(np.float32)}
    x = rng.standard_normal((2, s, 32)).astype(np.float32)
    if hot:
        u = np.full(32, 32 ** -0.5, np.float32)
        x += 4 * u
        p["router"][:, 0] += hot * u
    return p, x


def _assert_no_ties(p, x, k: int):
    """No token's k-th and (k+1)-th router probabilities are equal."""
    logits = torch.from_numpy(x) @ torch.from_numpy(p["router"])
    top = torch.topk(torch.softmax(logits, -1), min(k + 1, logits.shape[-1]),
                     dim=-1).values
    assert bool((top[..., k - 1] > top[..., -1]).all()) or \
        top.shape[-1] == k


def _ref_block(rcfg, p, x):
    shd = RefSharder(make_mesh((1, 1), ("data", "model")))
    return jax.jit(lambda p, x: ref_moe.moe_block(p, x, rcfg, shd))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))


BLOCK_CASES = [  # (experts, top-k, sequence): one group (s % 512 != 0)
    (4, 1, 24), (4, 2, 24), (8, 2, 40), (3, 2, 16),
    # two groups of 512
    (8, 2, 1024), (4, 1, 1024)]


@pytest.mark.parametrize("e,k,s", BLOCK_CASES)
def test_moe_block_matches_reference(e, k, s):
    rcfg, pcfg = _moe_cfgs(e, k)
    p, x = _block_inputs(e, s, seed=e * 100 + k * 10 + s)
    _assert_no_ties(p, x, k)
    ro, ra = _ref_block(rcfg, p, x)
    po, pa = moe.moe_block({n: torch.from_numpy(v) for n, v in p.items()},
                           torch.from_numpy(x), pcfg, Sharder())
    np.testing.assert_allclose(po.numpy(), np.asarray(ro), rtol=0,
                               atol=FP32_TOL)
    assert abs(float(pa) - float(ra)) <= FP32_TOL
    out, aux = moe.moe_block({n: torch.from_numpy(v) for n, v in p.items()},
                             torch.from_numpy(x), pcfg, Sharder(),
                             with_aux=False)
    assert aux is None and torch.equal(out, po)


@pytest.mark.parametrize("k", [1, 2])
def test_moe_block_with_dropped_choices(k):
    """A router whose expert 0 draws every token: the reference's
    dispatch drops choices past the capacity (fewer kept slots than
    choices made), and the port's output and aux still equal it."""
    e, s = 4, 64
    rcfg, pcfg = _moe_cfgs(e, k)
    p, x = _block_inputs(e, s, seed=11 + k, hot=5.0)
    _assert_no_ties(p, x, k)
    ro, ra = _ref_block(rcfg, p, x)
    # the reference's own dispatch: kept slots against choices made
    c = ref_moe.group_capacity(rcfg, s)
    rlogits = jnp.asarray(x)[:, None] @ jnp.asarray(p["router"])
    _, idx = jax.lax.top_k(jax.nn.softmax(rlogits, -1), k)
    first = np.asarray(idx[..., 0] == 0).sum(axis=(1, 2))
    assert (first > c).all()                # expert 0 overflows in each row
    vals, gidx = moe.route(torch.from_numpy(x)[:, None],
                           torch.from_numpy(p["router"]), k)[2:]
    dispatch, _, sel = moe.dispatch_tensors(vals, gidx, e, c)
    assert float(dispatch.sum()) < float(sel.sum()) == 2 * s * k
    assert float(dispatch[..., 0, :].sum()) == 2 * c
    po, pa = moe.moe_block({n: torch.from_numpy(v) for n, v in p.items()},
                           torch.from_numpy(x), pcfg, Sharder())
    np.testing.assert_allclose(po.numpy(), np.asarray(ro), rtol=0,
                               atol=FP32_TOL)
    assert abs(float(pa) - float(ra)) <= FP32_TOL


@pytest.mark.parametrize("e,k,s", [(4, 1, 24), (4, 2, 24), (8, 2, 1024)])
def test_moe_block_gradients(e, k, s):
    """Gradients of x, router, wi and wo through ``moe_block`` (the output
    against a fixed cotangent, plus the aux) against ``jax.vjp``."""
    rcfg, pcfg = _moe_cfgs(e, k)
    p, x = _block_inputs(e, s, seed=7 * e + k)
    _assert_no_ties(p, x, k)
    cot = np.random.default_rng(5).standard_normal(x.shape).astype(
        np.float32)
    shd = RefSharder(make_mesh((1, 1), ("data", "model")))

    _, vjp = jax.vjp(lambda p, x: ref_moe.moe_block(p, x, rcfg, shd),
                     {n: jnp.asarray(v) for n, v in p.items()},
                     jnp.asarray(x))
    rgrads = vjp((jnp.asarray(cot), jnp.ones((), jnp.float32)))
    tp = {n: torch.from_numpy(v).requires_grad_() for n, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = moe.moe_block(tp, tx, pcfg, Sharder())
    ((out * torch.from_numpy(cot)).sum() + aux).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(rgrads[1]),
                               rtol=0, atol=MODEL_TOL)
    for n in ("router", "wi", "wo"):
        np.testing.assert_allclose(tp[n].grad.numpy(),
                                   np.asarray(rgrads[0][n]), rtol=0,
                                   atol=MODEL_TOL, err_msg=n)


# ---------------------------------------------------------------------------
# the block on a real mesh: 4 gloo ranks, (data 2, model 2)
# ---------------------------------------------------------------------------
ROOT = Path(__file__).resolve().parents[1]
# one rank of the gloo group: argv is (rank, port, experts); prints its
# errors against the plain computation and the weights' layout as JSON
RANK = """
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
sys.path.insert(0, {src!r})
from repro_torch.models import moe
from repro_torch.models.common import ModelConfig
from repro_torch.parallel import Sharder

rank, port, e = map(int, sys.argv[1:])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{{port}}",
                        rank=rank, world_size=4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
cfg = ModelConfig(name="moe-test", family="moe", n_layers=1, d_model=32,
                  n_heads=2, n_kv_heads=2, d_ff=48, vocab_size=64,
                  n_experts=e, top_k=2)
rng = np.random.default_rng(3 * e)
p = {{"router": rng.standard_normal((32, e)),
      "wi": rng.standard_normal((e, 32, 96)) * 0.2,
      "wo": rng.standard_normal((e, 48, 32)) * 0.2}}
p = {{n: torch.from_numpy(v.astype(np.float32)) for n, v in p.items()}}
x = torch.from_numpy(rng.standard_normal((4, 24, 32)).astype(np.float32))
cot = torch.from_numpy(rng.standard_normal((4, 24, 32)).astype(np.float32))
tp = {{n: t.clone().requires_grad_() for n, t in p.items()}}
tx = x.clone().requires_grad_()
out, aux = moe.moe_block(tp, tx, cfg, Sharder())
((out * cot).sum() + aux).backward()
shd = Sharder(mesh)
axes = {{n: spec.axes for n, spec in moe.moe_spec(cfg).items()}}
dp = {{n: shd.shard(t, axes[n]).requires_grad_() for n, t in p.items()}}
dx = shd.shard(x, ("batch", "seq", None)).requires_grad_()
dout, daux = moe.moe_block(dp, dx, cfg, shd)
((dout * shd.shard(cot, ("batch", "seq", None))).sum() + daux).backward()
errs = {{"out": (dout.full_tensor() - out).abs().max().item(),
         "aux": abs(daux.full_tensor().item() - aux.item()),
         "x": (dx.grad.full_tensor() - tx.grad).abs().max().item()}}
for n in p:
    errs[n] = (dp[n].grad.full_tensor() - tp[n].grad).abs().max().item()
if rank == 0:
    print(json.dumps({{"errs": errs,
                      "wi": list(shd.spec(p["wi"].shape, axes["wi"]))}}))
dist.destroy_process_group()
"""


@pytest.mark.parametrize("e,wi_spec", [(4, ["model", "data", None]),
                                       (3, [None, "data", "model"])],
                         ids=["ep", "tp-experts"])
def test_block_on_a_gloo_mesh_matches_plain(e, wi_spec):
    """Output, aux and the gradients of x, router, wi and wo on a (data 2,
    model 2) gloo mesh of 4 processes against the plain computation of
    the same inputs, top-2: experts over ``model`` (4 experts, EP) and
    the hidden dim over ``model`` (3 experts, which ``model`` does not
    divide: TP-experts)."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    code = RANK.format(src=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(port),
                               str(e)], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    outs = [proc.communicate(timeout=240) for proc in procs]
    for proc, (_, err) in zip(procs, outs):
        assert proc.returncode == 0, err[-3000:]
    res = json.loads(outs[0][0].strip().splitlines()[-1])
    assert res["wi"] == wi_spec
    errs = res["errs"]
    assert errs["out"] <= FP32_TOL and errs["aux"] <= FP32_TOL, errs
    for n in ("x", "router", "wi", "wo"):
        assert errs[n] <= MODEL_TOL, (n, errs)


# ---------------------------------------------------------------------------
# the reduced models: loss, gradients, prefill, decode
# ---------------------------------------------------------------------------
def _cfgs(arch):
    rcfg = dataclasses.replace(ref_configs.config(arch, reduced=True),
                               compute_dtype="float32",
                               param_dtype="float32")
    pcfg = dataclasses.replace(configs.config(arch, reduced=True),
                               compute_dtype="float32",
                               param_dtype="float32")
    return rcfg, pcfg


_SETUP: dict = {}


def _setup(arch):
    """Both models, the same weights and prompts, the reference's
    prefill."""
    if arch not in _SETUP:
        rcfg, pcfg = _cfgs(arch)
        rmodel, pmodel = ref_build_model(rcfg), build_model(pcfg)
        rparams = rmodel.init(jax.random.PRNGKey(3))
        pparams = from_jax_params(jax.tree.map(np.asarray, rparams), pcfg,
                                  device="cpu")
        t = np.random.default_rng(0).integers(0, rcfg.vocab_size, (B, S),
                                              dtype=np.int32)
        rshd = RefSharder(make_mesh((1, 1), ("data", "model")))
        max_len = S + 4
        rlogits, rcache = jax.jit(lambda p, b: rmodel.prefill(
            p, b, rshd, max_len=max_len))(rparams, {"tokens": jnp.asarray(t)})
        _SETUP[arch] = dict(rmodel=rmodel, pmodel=pmodel, rparams=rparams,
                            pparams=pparams, tokens=t, rshd=rshd,
                            max_len=max_len, rlogits=rlogits, rcache=rcache)
    return _SETUP[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """``loss_fn`` (cross-entropy plus every layer's aux) under the TRAIN
    preset's remat, its ``xent`` and ``aux`` metrics, and every parameter
    gradient against ``jax.value_and_grad``, fp32, MODEL_TOL."""
    rcfg, pcfg = _cfgs(arch)
    remat = configs.train_config(arch).remat
    rparams = ref_build_model(rcfg).init(jax.random.PRNGKey(5))
    params = from_jax_params(jax.tree.map(np.asarray, rparams), pcfg,
                             device="cpu")
    rng = np.random.default_rng(6)
    tok = rng.integers(0, rcfg.vocab_size, (2, 12), dtype=np.int32)
    lab = rng.integers(0, rcfg.vocab_size, (2, 12), dtype=np.int32)
    lab[rng.random((2, 12)) < 0.1] = -1
    for t in tree_leaves(params):
        t.requires_grad_()
    loss, metrics = build_model(pcfg).loss_fn(
        params, {"tokens": torch.from_numpy(tok).long(),
                 "labels": torch.from_numpy(lab)}, Sharder(), remat=remat)
    loss.backward()
    rmodel = ref_build_model(rcfg)
    (rloss, rmetrics), rgrads = jax.value_and_grad(
        lambda p: rmodel.loss_fn(p, {"tokens": jnp.asarray(tok),
                                     "labels": jnp.asarray(lab)},
                                 RefSharder(make_mesh((1, 1),
                                                      ("data", "model"))),
                                 remat=remat), has_aux=True)(rparams)
    assert abs(float(loss.detach()) - float(rloss)) <= MODEL_TOL
    for name in ("xent", "aux"):
        assert abs(float(metrics[name].detach()) - float(rmetrics[name])) \
            <= MODEL_TOL, name
    assert float(metrics["aux"].detach()) > 0
    for path, g in jax.tree_util.tree_leaves_with_path(rgrads):
        node = params
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node.grad.numpy(), np.asarray(g), rtol=0,
                                   atol=MODEL_TOL,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache(arch):
    s = _setup(arch)
    with torch.inference_mode():
        logits, cache = s["pmodel"].prefill(
            s["pparams"], {"tokens": torch.from_numpy(s["tokens"]).long()},
            Sharder(), max_len=s["max_len"])
    np.testing.assert_allclose(_f32(logits), _f32(s["rlogits"]), rtol=0,
                               atol=FP32_TOL)
    assert int(cache["len"]) == int(s["rcache"]["len"]) == S
    for name in ("k", "v"):
        got, want = cache[name], s["rcache"][name]
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=2 ** -7,
                                   atol=1e-6)


@pytest.mark.parametrize("cache_dtype,tol", [("float32", FP32_TOL),
                                             ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps(arch, cache_dtype, tol):
    """Three decode steps from the reference's prefill cache (cast to
    ``cache_dtype``), one new token a step: each a group of one token, at
    the capacity floor of 4."""
    s = _setup(arch)
    rmodel, pmodel, rshd = s["rmodel"], s["pmodel"], s["rshd"]
    rcache = {k: (v.astype(cache_dtype) if k != "len" else v)
              for k, v in s["rcache"].items()}
    pcache = {k: torch.from_numpy(np.array(_f32(v))).to(
                  getattr(torch, cache_dtype)) if k != "len"
              else torch.tensor(int(v), dtype=torch.int32)
              for k, v in s["rcache"].items()}
    rstep = jax.jit(lambda p, c, b: rmodel.decode_step(p, c, b, rshd))
    rng = np.random.default_rng(1)
    for _ in range(3):
        t = rng.integers(0, pmodel.cfg.vocab_size, (B, 1), dtype=np.int32)
        rl, rcache = rstep(s["rparams"], rcache, {"tokens": jnp.asarray(t)})
        with torch.inference_mode():
            pl, pcache = pmodel.decode_step(
                s["pparams"], pcache, {"tokens": torch.from_numpy(t).long()},
                Sharder())
        assert pl.shape == rl.shape == (B, 1, pmodel.cfg.vocab_size)
        np.testing.assert_allclose(_f32(pl), _f32(rl), rtol=0, atol=tol)
    assert int(pcache["len"]) == int(rcache["len"]) == S + 3


# ---------------------------------------------------------------------------
# layouts on the production mesh
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_published_sharding_specs_on_16x16(arch):
    """Every parameter's mesh axes at the published size on the 16x16
    production mesh, the port's Sharder against the reference's: Grok-1's
    8 experts do not divide model 16, so its hidden dim takes it
    (TP-experts); Llama-4's 128 do (EP)."""
    sizes = {"data": 16, "model": 16}
    port = Sharder()
    port.mesh_sizes = dict(sizes)
    ref = RefSharder(types.SimpleNamespace(
        axis_names=tuple(sizes), devices=np.empty((16, 16))))
    model = build_model(configs.config(arch))
    shapes = tree_leaves(model.shapes(device="meta"))
    axes = tree_leaves(model.axes())
    for t, ax in zip(shapes, axes):
        assert port.spec(t.shape, ax) == tuple(ref.spec(t.shape, ax))
    moe_layer = model.specs()["layers"]["moe"]
    wi = port.spec(moe_layer["wi"].shape, moe_layer["wi"].axes)
    wo = port.spec(moe_layer["wo"].shape, moe_layer["wo"].axes)
    if arch == "grok_1_314b":
        assert (wi, wo) == ((None, None, "data", "model"),
                            (None, None, "model", "data"))
    else:
        assert (wi, wo) == ((None, "model", "data", None),
                            (None, "model", None, "data"))


# ---------------------------------------------------------------------------
# captures on the 4x2 mesh beside the reference's
# ---------------------------------------------------------------------------
_REPORTS: dict = {}


def _kinds(summary):
    return {k: (r["calls"], r["payload_bytes"]) for k, r in summary.items()}


def _tables(arch, ref: bool) -> dict:
    """step -> kind -> (calls, payload bytes) of the train, prefill and
    decode captures."""
    key = (arch, ref)
    if key not in _REPORTS:
        if ref:
            cfg = ref_configs.config(arch, reduced=True)
            mesh = ref_sweep.build_mesh("4x2")
            cells = {"train": ref_train_cell(cfg),
                     "serve": ref_serve_cell(cfg)}
            reps = {k: ref_sweep._monitor_cell(b(mesh), mesh, arch, "ring")
                    for k, b in cells.items()}
        else:
            cfg = configs.config(arch, reduced=True)
            cells = {
                "train": lambda m: sweep.train_cell(m, cfg, global_batch=8,
                                                    seq_len=64),
                "serve": lambda m: sweep.serve_cell(
                    m, cfg, batch=8, prompt_len=32, max_len=48)}
            reps = {k: sweep._monitor_cell(b, mesh_4x2(), arch)
                    for k, b in cells.items()}
        out = {"train": _kinds(reps["train"].compiled_summary)}
        out.update({ph: _kinds(summ) for ph, summ in
                    reps["serve"].phase_summaries().items()})
        _REPORTS[key] = out
    return _REPORTS[key]


# kind -> (calls, payload bytes per device): the port's on the fake CPU 4x2
# mesh, the reduced configs (4 experts: over model 2, EP); the two configs'
# tables are the same (top-1 and top-2 move the same tensors on a mesh)
PORT_TABLE = {
    "train": {"all-gather": (72, 5980160), "all-reduce": (55, 1449992),
              "reduce-scatter": (33, 1775616)},
    "prefill": {"all-gather": (43, 2174976), "all-reduce": (9, 294912),
                "reduce-scatter": (1, 8192)},
    "decode": {"all-gather": (51, 1669248), "all-reduce": (17, 18432),
               "reduce-scatter": (13, 32768)},
}
# the reference's on its 4x2 host mesh (GSPMD): no all-to-all in serving
REF_TABLES = {
    "grok_1_314b": {
        "train": {"all-gather": (77, 7548928), "all-reduce": (66, 4488168),
                  "all-to-all": (2, 524288),
                  "collective-permute": (1, 512)},
        "prefill": {"all-gather": (12, 557056), "all-reduce": (8, 262144)},
        "decode": {"all-gather": (16, 25600), "all-reduce": (20, 13312)},
    },
    "llama4_maverick_400b_a17b": {
        "train": {"all-gather": (77, 7548928), "all-reduce": (66, 4479976),
                  "all-to-all": (2, 524288),
                  "collective-permute": (1, 512)},
        "prefill": {"all-gather": (12, 557056), "all-reduce": (8, 262144)},
        "decode": {"all-gather": (16, 25600), "all-reduce": (20, 13312)},
    },
}


@pytest.mark.parametrize("step", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_capture_tables_pinned_beside_reference(arch, step):
    """The port's and the reference's per-kind tables, pinned side by side
    (the module docstring says why they differ)."""
    assert _tables(arch, ref=False)[step] == PORT_TABLE[step]
    assert _tables(arch, ref=True)[step] == REF_TABLES[arch][step]


def test_tp_experts_capture_gathers_the_hidden_dim():
    """Three experts on model 2 (TP-experts): each block all-gathers its
    gate and up halves over ``model`` between its two local steps, where
    the EP layout gathers nothing there -- one all-gather of the (experts,
    rows, 2f) hidden a layer beside the same four weight gathers."""
    cfg = dataclasses.replace(configs.config("grok_1_314b", reduced=True),
                              n_experts=3)
    rep = sweep._monitor_cell(lambda m: sweep.serve_cell(
        m, cfg, batch=8, prompt_len=32, max_len=48), mesh_4x2(), "tp")
    ops = [op for op in rep.compiled_ops if op.phase == "prefill"
           and op.kind == "all-gather" and op.group_size == 2]
    # the bf16 hidden gathered: 3 experts x (8/4 rows x c slots) x 2f
    c = moe.group_capacity(cfg, 32)
    hidden = [op for op in ops
              if op.payload_bytes == 3 * 2 * c * 2 * cfg.d_ff * 2]
    assert len(hidden) == cfg.n_layers
    assert _kinds(rep.phase_summaries()["prefill"])["all-reduce"] == \
        PORT_TABLE["prefill"]["all-reduce"]


# ---------------------------------------------------------------------------
# the moe-skew sweep cell
# ---------------------------------------------------------------------------
def test_moe_skew_cell_carries_irregular_vectors():
    """The reference's contract (``tests/test_sweep.py``): every captured
    all-to-all carries a per-rank byte vector summing to its payload with
    the hot expert above the ``skewed-a2a`` threshold, the summary grows
    the ``max_skew`` column, and the lint pass fires; the calls and bytes
    by kind equal the reference cell's."""
    spec = sweep.available_configs()["moe-skew"]
    ref_spec = ref_sweep.available_configs()["moe-skew"]
    assert spec.config_id == ref_spec.config_id
    assert list(sweep.available_configs()).index("moe-skew") == \
        list(sweep.available_configs()).index("serve") + 1
    mesh = mesh_4x2()
    rep = sweep._monitor_cell(spec.build, mesh, "moe-skew@4x2")
    a2as = [op for op in rep.compiled_ops
            if op.kind in ("all-to-all", "ragged-all-to-all")]
    assert len(a2as) == 2
    for op in a2as:
        vec = op.byte_vector()
        assert vec is not None
        assert vec.sum() == pytest.approx(op.payload_bytes)
        assert op.skew() > 2.0
    assert any(row.get("max_skew", 1.0) > 2.0
               for row in rep.compiled_summary.values())
    assert any(f.rule_id == "skewed-a2a" for f in rep.lint())
    rmesh = ref_sweep.build_mesh("4x2")
    ref = ref_sweep._monitor_cell(ref_spec.build(rmesh), rmesh, "moe-skew",
                                  "ring")
    assert rep.compiled_summary == ref.compiled_summary


def test_moe_skew_example_walkthrough(capsys):
    """``examples/torch_moe_skew.py`` on a CPU mesh: both phases' tables,
    the skew column only in the skewed one, the skewed phase the slower,
    and one ``skewed-a2a`` finding an all-to-all of the skewed phase."""
    mesh_4x2()       # the process's fake group of 8 ranks
    spec = importlib.util.spec_from_file_location(
        "torch_moe_skew", ROOT / "examples" / "torch_moe_skew.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    findings = example.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert [f.rule_id for f in findings] == ["skewed-a2a"] * 2
    assert {f.phase for f in findings} == {"skewed"}
    assert out.count("Skew (max/mean)") == 1 and "4.80x" in out
    times = re.search(r"balanced ([\d.]+) us, skewed ([\d.]+) us", out)
    assert float(times[2]) > float(times[1])


# ---------------------------------------------------------------------------
# the dry run and the init
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_decode_dryrun_cell(arch, monkeypatch):
    """A reduced config's decode_32k cell on the 4x2 mesh: captured, every
    op of weight 1, collectives and FLOPs counted, and the cache it
    updates in place equal to :func:`dryrun.cache_bytes_per_device`."""
    from repro_torch.core.summary import summarize

    reduced = configs.config
    monkeypatch.setattr(configs, "config",
                        lambda a, reduced_=False: reduced(a, reduced=True))
    cell = dryrun.capture_cell(arch, "decode_32k", mesh_4x2())
    kinds = _kinds(summarize(cell["ops"]))
    assert {op.weight for op in cell["ops"]} == {1.0}
    assert kinds["all-reduce"][0] > 0 and kinds["all-gather"][0] > 0
    assert cell["memory"]["alias_bytes"] == dryrun.cache_bytes_per_device(
        reduced(arch, reduced=True), SHAPES_BY_NAME["decode_32k"], (4, 2),
        ("data", "model"))


def test_init_draws_one_expert_matrix_at_a_time():
    """A stacked expert leaf (L, E, d, 2f) is drawn one (d, 2f) matrix at a
    time, so no fp32 temporary exceeds one expert's matrix, and a seed
    gives the same values twice."""
    specs = {"wi": Spec((2, 3, 8, 16), ("layers", "expert", "embed", "mlp")),
             "w": Spec((8, 16), ("embed", "mlp"))}
    drawn = []
    randn = torch.randn

    def spy(*args, **kwargs):
        out = randn(*args, **kwargs)
        drawn.append(tuple(out.shape))
        return out

    with mock.patch.object(torch, "randn", spy):
        a = init_params(specs, torch.Generator().manual_seed(4),
                        "bfloat16", device="cpu")
    assert drawn == [(8, 16)] * 7
    b = init_params(specs, torch.Generator().manual_seed(4), "bfloat16",
                    device="cpu")
    assert a["wi"].dtype == torch.bfloat16
    assert all(torch.equal(a[k], b[k]) for k in specs)
    assert not torch.equal(a["wi"][0, 0], a["wi"][0, 1])


# ---------------------------------------------------------------------------
# the serve path's kernel calls
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_kernel_calls_equal_chip_smoke_expectation(arch):
    """One prefill and three decode steps of a reduced MoE config, cut to
    the depth the card serves (``chip_smoke.SERVE_LAYERS``): the kernel
    ops called equal ``chip_smoke.expected_launches``, which the card's
    launch counters are held to; the MoE blocks call none."""
    from repro_torch.serve import generate

    cs = _chip_smoke()
    cfg = dataclasses.replace(configs.config(arch, reduced=True),
                              n_layers=cs.SERVE_LAYERS[arch])
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    prompts = torch.zeros((2, 8), dtype=torch.long)
    with _OpCount() as mode:
        generate(model, params, prompts, Sharder(), steps=4, max_len=12)
    assert mode.counts == cs.expected_launches(cfg, 3)
    assert mode.counts["rmsnorm"] == 4 * (2 * cfg.n_layers + 1)
