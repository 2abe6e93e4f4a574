"""The five configs on the transformer backbone against the reference:
``codeqwen15_7b`` (MHA), ``granite_3_2b`` (a vocab no mesh axis divides),
``granite_20b`` (MQA), ``chameleon_34b`` (``vlm``, qk-norm) and
``musicgen_medium`` (``audio``); the last two read stub embeddings in
place of token ids.

Each test is parametrised over the five archs.  Their ``REDUCED`` configs
run in fp32 with the reference's weights carried across by
:func:`repro_torch.weights.from_jax_params`; token ids and embeddings are
made with numpy.  Tolerances are those of ``test_torch_train.py`` (the
loss and every gradient ``1e-4``) and ``test_torch_model.py`` (prefill
logits and decode steps over an fp32 cache ``2e-5``, the bf16 prefill
cache one bf16 rounding, decode steps over it ``2e-2``).

The captures: each arch's reduced train step (the sweep cell), prefill and
decode (batch 8, prompt 32, cache 48, as the ``serve`` sweep cell) on the
fake 4x2 mesh beside the reference's on its 4x2 host mesh.  The per-kind
(calls, payload bytes) tables are pinned side by side, because the two
partitioners place tensors differently (ROADMAP queue 3 item 6): DTensor
all-gathers each FSDP-sharded weight where it is used, all-reduces the
row-parallel outputs over ``model``, reduce-scatters data-partial products
back to batch-sharded rows and unrolls the layers (weight 1 an op); on a
CPU mesh its shard-to-shard moves are all-gathers and a chunk (queue 3
item 9).  GSPMD moves activations instead (all-to-alls,
collective-permutes) and scans the layers.  Both shard the cache by
sequence (``kv_seq``).  The port's prefill fills each layer's cache whole
and reshards it from kv heads to sequence shards (an all-to-all; on a CPU
mesh an all-gather and a chunk, 2 a layer where kv heads divide
``model``); its decode gathers q, k and v to all heads (3 all-gathers a
layer where they were head-sharded), decodes the rank's sequence shard
and merges the shards' partials with two fp32 all-reduces a layer over
``model`` (a max of the log-sum-exp, a sum of the packed output).
Granite-20B's one kv head, which a model shard splits along its head dim,
is gathered whole before the rotary embedding, as every split head is.  Granite-3-2B also runs at its published
vocab of 49155 (``granite_3_2b@v49155``): the embedding and the head then
take the Sharder's prefix fallback, replicated over ``model``, in both
packages, so the logits are gathered whole where the other configs gather
vocab shards.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro import sweep as ref_sweep
from repro.compat import make_mesh
from repro.models import build_model as ref_build_model
from repro.parallel import Sharder as RefSharder
from repro_torch import configs, sweep
from repro_torch.launch import serve as launch
from repro_torch.models import build_model
from repro_torch.models.common import tree_leaves
from repro_torch.parallel import Sharder
from repro_torch.weights import from_jax_params
from torch_fixtures import mesh_4x2, ref_serve_cell, ref_train_cell

ARCHS = ("codeqwen15_7b", "granite_3_2b", "granite_20b", "chameleon_34b",
         "musicgen_medium")
B, S = 2, 8
FP32_TOL, BF16_TOL, MODEL_TOL = 2e-5, 2e-2, 1e-4

# the reference's parameter counts of the published configs
# (``build_model(cfg).shapes()``)
PARAMS = {"codeqwen15_7b": 8_189_644_800, "granite_3_2b": 2_634_201_088,
          "granite_20b": 28_167_493_632, "chameleon_34b": 34_293_436_416,
          "musicgen_medium": 1_818_379_776}


# ---------------------------------------------------------------------------
# the configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_config_modules_match_reference(arch):
    """``CONFIG``, ``REDUCED`` and ``TRAIN`` field for field; the registry
    keeps the reference's order; the published parameter count."""
    mod, ref = configs.get(arch), ref_configs.get(arch)
    for name in ("CONFIG", "REDUCED", "TRAIN"):
        assert dataclasses.asdict(getattr(mod, name)) == \
            dataclasses.asdict(getattr(ref, name)), name
    assert configs.ARCH_IDS == tuple(a for a in ref_configs.ARCH_IDS
                                     if a in configs.ARCH_IDS)
    shapes = build_model(mod.CONFIG).shapes(device="meta")
    n = sum(t.numel() for t in tree_leaves(shapes))
    ref_n = sum(math.prod(s.shape) for s in jax.tree.leaves(
        ref_build_model(ref.CONFIG).shapes()))
    assert n == ref_n == PARAMS[arch]


def test_build_model_by_family():
    """``dense``/``vlm``/``audio`` run on the transformer backbone; a
    ``moe`` config builds one too, with MoE blocks in place of the MLPs;
    ``ssm`` builds the xLSTM model."""
    from repro_torch.models import TransformerLM, XLSTMLM

    for arch in ARCHS:
        assert isinstance(build_model(configs.config(arch)), TransformerLM)
    moe = dataclasses.replace(configs.config("qwen3_8b"), family="moe",
                              n_experts=8, top_k=2)
    model = build_model(moe)
    assert isinstance(model, TransformerLM)
    layer = model.specs()["layers"]
    assert "moe" in layer and "mlp" not in layer
    assert layer["moe"]["wi"].shape == (moe.n_layers, 8, moe.d_model,
                                        2 * moe.d_ff)
    ssm = dataclasses.replace(configs.config("qwen3_8b"), family="ssm")
    assert isinstance(build_model(ssm), XLSTMLM)


@pytest.mark.parametrize("arch", ["chameleon_34b", "musicgen_medium"])
def test_serve_refuses_an_embeddings_config(arch):
    """The modality front ends are stubs: serving feeds token ids back."""
    cfg = launch.model_config(arch, reduced=True)
    with pytest.raises(ValueError, match="front end is a stub"):
        launch.serve(cfg, batch=1, prompt_len=4, tokens=2, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_published_sharding_specs_match_reference(arch):
    """Every parameter's mesh axes at the published size,
    the port's Sharder against the reference's on the 4x2 mesh: the same
    prefix fallback (Granite-3-2B's vocab of 49155, Granite-20B's single
    kv head replicated under ``kv_heads``)."""
    cfg = configs.config(arch)
    port = Sharder(mesh_4x2())
    ref = RefSharder(make_mesh((4, 2), ("data", "model")))
    model, rmodel = build_model(cfg), ref_build_model(ref_configs.config(arch))
    shapes = tree_leaves(model.shapes(device="meta"))
    axes = tree_leaves(model.axes())
    assert len(shapes) == len(axes)
    rshapes = jax.tree.leaves(rmodel.shapes())
    assert [tuple(t.shape) for t in shapes] == [s.shape for s in rshapes]
    for t, ax in zip(shapes, axes):
        assert port.spec(t.shape, ax) == tuple(ref.spec(t.shape, ax))
    vocab = port.spec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"))
    assert vocab == ((None, "data") if arch == "granite_3_2b"
                     else ("model", "data"))
    kv = port.spec((cfg.d_model, cfg.n_kv_heads * cfg.dh),
                   ("embed", "kv_heads"))
    assert kv == ("data", "model")


# ---------------------------------------------------------------------------
# numerics: the reduced configs in fp32
# ---------------------------------------------------------------------------
def _cfgs(arch):
    rcfg = dataclasses.replace(ref_configs.config(arch, reduced=True),
                               compute_dtype="float32")
    pcfg = dataclasses.replace(configs.config(arch, reduced=True),
                               compute_dtype="float32")
    return rcfg, pcfg


def _inputs(cfg, rng, b, s):
    """(reference batch, port batch): token ids, or embeddings for a
    config that reads them."""
    if cfg.input_mode == "embeddings":
        x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        return {"embeds": jnp.asarray(x)}, {"embeds": torch.from_numpy(x)}
    t = rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)
    return {"tokens": jnp.asarray(t)}, {"tokens": torch.from_numpy(t).long()}


_SETUP: dict = {}


def _setup(arch):
    """Both models, the same weights and prompts, the reference's prefill."""
    if arch not in _SETUP:
        rcfg, pcfg = _cfgs(arch)
        rmodel, pmodel = ref_build_model(rcfg), build_model(pcfg)
        rparams = rmodel.init(jax.random.PRNGKey(3))
        pparams = from_jax_params(jax.tree.map(np.asarray, rparams), pcfg,
                                  device="cpu")
        rbatch, pbatch = _inputs(rcfg, np.random.default_rng(0), B, S)
        rshd = RefSharder(make_mesh((1, 1), ("data", "model")))
        max_len = S + 4
        rlogits, rcache = jax.jit(lambda p, b: rmodel.prefill(
            p, b, rshd, max_len=max_len))(rparams, rbatch)
        _SETUP[arch] = dict(rmodel=rmodel, pmodel=pmodel, rparams=rparams,
                            pparams=pparams, rbatch=rbatch, pbatch=pbatch,
                            rshd=rshd, max_len=max_len, rlogits=rlogits,
                            rcache=rcache)
    return _SETUP[arch]


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """``loss_fn`` under the TRAIN preset's remat and every parameter
    gradient against ``jax.value_and_grad``, fp32, MODEL_TOL.  An
    embeddings config never reads its token table: the port leaves that
    leaf's gradient unset, the reference's is zeros."""
    rcfg, pcfg = _cfgs(arch)
    remat = configs.train_config(arch).remat
    rparams = ref_build_model(rcfg).init(jax.random.PRNGKey(5))
    params = from_jax_params(jax.tree.map(np.asarray, rparams), pcfg,
                             device="cpu")
    rng = np.random.default_rng(6)
    rbatch, pbatch = _inputs(rcfg, rng, 2, 12)
    lab = rng.integers(0, rcfg.vocab_size, (2, 12), dtype=np.int32)
    lab[rng.random((2, 12)) < 0.1] = -1
    rbatch["labels"], pbatch["labels"] = jnp.asarray(lab), \
        torch.from_numpy(lab)
    if "tokens" not in rbatch:    # the reference's input_specs carry both
        rbatch["tokens"] = jnp.zeros((2, 12), jnp.int32)
    for t in tree_leaves(params):
        t.requires_grad_()
    loss, _ = build_model(pcfg).loss_fn(params, pbatch, Sharder(),
                                        remat=remat)
    loss.backward()
    rmodel = ref_build_model(rcfg)
    (rloss, _), rgrads = jax.value_and_grad(
        lambda p: rmodel.loss_fn(p, rbatch, RefSharder(
            make_mesh((1, 1), ("data", "model"))), remat=remat),
        has_aux=True)(rparams)
    assert abs(float(loss.detach()) - float(rloss)) <= MODEL_TOL
    for path, g in jax.tree_util.tree_leaves_with_path(rgrads):
        node = params
        for k in path:
            node = node[k.key]
        if node.grad is None:
            assert pcfg.input_mode == "embeddings" and path[0].key == "embed"
            assert not np.asarray(g).any()
            continue
        np.testing.assert_allclose(node.grad.numpy(), np.asarray(g), rtol=0,
                                   atol=MODEL_TOL,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache(arch):
    s = _setup(arch)
    with torch.inference_mode():
        logits, cache = s["pmodel"].prefill(s["pparams"], s["pbatch"],
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
    ``cache_dtype``), one new token or embedding a step."""
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
        rbatch, pbatch = _inputs(pmodel.cfg, rng, B, 1)
        rl, rcache = rstep(s["rparams"], rcache, rbatch)
        with torch.inference_mode():
            pl, pcache = pmodel.decode_step(s["pparams"], pcache, pbatch,
                                            Sharder())
        assert pl.shape == rl.shape == (B, 1, pmodel.cfg.vocab_size)
        np.testing.assert_allclose(_f32(pl), _f32(rl), rtol=0, atol=tol)
    assert int(pcache["len"]) == int(rcache["len"]) == S + 3


# ---------------------------------------------------------------------------
# captures on the 4x2 mesh against the reference's
# ---------------------------------------------------------------------------
PUBLISHED_VOCAB = "granite_3_2b@v49155"
CAPTURED = ARCHS + (PUBLISHED_VOCAB,)


def _capture_cfg(name, ref: bool):
    arch, _, vocab = name.partition("@v")
    cfg = (ref_configs if ref else configs).config(arch, reduced=True)
    return dataclasses.replace(cfg, vocab_size=int(vocab)) if vocab else cfg


_REPORTS: dict = {}


def _tables(name, ref: bool) -> dict:
    """step -> kind -> (calls, payload bytes) of the train, prefill and
    decode captures."""
    key = (name, ref)
    if key not in _REPORTS:
        cfg = _capture_cfg(name, ref)
        if ref:
            mesh = ref_sweep.build_mesh("4x2")
            cells = {"train": ref_train_cell(cfg), "serve": ref_serve_cell(cfg)}
            reps = {k: ref_sweep._monitor_cell(b(mesh), mesh, name, "ring")
                    for k, b in cells.items()}
        else:
            cells = {
                "train": lambda m: sweep.train_cell(m, cfg, global_batch=8,
                                                    seq_len=64),
                "serve": lambda m: sweep.serve_cell(
                    m, cfg, batch=8, prompt_len=32, max_len=48)}
            reps = {k: sweep._monitor_cell(b, mesh_4x2(), name)
                    for k, b in cells.items()}
        out = {"train": _kinds(reps["train"].compiled_summary)}
        out.update({ph: _kinds(summ) for ph, summ in
                    reps["serve"].phase_summaries().items()})
        _REPORTS[key] = out
    return _REPORTS[key]


def _kinds(summary):
    return {k: (r["calls"], r["payload_bytes"]) for k, r in summary.items()}


# kind -> (calls, payload bytes per device), by arch and step: the port's
# on the fake CPU 4x2 mesh
PORT_TABLES = {
    "codeqwen15_7b": {
        "train": {"all-gather": (72, 9900032), "all-reduce": (39, 1450568),
            "reduce-scatter": (25, 1441792)},
        "prefill": {"all-gather": (39, 2037760), "all-reduce": (9, 294912),
            "reduce-scatter": (1, 8192)},
        "decode": {"all-gather": (51, 155776), "all-reduce": (17, 18432),
            "reduce-scatter": (17, 65536)},
    },
    "granite_3_2b": {
        "train": {"all-gather": (72, 9900032), "all-reduce": (39, 1450568),
            "reduce-scatter": (25, 1441792)},
        "prefill": {"all-gather": (39, 2037760), "all-reduce": (9, 294912),
            "reduce-scatter": (1, 8192)},
        "decode": {"all-gather": (51, 155776), "all-reduce": (17, 18432),
            "reduce-scatter": (17, 65536)},
    },
    "granite_20b": {
        "train": {"all-gather": (96, 10588160), "all-reduce": (39, 1450568),
            "reduce-scatter": (25, 1343488)},
        "prefill": {"all-gather": (39, 1660928), "all-reduce": (9, 294912),
            "reduce-scatter": (1, 8192)},
        "decode": {"all-gather": (51, 131200), "all-reduce": (17, 18432),
            "reduce-scatter": (17, 53248)},
    },
    "chameleon_34b": {
        "train": {"all-gather": (69, 9633792), "all-reduce": (54, 1388104),
            "reduce-scatter": (25, 1441792)},
        "prefill": {"all-gather": (37, 1968128), "all-reduce": (8, 262144),
            "reduce-scatter": (1, 8192)},
        "decode": {"all-gather": (49, 129024), "all-reduce": (16, 17408),
            "reduce-scatter": (17, 57344)},
    },
    "musicgen_medium": {
        "train": {"all-gather": (69, 9633792), "all-reduce": (38, 1385032),
            "reduce-scatter": (25, 1441792)},
        "prefill": {"all-gather": (37, 1968128), "all-reduce": (8, 262144),
            "reduce-scatter": (1, 8192)},
        "decode": {"all-gather": (49, 153600), "all-reduce": (16, 17408),
            "reduce-scatter": (17, 65536)},
    },
    "granite_3_2b@v49155": {
        "train": {"all-gather": (73, 108668928), "all-reduce": (35, 13899064),
            "reduce-scatter": (27, 227816960)},
        "prefill": {"all-gather": (40, 2068480), "all-reduce": (8, 262144),
            "reduce-scatter": (1, 1572960)},
        "decode": {"all-gather": (51, 155776), "all-reduce": (16, 17408),
            "reduce-scatter": (17, 1630304)},
    },
}
# the reference's on its 4x2 host mesh (GSPMD)
REF_TABLES = {
    "codeqwen15_7b": {
        "train": {"all-gather": (53, 2625536), "all-reduce": (30, 2433744),
            "all-to-all": (14, 8912896), "collective-permute": (17, 1049088)},
        "prefill": {"all-gather": (8, 524288), "all-reduce": (8, 262144),
            "collective-permute": (8, 262144)},
        "decode": {"all-gather": (12, 24576), "all-reduce": (20, 13312),
            "collective-permute": (8, 8192)},
    },
    "granite_3_2b": {
        "train": {"all-gather": (53, 2625536), "all-reduce": (30, 2433744),
            "all-to-all": (14, 8912896), "collective-permute": (17, 1049088)},
        "prefill": {"all-gather": (8, 524288), "all-reduce": (8, 262144),
            "collective-permute": (8, 262144)},
        "decode": {"all-gather": (12, 24576), "all-reduce": (20, 13312),
            "collective-permute": (8, 8192)},
    },
    "granite_20b": {
        "train": {"all-gather": (69, 2953216), "all-reduce": (38, 2515664),
            "all-to-all": (50, 9699328), "collective-permute": (41, 1098240)},
        "prefill": {"all-reduce": (8, 262144),
            "collective-permute": (8, 262144)},
        "decode": {"all-gather": (4, 8192), "all-reduce": (20, 13312),
            "collective-permute": (8, 8192)},
    },
    "chameleon_34b": {
        "train": {"all-gather": (50, 2359296), "all-reduce": (28, 2304184),
            "all-to-all": (12, 8388608), "collective-permute": (16, 1048576)},
        "prefill": {"all-gather": (8, 524288), "all-reduce": (8, 262144),
            "collective-permute": (8, 262144)},
        "decode": {"all-gather": (12, 24576), "all-reduce": (20, 13312),
            "collective-permute": (8, 8192)},
    },
    "musicgen_medium": {
        "train": {"all-gather": (50, 2359296), "all-reduce": (28, 2302648),
            "all-to-all": (12, 8388608), "collective-permute": (16, 1048576)},
        "prefill": {"all-gather": (8, 524288), "all-reduce": (8, 262144),
            "collective-permute": (8, 262144)},
        "decode": {"all-gather": (12, 24576), "all-reduce": (20, 13312),
            "collective-permute": (8, 8192)},
    },
    "granite_3_2b@v49155": {
        "train": {"all-gather": (52, 52567040), "all-reduce": (25, 39850928),
            "all-to-all": (14, 8912896), "collective-permute": (17, 1049088)},
        "prefill": {"all-gather": (8, 524288), "all-reduce": (8, 262144),
            "collective-permute": (8, 262144)},
        "decode": {"all-gather": (12, 24576), "all-reduce": (20, 13312),
            "collective-permute": (8, 8192)},
    },
}


@pytest.mark.parametrize("step", ["train", "prefill", "decode"])
@pytest.mark.parametrize("name", CAPTURED)
def test_capture_tables_pinned_beside_reference(name, step):
    """The port's and the reference's per-kind tables, pinned side by side
    (the module docstring says why they differ)."""
    assert _tables(name, ref=False)[step] == PORT_TABLES[name][step]
    assert _tables(name, ref=True)[step] == REF_TABLES[name][step]
