"""The port's served model (``repro_torch.models``) against the JAX model.

``qwen3_8b``'s ``REDUCED`` config (MHA, 4 heads) and a GQA variant
(``n_kv_heads=2``), computed in fp32.  The reference's weights go across
through :func:`repro_torch.weights.from_jax_params`; the token ids are made
with numpy.  Tolerances:

* prefill logits and decode steps over an fp32 cache: ``2e-5`` absolute on
  logits of size ~3 (fp32 matmuls and softmax summed in another order over
  four layers);
* the prefill cache is bf16 in both (the reference hard-codes it): equal to
  within one bf16 rounding of fp32 values that differ in the last bits;
* decode steps over that bf16 cache: ``2e-2``.  The reference's plain
  ``decode_attention`` rounds the softmax weights to the cache's bf16 before
  the value product; the port's decode kernel keeps them in fp32, as the
  reference's own Pallas decode kernel does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.compat import make_mesh
from repro.models import build_model as ref_build_model
from repro.parallel import Sharder as RefSharder
from repro.serve import generate as ref_generate
from repro_torch import configs
from repro_torch.models import build_model
from repro_torch.parallel import Sharder
from repro_torch.serve import generate
from repro_torch.weights import from_jax_params

B, S = 2, 8
FP32_TOL = 2e-5


def _cfgs(variant):
    over = {"n_kv_heads": 2} if variant == "gqa" else {}
    ref = dataclasses.replace(
        ref_configs.reduce_config(ref_configs.config("qwen3_8b"), **over),
        compute_dtype="float32")
    port = dataclasses.replace(
        configs.reduce_config(configs.config("qwen3_8b"), **over),
        compute_dtype="float32")
    return ref, port


_CACHE: dict = {}


def _setup(variant):
    """Both models, the same weights and prompts, the reference's outputs."""
    if variant in _CACHE:
        return _CACHE[variant]
    rcfg, pcfg = _cfgs(variant)
    rmodel, pmodel = ref_build_model(rcfg), build_model(pcfg)
    rparams = rmodel.init(jax.random.PRNGKey(3))
    pparams = from_jax_params(jax.tree.map(np.asarray, rparams), pcfg,
                              device="cpu")
    toks = np.random.default_rng(0).integers(0, rcfg.vocab_size, (B, S),
                                             dtype=np.int32)
    rshd = RefSharder(make_mesh((1, 1), ("data", "model")))
    out = dict(rmodel=rmodel, pmodel=pmodel, rparams=rparams,
               pparams=pparams, toks=toks, rshd=rshd)
    max_len = S + 4
    rlogits, rcache = jax.jit(lambda p, b: rmodel.prefill(
        p, b, rshd, max_len=max_len))(rparams, {"tokens": jnp.asarray(toks)})
    out.update(rlogits=rlogits, rcache=rcache, max_len=max_len)
    _CACHE[variant] = out
    return out


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


VARIANTS = ["reduced", "gqa"]


def test_configs_match_reference():
    for variant in VARIANTS:
        rcfg, pcfg = _cfgs(variant)
        assert dataclasses.asdict(rcfg) == dataclasses.asdict(pcfg)
    full = configs.config("qwen3_8b")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.d_ff, full.vocab_size, full.dh, full.qk_norm,
            full.rope_theta) == (36, 4096, 32, 8, 12288, 151936, 128, True,
                                 10000.0)


@pytest.mark.parametrize("variant", VARIANTS)
def test_weights_cross_over(variant):
    s = _setup(variant)
    flat_ref = jax.tree_util.tree_leaves_with_path(s["rparams"])
    for path, leaf in flat_ref:
        node = s["pparams"]
        for key in path:
            node = node[key.key]
        assert node.dtype == torch.float32
        assert np.array_equal(node.numpy(), np.asarray(leaf)), path


def test_weights_reject_a_wrong_shape():
    rcfg, pcfg = _cfgs("gqa")
    tree = jax.tree.map(np.asarray, ref_build_model(rcfg).init(
        jax.random.PRNGKey(0)))
    tree["layers"]["attn"]["wk"] = tree["layers"]["attn"]["wk"][..., :-1]
    with pytest.raises(ValueError, match="wk"):
        from_jax_params(tree, pcfg, device="cpu")


@pytest.mark.parametrize("variant", VARIANTS)
def test_prefill_logits_and_cache(variant):
    s = _setup(variant)
    with torch.inference_mode():
        logits, cache = s["pmodel"].prefill(
            s["pparams"], {"tokens": torch.from_numpy(s["toks"]).long()},
            Sharder(), max_len=s["max_len"])
    assert logits.shape == (B, s["pmodel"].cfg.vocab_size)
    np.testing.assert_allclose(_f32(logits), _f32(s["rlogits"]), rtol=0,
                               atol=FP32_TOL)
    assert int(cache["len"]) == int(s["rcache"]["len"]) == S
    for name in ("k", "v"):
        got, want = cache[name], s["rcache"][name]
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        # one bf16 ulp (2^-7 relative) where fp32 inputs straddle a rounding
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=2 ** -7,
                                   atol=1e-6)


def _decode_both(s, cache_dtype, steps=3):
    """``steps`` decode steps from the reference's prefill cache (cast to
    ``cache_dtype``) in both models; returns the per-step logits."""
    rmodel, pmodel, rshd = s["rmodel"], s["pmodel"], s["rshd"]
    rcache = {k: (v.astype(cache_dtype) if k != "len" else v)
              for k, v in s["rcache"].items()}
    pcache = {k: torch.from_numpy(np.array(_f32(v))).to(
                  getattr(torch, cache_dtype)) if k != "len"
              else torch.tensor(int(v), dtype=torch.int32)
              for k, v in s["rcache"].items()}
    rstep = jax.jit(lambda p, c, b: rmodel.decode_step(p, c, b, rshd))
    toks = np.random.default_rng(1).integers(
        0, pmodel.cfg.vocab_size, (steps, B, 1), dtype=np.int32)
    out = []
    for t in range(steps):
        rl, rcache = rstep(s["rparams"], rcache,
                           {"tokens": jnp.asarray(toks[t])})
        with torch.inference_mode():
            pl, pcache = pmodel.decode_step(
                s["pparams"], pcache,
                {"tokens": torch.from_numpy(toks[t]).long()}, Sharder())
        out.append((pl, rl))
    assert int(pcache["len"]) == int(rcache["len"]) == S + steps
    return out


@pytest.mark.parametrize("variant", VARIANTS)
def test_decode_steps_fp32_cache(variant):
    for pl, rl in _decode_both(_setup(variant), "float32"):
        assert pl.shape == rl.shape == (B, 1, 512)
        np.testing.assert_allclose(_f32(pl), _f32(rl), rtol=0, atol=FP32_TOL)


@pytest.mark.parametrize("variant", VARIANTS)
def test_decode_steps_bf16_cache(variant):
    for pl, rl in _decode_both(_setup(variant), "bfloat16"):
        np.testing.assert_allclose(_f32(pl), _f32(rl), rtol=0, atol=2e-2)


@pytest.mark.parametrize("variant", VARIANTS)
def test_greedy_generate_same_tokens(variant):
    s = _setup(variant)
    want = ref_generate(s["rmodel"], s["rparams"], jnp.asarray(s["toks"]),
                        s["rshd"], steps=4, max_len=S + 4)
    got = generate(s["pmodel"], s["pparams"],
                   torch.from_numpy(s["toks"]).long(), Sharder(), steps=4,
                   max_len=S + 4)
    assert got.shape == (B, 4)
    assert got.tolist() == np.asarray(want).tolist()


def test_temperature_sampling_uses_the_generator():
    s = _setup("reduced")
    prompts = torch.from_numpy(s["toks"]).long()

    def draw(seed):
        return generate(s["pmodel"], s["pparams"], prompts, Sharder(),
                        steps=3, max_len=S + 3, temperature=1.0,
                        generator=torch.Generator().manual_seed(seed))

    assert draw(5).tolist() == draw(5).tolist()
    assert draw(5).shape == (B, 3)


def test_prefill_matches_stepwise_decode():
    """The port's own prefill/decode consistency (the reference's
    ``TestPrefillDecodeConsistency`` for qwen3, same tolerance)."""
    s = _setup("gqa")
    pmodel = s["pmodel"]
    toks = torch.from_numpy(s["toks"]).long()
    with torch.inference_mode():
        pf, _ = pmodel.prefill(s["pparams"], {"tokens": toks}, Sharder())
        cache = pmodel.init_cache(B, S, device="cpu")
        for t in range(S):
            logits, cache = pmodel.decode_step(
                s["pparams"], cache, {"tokens": toks[:, t:t + 1]}, Sharder())
    np.testing.assert_allclose(_f32(pf), _f32(logits[:, 0]), rtol=2e-2,
                               atol=2e-2)
