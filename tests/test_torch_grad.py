"""Gradients through the port's four kernel ops and its two LMs, against
``jax.vjp`` / ``jax.grad`` of the reference on CPU, in fp32.

Each op's forward on a CPU tensor is its plain version; its backward is the
port's autograd formula (for RG-LRU the backward op
``repro_torch::rglru_scan_bwd``, whose CPU branch is the reverse scan
``ref.rglru_bwd``; for the others autograd through the plain version).  The reference
differentiates its XLA paths (``repro.kernels.*.ops`` off the TPU): chunked
online-softmax attention, the associative scan, ``jnp`` RMSNorm.  Inputs and
output cotangents are made with numpy from a seed.

Tolerances (absolute, on gradients scaled to ~1):

* ops: ``2e-5`` -- fp32 sums in other orders (XLA's chunked attention and
  associative scan against the port's full softmax and sequential scan;
  attention's backward from the saved log-sum-exp against autograd
  through the softmax);
* models: ``1e-4`` -- the same, compounded over the layers, the embedding
  and the LM head, on gradients of a fixed cotangent of the last-token
  logits.

The narrow ``TransformerLM`` has 2 layers.  The reference's ``GriffinLM``
scans over superblocks (rec, rec, attn) and refuses a stack of none, so the
narrow ``GriffinLM`` has 3 layers (one superblock) and 4 (one more, a
recurrent tail layer).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.compat import make_mesh
from repro.kernels.flash_attention.ops import attend as jax_attend
from repro.kernels.flash_decode.ops import decode_attend as jax_decode
from repro.kernels.rglru.ops import rglru_scan as jax_rglru
from repro.kernels.rmsnorm.ops import rmsnorm as jax_rmsnorm
from repro.models import build_model as ref_build_model
from repro.parallel import Sharder as RefSharder
from repro_torch import configs
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (attention_bwd,
                                                     attention_bwd_from_lse,
                                                     attention_lse,
                                                     attention_ref, visible)
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.rglru import ops as rg_ops
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.models import build_model
from repro_torch.parallel import Sharder
from repro_torch.weights import from_jax_params

OP_TOL = 2e-5
MODEL_TOL = 1e-4


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _port_grads(fn, arrays, dy):
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    out = fn(*ts)
    out.backward(torch.from_numpy(dy))
    return [t.grad.numpy() for t in ts]


def _jax_grads(fn, arrays, dy):
    _, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in arrays])
    return [np.asarray(g) for g in vjp(jnp.asarray(dy))]


def _assert_close(got, want, tol):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)


@pytest.mark.parametrize("shape", [(2, 8, 32), (3, 5, 64)])
def test_rmsnorm_grad(shape):
    x, w, dy = _arrays(0, shape, shape[-1:], shape)
    w = 1.0 + 0.1 * w
    got = _port_grads(lambda a, b: rn_ops.rmsnorm(a, b, 1e-6), [x, w], dy)
    want = _jax_grads(lambda a, b: jax_rmsnorm(a, b, 1e-6), [x, w], dy)
    _assert_close(got, want, OP_TOL)


@pytest.mark.parametrize("case", [
    dict(sq=16, skv=16, h=4, kvh=2, causal=True, window=0, q_offset=0),
    dict(sq=16, skv=16, h=4, kvh=4, causal=True, window=5, q_offset=0),
    dict(sq=8, skv=24, h=4, kvh=1, causal=True, window=0, q_offset=16),
    dict(sq=12, skv=12, h=2, kvh=2, causal=False, window=0, q_offset=0),
])
def test_flash_attention_grad(case):
    b, dh = 2, 16
    q, k, v, do = _arrays(1, (b, case["sq"], case["h"], dh),
                          (b, case["skv"], case["kvh"], dh),
                          (b, case["skv"], case["kvh"], dh),
                          (b, case["sq"], case["h"], dh))
    kw = {key: case[key] for key in ("causal", "window", "q_offset")}
    got = _port_grads(lambda *t: fa_ops.attend(*t, **kw), [q, k, v], do)
    want = _jax_grads(lambda *t: jax_attend(*t, **kw), [q, k, v], do)
    _assert_close(got, want, OP_TOL)


# ---------------------------------------------------------------------------
# flash attention's backward from the forward's lse: the CUDA kernels'
# algorithm in plain PyTorch (``ref.attention_lse``,
# ``ref.attention_bwd_from_lse``) and the custom ops that carry it
# ---------------------------------------------------------------------------
LSE_CASES = [
    dict(sq=16, skv=16, h=4, kvh=2, causal=True, window=0, q_offset=0),
    dict(sq=16, skv=16, h=4, kvh=4, causal=True, window=5, q_offset=0),
    dict(sq=8, skv=24, h=4, kvh=1, causal=True, window=0, q_offset=16),
    dict(sq=12, skv=12, h=2, kvh=2, causal=False, window=0, q_offset=0),
    dict(sq=13, skv=21, h=8, kvh=2, causal=False, window=0, q_offset=0),
    dict(sq=10, skv=12, h=4, kvh=2, causal=True, window=4, q_offset=6),
    # rows at positions 10-17 see no key of 8 within a window of 3
    dict(sq=12, skv=8, h=4, kvh=2, causal=True, window=3, q_offset=6),
]
LSE_IDS = ["gqa", "mha-window", "mqa-q_offset", "bidirectional",
           "ragged-bidirectional", "window-q_offset", "rows-see-no-key"]


def _lse_inputs(case, seed):
    """q, k, v and a cotangent, the cotangent's rows that see no key set
    to 0 (the plain and the reference versions give such a row the uniform
    softmax, the kernels nothing), the bool of rows that see one, and the
    op's keyword arguments."""
    b, dh = 2, 16
    q, k, v, do = _arrays(seed, (b, case["sq"], case["h"], dh),
                          (b, case["skv"], case["kvh"], dh),
                          (b, case["skv"], case["kvh"], dh),
                          (b, case["sq"], case["h"], dh))
    kw = {key: case[key] for key in ("causal", "window", "q_offset")}
    seen = visible(case["sq"], case["skv"], **kw).any(-1).numpy()
    do[:, ~seen] = 0.0
    return q, k, v, do, seen, kw


@pytest.mark.parametrize("case", LSE_CASES, ids=LSE_IDS)
def test_attention_lse_matches_reference_scores(case):
    """Each row's log-sum-exp of its visible scaled scores against JAX's
    ``logsumexp`` over the reference's masked scores; -inf where a row
    sees no key."""
    q, k, _, _, seen, kw = _lse_inputs(case, 11)
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    qg = jnp.asarray(q).reshape(b, sq, kvh, h // kvh, dh) * dh ** -0.5
    s = jnp.einsum("bqkgd,bskd->bkgqs", qg, jnp.asarray(k))
    mask = jnp.asarray(visible(sq, case["skv"], **kw).numpy())
    want = np.asarray(jax.nn.logsumexp(jnp.where(mask, s, -jnp.inf),
                                       axis=-1)).reshape(b, h, sq)
    got = attention_lse(torch.from_numpy(q), torch.from_numpy(k),
                        **kw).numpy()
    assert got.dtype == np.float32 and got.shape == (b, h, sq)
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isneginf(got).any(axis=(0, 1)).tolist() == (~seen).tolist()
    np.testing.assert_allclose(got[:, :, seen], want[:, :, seen], rtol=0,
                               atol=OP_TOL)


@pytest.mark.parametrize("case", LSE_CASES, ids=LSE_IDS)
def test_attention_bwd_from_lse_matches_plain_and_reference(case):
    """The kernels' algorithm (P from the saved lse, ``D = rowsum(dO *
    O)``, the GQA sums) against autograd through the plain version and
    ``jax.vjp`` of the reference, in fp32; a row that sees no key gets a
    zero dq whatever its cotangent, and adds nothing to dk and dv."""
    q, k, v, do, seen, kw = _lse_inputs(case, 12)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o = attention_ref(tq, tk, tv, **kw)
    lse = attention_lse(tq, tk, **kw)
    got = [g.numpy() for g in attention_bwd_from_lse(tdo, tq, tk, tv, o,
                                                     lse, **kw)]
    plain = [g.numpy() for g in attention_bwd(tdo, tq, tk, tv, **kw)]
    want = _jax_grads(lambda *t: jax_attend(*t, **kw), [q, k, v], do)
    _assert_close(got, plain, OP_TOL)
    _assert_close(got, want, OP_TOL)
    noisy = tdo.clone()
    noisy[:, ~torch.from_numpy(seen)] = 1.0
    again = attention_bwd_from_lse(noisy, tq, tk, tv, o, lse, **kw)
    assert not again[0][:, ~torch.from_numpy(seen)].any()
    assert all(torch.equal(a, torch.from_numpy(g))
               for a, g in zip(again[1:], got[1:]))


@pytest.mark.parametrize("case", LSE_CASES, ids=LSE_IDS)
def test_flash_attention_grad_through_backward_op(case, monkeypatch):
    """``attend`` on the card's route (``kernel_backward`` true: the
    forward op with lse, its autograd formula the backward op, whose CPU
    branch is ``attention_bwd_from_lse``) against ``jax.vjp`` of the
    reference; no kernel counter moves on the CPU."""
    monkeypatch.setattr(fa_ops, "kernel_backward", lambda q: True)
    q, k, v, do, _, kw = _lse_inputs(case, 13)
    before = (fa_ops.launches, fa_ops.bwd_launches)
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in (q, k, v)]
    out = fa_ops.attend(*ts, **kw)
    assert "flash_attention_lse" in type(out.grad_fn).__name__
    out.backward(torch.from_numpy(do))
    want = _jax_grads(lambda *t: jax_attend(*t, **kw), [q, k, v], do)
    _assert_close([t.grad.numpy() for t in ts], want, OP_TOL)
    assert (fa_ops.launches, fa_ops.bwd_launches) == before


@pytest.mark.parametrize("cache_len,window", [(9, 0), (20, 0), (20, 6),
                                              (1, 0)])
def test_flash_decode_grad(cache_len, window):
    b, lmax, h, kvh, dh = 2, 20, 4, 2, 16
    q, kc, vc, do = _arrays(2, (b, h, dh), (b, lmax, kvh, dh),
                            (b, lmax, kvh, dh), (b, h, dh))
    got = _port_grads(lambda a, k, v: fd_ops.decode_attend(
        a, k, v, torch.tensor(cache_len, dtype=torch.int32), window=window),
        [q, kc, vc], do)
    want = _jax_grads(lambda a, k, v: jax_decode(
        a, k, v, jnp.int32(cache_len), window=window), [q, kc, vc], do)
    _assert_close(got, want, OP_TOL)
    # slots outside the live range take no gradient
    assert not got[1][:, cache_len:].any() and not got[2][:, cache_len:].any()


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s", [1, 7, 33, 130])
def test_rglru_grad(s, with_h0):
    b, d = 2, 24
    x, la, h0, dy = _arrays(3, (b, s, d), (b, s, d), (b, d), (b, s, d))
    la = -np.log1p(np.exp(la))          # log a < 0, as the model makes it
    arrays = [x, la] + ([h0] if with_h0 else [])
    got = _port_grads(lambda *t: rg_ops.rglru_scan(*t), arrays, dy)
    want = _jax_grads(lambda *t: jax_rglru(*t), arrays, dy)
    _assert_close(got, want, OP_TOL)


def _model_scan(x, la, h0=None):
    """The reference model's associative scan, ``h0`` folded into x_0 as
    the reference's decode folds its state."""
    from repro.models.rglru import rglru_scan as jax_model_scan
    if h0 is not None:
        x = x.at[:, 0].add(jnp.exp(la[:, 0]) * h0)
    return jax_model_scan(x, la)


@pytest.mark.parametrize("regime", ["softplus", "a_near_1"])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s", [1, 7, 33, 130])
def test_rglru_grad_against_both_reference_scans(s, with_h0, regime):
    """The backward op (its CPU branch) against ``jax.vjp`` of the
    reference's op (XLA's associative scan) and of its model's scan.  In
    the model's regime a = sigmoid(lam)^8 is near 1 (log a in [-1e-3, 0]
    here, x scaled by sqrt(1 - a^2) as ``rglru_apply`` scales it): the
    reverse scan then sums dy over ~1/(1 - a) steps, so gradients grow to
    ~40 at S = 130 and OP_TOL is taken of max(1, max|grad|); softplus
    inputs keep gradients of a few and OP_TOL absolute."""
    b, d = 2, 24
    x, la, h0, dy = _arrays(5, (b, s, d), (b, s, d), (b, d), (b, s, d))
    if regime == "a_near_1":
        la = (-1e-3 * np.random.default_rng(6).random((b, s, d))
              ).astype(np.float32)
        x = (np.sqrt(1.0 - np.exp(2.0 * la)) * x).astype(np.float32)
    else:
        la = -np.log1p(np.exp(la))
    arrays = [x, la] + ([h0] if with_h0 else [])
    got = _port_grads(lambda *t: rg_ops.rglru_scan(*t), arrays, dy)
    for fn in (lambda *t: jax_rglru(*t), _model_scan):
        want = _jax_grads(fn, arrays, dy)
        scale = (max(1.0, max(float(np.abs(w).max()) for w in want))
                 if regime == "a_near_1" else 1.0)
        _assert_close(got, want, OP_TOL * scale)


def test_rglru_bwd_is_the_reverse_scan():
    """The formula against autograd through the plain forward loop."""
    from repro_torch.kernels.rglru.ref import rglru_bwd, rglru_ref

    x, la, h0, dy = (torch.from_numpy(a) for a in _arrays(
        4, (2, 9, 8), (2, 9, 8), (2, 8), (2, 9, 8)))
    la = -torch.nn.functional.softplus(la)
    ts = [t.clone().requires_grad_() for t in (x, la, h0)]
    torch.autograd.backward(rglru_ref(*ts), dy)
    got = rglru_bwd(dy, la, rglru_ref(x, la, h0), h0)
    for g, t in zip(got, ts):
        torch.testing.assert_close(g, t.grad, rtol=0, atol=1e-6)


def test_forward_launch_counters_untouched_on_cpu():
    """A CPU backward launches no kernel: every counter stays put."""
    mods = (rn_ops, fa_ops, fd_ops, rg_ops)
    before = [m.launches for m in mods] + [rg_ops.bwd_launches]
    test_rmsnorm_grad((2, 4, 16))
    test_rglru_grad(3, True)
    assert [m.launches for m in mods] + [rg_ops.bwd_launches] == before


# ---------------------------------------------------------------------------
# the two LMs: parameter gradients of the last-token logits
# ---------------------------------------------------------------------------
B, S = 2, 12


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _model_grads(arch, n_layers):
    over = dict(n_layers=n_layers)
    rcfg = dataclasses.replace(ref_configs.reduce_config(
        ref_configs.config(arch), **over), compute_dtype="float32")
    pcfg = dataclasses.replace(configs.reduce_config(
        configs.config(arch), **over), compute_dtype="float32")
    rmodel, pmodel = ref_build_model(rcfg), build_model(pcfg)
    rparams = rmodel.init(jax.random.PRNGKey(5))
    pparams = from_jax_params(jax.tree.map(np.asarray, rparams), pcfg,
                              device="cpu")
    rng = np.random.default_rng(6)
    toks = rng.integers(0, rcfg.vocab_size, (B, S), dtype=np.int32)
    cot = rng.standard_normal((B, rcfg.vocab_size)).astype(np.float32)
    rshd = RefSharder(make_mesh((1, 1), ("data", "model")))
    batch = {"tokens": jnp.asarray(toks)}
    _, vjp = jax.vjp(lambda p: rmodel.prefill(p, batch, rshd,
                                              max_len=S)[0], rparams)
    (rgrads,) = vjp(jnp.asarray(cot))
    leaves = [t.requires_grad_() for _, t in _leaves(pparams)]
    logits, _ = pmodel.prefill(pparams, {"tokens": torch.from_numpy(
        toks).long()}, Sharder(), max_len=S)
    logits.backward(torch.from_numpy(cot))
    assert all(t.grad is not None for t in leaves)
    return rgrads, pparams


@pytest.mark.parametrize("arch,n_layers", [("qwen3_8b", 2),
                                           ("recurrentgemma_2b", 3),
                                           ("recurrentgemma_2b", 4)])
def test_lm_parameter_grads_match_reference(arch, n_layers):
    _assert_lm_grads(arch, n_layers)


@pytest.mark.parametrize("arch,n_layers", [("qwen3_8b", 2),
                                           ("recurrentgemma_2b", 3)])
def test_lm_parameter_grads_through_the_attention_backward_op(
        arch, n_layers, monkeypatch):
    """The same, attention on the card's route (the forward op with lse
    and the backward op, plain on the CPU)."""
    monkeypatch.setattr(fa_ops, "kernel_backward", lambda q: True)
    _assert_lm_grads(arch, n_layers)


def _assert_lm_grads(arch, n_layers):
    rgrads, pparams = _model_grads(arch, n_layers)
    flat = jax.tree_util.tree_leaves_with_path(rgrads)
    assert len(flat) == len(list(_leaves(pparams)))
    for path, g in flat:
        node = pparams
        for k in path:
            node = node[k.key]
        want = np.asarray(g, dtype=np.float32)
        got = node.grad.numpy()
        assert got.shape == want.shape, path
        np.testing.assert_allclose(got, want, rtol=0, atol=MODEL_TOL,
                                   err_msg=jax.tree_util.keystr(path))
