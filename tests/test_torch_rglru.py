"""The port's RecurrentGemma slice against the JAX package: the RG-LRU
recurrence (``repro_torch.kernels.rglru``) and ``GriffinLM``.

The RG-LRU wrapper runs its plain version for CPU tensors; it is held to the
reference's oracle (``repro.kernels.rglru.ref``) and to the reference's
Pallas kernel in interpret mode at the reference test's shapes and
tolerances (1e-4; 1e-5 for the ``h0`` carry).  The CUDA kernels themselves
run only on the card (``chip_smoke.py``).  Here: the backward op
(``repro_torch::rglru_scan_bwd``: its CPU branch, fake impl and
``opcheck``), the kernels' launch plan (``ops.rglru_plan``) at every
main-path shape and over a grid against the card's limits, and the
kernels' sequence-split arithmetic (``ref.rglru_split_ref``,
``ref.rglru_bwd_split_ref``) against the plain versions.

``GriffinLM`` is held to ``repro.models.rglru.GriffinLM`` in fp32 on the CPU
in two variants: ``REDUCED`` (6 layers = 2 superblocks, no tail) and an
8-layer cut (2 superblocks + 2 tail recurrent layers, whose states the
decode carries apart from the superblocks').  The reference's weights cross
over through :func:`repro_torch.weights.from_jax_params`; token ids are made
with numpy.  Prompt 36 + 4 new tokens exceeds the reduced window of 32, so
prefill takes the ring (``roll``) layout of the KV cache and decode
overwrites its oldest slots.  Tolerances:

* prefill logits, recurrent states and decode steps over an fp32 cache:
  ``2e-5`` absolute on logits of size ~3.5.  The reference's recurrence is
  a log-depth associative scan and the port's a sequential loop, so the fp32
  states differ in their last bits (~1e-6 after 6-8 layers);
* the prefill KV cache is bf16 in both: within one bf16 rounding;
* decode steps over a bf16 cache: ``2e-2``, the transformer tests' bound
  (``tests/test_torch_model.py``): the reference's plain ring decode rounds
  the softmax weights to bf16, the port's decode kernel keeps them fp32.
"""
import dataclasses
import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.compat import make_mesh
from repro.kernels.rglru.ops import rglru_scan as jax_rglru_scan
from repro.kernels.rglru.ref import rglru_ref as jax_rglru_ref
from repro.models import build_model as ref_build_model
from repro.parallel import Sharder as RefSharder
from repro.serve import generate as ref_generate
from repro_torch import configs
from repro_torch.kernels.rglru import ops as rg_ops
from repro_torch.kernels.rglru.ops import Plan, rglru_plan
from repro_torch.kernels.rglru.ref import (rglru_bwd, rglru_bwd_split_ref,
                                           rglru_ref, rglru_split_ref)
from repro_torch.models import GriffinLM, build_model
from repro_torch.models.common import Spec, init_params
from repro_torch.parallel import Sharder
from repro_torch.serve import generate
from repro_torch.weights import from_jax_params

ARCH = "recurrentgemma_2b"


def _scan_inputs(b, s, d, seed):
    """x ~ N(0,1), log_a = -softplus(N(0,1)), h0 ~ N(0,1), as numpy fp32
    (the reference test's distributions)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    la = (-np.logaddexp(rng.standard_normal((b, s, d)), 0.0)
          ).astype(np.float32)
    h0 = rng.standard_normal((b, d)).astype(np.float32)
    return x, la, h0


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the RG-LRU recurrence
# ---------------------------------------------------------------------------
class TestRGLRUScan:
    @pytest.mark.parametrize("with_h0", [True, False])
    @pytest.mark.parametrize("b,s,d", [(2, 64, 128), (1, 256, 256),
                                       (3, 128, 384)])
    def test_matches_reference(self, b, s, d, with_h0):
        x, la, h0 = _scan_inputs(b, s, d, d)
        jh0 = jnp.asarray(h0) if with_h0 else None
        th0 = _t(h0) if with_h0 else None
        got = rg_ops.rglru_scan(_t(x), _t(la), th0)
        assert got.dtype == torch.float32 and got.shape == (b, s, d)
        pallas = jax_rglru_scan(jnp.asarray(x), jnp.asarray(la), jh0,
                                force="pallas_interpret", seq_chunk=64)
        ref = jax_rglru_ref(jnp.asarray(x), jnp.asarray(la), jh0)
        assert np.max(np.abs(np.asarray(pallas) - got.numpy())) < 1e-4
        assert np.max(np.abs(np.asarray(ref) - got.numpy())) < 1e-4
        # the wrapper's CPU branch is the plain version itself
        assert torch.equal(got, rglru_ref(_t(x), _t(la), th0))

    def test_h0_carry(self):
        """Two halves scanned in turn, the first's last state carried as
        ``h0``, equal one pass (the reference's chunk-carry test)."""
        x, la, _ = _scan_inputs(1, 128, 128, 0)
        la = la * 0.2
        full = rg_ops.rglru_scan(_t(x), _t(la))
        first = rg_ops.rglru_scan(_t(x[:, :64]), _t(la[:, :64]))
        second = rg_ops.rglru_scan(_t(x[:, 64:]), _t(la[:, 64:]),
                                   first[:, -1].contiguous())
        both = torch.cat([first, second], dim=1)
        assert torch.max(torch.abs(full - both)).item() < 1e-5

    def test_decode_shape_matches_associative_scan(self):
        """One step with h0, as the decode calls it, against the reference
        model's own fold of h0 into x_0 and its associative scan."""
        from repro.models.rglru import rglru_scan as jax_model_scan
        x, la, h0 = _scan_inputs(4, 1, 96, 3)
        want = jax_model_scan(jnp.asarray(x).at[:, 0].add(
            jnp.exp(jnp.asarray(la)[:, 0]) * jnp.asarray(h0)),
            jnp.asarray(la))
        got = rg_ops.rglru_scan(_t(x), _t(la), _t(h0))
        assert np.max(np.abs(np.asarray(want) - got.numpy())) < 1e-5

    @pytest.mark.parametrize("call,exc", [
        (lambda: rg_ops.rglru_scan(torch.ones(1, 4, 8, dtype=torch.bfloat16),
                                   torch.ones(1, 4, 8, dtype=torch.bfloat16)),
         TypeError),
        (lambda: rg_ops.rglru_scan(torch.ones(1, 4, 8), torch.ones(1, 4, 4)),
         ValueError),
        (lambda: rg_ops.rglru_scan(torch.ones(1, 4, 8), torch.ones(1, 4, 8),
                                   torch.ones(2, 8)), ValueError),
        (lambda: rg_ops.rglru_scan(torch.ones(4, 8), torch.ones(4, 8)),
         ValueError),
    ])
    def test_bad_arguments_raise(self, call, exc):
        with pytest.raises(exc):
            call()


def _regime_inputs(b, s, d, seed, regime):
    """(x, log_a, h0, dy) as numpy fp32.  "softplus": the reference test's
    distributions (``_scan_inputs``).  "a_near_1": the model's regime, log a
    uniform in [-1e-3, 0] (a in [0.999, 1]) and x scaled by sqrt(1 - a^2)
    as ``rglru_apply`` scales its input, so h stays of order 1 while a
    carry crosses many sub-chunks; dy ~ N(0, 1) in both."""
    x, la, h0 = _scan_inputs(b, s, d, seed)
    rng = np.random.default_rng(seed + 1)
    if regime == "a_near_1":
        la = (-1e-3 * rng.random((b, s, d))).astype(np.float32)
        x = (np.sqrt(1.0 - np.exp(2.0 * la)) * x).astype(np.float32)
    dy = rng.standard_normal((b, s, d)).astype(np.float32)
    return x, la, h0, dy


# ---------------------------------------------------------------------------
# the backward op
# ---------------------------------------------------------------------------
BWD_OP = torch.ops.repro_torch.rglru_scan_bwd


class TestRGLRUBackwardOp:
    @pytest.mark.parametrize("with_h0", [True, False])
    @pytest.mark.parametrize("regime", ["softplus", "a_near_1"])
    @pytest.mark.parametrize("s", [1, 7, 33, 130])
    def test_cpu_branch_is_the_plain_backward(self, s, regime, with_h0):
        x, la, h0, dy = (_t(a) for a in _regime_inputs(2, s, 24, s, regime))
        h0 = h0 if with_h0 else None
        h = rglru_ref(x, la, h0)
        dx, dla, dh0 = BWD_OP(dy, la, h, h0)
        want = rglru_bwd(dy, la, h, h0)
        assert torch.equal(dx, want[0]) and torch.equal(dla, want[1])
        if with_h0:
            assert torch.equal(dh0, want[2])
        else:
            assert dh0.shape == (0,) and want[2] is None

    def test_autograd_takes_the_op(self):
        """The forward's autograd formula calls the backward op once, with
        the cotangent of ``h`` and of its last state ``h[:, -1]`` summed, as
        ``rglru_apply`` returns both; the gradients equal autograd through
        the plain forward loop."""
        x, la, h0, dy = (_t(a) for a in _regime_inputs(2, 33, 24, 5,
                                                         "a_near_1"))
        w_last = torch.randn(2, 24, generator=torch.Generator().manual_seed(0))
        calls = []

        class Spy(torch.utils._python_dispatch.TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                calls.append(str(func))
                return func(*args, **(kwargs or {}))

        def grads(fn):
            ts = [t.clone().requires_grad_() for t in (x, la, h0)]
            h = fn(*ts)
            ((h * dy).sum() + (h[:, -1] * w_last).sum()).backward()
            return [t.grad for t in ts]

        with Spy():
            got = grads(rg_ops.rglru_scan)
        want = grads(rglru_ref)
        assert calls.count("repro_torch.rglru_scan_bwd.default") == 1
        # the reverse scan against autograd's chain through the loop: fp32
        # roundings in another order, on gradients of up to ~20 (a near 1
        # sums dy over many steps)
        for g, w in zip(got, want):
            tol = 1e-6 * max(1.0, w.abs().max().item())
            assert (g - w).abs().max().item() <= tol

    def test_fake_impl_launches_nothing(self):
        """Under FakeTensorMode (a capture) both ops give the right shapes
        and dtypes from their fake impls, forward and backward, and launch
        no kernel: a fake capture traces one op, not a loop of positions."""
        from torch._subclasses.fake_tensor import FakeTensorMode

        before = (rg_ops.launches, rg_ops.bwd_launches)
        with FakeTensorMode(allow_non_fake_inputs=False):
            def mk(*shape):
                return torch.empty(*shape)
            dy, la, h, h0 = mk(2, 1024, 64), mk(2, 1024, 64), \
                mk(2, 1024, 64), mk(2, 64)
            dx, dla, dh0 = BWD_OP(dy, la, h, h0)
            assert [tuple(t.shape) for t in (dx, dla, dh0)] == [
                (2, 1024, 64), (2, 1024, 64), (2, 64)]
            assert all(t.dtype == torch.float32 for t in (dx, dla, dh0))
            assert tuple(BWD_OP(dy, la, h, None)[2].shape) == (0,)
            ts = [mk(2, 1024, 64).requires_grad_(),
                  mk(2, 1024, 64).requires_grad_(), mk(2, 64).requires_grad_()]
            rg_ops.rglru_scan(*ts).sum().backward()
            assert [tuple(t.grad.shape) for t in ts] == [
                (2, 1024, 64), (2, 1024, 64), (2, 64)]
        assert (rg_ops.launches, rg_ops.bwd_launches) == before

    @pytest.mark.parametrize("with_h0", [True, False])
    def test_opcheck(self, with_h0):
        x, la, h0, dy = (_t(a) for a in _regime_inputs(2, 9, 8, 2,
                                                         "softplus"))
        h0 = h0 if with_h0 else None
        h = rglru_ref(x, la, h0)
        torch.library.opcheck(BWD_OP, (dy, la, h, h0))
        grad = [t.clone().requires_grad_() if t is not None else None
                for t in (x, la, h0)]
        torch.library.opcheck(torch.ops.repro_torch.rglru_scan, tuple(grad))


# ---------------------------------------------------------------------------
# the kernels' launch plan and their sequence-split arithmetic
# ---------------------------------------------------------------------------
H100_SMS = 132


def _grid(plan: Plan, b: int, s: int, d: int) -> tuple:
    """The grid, threads a CTA and rounds of ``plan``, as ``rglru_plan``'s
    docstring defines them."""
    if plan.variant == "walk":
        return (-(-d // 256), b, 1), 256, 1
    span = plan.cluster * plan.warps * plan.steps
    return (plan.cluster, -(-d // 32), b), 32 * plan.warps, -(-s // span)


class TestRGLRUPlan:
    @pytest.mark.parametrize("shape,plan,bwd_plan,rounds", [
        # decode with h0: a forward too short to split, one thread a
        # channel walks S (a single launch); the backward splits anyway
        ((8, 1, 2560), Plan("walk", 1, 8, 0), Plan("split", 1, 1, 1), 1),
        # serve prefill: 640 channel tiles fill the card at a cluster of
        # 1, so the forward walks; the backward splits in one round
        ((8, 128, 2560), Plan("walk", 1, 8, 0), Plan("split", 1, 8, 16), 1),
        # the train microbatch: 80 tiles x a cluster of 8 = 640 CTAs
        ((1, 1024, 2560), Plan("split", 8, 8, 16), None, 1),
        ((1, 1000, 2560), Plan("split", 8, 8, 16), None, 1),   # ragged S
        ((1, 8192, 2560), Plan("split", 8, 8, 16), None, 8),   # 8 rounds
        # a decode step at B=1: S too short to split forward
        ((1, 1, 2560), Plan("walk", 1, 8, 0), Plan("split", 1, 1, 1), 1),
        # a short backward: two sub-chunks in one CTA
        ((1, 17, 2560), Plan("walk", 1, 8, 0), Plan("split", 1, 2, 9), 1),
    ])
    def test_main_path_plans(self, shape, plan, bwd_plan, rounds):
        got = rglru_plan(*shape, H100_SMS)
        bwd = rglru_plan(*shape, H100_SMS, backward=True)
        assert got == plan
        assert bwd == (bwd_plan or plan)
        assert bwd.variant == "split"
        for p in (got, bwd):
            assert _grid(p, *shape)[2] == rounds

    @pytest.mark.parametrize("sms", [1, 8, 132])
    def test_plans_within_the_card_limits(self, sms):
        for b, d, s in itertools.product(
                (1, 2, 8, 64, 65535), (1, 5, 24, 32, 33, 2560, 4096, 100_000),
                (1, 2, 15, 16, 17, 31, 33, 100, 127, 128, 129, 1000, 1024,
                 4097, 8192, 65536)):
            for backward in (False, True):
                plan = rglru_plan(b, s, d, sms, backward)
                (gx, gy, gz), threads, rounds = _grid(plan, b, s, d)
                assert gy <= 65535 and gz <= 65535
                assert 32 <= threads <= 256
                if plan.variant == "walk":
                    # the forward, where a split would take a cluster of 1
                    assert not backward
                    assert s < 32 or b * -(-d // 32) >= 4 * sms
                    assert gx * threads >= d
                    continue
                assert backward or plan.cluster > 1
                # a split splits S across 1-8 CTAs (a portable cluster),
                # each keeping 16 rows unless S is too short to share
                assert plan.cluster in (1, 2, 4, 8) and gx == plan.cluster
                assert 1 <= plan.warps <= 8 and 1 <= plan.steps <= 16
                assert plan.cluster == 1 or -(-s // plan.cluster) >= 16
                # every row is covered and the last round holds one
                span = plan.cluster * plan.warps * plan.steps
                assert rounds * span >= s and (rounds - 1) * span < s

    @pytest.mark.parametrize("regime", ["softplus", "a_near_1"])
    @pytest.mark.parametrize("with_h0", [True, False])
    @pytest.mark.parametrize("b,s,d,plan", [
        (2, 1, 24, Plan("split", 1, 1, 1)),
        (2, 7, 24, Plan("split", 1, 1, 7)),
        (2, 33, 24, Plan("split", 2, 2, 9)),
        (2, 130, 40, Plan("split", 2, 5, 13)),
        (2, 130, 40, Plan("split", 2, 2, 4)),       # 9 rounds
        (1, 1000, 8, Plan("split", 4, 8, 16)),      # 2 rounds, ragged
        (2, 17, 24, Plan("split", 1, 2, 9))])
    def test_split_arithmetic_matches_the_plain_versions(
            self, b, s, d, plan, with_h0, regime):
        """The kernels' arithmetic under a plan (clusters, sub-chunks and
        rounds at small widths) against the plain versions: within 1e-5 of
        max(1, max|ref|) -- only the composed carries round differently --
        and bit for bit in the first sub-chunk of each scan, whose carry is
        the plain version's."""
        steps = plan.steps
        x, la, h0, dy = (_t(a) for a in _regime_inputs(b, s, d, s, regime))
        h0 = h0 if with_h0 else None
        want = rglru_ref(x, la, h0)
        got = rglru_split_ref(x, la, h0, plan)
        tol = 1e-5 * max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= tol
        assert torch.equal(got[:, :steps], want[:, :steps])
        gwant = rglru_bwd(dy, la, want, h0)
        ggot = rglru_bwd_split_ref(dy, la, want, h0, plan)
        for g, w in zip(ggot, gwant):
            if w is None:
                assert g is None
                continue
            tol = 1e-5 * max(1.0, w.abs().max().item())
            assert (g - w).abs().max().item() <= tol
        assert torch.equal(ggot[0][:, s - steps:], gwant[0][:, s - steps:])


def test_rglru_a_init_range():
    """``lam`` from the ``rglru_a`` initialiser puts a = sigmoid(lam)^8 in
    [0.9, 0.999], as the reference's initialiser does."""
    spec = {"lam": Spec((4096,), ("rnn",), init="rglru_a")}
    lam = init_params(spec, torch.Generator().manual_seed(0),
                      device="cpu")["lam"]
    a = torch.sigmoid(lam.double()) ** 8
    assert lam.dtype == torch.float32
    assert 0.9 - 1e-6 <= a.min().item() and a.max().item() <= 0.999 + 1e-6
    assert a.max().item() - a.min().item() > 0.09    # the whole range


# ---------------------------------------------------------------------------
# GriffinLM
# ---------------------------------------------------------------------------
B, S, STEPS = 2, 36, 4
FP32_TOL = 2e-5
VARIANTS = {"reduced": {}, "tail": {"n_layers": 8}}


def _cfgs(variant):
    over = VARIANTS[variant]      # {}: REDUCED itself
    ref = ref_configs.reduce_config(ref_configs.config(ARCH), **over)
    port = configs.reduce_config(configs.config(ARCH), **over)
    return (dataclasses.replace(ref, compute_dtype="float32"),
            dataclasses.replace(port, compute_dtype="float32"))


_CACHE: dict = {}


def _setup(variant):
    """Both models, the same weights and prompts, the reference's prefill
    (module-scoped: each variant compiles once per test process)."""
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
    max_len = S + STEPS
    rlogits, rcache = jax.jit(lambda p, b: rmodel.prefill(
        p, b, rshd, max_len=max_len))(rparams, {"tokens": jnp.asarray(toks)})
    out = dict(rmodel=rmodel, pmodel=pmodel, rparams=rparams,
               pparams=pparams, toks=toks, rshd=rshd, max_len=max_len,
               rlogits=rlogits, rcache=rcache,
               rstep=jax.jit(lambda p, c, b: rmodel.decode_step(p, c, b,
                                                                rshd)))
    _CACHE[variant] = out
    return out


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _tree_get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_configs_match_reference():
    for reduced in (False, True):
        assert dataclasses.asdict(configs.config(ARCH, reduced)) == \
            dataclasses.asdict(ref_configs.config(ARCH, reduced))
    for variant in VARIANTS:
        rcfg, pcfg = _cfgs(variant)
        assert dataclasses.asdict(rcfg) == dataclasses.asdict(pcfg)
    full = configs.config(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.dh, full.d_ff, full.d_rnn_, full.conv_width,
            full.attn_window, full.vocab_size, full.family) == (
        26, 2560, 10, 1, 256, 7680, 2560, 4, 2048, 256000, "hybrid")
    assert [full.block_kind(i) for i in range(4)] == ["rec", "rec", "attn",
                                                      "rec"]


def test_build_model_dispatches_on_family():
    full = configs.config(ARCH)
    model = build_model(full)
    assert isinstance(model, GriffinLM)
    assert (model.n_super, model.n_tail) == (8, 2)
    n = sum(math.prod(s.shape) for _, s in _leaves(model.specs()))
    assert abs(n - 3.55e9) < 0.01e9        # 3.550 B parameters
    # the ssm family is xLSTM's (tests/test_torch_xlstm.py)
    assert not isinstance(build_model(dataclasses.replace(
        full, family="ssm", n_layers=2)), GriffinLM)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_weights_cross_over(variant):
    s = _setup(variant)
    flat_ref = jax.tree_util.tree_leaves_with_path(s["rparams"])
    assert len(flat_ref) == len(list(_leaves(s["pparams"])))
    assert ("tail" in s["pparams"]) == (variant == "tail")
    for path, leaf in flat_ref:
        node = _tree_get(s["pparams"], [k.key for k in path])
        assert node.dtype == torch.float32
        assert np.array_equal(node.numpy(), np.asarray(leaf)), path


def test_weights_reject_a_wrong_shape():
    rcfg, pcfg = _cfgs("tail")
    tree = jax.tree.map(np.asarray, ref_build_model(rcfg).init(
        jax.random.PRNGKey(0)))
    tree["tail"]["rec"]["w_a"] = tree["tail"]["rec"]["w_a"][..., :-1]
    with pytest.raises(ValueError, match="w_a"):
        from_jax_params(tree, pcfg, device="cpu")


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_logits_and_cache(variant):
    s = _setup(variant)
    with torch.inference_mode():
        logits, cache = s["pmodel"].prefill(
            s["pparams"], {"tokens": torch.from_numpy(s["toks"]).long()},
            Sharder(), max_len=s["max_len"])
    assert logits.shape == (B, s["pmodel"].cfg.vocab_size)
    np.testing.assert_allclose(_f32(logits), _f32(s["rlogits"]), rtol=0,
                               atol=FP32_TOL)
    ref_leaves = dict(_leaves(s["rcache"]))
    assert sorted(ref_leaves) == sorted(p for p, _ in _leaves(cache))
    assert int(cache["len"]) == int(s["rcache"]["len"]) == S
    for path, want in ref_leaves.items():
        got = _tree_get(cache, path)
        assert tuple(got.shape) == want.shape, path
        if path[0] == "attn":
            # the ring of the last 32 positions, bf16 in both: one bf16
            # ulp (2^-7 relative) where fp32 inputs straddle a rounding
            assert got.dtype == torch.bfloat16
            np.testing.assert_allclose(_f32(got), _f32(want), rtol=2 ** -7,
                                       atol=1e-6)
        elif path != ("len",):
            assert got.dtype == torch.float32     # rec h and conv, per group
            np.testing.assert_allclose(_f32(got), _f32(want), rtol=0,
                                       atol=FP32_TOL, err_msg=str(path))


def _decode_both(s, cache_dtype):
    """``STEPS`` decode steps from the reference's prefill cache (its kv
    cast to ``cache_dtype``) in both models; returns the per-step logits
    and both final caches."""
    pmodel, rshd = s["pmodel"], s["rshd"]

    def cast(path, v):
        return v.astype(cache_dtype) if path[0] == "attn" else v

    rcache = jax.tree_util.tree_map_with_path(
        lambda p, v: cast([k.key for k in p], v), s["rcache"])
    pcache: dict = {}
    for path, v in _leaves(rcache):
        node = pcache
        for k in path[:-1]:
            node = node.setdefault(k, {})
        arr = np.asarray(v)
        node[path[-1]] = (torch.tensor(int(arr), dtype=torch.int32)
                          if path == ("len",) else
                          torch.from_numpy(np.array(_f32(v))).to(
                              getattr(torch, str(arr.dtype))))
    if not rcache["tail"]:
        pcache["tail"] = {}
    toks = np.random.default_rng(1).integers(
        0, pmodel.cfg.vocab_size, (STEPS, B, 1), dtype=np.int32)
    out = []
    for t in range(STEPS):
        rl, rcache = s["rstep"](s["rparams"], rcache,
                                {"tokens": jnp.asarray(toks[t])})
        with torch.inference_mode():
            pl, pcache = pmodel.decode_step(
                s["pparams"], pcache,
                {"tokens": torch.from_numpy(toks[t]).long()}, Sharder())
        out.append((pl, rl))
    assert int(pcache["len"]) == int(rcache["len"]) == S + STEPS
    return out, pcache, rcache


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_decode_steps_fp32_cache(variant):
    steps, pcache, rcache = _decode_both(_setup(variant), "float32")
    for pl, rl in steps:
        assert pl.shape == rl.shape == (B, 1, 512)
        np.testing.assert_allclose(_f32(pl), _f32(rl), rtol=0, atol=FP32_TOL)
    # every state after the wrapped ring's last write, tail included
    for path, want in _leaves(rcache):
        np.testing.assert_allclose(_f32(_tree_get(pcache, path)), _f32(want),
                                   rtol=0, atol=FP32_TOL, err_msg=str(path))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_decode_steps_bf16_cache(variant):
    steps, _, _ = _decode_both(_setup(variant), "bfloat16")
    for pl, rl in steps:
        np.testing.assert_allclose(_f32(pl), _f32(rl), rtol=0, atol=2e-2)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_greedy_generate_same_tokens(variant):
    """Prompt 28 + 8 tokens: the prefill fills a linear cache of 32 slots,
    and decode wraps it at position 32."""
    s = _setup(variant)
    prompts = s["toks"][:, :28]
    want = ref_generate(s["rmodel"], s["rparams"], jnp.asarray(prompts),
                        s["rshd"], steps=8, max_len=36)
    got = generate(s["pmodel"], s["pparams"], torch.from_numpy(prompts).long(),
                   Sharder(), steps=8, max_len=36)
    assert got.shape == (B, 8)
    assert got.tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_matches_stepwise_decode(variant):
    """The port's own prefill/decode consistency, as the reference's
    ``TestPrefillDecodeConsistency`` holds it for ``recurrentgemma_2b`` (same
    tolerance), over 36 tokens: prefill's ring is rolled, and stepwise
    decode wraps the 32-slot cache."""
    s = _setup(variant)
    pmodel = s["pmodel"]
    toks = torch.from_numpy(s["toks"]).long()
    with torch.inference_mode():
        pf, _ = pmodel.prefill(s["pparams"], {"tokens": toks}, Sharder())
        cache = pmodel.init_cache(B, S, device="cpu")
        assert cache["attn"]["k"].shape[2] == 32
        for t in range(S):
            logits, cache = pmodel.decode_step(
                s["pparams"], cache, {"tokens": toks[:, t:t + 1]}, Sharder())
    np.testing.assert_allclose(_f32(pf), _f32(logits[:, 0]), rtol=2e-2,
                               atol=2e-2)
