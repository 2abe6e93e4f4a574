"""The xLSTM slice against the reference: ``configs/xlstm_1_3b.py``,
``models/xlstm.py`` (mLSTM and sLSTM blocks, ``XLSTMLM``) and its two
pairs of custom ops (``models/mlstm_parallel.py``, ``models/slstm_scan.py``).

Numerics run on the CPU in fp32 with inputs made with numpy and, for the
blocks and the model, the reference's weights carried across by
:func:`repro_torch.weights.from_jax_params`.  Tolerances, each of
``max(1, max|ref|)``: ``1e-5`` for the pure functions (the mLSTM parallel
form, decode step and final state, the gates, the sLSTM loop), ``1e-4``
for the blocks, the model (prefill logits and states, eight decode steps,
the loss) and every gradient.  The port's parallel form meets each query
chunk's whole key prefix in one product where the reference scans (query
chunk, key chunk) pairs with an online max, and both loops' backwards are
analytic: agreement is to fp32 rounding, not bit for bit.

The captures: the reduced config's train step (the sweep cell), prefill
and decode (batch 8, prompt 32, cache 48) on the fake 4x2 mesh beside the
reference's on its 4x2 host mesh, per-kind (calls, payload bytes) pinned
side by side (why they differ: :data:`PORT_TABLE`'s comment).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as ref_configs
from repro.compat import make_mesh
from repro.models import build_model as ref_build_model
from repro.models import xlstm as ref_x
from repro.models.common import init_params as ref_init_params
from repro.parallel import Sharder as RefSharder
from repro_torch import configs, sweep
from repro_torch.core.op_cost import OpCostMode
from repro_torch.models import XLSTMLM, build_model, xlstm
from repro_torch.models.common import tree_leaves, tree_paths
from repro_torch.models.mlstm_parallel import (mlstm_parallel_bwd_ref,
                                               mlstm_parallel_ref)
from repro_torch.models.slstm_scan import slstm_bwd_ref, slstm_ref
from repro_torch.parallel import Sharder
from repro_torch.weights import from_jax_params
from torch_fixtures import mesh_4x2, ref_serve_cell, ref_train_cell

FN_TOL, MODEL_TOL = 1e-5, 1e-4
ARCH = "xlstm_1_3b"
# the reference's parameter count of the published config: 24 superblocks
# of an mLSTM (inner width 4096) and an sLSTM block, vocab 50304 untied
PARAMS = 2_623_686_848
B = 2


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, tol, what=""):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, tol * scale)


def _cfgs():
    rcfg = dataclasses.replace(ref_configs.config(ARCH, reduced=True),
                               compute_dtype="float32")
    pcfg = dataclasses.replace(configs.config(ARCH, reduced=True),
                               compute_dtype="float32")
    return rcfg, pcfg


def _rshd():
    return RefSharder(make_mesh((1, 1), ("data", "model")))


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _block_params(spec_fn, seed):
    """One unstacked block's parameters from the reference's init, both
    packages' trees."""
    rcfg, _ = _cfgs()
    rp = ref_init_params(spec_fn(rcfg), jax.random.PRNGKey(seed),
                         rcfg.param_dtype)
    return rp, {k: _t(v) for k, v in rp.items()}


# ---------------------------------------------------------------------------
# config, specs, cache
# ---------------------------------------------------------------------------
def test_config_module_matches_reference():
    """``CONFIG``, ``REDUCED`` and ``TRAIN`` field for field, an
    ``XLSTMLM``, the published parameter count, and every leaf's shape and
    logical axes equal to the reference's."""
    mod, ref = configs.get(ARCH), ref_configs.get(ARCH)
    for name in ("CONFIG", "REDUCED", "TRAIN"):
        assert dataclasses.asdict(getattr(mod, name)) == \
            dataclasses.asdict(getattr(ref, name)), name
    assert mod.REDUCED.mlstm_chunk == 16
    model, rmodel = build_model(mod.CONFIG), ref_build_model(ref.CONFIG)
    assert isinstance(model, XLSTMLM) and model.n_super == 24
    shapes = tree_paths(model.shapes(device="meta"))
    n = sum(t.numel() for _, t in shapes)
    assert n == sum(math.prod(s.shape) for s in jax.tree.leaves(
        rmodel.shapes())) == PARAMS
    rshapes, raxes = rmodel.shapes(), rmodel.axes()
    axes = dict(tree_paths(model.axes()))
    for path, t in shapes:
        rs, ra = rshapes, raxes
        for k in path:
            rs, ra = rs[k], ra[k]
        assert tuple(t.shape) == tuple(rs.shape), path
        assert axes[path] == tuple(ra), path


def test_cache_shapes_and_axes_match_reference():
    """``cache_shapes`` against the reference's ``eval_shape`` of its
    ``init_cache`` (the O(1) states: ``max_len`` changes nothing), and
    ``cache_axes`` equal, leaf for leaf."""
    cfg = configs.config(ARCH)
    model, rmodel = build_model(cfg), ref_build_model(
        ref_configs.config(ARCH))
    for max_len in (64, 32768):
        got = dict(tree_paths(model.cache_shapes(8, max_len,
                                                 device="meta")))
        want = rmodel.cache_shapes(8, max_len)
        for path, t in got.items():
            w = want
            for k in path:
                w = w[k]
            assert tuple(t.shape) == tuple(w.shape), path
            assert str(t.dtype).split(".")[-1] == str(w.dtype), path
        assert len(got) == len(jax.tree.leaves(want))
    axes = dict(tree_paths(model.cache_axes()))
    raxes = rmodel.cache_axes()
    for path, ax in axes.items():
        w = raxes
        for k in path:
            w = w[k]
        assert ax == tuple(w), path


def test_zero_states_and_their_axes_match_reference():
    """``init_mlstm_state`` / ``init_slstm_state`` (``m`` at -1e30, fp32)
    and the two state layouts, against the reference's."""
    rcfg, pcfg = _cfgs()
    for port, ref in ((xlstm.init_mlstm_state, ref_x.init_mlstm_state),
                      (xlstm.init_slstm_state, ref_x.init_slstm_state)):
        got, want = port(pcfg, 3, device="cpu"), ref(rcfg, 3)
        assert set(got) == set(want)
        for n, t in got.items():
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), np.asarray(want[n]))
    assert xlstm.mlstm_state_axes() == ref_x.mlstm_state_axes()
    assert xlstm.slstm_state_axes() == ref_x.slstm_state_axes()


# ---------------------------------------------------------------------------
# mLSTM pure functions
# ---------------------------------------------------------------------------
def _mlstm_inputs(s, seed, nh=2, dh=8):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, s, nh, dh)).astype(np.float32)
               for _ in range(3))
    log_f = np.asarray(jax.nn.log_sigmoid(
        rng.standard_normal((B, s, nh)) + 2.0)).astype(np.float32)
    itilde = rng.standard_normal((B, s, nh)).astype(np.float32)
    return q, k, v, log_f, itilde


@pytest.mark.parametrize("s", [12, 16, 64])
def test_mlstm_parallel(s):
    """At S <= chunk (one block) and S = 4 x chunk (16), through the op,
    against the reference's single block and chunked scan."""
    ins = _mlstm_inputs(s, seed=s)
    want = ref_x.mlstm_parallel(*map(jnp.asarray, ins), chunk=16)
    got = xlstm.mlstm_parallel(*map(torch.from_numpy, ins), chunk=16)
    assert got.dtype == torch.float32
    _close(got, want, FN_TOL)


def test_mlstm_parallel_refuses_a_ragged_sequence():
    """Longer than a chunk, S must be a multiple of it (the reference
    asserts it)."""
    ins = _mlstm_inputs(40, seed=1)
    with pytest.raises(ValueError, match="multiple of the mLSTM chunk"):
        xlstm.mlstm_parallel(*map(torch.from_numpy, ins), chunk=16)


@pytest.mark.parametrize("s", [12, 64])
def test_mlstm_parallel_gradients(s):
    """Every input's gradient through the op against ``jax.vjp``."""
    ins = _mlstm_inputs(s, seed=10 + s)
    cot = np.random.default_rng(3).standard_normal(ins[0].shape).astype(
        np.float32)
    _, vjp = jax.vjp(lambda *a: ref_x.mlstm_parallel(*a, chunk=16),
                     *map(jnp.asarray, ins))
    want = vjp(jnp.asarray(cot))
    ts = [torch.from_numpy(a).requires_grad_() for a in ins]
    (xlstm.mlstm_parallel(*ts, chunk=16) * torch.from_numpy(cot)).sum() \
        .backward()
    for name, t, w in zip(("q", "k", "v", "log_f", "itilde"), ts, want):
        _close(t.grad, w, MODEL_TOL, name)


def test_mlstm_decode_step_and_final_state():
    """The O(1) recurrence from a state, and the state after a sequence."""
    q, k, v, log_f, itilde = _mlstm_inputs(1, seed=5)
    rng = np.random.default_rng(6)
    state = {"C": rng.standard_normal((B, 2, 8, 8)).astype(np.float32),
             "n": rng.standard_normal((B, 2, 8)).astype(np.float32),
             "m": rng.standard_normal((B, 2)).astype(np.float32)}
    args = (q[:, 0], k[:, 0], v[:, 0], log_f[:, 0], itilde[:, 0])
    rh, rst = ref_x.mlstm_decode_step(*map(jnp.asarray, args),
                                      {n: jnp.asarray(a)
                                       for n, a in state.items()})
    h, st = xlstm.mlstm_decode_step(*map(torch.from_numpy, args),
                                    {n: torch.from_numpy(a)
                                     for n, a in state.items()})
    _close(h, rh, FN_TOL, "h")
    for n in ("C", "n", "m"):
        _close(st[n], rst[n], FN_TOL, n)
    q, k, v, log_f, itilde = _mlstm_inputs(24, seed=7)
    want = ref_x.mlstm_final_state(*map(jnp.asarray, (k, v, log_f, itilde)))
    got = xlstm.mlstm_final_state(*map(torch.from_numpy,
                                       (k, v, log_f, itilde)))
    for n in ("C", "n", "m"):
        _close(got[n], want[n], FN_TOL, n)


def test_mlstm_gates():
    rp, tp = _block_params(ref_x.mlstm_spec, 2)
    xc = np.random.default_rng(8).standard_normal((B, 6, 128)).astype(
        np.float32)
    want = ref_x._mlstm_gates(rp, jnp.asarray(xc))
    got = xlstm._mlstm_gates(tp, torch.from_numpy(xc))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w, FN_TOL)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def _random_mlstm_state(cfg, seed):
    rng = np.random.default_rng(seed)
    shapes = xlstm.mlstm_state_shapes(cfg, B)
    st = {n: rng.standard_normal(s).astype(np.float32)
          for n, s in shapes.items()}
    return st


@pytest.mark.parametrize("branch,s", [("none", 32), ("decode", 1),
                                      ("prefill", 12)])
def test_mlstm_block_apply(branch, s):
    """No state (the chunked parallel form at S = 2 x chunk), a decode step
    from a random state, and a prefill from the zero state: the output and
    the new state."""
    rcfg, pcfg = _cfgs()
    rp, tp = _block_params(ref_x.mlstm_spec, 3)
    x = np.random.default_rng(9).standard_normal((B, s, 64)).astype(
        np.float32)
    state = None
    if branch == "decode":
        state = _random_mlstm_state(pcfg, 4)
    elif branch == "prefill":
        state = {n: t.numpy() for n, t in
                 xlstm.init_mlstm_state(pcfg, B, device="cpu").items()}
    rstate = None if state is None else {n: jnp.asarray(a)
                                         for n, a in state.items()}
    tstate = None if state is None else {n: torch.from_numpy(a)
                                         for n, a in state.items()}
    want, rnew = ref_x.mlstm_block_apply(rp, jnp.asarray(x), rcfg, _rshd(),
                                         state=rstate)
    got, new = xlstm.mlstm_block_apply(tp, torch.from_numpy(x), pcfg,
                                       Sharder(), state=tstate)
    _close(got, want, MODEL_TOL, "out")
    assert (new is None) == (rnew is None)
    if new is not None:
        assert set(new) == set(rnew)
        for n in new:
            assert new[n].dtype == torch.float32
            _close(new[n], rnew[n], MODEL_TOL, n)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [1, 24, 512])
def test_slstm_apply(s, with_state):
    """One step, a sequence shorter than the reference's 256-step chunk and
    two chunks of it, through the ``slstm_scan`` op, from the zero carry or
    a random one: the output and (with a state) the final carry."""
    rcfg, pcfg = _cfgs()
    rp, tp = _block_params(ref_x.slstm_spec, 5)
    rng = np.random.default_rng(s)
    x = rng.standard_normal((B, s, 64)).astype(np.float32)
    state = None
    if with_state:
        state = {n: rng.standard_normal((B, 64)).astype(np.float32)
                 for n in ("c", "n", "m", "h")}
        state["n"] = np.abs(state["n"]) + 0.5
    want, rnew = jax.jit(lambda p, x, st: ref_x.slstm_apply(
        p, x, rcfg, _rshd(), state=st))(
        rp, jnp.asarray(x),
        None if state is None else {n: jnp.asarray(a)
                                    for n, a in state.items()})
    got, new = xlstm.slstm_apply(
        tp, torch.from_numpy(x), pcfg, Sharder(),
        state=None if state is None else {n: torch.from_numpy(a)
                                          for n, a in state.items()})
    _close(got, want, MODEL_TOL, "out")
    if with_state:
        for n in ("c", "n", "m", "h"):
            _close(new[n], rnew[n], MODEL_TOL, n)


@pytest.mark.parametrize("s,chunk", [(24, 8), (512, 256)])
def test_slstm_apply_gradients(s, chunk):
    """x's and every parameter's gradient through the op's backward (its
    chunks recomputed from their starting carries) against ``jax.vjp`` of
    the reference's rematted two-level scan."""
    rcfg, pcfg = _cfgs()
    rp, tp = _block_params(ref_x.slstm_spec, 6)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, s, 64)).astype(np.float32)
    cot = rng.standard_normal((B, s, 64)).astype(np.float32)
    gp, gx = jax.jit(lambda p, x, c: jax.vjp(
        lambda p, x: ref_x.slstm_apply(p, x, rcfg, _rshd(), chunk=chunk)[0],
        p, x)[1](c))(rp, jnp.asarray(x), jnp.asarray(cot))
    tp = {n: t.requires_grad_() for n, t in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, _ = xlstm.slstm_apply(tp, tx, pcfg, Sharder(), chunk=chunk)
    (out * torch.from_numpy(cot)).sum().backward()
    _close(tx.grad, gx, MODEL_TOL, "x")
    for n, t in tp.items():
        _close(t.grad, gp[n], MODEL_TOL, n)


def test_op_fakes_match_real_in_shape_and_dtype():
    """Each op's fake implementation (what a capture runs) against its real
    one: the same shapes and dtypes, with and without a carried state."""
    rng = np.random.default_rng(0)
    xg = torch.from_numpy(rng.standard_normal((2, 5, 4, 8)).astype(
        np.float32))
    r = torch.from_numpy(rng.standard_normal((4, 2, 4, 4)).astype(
        np.float32))
    st = torch.from_numpy(np.abs(rng.standard_normal((4, 2, 8))).astype(
        np.float32))
    mins = [torch.from_numpy(a) for a in _mlstm_inputs(32, seed=2)]
    cases = []
    for state in (None, st):
        hs, carry = torch.ops.repro_torch.slstm_scan(xg, r, state, 4)
        cases.append(("slstm_scan", (xg, r, state, 4), (hs, carry)))
        cases.append(("slstm_scan_bwd", (hs, carry, xg, r, state, 4),
                      slstm_bwd_ref(hs, carry, xg, r, state, 4)))
    h = torch.ops.repro_torch.mlstm_parallel(*mins, 16)
    cases.append(("mlstm_parallel", (*mins, 16), (h,)))
    cases.append(("mlstm_parallel_bwd", (h, *mins, 16),
                  mlstm_parallel_bwd_ref(h, *mins, 16)))
    for name, args, real in cases:
        op = getattr(torch.ops.repro_torch, name)
        with FakeTensorMode(allow_non_fake_inputs=True):
            fake = op(*args)
        fake = fake if isinstance(fake, (tuple, list)) else (fake,)
        assert len(fake) == len(real), name
        for f, t in zip(fake, real):
            assert (tuple(f.shape), f.dtype) == (tuple(t.shape), t.dtype), \
                name
    # the op's forward equals its plain loop
    hs, carry = slstm_ref(xg, r, st)
    got = torch.ops.repro_torch.slstm_scan(xg, r, st, 4)
    assert torch.equal(got[0], hs) and torch.equal(got[1], carry)
    assert torch.equal(h, mlstm_parallel_ref(*mins, 16))


def test_op_flop_formulas():
    """``OpCostMode`` counts each op once at its formula: the sLSTM loop's
    recurrent products ``2·4·B·S·nh·dh²`` (its backward three times that),
    the mLSTM parallel form ``4·B·S²·nh·dh`` (its backward twice that)."""
    rng = np.random.default_rng(1)
    xg = torch.from_numpy(rng.standard_normal((2, 6, 4, 8)).astype(
        np.float32)).requires_grad_()
    r = torch.from_numpy(rng.standard_normal((4, 2, 4, 4)).astype(
        np.float32)).requires_grad_()
    with OpCostMode() as mode:
        hs, _ = torch.ops.repro_torch.slstm_scan(xg, r, None, 256)
    assert mode.cost()["flops"] == 2 * 4 * 2 * 6 * 2 * 4 * 4
    with OpCostMode() as mode:
        hs.sum().backward()
    assert mode.cost()["flops"] == 3 * 2 * 4 * 2 * 6 * 2 * 4 * 4
    mins = [torch.from_numpy(a) for a in _mlstm_inputs(32, seed=3)]
    with OpCostMode() as mode:
        torch.ops.repro_torch.mlstm_parallel(*mins, 16)
    assert mode.cost()["flops"] == 4 * 2 * 32 * 32 * 2 * 8


# ---------------------------------------------------------------------------
# the reduced model
# ---------------------------------------------------------------------------
_SETUP: dict = {}


def _setup():
    if not _SETUP:
        rcfg, pcfg = _cfgs()
        rmodel, pmodel = ref_build_model(rcfg), build_model(pcfg)
        rparams = rmodel.init(jax.random.PRNGKey(3))
        pparams = from_jax_params(jax.tree.map(np.asarray, rparams), pcfg,
                                  device="cpu")
        t = np.random.default_rng(0).integers(0, rcfg.vocab_size, (B, 12),
                                              dtype=np.int32)
        rlogits, rcache = jax.jit(lambda p, b: rmodel.prefill(
            p, b, _rshd()))(rparams, {"tokens": jnp.asarray(t)})
        _SETUP.update(rmodel=rmodel, pmodel=pmodel, rparams=rparams,
                      pparams=pparams, tokens=t, rlogits=rlogits,
                      rcache=rcache)
    return _SETUP


def test_from_jax_params_carries_every_leaf():
    """The reference's reduced parameters, leaf for leaf and unchanged, in
    the port's tree (sorted keys, the reference's flattening order)."""
    s = _setup()
    want = jax.tree.leaves(s["rparams"])
    got = tree_leaves(s["pparams"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _port_cache(rcache):
    return {k: ({n: torch.from_numpy(np.array(a)) for n, a in v.items()}
                if isinstance(v, dict)
                else torch.tensor(int(v), dtype=torch.int32))
            for k, v in rcache.items()}


def test_prefill_logits_and_cache():
    s = _setup()
    with torch.inference_mode():
        logits, cache = s["pmodel"].prefill(
            s["pparams"], {"tokens": torch.from_numpy(s["tokens"]).long()},
            Sharder())
    _close(logits, s["rlogits"], MODEL_TOL, "logits")
    assert int(cache["len"]) == int(s["rcache"]["len"]) == 12
    for block in ("mlstm", "slstm"):
        assert set(cache[block]) == set(s["rcache"][block])
        for n, t in cache[block].items():
            assert t.dtype == torch.float32
            _close(t, s["rcache"][block][n], MODEL_TOL, f"{block}/{n}")


def test_eight_decode_steps():
    """Eight decode steps from the reference's prefill cache, a new token
    a step, the port's cache updated in place."""
    s = _setup()
    rmodel, pmodel = s["rmodel"], s["pmodel"]
    rcache, pcache = s["rcache"], _port_cache(s["rcache"])
    rstep = jax.jit(lambda p, c, b: rmodel.decode_step(p, c, b, _rshd()))
    rng = np.random.default_rng(1)
    for _ in range(8):
        t = rng.integers(0, pmodel.cfg.vocab_size, (B, 1), dtype=np.int32)
        rl, rcache = rstep(s["rparams"], rcache, {"tokens": jnp.asarray(t)})
        with torch.inference_mode():
            pl, out = pmodel.decode_step(
                s["pparams"], pcache, {"tokens": torch.from_numpy(t).long()},
                Sharder())
        assert out is pcache
        assert pl.shape == rl.shape == (B, 1, pmodel.cfg.vocab_size)
        _close(pl, rl, MODEL_TOL, "logits")
    assert int(pcache["len"]) == int(rcache["len"]) == 20
    for block in ("mlstm", "slstm"):
        for n, t in pcache[block].items():
            _close(t, rcache[block][n], MODEL_TOL, f"{block}/{n}")


def test_loss_and_every_gradient():
    """``loss_fn`` (S = 32: the chunked parallel form, the TRAIN preset's
    remat) and every parameter leaf's gradient against
    ``jax.value_and_grad``."""
    s = _setup()
    rcfg, pcfg = _cfgs()
    remat = configs.train_config(ARCH).remat
    rng = np.random.default_rng(6)
    tok = rng.integers(0, rcfg.vocab_size, (B, 32), dtype=np.int32)
    lab = rng.integers(0, rcfg.vocab_size, (B, 32), dtype=np.int32)
    lab[rng.random((B, 32)) < 0.1] = -1
    params = from_jax_params(jax.tree.map(np.asarray, s["rparams"]), pcfg,
                             device="cpu")
    for t in tree_leaves(params):
        t.requires_grad_()
    loss, metrics = s["pmodel"].loss_fn(
        params, {"tokens": torch.from_numpy(tok).long(),
                 "labels": torch.from_numpy(lab)}, Sharder(), remat=remat)
    loss.backward()
    (rloss, _), rgrads = jax.value_and_grad(
        lambda p: s["rmodel"].loss_fn(p, {"tokens": jnp.asarray(tok),
                                          "labels": jnp.asarray(lab)},
                                      _rshd(), remat=remat),
        has_aux=True)(s["rparams"])
    assert abs(float(loss.detach()) - float(rloss)) <= MODEL_TOL
    assert float(metrics["aux"]) == 0.0
    for path, g in jax.tree_util.tree_leaves_with_path(rgrads):
        node = params
        for k in path:
            node = node[k.key]
        _close(node.grad, g, MODEL_TOL, jax.tree_util.keystr(path))


def test_prefill_matches_stepwise_decode():
    """The port's own prefill against its step-by-step decode from
    ``init_cache`` (the reference's ``tests/test_models.py`` property),
    fp32, within 1e-4: the parallel and the recurrent forms agree."""
    _, pcfg = _cfgs()
    model = build_model(pcfg)
    params = model.init(1, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, pcfg.vocab_size, (B, 8)).astype(np.int64))
    with torch.inference_mode():
        pf, _ = model.prefill(params, {"tokens": toks}, Sharder())
        cache = model.init_cache(B, 8, device="cpu")
        for t in range(8):
            logits, cache = model.decode_step(
                params, cache, {"tokens": toks[:, t:t + 1]}, Sharder())
    _close(logits[:, 0], pf, MODEL_TOL)


# ---------------------------------------------------------------------------
# captures on the 4x2 mesh beside the reference's
# ---------------------------------------------------------------------------
_REPORTS: dict = {}


def _kinds(summary):
    return {k: (r["calls"], r["payload_bytes"]) for k, r in summary.items()}


def _tables(ref: bool) -> dict:
    """step -> kind -> (calls, payload bytes) of the reduced config's train,
    prefill and decode captures."""
    if ref not in _REPORTS:
        if ref:
            from repro import sweep as ref_sweep

            cfg = ref_configs.config(ARCH, reduced=True)
            mesh = ref_sweep.build_mesh("4x2")
            cells = {"train": ref_train_cell(cfg),
                     "serve": ref_serve_cell(cfg)}
            reps = {k: ref_sweep._monitor_cell(b(mesh), mesh, ARCH, "ring")
                    for k, b in cells.items()}
        else:
            cfg = configs.config(ARCH, reduced=True)
            cells = {
                "train": lambda m: sweep.train_cell(m, cfg, global_batch=8,
                                                    seq_len=64),
                "serve": lambda m: sweep.serve_cell(
                    m, cfg, batch=8, prompt_len=32, max_len=48)}
            reps = {k: sweep._monitor_cell(b, mesh_4x2(), ARCH)
                    for k, b in cells.items()}
        out = {"train": _kinds(reps["train"].compiled_summary)}
        out.update({ph: _kinds(summ) for ph, summ in
                    reps["serve"].phase_summaries().items()})
        _REPORTS[ref] = out
    return _REPORTS[ref]


# kind -> (calls, payload bytes per device) by step.  The port's, on the
# fake CPU 4x2 mesh: each mLSTM and sLSTM block runs its cell on local
# shards (4 heads over model 2: two whole heads a rank), so a layer's
# collectives are the weights' FSDP gathers, the gathers of r_g to whole
# heads, the reshards into and out of the local steps (a CPU mesh
# all-gathers and chunks where a ``cuda`` mesh all-to-alls), the decode
# step's gathers of q, k and n whole (C stays split along its v rows), and
# in training the reduce-scatters of the FSDP weights' gradients and the
# all-reduces over ``data`` of those a local step reads whole on every
# batch shard (the norms, the conv, r_g).  The sLSTM loop and the mLSTM parallel form are
# one op each, so each layer's collectives are recorded once.  The
# reference's (GSPMD on its 4x2 host mesh) partitions the scans themselves:
# its sLSTM while loop holds collectives in its body, counted once in the
# HLO, and its train step moves activations (all-to-alls,
# collective-permutes) where the port gathers weights.
PORT_TABLE = {
    "train": {"all-gather": (86, 7291136), "all-reduce": (57, 1368776),
              "reduce-scatter": (35, 2228224)},
    "prefill": {"all-gather": (33, 929792), "all-reduce": (7, 294912),
                "reduce-scatter": (13, 548864)},
    "decode": {"all-gather": (39, 219776), "all-reduce": (9, 13312),
               "reduce-scatter": (17, 37376)},
}
REF_TABLE = {
    "train": {"all-gather": (555, 3903488), "all-to-all": (672, 11665408),
              "collective-permute": (9, 262656),
              "all-reduce": (157, 6276696)},
    "prefill": {"all-reduce": (18, 1200128),
                "collective-permute": (4, 65536), "all-gather": (2, 262144),
                "all-to-all": (2, 262144)},
    "decode": {"collective-permute": (4, 2048), "all-reduce": (12, 17024),
               "all-gather": (4, 16384), "all-to-all": (2, 8192)},
}


@pytest.mark.parametrize("step", ["train", "prefill", "decode"])
def test_capture_tables_pinned_beside_reference(step):
    """The port's and the reference's per-kind tables, pinned side by side
    (:data:`PORT_TABLE`'s comment says why they differ)."""
    assert _tables(ref=False)[step] == PORT_TABLE[step]
    assert _tables(ref=True)[step] == REF_TABLE[step]
