"""The port's optimizers (``repro_torch.optim``) against the reference's
(``repro.optim``) on the CPU: the schedule, the state's structure, and
``apply_updates`` for AdamW and Adafactor.

The same seeded numpy parameters and gradients go through both over three
steps (the state carried from step to step).  The port updates in place
(on copies here); the reference returns new trees.

Tolerances:

* ``lr_at_step``: ``rtol 1e-6`` -- the same fp32 formula; ``cos`` may round
  one ulp apart in XLA and in PyTorch;
* ``apply_updates``: ``rtol 1e-6`` on ``grad_norm`` (fp32 sums of squares
  in another order) and on ``lr``; ``2e-6 * max(1, |x|)`` on parameters,
  moments and masters -- the same sequence of fp32 operations, apart from
  the norm's summation order (which moves the clip factor by an ulp), the
  bias corrections' ``pow`` and Adafactor's means; bf16 moments and
  parameters: one bf16 ulp of their magnitude (``2**-7 * max(1, |x|)``),
  since an ulp of difference before the cast can round either way.  With
  bf16 moments, such a flip moves the next update by a bf16 ulp of the
  moment's share, so fp32 parameters are held to ``3 * peak_lr * 2**-7``
  (three steps of ``lr`` times a bf16 ulp).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import OptConfig as RefOptConfig
from repro.optim import apply_updates as ref_apply
from repro.optim import init_opt_state as ref_init
from repro.optim import lr_at_step as ref_lr
from repro.optim import opt_state_axes as ref_axes
from repro_torch.models.common import tree_leaves
from repro_torch.optim import (OptConfig, apply_updates, init_opt_state,
                               lr_at_step, opt_state_axes)

SHAPES = {"a": (130, 140), "b": (7,), "c": {"w": (2, 128, 130),
                                             "n": (2, 20)}}
AXES = {"a": ("embed", "mlp"), "b": (None,),
        "c": {"w": ("layers", "embed", "mlp"), "n": ("layers", None)}}


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _draw(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return _map(SHAPES, lambda s: (scale * rng.standard_normal(s)).astype(
        np.float32))


def _to_torch(tree, dtype=None):
    return _map(tree, lambda a: torch.from_numpy(np.array(a, np.float32))
                .to(dtype or torch.float32))


def _to_jax(tree, dtype=jnp.float32):
    return _map(tree, lambda a: jnp.asarray(a, dtype))


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _leaves(tree):
    """(path, leaf) of a nested dict, sorted keys."""
    if isinstance(tree, dict):
        return [(k + "/" + p, v) for k in sorted(tree)
                for p, v in _leaves(tree[k])]
    return [("", tree)]


def _close(got, want, tol):
    g, w = _leaves(got), _leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape, path
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=tol * max(1.0, np.abs(b).max()),
                                   err_msg=path)


@pytest.mark.parametrize("cfg", [
    dict(warmup_steps=10, decay_steps=40),
    dict(warmup_steps=0, decay_steps=7, min_lr_ratio=0.0),
    dict(warmup_steps=3, decay_steps=3, peak_lr=1e-2)])
def test_lr_at_step(cfg):
    """Over steps 0 to ``decay_steps + 5``, ints and int32 tensors alike
    (rtol 1e-6)."""
    pc, rc = OptConfig(**cfg), RefOptConfig(**cfg)
    for step in range(cfg["decay_steps"] + 6):
        want = float(ref_lr(rc, step))
        got = lr_at_step(pc, step)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=1e-6)
        np.testing.assert_allclose(
            float(lr_at_step(pc, torch.tensor(step, dtype=torch.int32))),
            float(ref_lr(rc, jnp.int32(step))), rtol=1e-6)


@pytest.mark.parametrize("name,state_dtype,param_dtype", [
    ("adamw", "float32", torch.float32),
    ("adamw", "bfloat16", torch.float32),
    ("adamw", "float32", torch.bfloat16),
    ("adafactor", "float32", torch.float32),
    ("adafactor", "bfloat16", torch.bfloat16)])
def test_init_state_and_axes_match_reference(name, state_dtype, param_dtype):
    """Keys, shapes and dtypes of the state, and the axes tree."""
    pc = OptConfig(name=name, state_dtype=state_dtype)
    rc = RefOptConfig(name=name, state_dtype=state_dtype)
    jdt = jnp.bfloat16 if param_dtype == torch.bfloat16 else jnp.float32
    params = _draw(0)
    got = init_opt_state(_to_torch(params, param_dtype), pc)
    want = ref_init(_to_jax(params, jdt), rc)
    g, w = _leaves(got), _leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert tuple(a.shape) == b.shape, path
        assert str(a.dtype).split(".")[-1] == str(b.dtype), path
    shapes = _map(params, lambda a: torch.empty(a.shape, dtype=param_dtype))
    ref_shapes = _map(params, lambda a: jax.ShapeDtypeStruct(a.shape, jdt))
    got_axes = opt_state_axes(AXES, shapes, pc)
    want_axes = ref_axes(AXES, ref_shapes, rc)
    assert got_axes == jax.tree.map(lambda x: x, want_axes,
                                    is_leaf=lambda x: isinstance(x, tuple))


CASES = [
    dict(name="adamw"),
    dict(name="adamw", grad_clip=0.0),
    dict(name="adamw", state_dtype="bfloat16"),
    dict(name="adamw", param_dtype="bfloat16"),
    dict(name="adafactor"),
    dict(name="adafactor", grad_clip=0.0),
]


@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: "-".join(f"{v}" for v in c.values()))
def test_apply_updates_matches_reference(case):
    """Three steps, new parameters, state, ``lr`` and ``grad_norm``; the
    gradients are large enough (norm ~100) that clipping is on unless
    ``grad_clip`` is 0."""
    case = dict(case)
    bf16 = case.pop("param_dtype", "float32") == "bfloat16"
    kw = dict(case, peak_lr=1e-2, warmup_steps=2, decay_steps=6)
    pc, rc = OptConfig(**kw), RefOptConfig(**kw)
    pdt, jdt = ((torch.bfloat16, jnp.bfloat16) if bf16
                else (torch.float32, jnp.float32))
    bf16_state = pc.state_dtype == "bfloat16"
    p0 = _draw(1)
    params, rparams = _to_torch(p0, pdt), _to_jax(p0, jdt)
    state, rstate = init_opt_state(params, pc), ref_init(rparams, rc)
    for step in range(3):
        g = _draw(10 + step, scale=1.0)
        params, state, stats = apply_updates(params, _to_torch(g), state, pc,
                                             torch.tensor(step,
                                                          dtype=torch.int32))
        rparams, rstate, rstats = ref_apply(rparams, _to_jax(g), rstate, rc,
                                            jnp.int32(step))
        np.testing.assert_allclose(float(stats["lr"]), float(rstats["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(stats["grad_norm"]),
                                   float(rstats["grad_norm"]), rtol=1e-6)
        _close(params, rparams, 2 ** -7 if bf16 else
               3 * kw["peak_lr"] * 2 ** -7 if bf16_state else 2e-6)
        _close(state, rstate, 2 ** -7 if bf16_state else 2e-6)
        assert [t.dtype for t in tree_leaves(params)] == [pdt] * 4


def test_apply_updates_is_in_place():
    """The returned trees are the caller's, updated; the gradients are
    left as they were."""
    cfg = OptConfig()
    params = _to_torch(_draw(2))
    grads = _to_torch(_draw(3))
    g0 = [g.clone() for g in tree_leaves(grads)]
    state = init_opt_state(params, cfg)
    before = [p.clone() for p in tree_leaves(params)]
    new_p, new_s, _ = apply_updates(params, grads, state, cfg, 0)
    assert new_p is params and new_s is state
    assert all(not torch.equal(a, b)
               for a, b in zip(before, tree_leaves(params)))
    assert all(torch.equal(a, b) for a, b in zip(g0, tree_leaves(grads)))
