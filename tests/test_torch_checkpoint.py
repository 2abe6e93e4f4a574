"""The port's checkpoints (``repro_torch.checkpoint``) against the
reference's (``repro.checkpoint``) on the CPU.

The format is the reference's (``manifest.json`` with ``"/"``-joined key
paths, ``arrays.npz`` with ``leaf_<i>``), so fp32 and integer leaves
restore both ways, bit for bit.  A bf16 leaf is stored as its raw 2-byte
words (``|V2``, manifest dtype ``bfloat16``), as the reference stores one:
the port restores such a leaf from either package bit for bit; the
reference restores none, its own included (numpy has no cast from ``|V2``
to ``bfloat16``).  Then the port's own behaviour: atomic writes, retention,
validation, the async writer's errors, and a resumed training run equal to
an uninterrupted one, bit for bit.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as ref_restore
from repro.checkpoint import save_checkpoint as ref_save
from repro_torch import configs
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.launch import train as launch
from repro_torch.models.common import tree_leaves
from repro_torch.train import TrainConfig


def _state(seed=0, bf16=False):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((5, 6)).astype(np.float32)
    return {"params": {"w": w, "b": rng.standard_normal(6).astype(np.float32)},
            "opt": {"w": {"m": np.zeros((5, 6), np.float32),
                          "v": rng.random((5, 6)).astype(np.float32)}},
            "step": np.array(7, np.int32),
            **({"h": w[:2]} if bf16 else {})}


def _torch(tree, bf16_keys=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _torch(v)
        else:
            t = torch.from_numpy(np.array(v))
            out[k] = t.to(torch.bfloat16) if k in bf16_keys else t
    return out


def _jax(tree, bf16_keys=()):
    return {k: (_jax(v) if isinstance(v, dict) else
                jnp.asarray(v, jnp.bfloat16 if k in bf16_keys else None))
            for k, v in tree.items()}


def _assert_equal(got, want):
    """Bitwise: same keys, dtypes' names and bits."""
    assert sorted(got) == sorted(want)
    for k in got:
        if isinstance(got[k], dict):
            _assert_equal(got[k], want[k])
            continue
        g = got[k]
        w = want[k]
        if isinstance(g, torch.Tensor) and g.dtype == torch.bfloat16:
            g = g.view(torch.int16).numpy()
            w = np.asarray(w).view(np.int16) if not isinstance(
                w, torch.Tensor) else w.view(torch.int16).numpy()
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_port_save_restores_in_the_reference(tmp_path):
    """fp32 and int32 leaves, bit for bit, and the same manifest."""
    state = _state(1)
    save_checkpoint(str(tmp_path / "port"), 3, _torch(state))
    ref_save(str(tmp_path / "ref"), 3, _jax(state))
    got = ref_restore(str(tmp_path / "port"), 3, _jax(state))
    _assert_equal(jax.tree.map(np.asarray, got), state)
    man = [json.loads((tmp_path / d / "step_3" / "manifest.json").read_text())
           for d in ("port", "ref")]
    assert man[0] == man[1]


def test_reference_save_restores_in_the_port(tmp_path):
    """fp32, int32 and bf16 leaves, bit for bit, onto the target's dtypes."""
    state = _state(2, bf16=True)
    ref_save(str(tmp_path), 5, _jax(state, bf16_keys=("h",)))
    target = _torch(state, bf16_keys=("h",))
    got = restore_checkpoint(str(tmp_path), 5, target)
    _assert_equal(got, target)
    assert got["h"].dtype == torch.bfloat16


def test_bf16_leaves_each_package(tmp_path):
    """The port writes a bf16 leaf as the reference does (``|V2`` words,
    dtype ``bfloat16``) and restores its own; the reference restores no
    bf16 leaf, its own file or the port's."""
    state = _state(3, bf16=True)
    target = _torch(state, bf16_keys=("h",))
    save_checkpoint(str(tmp_path / "port"), 1, target)
    ref_save(str(tmp_path / "ref"), 1, _jax(state, bf16_keys=("h",)))
    for d in ("port", "ref"):
        man = json.loads((tmp_path / d / "step_1" / "manifest.json")
                         .read_text())
        assert {e["key"]: e["dtype"] for e in man["leaves"]}["h"] == \
            "bfloat16"
        with np.load(tmp_path / d / "step_1" / "arrays.npz") as data:
            leaf = [e["name"] for e in man["leaves"] if e["key"] == "h"][0]
            assert data[leaf].dtype == np.dtype("|V2")
    _assert_equal(restore_checkpoint(str(tmp_path / "port"), 1, target),
                  target)
    for d in ("port", "ref"):
        with pytest.raises(ValueError, match="No cast function"):
            ref_restore(str(tmp_path / d), 1,
                        _jax(state, bf16_keys=("h",)))


def test_atomic_save_and_retention(tmp_path):
    state = _torch(_state(4))
    for step in range(1, 6):
        save_checkpoint(str(tmp_path), step, state, keep=2)
        assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["step_4", "step_5"]
    assert latest_step(str(tmp_path)) == 5
    assert latest_step(str(tmp_path / "absent")) is None


def test_restore_validates_keys_and_shapes(tmp_path):
    state = _torch(_state(5))
    save_checkpoint(str(tmp_path), 1, state)
    bad = _torch(_state(5))
    bad["params"]["x"] = torch.zeros(2)
    with pytest.raises(KeyError, match="params/x"):
        restore_checkpoint(str(tmp_path), 1, bad)
    bad = _torch(_state(5))
    bad["params"]["b"] = torch.zeros(7)
    with pytest.raises(ValueError, match="shape mismatch for params/b"):
        restore_checkpoint(str(tmp_path), 1, bad)


def test_async_checkpointer_writes_and_raises_on_wait(tmp_path):
    state = _torch(_state(6))
    ck = AsyncCheckpointer(str(tmp_path / "ok"))
    ck.save(2, state)
    state["params"]["w"].add_(1.0)      # after the snapshot: not saved
    ck.wait()
    got = restore_checkpoint(str(tmp_path / "ok"), 2, state)
    _assert_equal(got["params"], _torch(_state(6))["params"])
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ck = AsyncCheckpointer(str(blocker))
    ck.save(1, state)
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()                           # the error is raised once


def test_resumed_run_equals_an_uninterrupted_one(tmp_path):
    """Six steps straight against three, a checkpoint, a resume and three
    more: losses and final state bit for bit on the CPU."""
    cfg = configs.config("qwen3_8b", reduced=True)
    kw = dict(global_batch=4, seq_len=16, ocfg=launch.opt_config(3e-3, 6),
              tcfg=TrainConfig(microbatches=2), device="cpu",
              log=lambda m: None)
    straight = launch.train(cfg, steps=6, **kw)
    ck = str(tmp_path / "ck")
    launch.train(cfg, steps=3, ckpt_dir=ck, ckpt_every=3, **kw)
    resumed = launch.train(cfg, steps=6, ckpt_dir=ck, resume=True, **kw)
    assert resumed["start"] == 3
    assert resumed["losses"] == straight["losses"][3:]
    for a, b in zip(tree_leaves(resumed["state"]),
                    tree_leaves(straight["state"])):
        assert torch.equal(a, b)
