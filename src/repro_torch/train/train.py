"""The LM train step (port of ``repro.train.train``): microbatched
gradient accumulation, bf16 gradient communication, AdamW/Adafactor.

The state is ``{"params", "opt", "step"}``, nested dicts of tensors.  On
one card (``Sharder()``) they are plain tensors; under a mesh they are
DTensors placed by :meth:`~repro_torch.parallel.Sharder.shard_tree` from
the logical-axes trees :func:`train_state_shardings` gives, and the
collectives are DTensor's (FSDP all-gathers of the weights, reductions of
the gradients, the norm's scalar all-reduces), which the monitor records.

Where the port differs from the reference:

* The step updates ``state`` in place and returns it (the reference
  returns a new state, its old one donated).
* The microbatch loop is a Python loop (the reference scans), each
  microbatch's loss backward accumulating into ``accum_dtype`` buffers
  placed as the parameters are.  Each stacked ``(L, ...)`` parameter is
  handed to the loss as a list of ``L`` per-layer autograd leaves (views
  of it), each of whose gradient is added into its layer's slice of the
  buffer as soon as autograd has it, then dropped: no microbatch keeps a
  whole gradient tree beside the buffers.  The sums are the reference's
  (``acc + g.astype(accum_dtype)`` from zeros, then ``/ a``).
* ``jit_train_step`` has no counterpart: there is no compile step, and
  the state's placement is :func:`train_state_shardings`' axes trees.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models.common import tree_leaves, tree_unflatten
from repro_torch.optim import (OptConfig, apply_updates, init_opt_state,
                               opt_state_axes)
from repro_torch.parallel import Sharder


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    remat: str = "dots"                  # none | dots | full
    grad_dtype: str = "float32"          # "bfloat16": bf16 weights into the loss
    accum_dtype: str = "float32"         # bf16 halves the accumulation buffer
    seed: int = 0


TrainState = dict  # {"params": tree, "opt": tree, "step": int32 scalar}


def init_train_state(model, opt_cfg: OptConfig, seed: int = 0,
                     device="cuda") -> TrainState:
    """Random parameters from ``seed`` on ``device``, zero optimizer
    state, step 0."""
    params = model.init(seed, device=device)
    return {"params": params, "opt": init_opt_state(params, opt_cfg),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def train_state_shapes(model, opt_cfg: OptConfig, device="cuda") -> TrainState:
    """``torch.empty`` stand-ins of the state (allocation-free under
    ``FakeTensorMode``)."""
    meta = init_opt_state(model.shapes(device="meta"), opt_cfg)
    opt = tree_unflatten(meta, [torch.empty(t.shape, dtype=t.dtype,
                                            device=device)
                                for t in tree_leaves(meta)])
    return {"params": model.shapes(device=device), "opt": opt,
            "step": torch.empty((), dtype=torch.int32, device=device)}


def train_state_shardings(model, opt_cfg: OptConfig):
    """The state's logical-axes tree (what ``Sharder.shard_tree`` places;
    the reference returns the ``NamedSharding`` tree its Sharder makes)."""
    p_axes = model.axes()
    return {"params": p_axes,
            "opt": opt_state_axes(p_axes, model.shapes(device="meta"),
                                  opt_cfg),
            "step": ()}


def batch_shardings(batch_shapes):
    """Each batch leaf's logical axes: ``batch`` then ``seq`` (the layout
    the models give their token and label inputs)."""
    def leaf(s):
        if len(s.shape) >= 2:
            return ("batch", "seq") + (None,) * (len(s.shape) - 2)
        return ("batch",) + (None,) * (len(s.shape) - 1)
    return {k: leaf(v) for k, v in batch_shapes.items()}


def _stacked(axes) -> bool:
    return len(axes) > 0 and axes[0] == "layers"


def make_train_step(model, opt_cfg: OptConfig, train_cfg: TrainConfig,
                    shd: Sharder) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``; ``state``
    is updated in place.  ``metrics`` holds the reference's ``xent``,
    ``aux``, ``loss``, ``lr`` and ``grad_norm`` (fp32 scalar tensors)."""
    a = train_cfg.microbatches
    bf16_grads = train_cfg.grad_dtype == "bfloat16"

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        params = state["params"]
        flat = tree_leaves(params)
        stacked = [_stacked(ax) for ax in tree_leaves(model.axes())]
        accum = (getattr(torch, train_cfg.accum_dtype) if a > 1 else None)
        bufs = [torch.zeros_like(p, dtype=accum or p.dtype) for p in flat]

        def leaf(view, buf):
            t = view.detach().requires_grad_()

            def add(t):
                buf.add_(t.grad.to(buf.dtype))
                t.grad = None
            t.register_post_accumulate_grad_hook(add)
            return t

        loss_leaves = []
        for p, buf, st in zip(flat, bufs, stacked):
            cast = (bf16_grads and p.dtype == torch.float32 and p.dim() > 1)
            per = ([leaf(p[l], buf[l]) for l in range(p.shape[0])] if st
                   else [leaf(p, buf)])
            if cast:
                # on the sharded side, as the reference casts (the models
                # then cast to their compute dtype, also before a gather)
                per = [t.to(torch.bfloat16) for t in per]
            loss_leaves.append(per if st else per[0])
        loss_params = tree_unflatten(params, loss_leaves)

        n = next(iter(batch.values())).shape[0] // max(a, 1)
        total = 0
        for i in range(max(a, 1)):
            mb = batch if a <= 1 else {k: v[i * n:(i + 1) * n]
                                        for k, v in batch.items()}
            loss, metrics = model.loss_fn(loss_params, mb, shd,
                                          remat=train_cfg.remat)
            loss.backward()
            total = total + loss.detach()
        with torch.no_grad():
            if a > 1:
                for buf in bufs:
                    buf.div_(a)
                loss = total / a
                metrics = {"xent": loss,
                           "aux": torch.zeros((), dtype=torch.float32,
                                              device=loss.device)}
            else:
                loss = total
                metrics = {k: v.detach() for k, v in metrics.items()}
        grads = tree_unflatten(params, bufs)
        _, _, stats = apply_updates(params, grads, state["opt"], opt_cfg,
                                    state["step"])
        del grads, bufs
        with torch.no_grad():
            state["step"].add_(1)
        return state, dict(metrics, loss=loss, **stats)

    return train_step
