"""Explicit DDP gradient synchronization (port of ``repro.train.ddp``).

PyTorch DDP issues one all-reduce per gradient bucket (the paper's Table 3;
bucketing is Li et al.'s).  This module issues those all-reduces itself,
on the calling thread, over a process group the caller passes: a mesh
dimension's group of a fake process group when monitoring, a real one-rank
group when training on one card.  Three flavours, as in the reference:

* ``per_param`` -- one all-reduce per gradient tensor (naive DDP);
* ``bucketed``  -- gradients flattened into ~``bucket_mb`` MiB buckets in
  the parameter tree's leaf order, one all-reduce per bucket;
* bf16 wire compression with fp32 error feedback on ``bucketed``.

``pmean`` is a sum all-reduce divided by the group size.
``torch.nn.parallel.DistributedDataParallel`` is not used: its reducer
buckets in reverse registration order, caps its first bucket at 1 MiB and
runs from autograd threads, so its calls would not follow this plan.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol

from repro_torch.models.common import tree_leaves, tree_unflatten


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    """Mean of ``x`` over ``group``: one sum all-reduce, then a division."""
    return funcol.all_reduce(x, "sum", group) / dist.get_world_size(group)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` in ``group``, concatenated along dim 0."""
    # all_gather_single replaces all_gather_tensor in newer torch releases
    gather = getattr(funcol, "all_gather_single", None) \
        or funcol.all_gather_tensor
    return funcol.wait_tensor(gather(x, 0, group))


# ---------------------------------------------------------------------------
# bucketing
# ---------------------------------------------------------------------------
def bucket_plan(params, bucket_mb: float = 25.0) -> list[list[int]]:
    """Greedy assignment of leaf indices to ~``bucket_mb`` MiB buckets, in
    leaf order, sized as fp32 whatever the leaves' dtype."""
    limit = bucket_mb * 1024 * 1024
    buckets, cur, cur_bytes = [], [], 0.0
    for i, leaf in enumerate(tree_leaves(params)):
        nbytes = float(math.prod(leaf.shape)) * 4
        if cur and cur_bytes + nbytes > limit:
            buckets.append(cur)
            cur, cur_bytes = [], 0.0
        cur.append(i)
        cur_bytes += nbytes
    if cur:
        buckets.append(cur)
    return buckets


def allreduce_bucketed(grads, group, bucket_mb: float = 25.0,
                       compress: bool = False, error_feedback=None):
    """All-reduce (mean) ``grads`` in buckets.  Returns (synced grads, new
    error feedback).

    ``compress=True`` casts each bucket to bf16 for the wire (half the
    bytes) and keeps the fp32 quantization error in ``error_feedback`` (a
    tree like ``grads``), re-added next step."""
    leaves = tree_leaves(grads)
    ef_leaves = (tree_leaves(error_feedback) if error_feedback is not None
                 else [None] * len(leaves))
    out = [None] * len(leaves)
    new_ef = [None] * len(leaves)
    for idx in bucket_plan(grads, bucket_mb):
        flat = []
        for i in idx:
            g = leaves[i].float()
            if ef_leaves[i] is not None:
                g = g + ef_leaves[i]
            flat.append(g.reshape(-1))
        buf = torch.cat(flat) if len(flat) > 1 else flat[0]
        if compress:
            wire = buf.to(torch.bfloat16)
            err = buf - wire.float()
            buf = pmean(wire, group).float()
        else:
            err = None
            buf = pmean(buf, group)
        off = 0
        for i in idx:
            n = leaves[i].numel()
            out[i] = buf[off:off + n].reshape(leaves[i].shape)
            if err is not None:
                new_ef[i] = err[off:off + n].reshape(leaves[i].shape)
            off += n
    ef_out = (tree_unflatten(grads, new_ef)
              if compress and error_feedback is not None else error_feedback)
    return tree_unflatten(grads, out), ef_out


def allreduce_per_param(grads, group):
    """One all-reduce (mean) per tensor (naive DDP)."""
    return tree_unflatten(grads, [pmean(g, group)
                                  for g in tree_leaves(grads)])


# ---------------------------------------------------------------------------
# a complete DDP train step
# ---------------------------------------------------------------------------
def value_and_grad(loss_fn: Callable, params, batch):
    """``(loss, metrics), grads`` of ``loss_fn(params, batch)``, the
    gradients a tree like ``params`` (taken with ``torch.autograd.grad``
    over fresh leaves, so ``params`` need not require grad)."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, metrics = loss_fn(tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    return (loss.detach(), metrics), tree_unflatten(params, list(grads))


def sgd(params, grads, lr: float):
    """``p - lr * g`` in fp32, cast back to each parameter's dtype."""
    with torch.no_grad():
        return tree_unflatten(params, [
            (p.float() - lr * g.float()).to(p.dtype)
            for p, g in zip(tree_leaves(params), tree_leaves(grads))])


def make_ddp_train_step(loss_fn: Callable, group, *, mode: str = "bucketed",
                        bucket_mb: float = 25.0, compress: bool = False,
                        lr: float = 1e-3):
    """``step(params, ef, batch) -> (new params, ef, loss)``.

    ``loss_fn(params, batch) -> (loss, metrics)``.  Parameters are
    replicated and ``batch`` is this rank's shard; the gradients are synced
    over ``group`` (per tensor or in buckets), then the loss is averaged
    over it, then SGD updates inline (the paper's applications)."""
    if mode not in ("bucketed", "per_param"):
        raise ValueError(f"unknown DDP mode {mode!r}")

    def step(params, ef, batch):
        (loss, _), grads = value_and_grad(loss_fn, params, batch)
        if mode == "per_param":
            grads = allreduce_per_param(grads, group)
        else:
            grads, ef = allreduce_bucketed(grads, group, bucket_mb,
                                           compress=compress,
                                           error_feedback=ef)
        loss = pmean(loss, group)
        return sgd(params, grads, lr), ef, loss

    return step


def init_error_feedback(params):
    return tree_unflatten(params, [torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device)
                                   for p in tree_leaves(params)])
