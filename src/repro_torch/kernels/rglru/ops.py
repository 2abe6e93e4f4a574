"""RG-LRU recurrence wrapper: the CUDA kernels of ``csrc/rglru.cu`` for CUDA
tensors, the plain versions (:func:`.ref.rglru_ref`, :func:`.ref.rglru_bwd`)
for CPU tensors.

The scan is elementwise over D, so under a mesh the model runs it on local
shards (an ``rnn``-sharded D needs no collective).  The forward is the
custom op ``repro_torch::rglru_scan``; its autograd formula calls a second
custom op, ``repro_torch::rglru_scan_bwd``, the reverse scan with its
epilogue: one kernel launch on the card, :func:`.ref.rglru_bwd` on the CPU.
Both take their launch from :func:`rglru_plan`: a sequence-split scan, or
for a forward that a split would not speed up a walk of S a thread a
channel.  ``launches`` counts forward launches and ``bwd_launches``
backward launches (only the CUDA branches add to them).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from .. import build
from .ref import rglru_bwd, rglru_ref

launches = 0
bwd_launches = 0

VARIANTS = {"walk": 0, "split": 1}   # csrc/rglru.cu's codes
# csrc/rglru.cu's limits: the split's channels a CTA (one a lane), warps
# (sub-chunks) a CTA, rows a sub-chunk and CTAs a cluster (the portable
# cluster size); the walk's threads (channels) a CTA
CHANNELS = 32
MAX_WARPS = 8
MAX_STEPS = 16
MAX_CLUSTER = 8
WALK_THREADS = 256
# the cluster grows until the grid holds this many CTAs an SM
CTAS_PER_SM = 4


class Plan(NamedTuple):
    variant: str    # "walk" or "split"
    cluster: int    # CTAs a cluster, each a tile of S (the walk: 1)
    warps: int      # sub-chunks a CTA, one warp each (the walk: 8)
    steps: int      # rows a sub-chunk; a tile is warps * steps rows (walk: 0)


WALK = Plan("walk", 1, WALK_THREADS // 32, 0)


@functools.lru_cache(maxsize=256)
def rglru_plan(b: int, s: int, d: int, sm_count: int,
               backward: bool = False) -> Plan:
    """The launch of a (b, s, d) scan, forward or ``backward``, on a card of
    ``sm_count`` SMs.  The split takes 32 channels of one batch row a CTA,
    so its grid has ``b * ceil(d / 32)`` channel tiles before S is split;
    its cluster doubles, up to 8, while the grid holds fewer than
    ``CTAS_PER_SM`` CTAs an SM and each CTA would keep at least
    ``MAX_STEPS`` rows (train (1, 1024, 2560): 80 tiles x 8).  A CTA's
    share of S is cut into at most 8 sub-chunks of at most 16 rows, as few
    rows a sub-chunk as cover it, and a longer share is walked in rounds of
    8 x 16 rows.  A forward whose split would take a cluster of 1 takes
    the walk instead: a sequence too short to split (S < 32, the serve
    decode step), where the split only adds latency, or a grid the channel
    tiles already fill (serve prefill (8, 128, 2560): 640 tiles), where
    the split gains nothing on the walk.  The backward, which only
    training runs, always splits.  The grid is (cluster, ceil(d / 32), b)
    CTAs of ``32 * warps`` threads (the walk's: (ceil(d / 256), b) of 256);
    ``csrc/rglru.cu``'s ``repro_rglru_smem`` gives a split plan's shared
    memory."""
    tiles = b * -(-d // CHANNELS)
    cluster = 1
    while (cluster < MAX_CLUSTER and tiles * cluster < CTAS_PER_SM * sm_count
           and s >= 2 * cluster * MAX_STEPS):
        cluster *= 2
    if cluster == 1 and not backward:
        return WALK
    share = -(-s // cluster)
    warps = min(MAX_WARPS, -(-share // MAX_STEPS))
    steps = min(MAX_STEPS, -(-share // warps))
    return Plan("split", cluster, warps, steps)


def plan_for(x: torch.Tensor, backward: bool = False) -> Plan:
    """:func:`rglru_plan` for a CUDA tensor of shape (B, S, D) (the SM
    count is read once per device)."""
    b, s, d = x.shape
    return rglru_plan(b, s, d, build.sm_count(x.device.index), backward)


def _launch(x, log_a, h0, plan: Plan | None = None):
    global launches
    b, s, d = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    fn = build.library("rglru").repro_rglru
    plan = plan or plan_for(x)
    err = fn(build.ptr(x), build.ptr(log_a),
             None if h0 is None else build.ptr(h0), build.ptr(out), b, s, d,
             VARIANTS[plan.variant], *plan[1:], build.stream_of(x))
    build.check("rglru", err)
    launches += 1
    return out


def _launch_bwd(dy, log_a, h, h0, plan: Plan | None = None):
    """The backward kernel: ``(dx, dlog_a, dh0)``, dh0 empty when h0 is
    None.  ``dy`` comes from autograd in whatever layout it made (the
    model's ``h, h[:, -1]`` sums two cotangents, one of them expanded), so
    it is made contiguous here."""
    global bwd_launches
    b, s, d = dy.shape
    dy = dy.contiguous()
    dx, dlog_a = torch.empty_like(dy), torch.empty_like(dy)
    dh0 = dy.new_empty(0) if h0 is None else torch.empty_like(h0)
    if dx.numel() == 0:
        return dx, dlog_a, dh0.zero_()
    fn = build.library("rglru").repro_rglru_bwd
    plan = plan or plan_for(dy, backward=True)
    err = fn(build.ptr(dy), build.ptr(log_a), build.ptr(h),
             None if h0 is None else build.ptr(h0), build.ptr(dx),
             build.ptr(dlog_a), None if h0 is None else build.ptr(dh0),
             b, s, d, *plan[1:], build.stream_of(dy))
    build.check("rglru", err)
    bwd_launches += 1
    return dx, dlog_a, dh0


def _plain_bwd(dy, log_a, h, h0):
    """:func:`.ref.rglru_bwd` in the backward op's output form (dh0 empty
    when h0 is None)."""
    dx, dlog_a, dh0 = rglru_bwd(dy, log_a, h, h0)
    return dx, dlog_a, dy.new_empty(0) if dh0 is None else dh0


@torch.library.custom_op("repro_torch::rglru_scan", mutates_args=())
def _rglru_scan(x: torch.Tensor, log_a: torch.Tensor,
                h0: Optional[torch.Tensor]) -> torch.Tensor:
    if x.device.type == "cpu":
        return rglru_ref(x, log_a, h0)
    return _launch(x, log_a, h0)


@_rglru_scan.register_fake
def _(x, log_a, h0):
    return torch.empty_like(x)


@torch.library.custom_op("repro_torch::rglru_scan_bwd", mutates_args=())
def _rglru_scan_bwd(
        dy: torch.Tensor, log_a: torch.Tensor, h: torch.Tensor,
        h0: Optional[torch.Tensor]
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if dy.device.type == "cpu":
        return _plain_bwd(dy, log_a, h, h0)
    return _launch_bwd(dy, log_a, h, h0)


@_rglru_scan_bwd.register_fake
def _(dy, log_a, h, h0):
    dh0 = dy.new_empty(0) if h0 is None else torch.empty_like(h0)
    return torch.empty_like(dy), torch.empty_like(dy), dh0


def _setup(ctx, inputs, output):
    _, log_a, h0 = inputs
    ctx.save_for_backward(log_a, output, h0)


def _backward(ctx, dy):
    log_a, h, h0 = ctx.saved_tensors
    dx, dlog_a, dh0 = _rglru_scan_bwd(dy, log_a, h, h0)
    return dx, dlog_a, None if h0 is None else dh0


_rglru_scan.register_autograd(_backward, setup_context=_setup)


def rglru_scan(x: torch.Tensor, log_a: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``h_t = exp(log_a_t) * h_{t-1} + x_t`` over axis 1 in one pass.
    x, log_a: (B, S, D) fp32; h0: (B, D) fp32 or None (zeros) ->
    (B, S, D) fp32."""
    if x.dim() != 3 or log_a.shape != x.shape:
        raise ValueError(f"bad shapes x {tuple(x.shape)} "
                         f"log_a {tuple(log_a.shape)}")
    if h0 is not None and tuple(h0.shape) != (x.shape[0], x.shape[2]):
        raise ValueError(f"h0 {tuple(h0.shape)} does not fit x "
                         f"{tuple(x.shape)}")
    ts = (x, log_a) if h0 is None else (x, log_a, h0)
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("rglru_scan takes fp32 x, log_a and h0, got "
                        + "/".join(str(t.dtype) for t in ts))
    if any(t.device != x.device for t in ts):
        raise ValueError("x, log_a and h0 must share a device")
    if x.device.type == "cuda":
        if not all(t.is_contiguous() for t in ts):
            raise ValueError("rglru kernel needs contiguous x/log_a/h0")
    elif x.device.type != "cpu":
        raise ValueError(f"rglru_scan runs on cuda or cpu, not {x.device}")
    return _rglru_scan(x, log_a, h0)
