"""RG-LRU recurrence wrapper: the CUDA kernel ``csrc/rglru.cu`` for CUDA
tensors, the plain version (:func:`.ref.rglru_ref`) for CPU tensors.

The scan is elementwise over D, so under a mesh the model runs it on local
shards (an ``rnn``-sharded D needs no collective).  ``launches`` counts
kernel launches (only the CUDA branch adds to it).  The backward is the
plain reverse scan :func:`.ref.rglru_bwd` on either device.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import build
from .ref import rglru_bwd, rglru_ref

launches = 0


def _launch(x, log_a, h0):
    global launches
    b, s, d = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    fn = build.library("rglru").repro_rglru
    err = fn(build.ptr(x), build.ptr(log_a),
             None if h0 is None else build.ptr(h0), build.ptr(out), b, s, d,
             build.stream_of(x))
    build.check("rglru", err)
    launches += 1
    return out


@torch.library.custom_op("repro_torch::rglru_scan", mutates_args=())
def _rglru_scan(x: torch.Tensor, log_a: torch.Tensor,
                h0: Optional[torch.Tensor]) -> torch.Tensor:
    if x.device.type == "cpu":
        return rglru_ref(x, log_a, h0)
    return _launch(x, log_a, h0)


@_rglru_scan.register_fake
def _(x, log_a, h0):
    return torch.empty_like(x)


def _setup(ctx, inputs, output):
    _, log_a, h0 = inputs
    ctx.save_for_backward(log_a, output, h0)


def _backward(ctx, dy):
    log_a, h, h0 = ctx.saved_tensors
    return rglru_bwd(dy, log_a, h, h0)


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
