"""Attention wrapper: the CUDA kernel ``csrc/flash_attention.cu`` for CUDA
tensors, the plain version (:func:`.ref.attention_ref`) for CPU tensors.

``attend`` is the call-site of the port's transformer prefill; ``launches``
counts kernel launches (only the CUDA branch adds to it).  The backward
recomputes through the plain version (:func:`.ref.attention_bwd`) on either
device, as the reference differentiates its XLA path.
"""
from __future__ import annotations

import torch

from ... import spans
from .. import build
from .ref import attention_bwd, attention_ref

launches = 0
MAX_HEAD_DIM = 256


def _launch(q, k, v, causal: bool, window: int, q_offset: int):
    global launches
    b, sq, h, dh = q.shape
    _, skv, kvh, _ = k.shape
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    fn = build.library("flash_attention").repro_flash_attention
    err = fn(build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(o),
             b, sq, skv, h, kvh, dh, dh ** -0.5, int(causal), window,
             q_offset, build.DTYPE_CODES[q.dtype], build.stream_of(q))
    build.check("flash_attention", err)
    launches += 1
    return o


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool, window: int,
                     q_offset: int) -> torch.Tensor:
    if q.device.type == "cpu":
        # in the layout the kernel and the fake give: empty_like(q)
        return torch.empty_like(q).copy_(attention_ref(
            q, k, v, causal=causal, window=window, q_offset=q_offset))
    return _launch(q, k, v, causal, window, q_offset)


@_flash_attention.register_fake
def _(q, k, v, causal, window, q_offset):
    return torch.empty_like(q)


def _setup(ctx, inputs, output):
    q, k, v, ctx.causal, ctx.window, ctx.q_offset = inputs
    ctx.save_for_backward(q, k, v)


def _backward(ctx, do):
    q, k, v = ctx.saved_tensors
    with spans.span("attention"):
        grads = attention_bwd(do, q, k, v, causal=ctx.causal,
                              window=ctx.window, q_offset=ctx.q_offset)
    return (*grads, None, None, None)


_flash_attention.register_autograd(_backward, setup_context=_setup)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True, window: int = 0,
           q_offset: int = 0) -> torch.Tensor:
    """q: (B,Sq,H,dh); k,v: (B,Skv,KVH,dh) -> (B,Sq,H,dh).

    GQA reads kv head ``h // (H/KVH)``, so k/v go in unexpanded.  Ragged
    ``Sq``/``Skv`` are fine; ``dh`` may be up to 256 on the card.
    """
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    b, sq, h, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh or h % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must share a device")
    if q.device.type == "cuda":
        if q.dtype not in build.DTYPE_CODES or not (q.dtype == k.dtype
                                                     == v.dtype):
            raise TypeError("flash_attention kernel takes one dtype of "
                            f"f32/bf16/f16, got {q.dtype}/{k.dtype}/{v.dtype}")
        if dh > MAX_HEAD_DIM:
            raise ValueError(f"head dim {dh} > {MAX_HEAD_DIM}")
        if not (q.is_contiguous() and k.is_contiguous()
                and v.is_contiguous()):
            raise ValueError("flash_attention kernel needs contiguous q/k/v")
    elif q.device.type != "cpu":
        raise ValueError(f"attend runs on cuda or cpu, not {q.device}")
    with spans.span("attention"):
        return _flash_attention(q, k, v, bool(causal), int(window),
                                int(q_offset))
