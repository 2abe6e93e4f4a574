"""Attention wrapper: the CUDA kernels of ``csrc/flash_attention.cu`` for
CUDA tensors, the plain versions (:mod:`.ref`) for CPU tensors.

``attend`` is the call-site of the port's transformer prefill and training
forward.  The backward is chosen by device and dtype, as the forward's
tensor-core and fp32 kernels are:

* bf16/f16 CUDA tensors under autograd take the custom op
  ``repro_torch::flash_attention_lse``: the forward kernel, which also
  writes each row's log-sum-exp; its autograd formula calls
  ``repro_torch::flash_attention_bwd``, the backward kernels (a prep pass,
  dK/dV, dQ: one C call) from the saved ``q, k, v, o, lse``.
* Everything else takes ``repro_torch::flash_attention``, whose backward
  recomputes through the plain version (:func:`.ref.attention_bwd`), as
  the reference differentiates its XLA path: CPU tensors, fp32 CUDA
  tensors (the tensor cores cannot hold the fp32 tolerance), and any call
  outside autograd (serving), which launches the forward with no lse.

``launches`` counts forward kernel launches and ``bwd_launches`` backward
calls (only the CUDA branches add to them).
"""
from __future__ import annotations

import functools

import torch

from ... import spans
from .. import build
from .ref import (attention_bwd, attention_bwd_from_lse, attention_lse,
                  attention_ref)

launches = 0
bwd_launches = 0
MAX_HEAD_DIM = 256
# csrc/flash_attention.cu's dK/dV kernel: keys a CTA; the CTAs an SM its
# grid should hold before CTAs share a kv tile's query heads
BWD_BK = 64
BWD_CTAS_PER_SM = 2
# dtypes whose CUDA backward is the kernel (the tensor-core forward's)
KERNEL_BWD_DTYPES = (torch.bfloat16, torch.float16)


def kernel_backward(q: torch.Tensor) -> bool:
    """Whether a call on ``q`` under autograd takes the backward kernels:
    bf16/f16 CUDA tensors, a rule by device and dtype."""
    return q.device.type == "cuda" and q.dtype in KERNEL_BWD_DTYPES


def _run(q, k, v, causal: bool, window: int, q_offset: int, lse):
    global launches
    b, sq, h, dh = q.shape
    _, skv, kvh, _ = k.shape
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    fn = build.library("flash_attention").repro_flash_attention
    err = fn(build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(o),
             None if lse is None else build.ptr(lse), b, sq, skv, h, kvh, dh,
             dh ** -0.5, int(causal), window, q_offset,
             build.DTYPE_CODES[q.dtype], build.stream_of(q))
    build.check("flash_attention", err)
    launches += 1
    return o


def _launch(q, k, v, causal: bool, window: int, q_offset: int):
    """The forward kernel, no lse: ``o``."""
    return _run(q, k, v, causal, window, q_offset, None)


def _launch_lse(q, k, v, causal: bool, window: int, q_offset: int):
    """The forward kernel writing the fp32 (B, H, Sq) lse too: ``(o,
    lse)``."""
    b, sq, h, _ = q.shape
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    return _run(q, k, v, causal, window, q_offset, lse), lse


@functools.lru_cache(maxsize=256)
def bwd_head_split(b: int, skv: int, kvh: int, group: int,
                   sm_count: int) -> int:
    """CTAs that share each kv tile's query heads in the dK/dV kernel, on
    a card of ``sm_count`` SMs.  One CTA a (kv tile, kv head, batch) takes
    its whole group while that grid holds ``BWD_CTAS_PER_SM`` CTAs an SM
    (Granite-3-2B's training call: 16 x 8 x 4); a smaller grid shares each
    group between as many CTAs as fill it, rounded up to a divisor of the
    group so the shares are even (Qwen3-8B's at batch 1: 128 CTAs, so 4 of
    one head; RecurrentGemma-2B's MQA: 16, so 10), and a sum kernel adds
    their fp32 partial dK and dV in order."""
    ctas = b * kvh * -(-skv // BWD_BK)
    want = BWD_CTAS_PER_SM * sm_count
    if ctas >= want:
        return 1
    split = min(group, -(-want // ctas))
    while group % split:
        split += 1
    return split


def _launch_bwd(do, q, k, v, o, lse, causal: bool, window: int,
                q_offset: int):
    """The backward kernels: ``(dq, dk, dv)``.  ``do`` comes from autograd
    in whatever layout it made, so it is made contiguous here; ``D``'s
    fp32 (B, H, Sq) scratch, and the head shares' fp32 partial dK and dV
    where :func:`bwd_head_split` is above 1, are allocated here."""
    global bwd_launches
    b, sq, h, dh = q.shape
    _, skv, kvh, _ = k.shape
    do = do.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    fn = build.library("flash_attention").repro_flash_attention_bwd
    hsplit = bwd_head_split(b, skv, kvh, h // kvh,
                            build.sm_count(q.device.index))
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    part = (torch.empty((2, hsplit, *k.shape), dtype=torch.float32,
                        device=q.device) if hsplit > 1 else None)
    err = fn(build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(o),
             build.ptr(do), build.ptr(lse), build.ptr(delta),
             None if part is None else build.ptr(part), build.ptr(dq),
             build.ptr(dk), build.ptr(dv), b, sq, skv, h, kvh, dh,
             dh ** -0.5, int(causal), window, q_offset, hsplit,
             build.DTYPE_CODES[q.dtype], build.stream_of(q))
    build.check("flash_attention", err)
    bwd_launches += 1
    return dq, dk, dv


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


@torch.library.custom_op("repro_torch::flash_attention_lse",
                         mutates_args=())
def _flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, window: int, q_offset: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    if q.device.type == "cpu":
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        return (torch.empty_like(q).copy_(attention_ref(q, k, v, **kw)),
                attention_lse(q, k, **kw))
    return _launch_lse(q, k, v, causal, window, q_offset)


@_flash_attention_lse.register_fake
def _(q, k, v, causal, window, q_offset):
    b, sq, h, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, h, sq), dtype=torch.float32)


@torch.library.custom_op("repro_torch::flash_attention_bwd",
                         mutates_args=())
def _flash_attention_bwd(do: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
                         causal: bool, window: int, q_offset: int
                         ) -> tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    if q.device.type == "cpu":
        return attention_bwd_from_lse(do, q, k, v, o, lse, causal=causal,
                                      window=window, q_offset=q_offset)
    return _launch_bwd(do, q, k, v, o, lse, causal, window, q_offset)


@_flash_attention_bwd.register_fake
def _(do, q, k, v, o, lse, causal, window, q_offset):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _setup_lse(ctx, inputs, output):
    q, k, v, ctx.causal, ctx.window, ctx.q_offset = inputs
    o, lse = output
    ctx.mark_non_differentiable(lse)
    ctx.save_for_backward(q, k, v, o, lse)


def _backward_lse(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    with spans.span("attention"):
        grads = _flash_attention_bwd(do, q, k, v, o, lse, ctx.causal,
                                     ctx.window, ctx.q_offset)
    return (*grads, None, None, None)


_flash_attention_lse.register_autograd(_backward_lse,
                                       setup_context=_setup_lse)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True, window: int = 0,
           q_offset: int = 0) -> torch.Tensor:
    """q: (B,Sq,H,dh); k,v: (B,Skv,KVH,dh) -> (B,Sq,H,dh).

    GQA reads kv head ``h // (H/KVH)``, so k/v go in unexpanded.  Ragged
    ``Sq``/``Skv`` are fine; ``dh`` may be up to 256 on the card.  Under
    autograd, bf16/f16 CUDA tensors take the backward kernels (module
    docstring).
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
    args = (q, k, v, bool(causal), int(window), int(q_offset))
    with spans.span("attention"):
        if (torch.is_grad_enabled() and kernel_backward(q)
                and (q.requires_grad or k.requires_grad or v.requires_grad)):
            return _flash_attention_lse(*args)[0]
        return _flash_attention(*args)
