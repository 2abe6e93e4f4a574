"""Decode-attention wrapper: the CUDA kernels of ``csrc/flash_decode.cu``
(split-K: a split kernel and a combine, one C call) for CUDA tensors, the
plain version (:func:`.ref.decode_ref`) for CPU tensors.

``cache_len`` stays a device tensor: the kernels read it, the host never
does; the number of splits comes from the shapes and the card alone
(:func:`num_splits`).  ``launches`` counts calls that launched the kernels
(only the CUDA branch adds to it).  The backward recomputes through the
plain version (:func:`.ref.decode_bwd`) on either device; ``cache_len``
takes no gradient.
"""
from __future__ import annotations

import torch

from .. import build
from .ref import decode_bwd, decode_ref

launches = 0
MAX_GROUP_WIDTH = 2560      # G * dh outputs per CTA (csrc NACC * THREADS)
SPLIT_KEYS = 16             # a split's chunk is a multiple of 16 keys


def num_splits(b: int, kvh: int, lmax: int, sms: int) -> int:
    """Splits of the cache per (batch row, kv head): the largest power of
    two that keeps ``b * kvh * nsplit`` within two CTAs per SM, at least 1
    and at most one per 16 slots of ``lmax``.  It never depends on
    ``cache_len``, which only the device reads."""
    per_group = max(1, 2 * sms // max(1, b * kvh))
    n = 1 << (per_group.bit_length() - 1)
    return max(1, min(n, -(-lmax // SPLIT_KEYS)))


def splits_for(q: torch.Tensor, k_cache: torch.Tensor) -> int:
    """:func:`num_splits` for these CUDA tensors (the SM count is read once
    per device)."""
    b, lmax, kvh, _ = k_cache.shape
    return num_splits(b, kvh, lmax, build.sm_count(q.device.index))


def _launch(q, k_cache, v_cache, cache_len, window: int):
    global launches
    b, h, dh = q.shape
    _, lmax, kvh, _ = k_cache.shape
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    fn = build.library("flash_decode").repro_flash_decode
    nsplit = splits_for(q, k_cache)
    g = h // kvh
    scratch = torch.empty(b * kvh * nsplit * (g * dh + 2 * g),
                          dtype=torch.float32, device=q.device)
    err = fn(build.ptr(q), build.ptr(k_cache), build.ptr(v_cache),
             build.ptr(cache_len), build.ptr(o), build.ptr(scratch), b, lmax,
             h, kvh, dh, dh ** -0.5, window, nsplit,
             build.DTYPE_CODES[q.dtype], build.DTYPE_CODES[k_cache.dtype],
             build.stream_of(q))
    build.check("flash_decode", err)
    launches += 1
    return o


@torch.library.custom_op("repro_torch::flash_decode", mutates_args=())
def _flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, cache_len: torch.Tensor,
                  window: int) -> torch.Tensor:
    if q.device.type == "cpu":
        # in the layout the kernel and the fake give: empty_like(q)
        return torch.empty_like(q).copy_(
            decode_ref(q, k_cache, v_cache, cache_len, window=window))
    return _launch(q, k_cache, v_cache, cache_len, window)


@_flash_decode.register_fake
def _(q, k_cache, v_cache, cache_len, window):
    return torch.empty_like(q)


def _setup(ctx, inputs, output):
    q, k_cache, v_cache, cache_len, ctx.window = inputs
    ctx.save_for_backward(q, k_cache, v_cache, cache_len)


def _backward(ctx, do):
    q, k_cache, v_cache, cache_len = ctx.saved_tensors
    return (*decode_bwd(do, q, k_cache, v_cache, cache_len,
                        window=ctx.window), None, None)


_flash_decode.register_autograd(_backward, setup_context=_setup)


def decode_attend(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                  window: int = 0) -> torch.Tensor:
    """q: (B,H,dh); k/v: (B,L,KVH,dh); cache_len: int32 scalar tensor on
    q's device -> (B,H,dh)."""
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} "
                         f"cache {tuple(k_cache.shape)}")
    b, h, dh = q.shape
    if k_cache.shape[0] != b or k_cache.shape[3] != dh \
            or h % k_cache.shape[2]:
        raise ValueError(f"cache {tuple(k_cache.shape)} does not fit q "
                         f"{tuple(q.shape)}")
    if not isinstance(cache_len, torch.Tensor) or cache_len.numel() != 1 \
            or cache_len.dtype != torch.int32:
        raise TypeError("cache_len must be a one-element int32 tensor")
    if not (q.device == k_cache.device == v_cache.device
            == cache_len.device):
        raise ValueError("q, caches and cache_len must share a device")
    if q.device.type == "cuda":
        if q.dtype not in build.DTYPE_CODES or k_cache.dtype not in \
                build.DTYPE_CODES or k_cache.dtype != v_cache.dtype:
            raise TypeError("flash_decode kernel takes f32/bf16/f16, got "
                            f"q {q.dtype}, cache {k_cache.dtype}/"
                            f"{v_cache.dtype}")
        if (h // k_cache.shape[2]) * dh > MAX_GROUP_WIDTH:
            raise ValueError(f"query group width {(h // k_cache.shape[2])}"
                             f"x{dh} > {MAX_GROUP_WIDTH}")
        if not (q.is_contiguous() and k_cache.is_contiguous()
                and v_cache.is_contiguous()):
            raise ValueError("flash_decode kernel needs contiguous q/caches")
    elif q.device.type != "cpu":
        raise ValueError(f"decode_attend runs on cuda or cpu, not {q.device}")
    return _flash_decode(q, k_cache, v_cache, cache_len, int(window))
