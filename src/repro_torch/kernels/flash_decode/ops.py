"""Decode-attention wrappers: the CUDA kernels of ``csrc/flash_decode.cu``
(split-K: a split kernel and a combine, one C call) for CUDA tensors, the
plain versions for CPU tensors.  :func:`decode_attend` decodes a whole
cache (:func:`.ref.decode_ref`); :func:`decode_attend_partial` one sequence
shard of it, returning the fp32 partial and its log-sum-exp for a merge
across the shards (:func:`.ref.decode_partial_ref`, :func:`.ref.lse_combine`).

``cache_len`` stays a device tensor: the kernels read it, the host never
does; the number of splits comes from the shapes and the card alone
(:func:`num_splits`).  ``launches`` counts the whole-cache op's launches
and ``partial_launches`` the partial op's (only the CUDA branches add to
them).  The backward recomputes through the
plain version (:func:`.ref.decode_bwd`) on either device; ``cache_len``
takes no gradient.  No path differentiates a sharded decode: the partial
op refuses a backward.
"""
from __future__ import annotations

import torch

from ... import spans
from .. import build
from .ref import decode_bwd, decode_partial_ref, decode_ref

launches = 0
partial_launches = 0
MAX_GROUP_WIDTH = 2560      # outputs per CTA, heads x dh (csrc NACC * THREADS)
SPLIT_KEYS = 16             # a split's chunk is a multiple of 16 keys


def head_blocks(g: int, dh: int) -> int:
    """Blocks of heads a kv head's ``g`` query heads are cut into, one CTA
    each: the fewest that divide ``g`` and keep a block's ``heads * dh``
    outputs within :data:`MAX_GROUP_WIDTH` (1 for every GQA layout served;
    3 blocks of 16 for Granite-20B's 48 heads of 128 on one kv head)."""
    return next(n for n in range(1, g + 1)
                if g % n == 0 and g // n * dh <= MAX_GROUP_WIDTH)


def num_splits(b: int, kvh: int, lmax: int, sms: int) -> int:
    """Splits of the cache per (batch row, kv head) group: the largest
    power of two that keeps ``b * kvh * nsplit`` within two CTAs per SM, at
    least 1 and at most one per 16 slots of ``lmax``.  ``kvh`` counts a kv
    head's :func:`head_blocks` apart.  It never depends on ``cache_len``,
    which only the device reads."""
    per_group = max(1, 2 * sms // max(1, b * kvh))
    n = 1 << (per_group.bit_length() - 1)
    return max(1, min(n, -(-lmax // SPLIT_KEYS)))


def splits_for(q: torch.Tensor, k_cache: torch.Tensor) -> int:
    """:func:`num_splits` for these CUDA tensors (the SM count is read once
    per device)."""
    b, lmax, kvh, dh = k_cache.shape
    return num_splits(b, kvh * head_blocks(q.shape[1] // kvh, dh), lmax,
                      build.sm_count(q.device.index))


def _launch(q, k_cache, v_cache, cache_len, window: int,
            kv_offset: int = 0, lmax=None, lse=None):
    """Both kernels, one C call; ``lse`` (fp32 (B,H), or None) asks for the
    shard's partial, and then ``o`` is fp32.  ``k_cache`` holds global
    slots ``[kv_offset, kv_offset + L)`` of a cache of ``lmax`` (default
    ``L``)."""
    global launches, partial_launches
    b, h, dh = q.shape
    _, l_loc, kvh, _ = k_cache.shape
    o = torch.empty_like(q, dtype=torch.float32 if lse is not None
                         else q.dtype)
    if o.numel() == 0:
        return o
    fn = build.library("flash_decode").repro_flash_decode
    nsplit = splits_for(q, k_cache)
    g = h // kvh
    scratch = torch.empty(b * kvh * nsplit * (g * dh + 2 * g),
                          dtype=torch.float32, device=q.device)
    err = fn(build.ptr(q), build.ptr(k_cache), build.ptr(v_cache),
             build.ptr(cache_len), build.ptr(o),
             None if lse is None else build.ptr(lse), build.ptr(scratch), b,
             l_loc, l_loc if lmax is None else lmax, kv_offset, h, kvh, dh,
             dh ** -0.5, window, nsplit, head_blocks(g, dh),
             build.DTYPE_CODES[q.dtype], build.DTYPE_CODES[k_cache.dtype],
             build.stream_of(q))
    build.check("flash_decode", err)
    if lse is None:
        launches += 1
    else:
        partial_launches += 1
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


@torch.library.custom_op("repro_torch::flash_decode_partial", mutates_args=())
def _flash_decode_partial(q: torch.Tensor, k_shard: torch.Tensor,
                          v_shard: torch.Tensor, cache_len: torch.Tensor,
                          kv_offset: int, lmax: int,
                          window: int) -> tuple[torch.Tensor, torch.Tensor]:
    if q.device.type == "cpu":
        return decode_partial_ref(q, k_shard, v_shard, cache_len,
                                  kv_offset=kv_offset, lmax=lmax,
                                  window=window)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    return _launch(q, k_shard, v_shard, cache_len, window, kv_offset, lmax,
                   lse), lse


@_flash_decode_partial.register_fake
def _(q, k_shard, v_shard, cache_len, kv_offset, lmax, window):
    return (torch.empty_like(q, dtype=torch.float32),
            q.new_empty(q.shape[:2], dtype=torch.float32))


def _partial_backward(ctx, do, dlse):
    raise RuntimeError(
        "repro_torch::flash_decode_partial has no gradient: no path "
        "differentiates a sequence-sharded decode")


_flash_decode_partial.register_autograd(_partial_backward)


def _check(q, k_cache, v_cache, cache_len, name: str) -> None:
    """The checks both wrappers make (shapes, ``cache_len`` a one-element
    int32 tensor on q's device, the kernel's dtypes and layout on CUDA)."""
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
        if dh > MAX_GROUP_WIDTH:
            raise ValueError(f"head dim {dh} > {MAX_GROUP_WIDTH}")
        if not (q.is_contiguous() and k_cache.is_contiguous()
                and v_cache.is_contiguous()):
            raise ValueError("flash_decode kernel needs contiguous q/caches")
    elif q.device.type != "cpu":
        raise ValueError(f"{name} runs on cuda or cpu, not {q.device}")


def decode_attend(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                  window: int = 0) -> torch.Tensor:
    """q: (B,H,dh); k/v: (B,L,KVH,dh); cache_len: int32 scalar tensor on
    q's device -> (B,H,dh)."""
    _check(q, k_cache, v_cache, cache_len, "decode_attend")
    with spans.span("attention"):
        return _flash_decode(q, k_cache, v_cache, cache_len, int(window))


def decode_attend_partial(q: torch.Tensor, k_shard: torch.Tensor,
                          v_shard: torch.Tensor, cache_len: torch.Tensor, *,
                          kv_offset: int, lmax: int, window: int = 0):
    """One sequence shard of a decode: q (B,H,dh) over k/v (B,L_local,KVH,
    dh), global slots ``[kv_offset, kv_offset + L_local)`` of a cache of
    ``lmax`` slots, whose first ``cache_len`` are live (a ring with a
    window of at least ``lmax`` passes window 0, as to :func:`decode_attend`).
    Returns fp32 ``(out (B,H,dh), lse (B,H))``: the output normalised over
    the shard's live keys and their log-sum-exp, ``lse = -inf`` and ``out =
    0`` where the shard holds none; :func:`.ref.lse_combine` merges them."""
    _check(q, k_shard, v_shard, cache_len, "decode_attend_partial")
    if not 0 <= kv_offset <= lmax - k_shard.shape[1]:
        raise ValueError(f"shard of {k_shard.shape[1]} slots at kv_offset "
                         f"{kv_offset} does not lie in a cache of {lmax}")
    with spans.span("attention"):
        return _flash_decode_partial(q, k_shard, v_shard, cache_len,
                                     int(kv_offset), int(lmax), int(window))
