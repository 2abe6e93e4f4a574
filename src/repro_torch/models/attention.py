"""Attention (port of ``repro.models.attention``): GQA with RoPE, optional
qk-norm, causal or sliding window; prefill through the flash-attention
kernel, decode through the flash-decode kernel.

Where the port differs from the reference:

* The decode KV-cache write is in place: ``index_copy_`` at the device-side
  ``cache["len"]`` into the caller's cache tensors (the reference returns a
  new cache array).  Nothing on the decode path reads ``len`` on the host.
* On one card, prefill hands k/v to the kernel unexpanded (it maps query
  head ``h`` to kv head ``h // G``); the reference's ``_expand_kv`` copy
  stays on the path where the Sharder splits heads.
* The cache is the reference's (:func:`kv_cache_axes`): its sequence over
  ``model`` (``kv_seq``), the first dim to claim that axis.  Where it is
  sharded so, each rank decodes its slots with the kernel's partial
  (:func:`~repro_torch.kernels.flash_decode.ops.decode_attend_partial`, at
  the shard's ``kv_offset``) and the ranks merge the partials by
  log-sum-exp: an all-reduce max of the fp32 ``lse`` over ``model``, then
  one all-reduce sum of the rescaled output packed with its weight
  (:func:`merge_partials`).  The reference's global-view program needs
  neither: GSPMD partitions its einsums over the sharded cache.  The new
  token's k/v is written only into the shard that owns its slot.  Where
  ``model`` is 1 (one card) the decode is the unsharded kernel's.
* Where heads do not divide the model axis and one score block is small
  (:func:`use_context_parallel`, the reference's predicate), prefill and
  training take the reference's context-parallel branch: q sharded over
  the sequence (``attn_seq``), k and v expanded and replicated, one score
  block a shard.  The kernel runs on each shard with the shard's global
  position as ``q_offset`` (:func:`context_parallel_offset`), which the
  reference's global-view program does not need.  Elsewhere heads are
  padded to a multiple of ``tp``, as in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_decode import ops as decode_ops

from .common import ModelConfig, Spec, rms_norm
from .layers import apply_rope

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
CP_SCORE_BYTES = 2 << 30   # the context-parallel branch's score-block limit
CP_AXES = ("batch", "attn_seq", None, None)


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------
def attn_spec(cfg: ModelConfig, stacked: int = 0,
              n_heads: Optional[int] = None,
              n_kv_heads: Optional[int] = None) -> dict:
    d, dh = cfg.d_model, cfg.dh
    nh = n_heads or cfg.n_heads
    nkv = n_kv_heads or cfg.n_kv_heads
    lead = (stacked,) if stacked else ()
    lx = ("layers",) if stacked else ()
    spec = {
        "wq": Spec(lead + (d, nh * dh), lx + ("embed", "heads")),
        "wk": Spec(lead + (d, nkv * dh), lx + ("embed", "kv_heads")),
        "wv": Spec(lead + (d, nkv * dh), lx + ("embed", "kv_heads")),
        "wo": Spec(lead + (nh * dh, d), lx + ("heads", "embed")),
    }
    if cfg.qk_norm:
        spec["q_norm"] = Spec(lead + (dh,), lx + (None,), init="ones")
        spec["k_norm"] = Spec(lead + (dh,), lx + (None,), init="ones")
    return spec


def head_sharding_axes(cfg: ModelConfig, shd, nh: int, nkv: int):
    """(q_axes, kv_axes): heads over the model axis when it is > 1, kv
    heads too when they divide it."""
    tp = shd.logical_size("heads")
    if tp > 1:
        q_ax = ("batch", "seq", "heads", None)
        kv_ax = ("batch", "seq",
                 "kv_heads" if nkv % tp == 0 else None, None)
    else:
        q_ax = ("batch", "seq", None, None)
        kv_ax = q_ax
    return q_ax, kv_ax


def use_context_parallel(b: int, s: int, nh: int, tp: int, dp: int) -> bool:
    """The reference's choice of the context-parallel schedule for an
    attention over ``b`` sequences of ``s`` with ``nh`` heads, on ``tp``
    model shards and ``dp`` batch shards: heads do not divide ``tp`` and one
    shard's fp32 score block, ``b_loc * nh * (s // tp) * s * 4`` bytes, is
    under 2 GiB.  Elsewhere heads are padded to a multiple of ``tp``."""
    if tp <= 1 or nh % tp == 0:
        return False
    b_loc = max(1, b // max(1, dp))
    return b_loc * nh * (s // tp) * s * 4 < CP_SCORE_BYTES


def context_parallel_offset(shd, s: int) -> int:
    """Global position of this rank's first query row under
    :data:`CP_AXES`: its ``model`` coordinate times ``s // tp`` when the
    sequence is sharded there, else 0 (the Sharder's fallback leaves a
    sequence that ``tp`` does not divide whole)."""
    if shd.spec((1, s, 1, 1), CP_AXES)[1] is None:
        return 0
    return shd.mesh.get_local_rank("model") * (s // shd.tp)


def pad_heads(x, nh_pad: int):
    """Zero-pad the head dim (axis 2) up to nh_pad."""
    b, s, nh, dh = x.shape
    if nh == nh_pad:
        return x
    return torch.cat([x, x.new_zeros((b, s, nh_pad - nh, dh))], dim=2)


def _expand_kv(k, h: int):
    """(B,S,KVH,dh) -> (B,S,H,dh): each kv head repeated over its group."""
    b, s, kvh, dh = k.shape
    if kvh == h:
        return k
    g = h // kvh
    return k[:, :, :, None, :].expand(b, s, kvh, g, dh).reshape(b, s, h, dh)


# ---------------------------------------------------------------------------
# plain attention paths (the reference's XLA paths)
# ---------------------------------------------------------------------------
def _attend_block(qc, k, v, qpos, kpos, *, causal: bool, window: int):
    """qc: (B,cq,H,dh); k,v: (B,Skv,H,dh) (kv pre-expanded); global pos."""
    scale = qc.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bshd->bhqs", (qc * scale).float(), k.float())
    mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                      device=qc.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask &= kpos[None, :] > qpos[:, None] - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqs,bshd->bqhd", p.to(v.dtype), v)


def chunked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      q_chunk: int = 512, q_offset: int = 0):
    """Plain attention one q chunk at a time (never all (Sq,Skv) scores).

    q: (B,Sq,H,dh); k,v: (B,Skv,KVH,dh).  ``q_offset`` is the global
    position of q[0].  Returns (B,Sq,H,dh).
    """
    b, sq, h, dh = q.shape
    skv = k.shape[1]
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    kpos_full = torch.arange(skv, device=q.device)
    if q_chunk >= sq:
        qpos = q_offset + torch.arange(sq, device=q.device)
        return _attend_block(q, k, v, qpos, kpos_full, causal=causal,
                             window=window)
    if sq % q_chunk:
        raise ValueError(f"Sq {sq} is not a multiple of q_chunk {q_chunk}")
    use_slice = window > 0 and skv > window + q_chunk
    outs = []
    for idx in range(sq // q_chunk):
        qc = q[:, idx * q_chunk:(idx + 1) * q_chunk]
        qpos = q_offset + idx * q_chunk + torch.arange(q_chunk,
                                                       device=q.device)
        if use_slice:
            slice_len = window + q_chunk
            start = min(max(q_offset + (idx + 1) * q_chunk - slice_len, 0),
                        skv - slice_len)
            kc, vc = k[:, start:start + slice_len], v[:, start:start + slice_len]
            kpos = start + torch.arange(slice_len, device=q.device)
        else:
            kc, vc, kpos = k, v, kpos_full
        outs.append(_attend_block(qc, kc, vc, qpos, kpos, causal=causal,
                                  window=window))
    return torch.cat(outs, dim=1)


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int = 0,
                     ring: bool = False):
    """Single-position decode, plain: q (B,1,H,dh) over a (B,L,KVH,dh)
    cache.  ``cache_len`` (int or int32 scalar tensor) counts the valid
    entries, the new token's k/v already written (at ``(cache_len-1) % L``
    if ``ring``).  The model decodes through the flash-decode kernel, ring
    caches included; this plain version is the tests' oracle."""
    b, _, h, dh = q.shape
    _, lmax, kvh, _ = k_cache.shape
    g = h // kvh
    scale = dh ** -0.5
    qg = q.reshape(b, kvh, g, dh)
    s = torch.einsum("bkgd,bskd->bkgs", (qg * scale).float(),
                     k_cache.float())
    kpos = torch.arange(lmax, device=q.device)
    if ring:
        # slot i holds absolute position cache_len-1-age, age=(cache_len-1-i)%L
        age = torch.remainder(cache_len - 1 - kpos, lmax)
        mask = age < cache_len
        if window > 0:
            mask &= age < window
    else:
        mask = kpos < cache_len
        if window > 0:
            mask &= kpos >= cache_len - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(b, 1, h, dh)


# ---------------------------------------------------------------------------
# full attention block (projections + rope + attend + out-proj)
# ---------------------------------------------------------------------------
def _rope(shd, x, positions, theta):
    return shd.local(lambda t, p: apply_rope(t, p, theta), (x, positions),
                     (None, None))


def attention_block(params, x, cfg: ModelConfig, shd, *,
                    cache=None, window: Optional[int] = None,
                    n_heads: Optional[int] = None,
                    n_kv_heads: Optional[int] = None):
    """Returns ``(out, new_cache)``.

    ``cache=None``: no cache (training-style forward).  ``cache`` with
    ``S > 1``: prefill; ``cache`` names only ``{"max_len", "dtype"}`` of
    the per-layer cache to fill, and ``new_cache`` is ``{"k", "v"}``.
    ``cache`` with ``S == 1``: one decode step over ``{"k": (B,L,KVH,dh),
    "v", "len": int32 scalar tensor}``, written in place; ``new_cache`` is
    that same dict.
    """
    b, s, d = x.shape
    nh = n_heads or cfg.n_heads
    nkv = n_kv_heads or cfg.n_kv_heads
    dh = cfg.dh
    win = cfg.attn_window if window is None else window
    dt = x.dtype
    q_ax, kv_ax = head_sharding_axes(cfg, shd, nh, nkv)

    tp = shd.logical_size("heads")

    def heads(w, n):
        t = x @ params[w].to(dt)
        if n % tp:
            # a model shard that splits a head is gathered first: DTensor
            # cannot unflatten it, or (one head, MQA) unflattens it along
            # its dh, where the rotary embedding needs both halves whole
            t = shd.constraint(t, ("batch", "seq", None))
        return t.reshape(b, s, n, dh)

    q, k, v = heads("wq", nh), heads("wk", nkv), heads("wv", nkv)

    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps, shd, q_ax)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps, shd, kv_ax)

    if cache is None or s > 1:
        positions = torch.arange(s, device=x.device)[None]
        q = _rope(shd, q, positions, cfg.rope_theta)
        k = _rope(shd, k, positions, cfg.rope_theta)
        k_gqa, v_gqa = k, v              # unexpanded GQA form for the cache
        q_off = 0
        if use_context_parallel(b, s, nh, tp, shd.dp):
            q = shd.constraint(q, CP_AXES)
            # one kv head expands as a view (stride 0 over the heads),
            # which stays a view when replicated; the kernel reads rows
            k, v = (shd.constraint(_expand_kv(t, nh).contiguous(),
                                   ("batch", None, None, None))
                    for t in (k, v))
            q_ax, q_off = CP_AXES, context_parallel_offset(shd, s)
        elif tp > 1:
            nh_pad = -(-nh // tp) * tp
            q = shd.constraint(pad_heads(q, nh_pad), q_ax)
            k = shd.constraint(pad_heads(_expand_kv(k, nh), nh_pad), q_ax)
            v = shd.constraint(pad_heads(_expand_kv(v, nh), nh_pad), q_ax)
        out = shd.local(
            lambda q_, k_, v_: flash_ops.attend(q_, k_, v_, causal=True,
                                                window=win, q_offset=q_off),
            (q, k, v), (q_ax, None, None))
        if out.shape[2] != nh:
            out = out[:, :, :nh]
        new_cache = None
        if cache is not None:
            new_cache = {n: _fill_cache(shd, t, cache["max_len"],
                                        cache["dtype"])
                         for n, t in (("k", k_gqa), ("v", v_gqa))}
    else:
        pos = cache["len"]                                # int32, on device
        lmax = cache["k"].shape[1]
        ring = win > 0 and lmax <= win
        positions = pos.reshape(1, 1)
        cache_ax = kv_cache_axes()["k"]
        by_seq = tp > 1 and shd.spec(cache["k"].shape, cache_ax)[1] \
            is not None
        if by_seq:                  # all heads meet every sequence shard
            q_ax = kv_ax = ("batch", "seq", None, None)
        elif kv_ax[2] is None:      # kv heads replicated: so are q heads
            q_ax = kv_ax
        q = shd.constraint(_rope(shd, q, positions, cfg.rope_theta), q_ax)
        k = shd.constraint(_rope(shd, k, positions, cfg.rope_theta), kv_ax)
        v = shd.constraint(v, kv_ax)
        # a ring is kept only with win >= L, where its age mask keeps the
        # slots below min(pos + 1, L): the linear mask, window 0
        dwin = 0 if ring else win

        def step(q_, k_, v_, kc, vc):
            slot = torch.remainder(pos, lmax) if ring else pos
            if not by_seq:
                idx = slot.reshape(1).long()
                kc.index_copy_(1, idx, k_.to(kc.dtype))
                vc.index_copy_(1, idx, v_.to(vc.dtype))
                return decode_ops.decode_attend(
                    q_[:, 0].contiguous(), kc, vc, pos + 1,
                    window=dwin)[:, None]
            off = shd.coordinate("model") * kc.shape[1]
            write_owned_slot(kc, k_, slot - off)
            write_owned_slot(vc, v_, slot - off)
            o, lse = decode_ops.decode_attend_partial(
                q_[:, 0].contiguous(), kc, vc, pos + 1, kv_offset=off,
                lmax=lmax, window=dwin)
            return merge_partials(o, lse, shd.group("model")).to(
                q_.dtype)[:, None]

        out = shd.local(step, (q, k, v, cache["k"], cache["v"]),
                        (None, None, None, cache_ax, cache_ax))
        new_cache = cache

    out = out.reshape(b, -1, nh * dh)
    if nh > 1 and nh % tp:
        # heads that do not divide ``model`` enter the out-projection
        # gathered (DTensor flattens neither the context-parallel sequence
        # shards for the matmul nor, backwards, a gradient shard that
        # splits a head)
        out = shd.constraint(out, ("batch", "seq", None))
    out = out.to(dt) @ params["wo"].to(dt)
    return shd.constraint(out, ("batch", "seq", None)), new_cache


def write_owned_slot(cache, new, rel):
    """Write ``new`` (B,1,KVH,dh) into slot ``rel`` of this rank's sequence
    shard ``cache`` (B,L_local,KVH,dh) if the shard holds it (``0 <= rel <
    L_local``; ``rel``: an int32 device scalar, never read on the host);
    any other shard writes its slot's own row back, bit for bit."""
    l_loc = cache.shape[1]
    own = (rel >= 0) & (rel < l_loc)
    idx = rel.clamp(0, l_loc - 1).reshape(1).long()
    row = torch.where(own, new.to(cache.dtype), cache.index_select(1, idx))
    cache.index_copy_(1, idx, row)


def merge_partials(out, lse, group):
    """The log-sum-exp merge of the sequence shards' decode partials over
    ``group`` (the ``model`` axis): out (B,H,dh) and lse (B,H), fp32.  An
    all-reduce max of ``lse``, then one all-reduce sum of ``e^(lse - M)
    out`` packed with ``e^(lse - M)``; a shard with no live key (``lse =
    -inf``) weighs 0.  Returns the fp32 (B,H,dh) output."""
    from torch.distributed import _functional_collectives as funcol

    m = funcol.all_reduce(lse, "max", group)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(lse - m)[..., None]
    tot = funcol.all_reduce(torch.cat([out * w, w], dim=-1), "sum", group)
    return tot[..., :-1] / tot[..., -1:].clamp_min(1e-30)


def _fill_cache(shd, t, max_len: int, dtype: torch.dtype):
    """Prefill's per-layer cache: ``t`` (B,S,KVH,dh) in the cache dtype at
    positions ``[0, S)``, zeros after; with ``S >= max_len`` (a window
    ring) the last ``max_len`` positions, slot ``j`` holding position
    ``p`` with ``p % max_len == j``.  Filled whole along the sequence, then
    laid out as :func:`kv_cache_axes` says."""
    s = t.shape[1]

    def fill(x):
        x = x.to(dtype)
        if s >= max_len:
            return torch.roll(x[:, -max_len:], s % max_len, dims=1)
        return F.pad(x, (0, 0, 0, 0, 0, max_len - s))

    whole = shd.local(fill, (shd.constraint(t, ("batch", None, "kv_heads",
                                                None)),), (None,))
    return shd.constraint(whole, kv_cache_axes()["k"])


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                  n_kv_heads: Optional[int] = None,
                  dtype: torch.dtype = torch.bfloat16,
                  window: Optional[int] = None, device="cuda"):
    nkv = n_kv_heads or cfg.n_kv_heads
    win = cfg.attn_window if window is None else window
    if win > 0:
        max_len = min(max_len, win)                       # ring buffer
    shape = (batch, max_len, nkv, cfg.dh)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }


def kv_cache_axes():
    """Per-layer cache layout, the reference's: batch over data, the
    sequence over model (``kv_seq``), kv heads over model only where the
    sequence cannot take it (the Sharder's prefix fallback)."""
    return {
        "k": ("batch", "kv_seq", "kv_heads", None),
        "v": ("batch", "kv_seq", "kv_heads", None),
        "len": (),
    }
