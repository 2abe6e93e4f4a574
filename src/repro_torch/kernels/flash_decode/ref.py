"""Plain PyTorch decode attention: the port of
``repro.kernels.flash_decode.ref``, and the plain versions of a
sequence-sharded cache's decode (:func:`decode_partial_ref`, one shard's
partial) and of the partials' merge (:func:`lse_combine`)."""
from __future__ import annotations

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def decode_ref(q: torch.Tensor, k_cache: torch.Tensor,
               v_cache: torch.Tensor, cache_len, *,
               window: int = 0) -> torch.Tensor:
    """q: (B,H,dh); k/v: (B,L,KVH,dh); cache_len: int or int32 scalar
    tensor -> (B,H,dh) in q's dtype."""
    b, h, dh = q.shape
    _, lmax, kvh, _ = k_cache.shape
    g = h // kvh
    qg = q.reshape(b, kvh, g, dh).float() * dh ** -0.5
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float())
    kpos = torch.arange(lmax, device=q.device)
    mask = kpos < cache_len
    if window > 0:
        mask &= kpos >= cache_len - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(b, h, dh).to(q.dtype)


def decode_bwd(do: torch.Tensor, q: torch.Tensor, k_cache: torch.Tensor,
               v_cache: torch.Tensor, cache_len, *, window: int = 0):
    """``(dq, dk_cache, dv_cache)`` of :func:`decode_ref` for the output
    cotangent ``do`` (``cache_len`` takes none): autograd through the plain
    version, recomputed."""
    with torch.enable_grad():
        q, k_cache, v_cache = (t.detach().requires_grad_()
                               for t in (q, k_cache, v_cache))
        o = decode_ref(q, k_cache, v_cache, cache_len, window=window)
        return torch.autograd.grad(o, (q, k_cache, v_cache), do)


def decode_partial_ref(q: torch.Tensor, k_shard: torch.Tensor,
                       v_shard: torch.Tensor, cache_len, *, kv_offset: int,
                       lmax: int, window: int = 0, ring: bool = False):
    """One sequence shard's decode partial: q (B,H,dh) over the shard's
    k/v (B,L_local,KVH,dh), which hold global slots ``[kv_offset,
    kv_offset + L_local)`` of a cache of ``lmax`` slots.  Returns ``(out,
    lse)``, both fp32: ``out`` (B,H,dh) normalised over the shard's own
    live keys, ``lse`` (B,H) their log-sum-exp of the scaled scores; a
    shard with no live key gives ``out = 0`` and ``lse = -inf``.

    The masks are the reference model's (``decode_attention``) at global
    slots ``kv_offset + j``: with ``ring`` the age mask ``(cache_len - 1 -
    slot) % lmax < cache_len`` (and ``< window`` with a window), else
    ``slot < cache_len`` (and ``>= cache_len - window``)."""
    b, h, dh = q.shape
    _, l_loc, kvh, _ = k_shard.shape
    g = h // kvh
    qg = q.reshape(b, kvh, g, dh).float() * dh ** -0.5
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_shard.float())
    kpos = kv_offset + torch.arange(l_loc, device=q.device)
    if ring:
        age = torch.remainder(cache_len - 1 - kpos, lmax)
        mask = age < cache_len
        if window > 0:
            mask &= age < window
    else:
        mask = kpos < cache_len
        if window > 0:
            mask &= kpos >= cache_len - window
    s = torch.where(mask, s, torch.full_like(s, float("-inf")))
    m = s.amax(-1, keepdim=True)
    live = torch.isfinite(m)
    p = torch.exp(s - torch.where(live, m, torch.zeros_like(m)))
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bkgs,bskd->bkgd", p, v_shard.float())
    out = torch.where(live, acc / torch.where(live, l, torch.ones_like(l)),
                      torch.zeros_like(acc))
    lse = torch.where(live, m + torch.log(l), m)[..., 0]
    return out.reshape(b, h, dh), lse.reshape(b, h)


def lse_combine(outs, lses):
    """Merge per-shard partials ``(out (B,H,dh), lse (B,H))``, lists over
    the shards: ``sum_r e^(lse_r - M) out_r / sum_r e^(lse_r - M)`` with
    ``M = max_r lse_r``.  A shard with ``lse = -inf`` weighs exactly 0.
    Returns ``(out, lse)`` in fp32, ``out = 0`` and ``lse = -inf`` where
    no shard held a live key."""
    lse = torch.stack([t.float() for t in lses])
    out = torch.stack([t.float() for t in outs])
    m = lse.amax(0)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(lse - m_safe)
    den = w.sum(0)
    num = (w[..., None] * out).sum(0)
    live = den > 0
    merged = torch.where(live[..., None],
                         num / torch.where(live, den,
                                           torch.ones_like(den))[..., None],
                         torch.zeros_like(num))
    return merged, torch.where(live, m_safe + torch.log(den), m)


def split_range(cache_len: int, lmax: int, window: int, nsplit: int,
                s: int, kv_offset: int = 0,
                lglob: int | None = None) -> tuple[int, int]:
    """Keys ``[lo, hi)`` of split ``s``, as the split kernel takes them: the
    ``s``-th of ``nsplit`` equal chunks of the live range ``[max(0,
    cache_len - window) if window else 0, min(cache_len, lglob))``, clipped
    to the shard's global slots ``[kv_offset, kv_offset + lmax)`` and
    counted from its first, each rounded up to a multiple of 16 keys;
    empty when ``lo >= hi``.  ``lglob`` defaults to ``lmax`` (no shard)."""
    lglob = lmax if lglob is None else lglob
    live_hi = min(cache_len, lglob, kv_offset + lmax) - kv_offset
    live_lo = max(max(0, cache_len - window) if window > 0 else 0,
                  kv_offset) - kv_offset
    n = max(0, live_hi - live_lo)
    chunk = -(-(-(-n // nsplit)) // 16) * 16
    lo = live_lo + s * chunk
    return lo, min(lo + chunk, live_hi)


def decode_split_ref(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *, window: int = 0,
                     nsplit: int = 1) -> torch.Tensor:
    """The split-K kernel's arithmetic, plainly (tests only): per split the
    fp32 ``(m, l, acc)`` of its keys (``m = NEG_INF``, ``l = acc = 0`` when
    empty), then the log-sum-exp combine ``sum e^(m_s-M) acc_s / max(sum
    e^(m_s-M) l_s, 1e-30)`` with ``M = max m_s``, rounded once to q's
    dtype.  Same shapes as :func:`decode_ref`."""
    b, h, dh = q.shape
    _, lmax, kvh, _ = k_cache.shape
    g = h // kvh
    clen = int(cache_len)
    qg = q.reshape(b, kvh, g, dh).float() * dh ** -0.5
    ms, ls, accs = [], [], []
    for s in range(nsplit):
        lo, hi = split_range(clen, lmax, window, nsplit, s)
        if lo >= hi:
            ms.append(torch.full((b, kvh, g), NEG_INF, device=q.device))
            ls.append(torch.zeros(b, kvh, g, device=q.device))
            accs.append(torch.zeros(b, kvh, g, dh, device=q.device))
            continue
        sc = torch.einsum("bkgd,bskd->bkgs", qg, k_cache[:, lo:hi].float())
        m = sc.amax(-1)
        p = torch.exp(sc - m[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bkgs,bskd->bkgd", p,
                                 v_cache[:, lo:hi].float()))
    m_s = torch.stack(ms)
    w = torch.exp(m_s - m_s.amax(0))
    l_sum = (w * torch.stack(ls)).sum(0)
    acc = (w[..., None] * torch.stack(accs)).sum(0)
    out = acc / torch.clamp(l_sum, min=1e-30)[..., None]
    return out.reshape(b, h, dh).to(q.dtype)
