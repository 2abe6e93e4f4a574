"""Plain PyTorch decode attention: the port of
``repro.kernels.flash_decode.ref``."""
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
