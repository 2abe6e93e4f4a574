"""Plain PyTorch attention: the port of ``repro.kernels.flash_attention.ref``
(full score matrix, fp32)."""
from __future__ import annotations

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  q_offset: int = 0) -> torch.Tensor:
    """q: (B,Sq,H,dh); k,v: (B,Skv,KVH,dh) -> (B,Sq,H,dh) in q's dtype."""
    b, sq, h, dh = q.shape
    _, skv, kvh, _ = k.shape
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, dh).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg * dh ** -0.5, k.float())
    qpos = q_offset + torch.arange(sq, device=q.device)
    kpos = torch.arange(skv, device=q.device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask &= kpos[None, :] > qpos[:, None] - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(b, sq, h, dh).to(q.dtype)


def attention_bwd(do: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, *, causal: bool = True, window: int = 0,
                  q_offset: int = 0):
    """``(dq, dk, dv)`` of :func:`attention_ref` for the output cotangent
    ``do``: autograd through the plain version, recomputed (the full score
    matrix in fp32, as the reference differentiates its XLA path)."""
    with torch.enable_grad():
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
        o = attention_ref(q, k, v, causal=causal, window=window,
                          q_offset=q_offset)
        return torch.autograd.grad(o, (q, k, v), do)
