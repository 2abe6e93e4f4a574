"""Plain PyTorch attention: the port of ``repro.kernels.flash_attention.ref``
(full score matrix, fp32), its backward by autograd, and the CUDA
backward's algorithm from the forward's log-sum-exp (:func:`attention_lse`,
:func:`attention_bwd_from_lse`)."""
from __future__ import annotations

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def visible(sq: int, skv: int, *, causal: bool = True, window: int = 0,
            q_offset: int = 0, device=None) -> torch.Tensor:
    """(Sq, Skv) bool: the keys each query row sees (causal and window
    masks taken against ``q_offset`` + row)."""
    qpos = q_offset + torch.arange(sq, device=device)
    kpos = torch.arange(skv, device=device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask &= kpos[None, :] > qpos[:, None] - window
    return mask


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(B, KVH, G, Sq, Skv) fp32 scores scaled by dh^-0.5."""
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, dh).float()
    return torch.einsum("bqkgd,bskd->bkgqs", qg * dh ** -0.5, k.float())


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


def attention_lse(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
                  window: int = 0, q_offset: int = 0) -> torch.Tensor:
    """(B, H, Sq) fp32: each query row's log-sum-exp (base e) of its
    visible scores scaled by dh^-0.5, -inf for a row that sees no key --
    the statistic the CUDA forward saves for its backward."""
    b, sq, h, _ = q.shape
    mask = visible(sq, k.shape[1], causal=causal, window=window,
                   q_offset=q_offset, device=q.device)
    s = _scores(q, k).masked_fill(~mask, float("-inf"))
    return torch.logsumexp(s, dim=-1).reshape(b, h, sq)


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


def attention_bwd_from_lse(do: torch.Tensor, q: torch.Tensor,
                           k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                           lse: torch.Tensor, *, causal: bool = True,
                           window: int = 0, q_offset: int = 0):
    """``(dq, dk, dv)`` by the CUDA backward's algorithm, in fp32: from the
    forward's output ``o`` and its ``lse`` (:func:`attention_lse`), never
    the softmax's own backward.  ``P = exp(S - lse)`` on visible pairs and
    0 elsewhere, ``D = rowsum(dO * O)``, ``dS = P (dP - D)`` with ``dP = dO
    V^T``; ``dv = P^T dO``, ``dq = scale dS K``, ``dk = scale dS^T Q``, each
    kv head's gradients summed over its query group.  A row that sees no
    key contributes nothing and gets zeros (``attention_bwd`` gives its
    rows the uniform softmax's gradients instead).  Returned in the
    inputs' dtypes."""
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    g = h // kvh
    mask = visible(sq, k.shape[1], causal=causal, window=window,
                   q_offset=q_offset, device=q.device)
    s = _scores(q, k)
    p = torch.where(mask, torch.exp(s - lse.float().reshape(b, kvh, g, sq,
                                                            1)), 0.0)
    dog = do.float().reshape(b, sq, kvh, g, dh)
    dd = (dog * o.float().reshape(b, sq, kvh, g, dh)).sum(-1)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, v.float())
    ds = p * (dp - dd.permute(0, 2, 3, 1)[..., None])
    scale = dh ** -0.5
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float()) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds,
                      q.float().reshape(b, sq, kvh, g, dh)) * scale
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
    return (dq.reshape(b, sq, h, dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
