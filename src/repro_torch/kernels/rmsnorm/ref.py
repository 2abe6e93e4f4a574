"""Plain PyTorch RMSNorm: the port of ``repro.kernels.rmsnorm.ref``."""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """``mean(x^2)`` in fp32, ``x * rsqrt(var + eps)`` rounded to x's dtype,
    then times ``w`` rounded to x's dtype (the reference's order)."""
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * w.to(dt)


def rmsnorm_bwd(dy: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dw)`` of :func:`rmsnorm_ref` at ``(x, w)`` for the output
    cotangent ``dy``: autograd through the plain version, recomputed."""
    with torch.enable_grad():
        x = x.detach().requires_grad_()
        w = w.detach().requires_grad_()
        dx, dw = torch.autograd.grad(rmsnorm_ref(x, w, eps), (x, w), dy)
    return dx, dw
