"""Plain PyTorch RG-LRU recurrence: the port of ``repro.kernels.rglru.ref``."""
from __future__ import annotations

from typing import Optional

import torch


def rglru_ref(x: torch.Tensor, log_a: torch.Tensor,
              h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``h_t = exp(log_a_t) * h_{t-1} + x_t``, a sequential fp32 loop over
    axis 1.  x, log_a: (B, S, D); h0: (B, D) initial state (zeros when
    None).  Returns (B, S, D) in x's dtype."""
    b, s, d = x.shape
    h = (torch.zeros((b, d), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    a = torch.exp(log_a.float())
    xf = x.float()
    out = torch.empty((b, s, d), dtype=torch.float32, device=x.device)
    for t in range(s):
        h = a[:, t] * h + xf[:, t]
        out[:, t] = h
    return out.to(x.dtype)


def rglru_bwd(dy: torch.Tensor, log_a: torch.Tensor, h: torch.Tensor,
              h0: Optional[torch.Tensor] = None):
    """``(dx, dlog_a, dh0)`` of the recurrence at its outputs ``h`` (B, S,
    D) for the output cotangent ``dy``: the reverse scan
    ``g_t = dy_t + a_{t+1} g_{t+1}`` with ``dx_t = g_t``,
    ``dlog_a_t = g_t a_t h_{t-1}`` (``h_{-1} = h0``, zeros when None) and
    ``dh0 = a_0 g_0``; ``dh0`` is None when ``h0`` is.  All fp32."""
    b, s, d = dy.shape
    a = torch.exp(log_a.float())
    h = h.float()
    prev = torch.empty_like(h)
    prev[:, 1:] = h[:, :-1]
    prev[:, 0] = 0.0 if h0 is None else h0.float()
    dx = torch.empty_like(h)
    g = torch.zeros((b, d), dtype=torch.float32, device=dy.device)
    for t in range(s - 1, -1, -1):
        g = dy[:, t].float() + (a[:, t + 1] * g if t + 1 < s else 0.0)
        dx[:, t] = g
    dlog_a = dx * a * prev
    dh0 = None if h0 is None else (a[:, 0] * dx[:, 0]).to(h0.dtype)
    return dx.to(dy.dtype), dlog_a.to(log_a.dtype), dh0
