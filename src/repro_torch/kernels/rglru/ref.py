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
