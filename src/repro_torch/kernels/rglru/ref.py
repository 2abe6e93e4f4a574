"""Plain PyTorch RG-LRU recurrence: the port of ``repro.kernels.rglru.ref``,
and the CUDA kernels' sequence-split arithmetic (``rglru_split_ref``,
``rglru_bwd_split_ref``), which ``chip_smoke.py`` holds the kernels to bit
for bit on the card."""
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


def _scan_order(plan, s: int):
    """The sub-chunks of ``csrc/rglru.cu``'s split launch ``plan``
    (variant, cluster, warps, steps) over a sequence of ``s`` rows, in scan
    order: rounds of ``cluster * warps`` sub-chunks of ``steps`` rows, a
    CTA's ``warps`` consecutive ones, each round's state carried into the
    next."""
    _, cluster, warps, steps = plan
    per_round = cluster * warps
    rounds = -(-s // (per_round * steps))
    return cluster, warps, steps, rounds, per_round


def _carries(P, H, carry, cluster, warps):
    """The kernels' ``exchange``: each CTA's aggregate of its sub-chunks'
    (P, H), composed over the cluster in rank order from ``carry``, gives
    every sub-chunk's carry in; returns them and the state after the
    round."""
    cta = []
    for k in range(cluster):
        p, h = torch.ones_like(carry), torch.zeros_like(carry)
        for j in range(k * warps, (k + 1) * warps):
            h = P[j] * h + H[j]
            p = p * P[j]
        cta.append((p, h))
    cins = []
    for p, h in cta:
        cins.append(carry)
        carry = p * carry + h
    out = []
    for k, cin in enumerate(cins):
        for j in range(k * warps, (k + 1) * warps):
            out.append(cin)
            cin = P[j] * cin + H[j]
    return out, carry


def rglru_split_ref(x: torch.Tensor, log_a: torch.Tensor,
                    h0: Optional[torch.Tensor], plan) -> torch.Tensor:
    """The forward kernel's arithmetic in plain PyTorch: the
    sequence split by ``plan`` into sub-chunks, each scanned from zero
    (pass 1), the carries composed as the kernel composes them, and each
    sub-chunk scanned again from its carry (pass 2).  Rows past the end are
    the identity (x = 0, log_a = 0).  A walk plan is the plain version's
    arithmetic.  fp32 in, fp32 out."""
    if plan[0] == "walk":
        return rglru_ref(x.float(), log_a.float(), h0)
    b, s, d = x.shape
    cluster, warps, steps, rounds, per_round = _scan_order(plan, s)
    pad = rounds * per_round * steps - s
    xf = torch.nn.functional.pad(x.float(), (0, 0, 0, pad))
    a = torch.exp(torch.nn.functional.pad(log_a.float(), (0, 0, 0, pad)))
    out = torch.empty_like(xf)
    carry = (torch.zeros((b, d), dtype=torch.float32, device=x.device)
             if h0 is None else h0.float())
    for r in range(rounds):
        subs = [range((r * per_round + m) * steps,
                      (r * per_round + m + 1) * steps)
                for m in range(per_round)]
        P, H = [], []
        for rows in subs:
            p, h = torch.ones_like(carry), torch.zeros_like(carry)
            for t in rows:
                h = a[:, t] * h + xf[:, t]
                p = p * a[:, t]
            P.append(p)
            H.append(h)
        cins, carry = _carries(P, H, carry, cluster, warps)
        for rows, h in zip(subs, cins):
            for t in rows:
                h = a[:, t] * h + xf[:, t]
                out[:, t] = h
    return out[:, :s]


def rglru_bwd_split_ref(dy: torch.Tensor, log_a: torch.Tensor,
                        h: torch.Tensor, h0: Optional[torch.Tensor], plan):
    """The backward kernel's arithmetic in plain PyTorch: the reverse scan
    split by the split ``plan`` from the end of the sequence (sub-chunk m
    in scan order holds rows [s - (m+1) steps, s - m steps), each walked
    last row first), pass 1, the carries, then pass 2 with the epilogue.
    Rows before the start are zero-filled (dy = 0, log_a = 0, h = 0) and
    written nowhere.  Returns ``(dx, dlog_a, dh0)`` as :func:`rglru_bwd`
    does."""
    b, s, d = dy.shape
    cluster, warps, steps, rounds, per_round = _scan_order(plan, s)
    pad = rounds * per_round * steps - s
    F = torch.nn.functional
    dyp = F.pad(dy.float(), (0, 0, pad, 0))
    # a_{t+1} of the last row is a zero-filled row: exp(0)
    a = torch.exp(F.pad(log_a.float(), (0, 0, pad, 1)))
    first = (torch.zeros((b, 1, d), dtype=torch.float32, device=dy.device)
             if h0 is None else h0.float()[:, None])
    prev = F.pad(torch.cat([first, h.float()[:, :-1]], dim=1),
                 (0, 0, pad, 0))
    dx = torch.empty_like(dyp)
    dlog_a = torch.empty_like(dyp)
    carry = torch.zeros((b, d), dtype=torch.float32, device=dy.device)
    for r in range(rounds):
        # padded row indices, last row first
        subs = [range(pad + s - (r * per_round + m) * steps - 1,
                      pad + s - (r * per_round + m + 1) * steps - 1, -1)
                for m in range(per_round)]
        P, H = [], []
        for rows in subs:
            p, g = torch.ones_like(carry), torch.zeros_like(carry)
            for u in rows:
                g = dyp[:, u] + a[:, u + 1] * g
                p = p * a[:, u + 1]
            P.append(p)
            H.append(g)
        cins, carry = _carries(P, H, carry, cluster, warps)
        for rows, g in zip(subs, cins):
            for u in rows:
                g = dyp[:, u] + a[:, u + 1] * g
                dx[:, u] = g
                dlog_a[:, u] = g * a[:, u] * prev[:, u]
    dh0 = None if h0 is None else (a[:, pad] * dx[:, pad]).to(h0.dtype)
    return dx[:, pad:], dlog_a[:, pad:], dh0
