"""The sLSTM time loop as two custom ops, ``repro_torch::slstm_scan`` and
``repro_torch::slstm_scan_bwd``.

The sLSTM recurrence (arXiv 2405.04517; the reference's ``_slstm_step``)
is sequential and has recurrent weights, so it cannot be a parallel scan.
The reference traces its two-level ``lax.scan`` once; a Python loop over
the steps would record one op (and, on a mesh, possibly one collective) a
step in a capture, and millions of fake ops in a full-size dry run.  So
the loop runs inside one op: a capture sees it once, and its fake
implementations give the shapes without running it.

Both real implementations are the plain step loop in PyTorch (no Pallas
kernel stands behind this loop, so there is no kernel to port; a CUDA one
is later work).  The backward is the loop's analytic gradient run from the
end, a chunk of ``chunk`` steps at a time: each chunk's carries are
recomputed from the carry at its start (kept from one forward pass), as
the reference's rematted outer scan recomputes its chunks.

Layouts: ``xg`` (B, S, 4, d) holds the z, i, f, o gate pre-activations
(the input products and biases) in fp32; ``r`` (4, nh, dh, dh) the four
recurrent matrices; a carry (4, B, d) holds c, n, m, h.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30
N_EPS = 1e-6


def init_carry(xg: torch.Tensor) -> torch.Tensor:
    """The zero carry of a (B, S, 4, d) input: c, n, h zero, m -1e30."""
    b, _, _, d = xg.shape
    carry = xg.new_zeros((4, b, d))
    carry[2] = NEG_INF
    return carry


def _gates(r, carry, xt):
    """One step's activations.  xt: (B, 4, d); carry: (c, n, m, h)."""
    c, n, m, hp = carry
    b, d = hp.shape
    g, nh, dh, _ = r.shape
    rec = torch.einsum("bhd,ghde->gbhe", hp.reshape(b, nh, dh),
                       r).reshape(g, b, d)
    zt = torch.tanh(xt[:, 0] + rec[0])
    it = xt[:, 1] + rec[1]
    ft = xt[:, 2] + rec[2]
    ot = torch.sigmoid(xt[:, 3] + rec[3])
    u = F.logsigmoid(ft) + m
    m_new = torch.maximum(u, it)
    fp = torch.exp(u - m_new)
    ip = torch.exp(it - m_new)
    c_new = fp * c + ip * zt
    n_new = fp * n + ip
    h = ot * c_new / torch.clamp_min(n_new, N_EPS)
    return zt, it, ft, ot, u, m_new, fp, ip, c_new, n_new, h


def _run(xg, r, carry):
    """The forward loop over ``xg``'s steps from ``carry`` (4, B, d) ->
    (hs (B, S, d), final carry (4, B, d))."""
    c = tuple(carry.unbind(0))
    hs = []
    for t in range(xg.shape[1]):
        *_, m_new, _, _, c_new, n_new, h = _gates(r, c, xg[:, t])
        c = (c_new, n_new, m_new, h)
        hs.append(h)
    return torch.stack(hs, dim=1), torch.stack(c)


def slstm_ref(xg: torch.Tensor, r: torch.Tensor,
              state: Optional[torch.Tensor] = None):
    """The plain forward: (hs (B, S, d), final carry (4, B, d))."""
    return _run(xg, r, init_carry(xg) if state is None else state)


def _step_bwd(r, carry, xt, gh, gnext, dr):
    """One step's gradient, given ``gh`` (dL/dh_t from the output) and
    ``gnext`` (dL/d of the new carry).  Returns (dxt (B, 4, d), dL/d
    ``carry``) and adds the step's share into ``dr``."""
    c, n, m, hp = carry
    zt, it, ft, ot, u, m_new, fp, ip, c_new, n_new, _ = _gates(r, carry, xt)
    gc_, gn_, gm_, gh_ = gnext
    gh = gh + gh_
    nc = torch.clamp_min(n_new, N_EPS)
    got = gh * c_new / nc
    gc_ = gc_ + gh * ot / nc
    gn_ = gn_ + torch.where(n_new > N_EPS, -gh * ot * c_new / (nc * nc),
                            torch.zeros_like(nc))
    gfp = (gc_ * c + gn_ * n) * fp          # d/d(u - m_new)
    gip = (gc_ * zt + gn_) * ip             # d/d(it - m_new)
    gm_new = gm_ - gfp - gip
    # the maximum's gradient splits evenly at a tie, as jnp.maximum's
    w_u = (u > it).to(u.dtype) + 0.5 * (u == it).to(u.dtype)
    gu = gfp + gm_new * w_u
    git = gip + gm_new * (1 - w_u)
    ga = torch.stack([gc_ * ip * (1 - zt * zt),          # z pre-activation
                      git,                               # i
                      gu * torch.sigmoid(-ft),           # f (log-sigmoid)
                      got * ot * (1 - ot)])              # o (sigmoid)
    g, b, d = ga.shape
    nh, dh = r.shape[1], r.shape[2]
    gah = ga.reshape(g, b, nh, dh)
    ghp = torch.einsum("gbhe,ghde->bhd", gah, r).reshape(b, d)
    dr.add_(torch.einsum("bhd,gbhe->ghde", hp.reshape(b, nh, dh), gah))
    return ga.transpose(0, 1), (gc_ * fp, gn_ * fp, gu, ghp)


def slstm_bwd_ref(dhs: torch.Tensor, dcarry: torch.Tensor, xg: torch.Tensor,
                  r: torch.Tensor, state: Optional[torch.Tensor] = None,
                  chunk: int = 256):
    """The plain backward: (dxg, dr, dstate), dstate empty when ``state``
    is None.  Runs from the last chunk of ``chunk`` steps to the first,
    each chunk's carries recomputed from its start."""
    s = xg.shape[1]
    chunk = max(1, min(chunk, s))
    starts = []
    carry = init_carry(xg) if state is None else state
    for c0 in range(0, s, chunk):
        starts.append(carry)
        carry = _run(xg[:, c0:c0 + chunk], r, carry)[1]
    dxg = torch.empty_like(xg)
    dr = torch.zeros_like(r)
    g = tuple(dcarry.unbind(0))
    for k in reversed(range(len(starts))):
        c0 = k * chunk
        carries = [tuple(starts[k].unbind(0))]
        for t in range(c0, min(c0 + chunk, s) - 1):
            *_, m_new, _, _, c_new, n_new, h = _gates(r, carries[-1],
                                                      xg[:, t])
            carries.append((c_new, n_new, m_new, h))
        for t in reversed(range(c0, min(c0 + chunk, s))):
            dxg[:, t], g = _step_bwd(r, carries[t - c0], xg[:, t],
                                     dhs[:, t], g, dr)
    dstate = xg.new_empty(0) if state is None else torch.stack(g)
    return dxg, dr, dstate


def _check(xg, r, state):
    if xg.dim() != 4 or xg.shape[2] != 4 or r.dim() != 4 or r.shape[0] != 4:
        raise ValueError(f"bad shapes xg {tuple(xg.shape)} r "
                         f"{tuple(r.shape)}")
    if r.shape[1] * r.shape[2] != xg.shape[3] or r.shape[2] != r.shape[3]:
        raise ValueError(f"r {tuple(r.shape)} does not fit d {xg.shape[3]}")
    ts = (xg, r) if state is None else (xg, r, state)
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("slstm_scan runs in fp32, got "
                        + "/".join(str(t.dtype) for t in ts))
    if state is not None and tuple(state.shape) != (4, xg.shape[0],
                                                    xg.shape[3]):
        raise ValueError(f"state {tuple(state.shape)} does not fit xg "
                         f"{tuple(xg.shape)}")


@torch.library.custom_op("repro_torch::slstm_scan", mutates_args=())
def _slstm_scan(xg: torch.Tensor, r: torch.Tensor,
                state: Optional[torch.Tensor],
                chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    return slstm_ref(xg, r, state)


@_slstm_scan.register_fake
def _(xg, r, state, chunk):
    b, s, _, d = xg.shape
    return xg.new_empty((b, s, d)), xg.new_empty((4, b, d))


@torch.library.custom_op("repro_torch::slstm_scan_bwd", mutates_args=())
def _slstm_scan_bwd(
        dhs: torch.Tensor, dcarry: torch.Tensor, xg: torch.Tensor,
        r: torch.Tensor, state: Optional[torch.Tensor], chunk: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return slstm_bwd_ref(dhs, dcarry, xg, r, state, chunk)


@_slstm_scan_bwd.register_fake
def _(dhs, dcarry, xg, r, state, chunk):
    dstate = xg.new_empty(0) if state is None else torch.empty_like(state)
    return torch.empty_like(xg), torch.empty_like(r), dstate


def _setup(ctx, inputs, output):
    xg, r, state, chunk = inputs
    ctx.chunk = chunk
    ctx.save_for_backward(xg, r, state)


def _backward(ctx, dhs, dcarry):
    xg, r, state = ctx.saved_tensors
    b, s, _, d = xg.shape
    if dhs is None:
        dhs = xg.new_zeros((b, s, d))
    if dcarry is None:
        dcarry = xg.new_zeros((4, b, d))
    dxg, dr, dstate = _slstm_scan_bwd(dhs.contiguous(), dcarry.contiguous(),
                                      xg, r, state, ctx.chunk)
    return dxg, dr, None if state is None else dstate, None


_slstm_scan.register_autograd(_backward, setup_context=_setup)


def slstm_scan(xg: torch.Tensor, r: torch.Tensor,
               state: Optional[torch.Tensor] = None, chunk: int = 256):
    """The sLSTM recurrence over axis 1 of ``xg`` (B, S, 4, d) with
    recurrent matrices ``r`` (4, nh, dh, dh), from ``state`` (4, B, d)
    (None: the zero carry) -> (hs (B, S, d), final carry (4, B, d)), all
    fp32.  ``chunk`` is the backward's recompute length."""
    _check(xg, r, state)
    return _slstm_scan(xg, r, state, chunk)
