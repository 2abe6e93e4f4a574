"""The mLSTM parallel form as two custom ops, ``repro_torch::mlstm_parallel``
and ``repro_torch::mlstm_parallel_bwd``.

The parallel form (the reference's ``mlstm_parallel``) is a decay-masked
linear attention::

    D_ij = b_i - b_j + itilde_j  (j <= i),   b = cumsum(log_f)
    m_i  = max_j D_ij
    P_ij = (q_i . k_j) exp(D_ij - m_i)
    h_i  = sum_j P_ij v_j / max(|sum_j P_ij|, exp(-m_i))

computed one query chunk at a time against its whole key prefix (the
reference scans (query chunk, key chunk) pairs with an online max; the two
agree to fp32 rounding).  At a production sequence that is hundreds of
chunks a layer: run op by op, a capture would record thousands of ops a
layer and a full-size dry run would trace for minutes.  So the form runs
inside one op, as the sLSTM loop does (:mod:`.slstm_scan`), with fake
implementations for captures.  No Pallas kernel stands behind it: both
real implementations are plain PyTorch.

The backward is the form's analytic gradient, a query chunk at a time
from the same recomputed scores.  It holds ``m`` constant: ``h`` does not
depend on ``m`` (both branches of the normaliser cancel it), so the terms
autodiff takes through ``m`` sum to zero up to rounding.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _prepare(q, k, v, log_f, itilde):
    """Head-major fp32 operands: q scaled (B,nh,S,dh), k, v (B,nh,S,dh),
    b = cumsum(log_f) and a = b - itilde (B,nh,S)."""
    dh = q.shape[-1]
    qf = q.float().transpose(1, 2) * dh ** -0.5
    kf = k.float().transpose(1, 2)
    vf = v.float().transpose(1, 2)
    b = torch.cumsum(log_f.float(), dim=1).transpose(1, 2)
    a = b - itilde.float().transpose(1, 2)
    return qf, kf, vf, b, a


def _scores(qc, kp, bc, ap, c0: int):
    """A query chunk's masked decays, row max and products against its key
    prefix: (D, m, E, S) with D, E, S (B,nh,cq,L) and m (B,nh,cq)."""
    cq, lk = qc.shape[2], kp.shape[2]
    d_ = bc[..., :, None] - ap[..., None, :]
    rows = torch.arange(c0, c0 + cq, device=qc.device)
    mask = torch.arange(lk, device=qc.device)[None, :] <= rows[:, None]
    d_ = torch.where(mask, d_, NEG_INF)
    m = d_.amax(dim=-1)
    e = torch.exp(d_ - m[..., None])
    return m, e, qc @ kp.transpose(-1, -2)


def _chunks(s: int, chunk: int):
    if s <= chunk:
        return [(0, s)]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the mLSTM "
                         f"chunk {chunk}")
    return [(c0, c0 + chunk) for c0 in range(0, s, chunk)]


def mlstm_parallel_ref(q, k, v, log_f, itilde, chunk: int = 256):
    """The plain forward: q,k,v (B,S,nh,dh), gates (B,S,nh) -> h
    (B,S,nh,dh) fp32."""
    qf, kf, vf, b, a = _prepare(q, k, v, log_f, itilde)
    outs = []
    for c0, c1 in _chunks(q.shape[1], chunk):
        m, e, sc = _scores(qf[..., c0:c1, :], kf[..., :c1, :],
                           b[..., c0:c1], a[..., :c1], c0)
        p = sc * e
        den = p.sum(dim=-1)
        outs.append((p @ vf[..., :c1, :])
                    / torch.maximum(den.abs(), torch.exp(-m))[..., None])
    return torch.cat(outs, dim=2).transpose(1, 2)


def mlstm_parallel_bwd_ref(dh, q, k, v, log_f, itilde, chunk: int = 256):
    """The plain backward: (dq, dk, dv, dlog_f, ditilde), each in its
    input's dtype."""
    qf, kf, vf, b, a = _prepare(q, k, v, log_f, itilde)
    g = dh.float().transpose(1, 2)
    dq, dk, dv = (torch.zeros_like(t) for t in (qf, kf, vf))
    db, da = torch.zeros_like(b), torch.zeros_like(a)
    for c0, c1 in _chunks(q.shape[1], chunk):
        qc, kp, vp = qf[..., c0:c1, :], kf[..., :c1, :], vf[..., :c1, :]
        m, e, sc = _scores(qc, kp, b[..., c0:c1], a[..., :c1], c0)
        p = sc * e
        den = p.sum(dim=-1)
        num = p @ vp
        floor = torch.exp(-m)
        n = torch.maximum(den.abs(), floor)
        gc = g[..., c0:c1, :]
        gnum = gc / n[..., None]
        gn = -(gc * num).sum(dim=-1) / (n * n)
        # the maximum's gradient splits evenly at a tie, as jnp.maximum's
        w = (den.abs() > floor).to(n.dtype) + 0.5 * (den.abs() == floor).to(
            n.dtype)
        gden = gn * torch.sign(den) * w
        gp = gnum @ vp.transpose(-1, -2) + gden[..., None]
        dv[..., :c1, :] += p.transpose(-1, -2) @ gnum
        gs = gp * e
        gd = gs * sc
        dq[..., c0:c1, :] += gs @ kp
        dk[..., :c1, :] += gs.transpose(-1, -2) @ qc
        db[..., c0:c1] += gd.sum(dim=-1)
        da[..., :c1] -= gd.sum(dim=-2)
    dq = dq * q.shape[-1] ** -0.5
    # a = b - itilde; b = cumsum(log_f): the reverse cumulative sum
    db = db + da
    dlog_f = torch.flip(torch.cumsum(torch.flip(db, [-1]), dim=-1), [-1])
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype),
            dlog_f.transpose(1, 2).to(log_f.dtype),
            (-da).transpose(1, 2).to(itilde.dtype))


@torch.library.custom_op("repro_torch::mlstm_parallel", mutates_args=())
def _mlstm_parallel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    log_f: torch.Tensor, itilde: torch.Tensor,
                    chunk: int) -> torch.Tensor:
    return mlstm_parallel_ref(q, k, v, log_f, itilde, chunk)


@_mlstm_parallel.register_fake
def _(q, k, v, log_f, itilde, chunk):
    _chunks(q.shape[1], chunk)
    return q.new_empty(q.shape, dtype=torch.float32)


@torch.library.custom_op("repro_torch::mlstm_parallel_bwd", mutates_args=())
def _mlstm_parallel_bwd(
        dh: torch.Tensor, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        log_f: torch.Tensor, itilde: torch.Tensor, chunk: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor]:
    return mlstm_parallel_bwd_ref(dh, q, k, v, log_f, itilde, chunk)


@_mlstm_parallel_bwd.register_fake
def _(dh, q, k, v, log_f, itilde, chunk):
    return tuple(torch.empty_like(t) for t in (q, k, v, log_f, itilde))


def _setup(ctx, inputs, output):
    *tensors, chunk = inputs
    ctx.chunk = chunk
    ctx.save_for_backward(*tensors)


def _backward(ctx, dh):
    grads = _mlstm_parallel_bwd(dh.contiguous(), *ctx.saved_tensors,
                                ctx.chunk)
    return (*grads, None)


_mlstm_parallel.register_autograd(_backward, setup_context=_setup)


def mlstm_parallel(q, k, v, log_f, itilde, *, chunk: int = 256):
    """Decay-masked linear attention (the mLSTM parallel form).

    q,k,v: (B,S,nh,dh); log_f,itilde: (B,S,nh).  Returns (B,S,nh,dh) fp32.
    Longer than ``chunk``, S must be a multiple of it: each query chunk
    meets its whole key prefix in one product."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape \
            or log_f.shape != q.shape[:3] or itilde.shape != q.shape[:3]:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} log_f {tuple(log_f.shape)} "
                         f"itilde {tuple(itilde.shape)}")
    _chunks(q.shape[1], chunk)
    return _mlstm_parallel(q, k, v, log_f, itilde, chunk)
