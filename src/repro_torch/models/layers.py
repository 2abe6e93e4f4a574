"""Shared neural layers (port of ``repro.models.layers``): embeddings, the
SwiGLU MLP, LM logits, the chunked LM loss and rotary embeddings.

All layers take ``(params, x, ...)`` plus the
:class:`~repro_torch.parallel.Sharder` for activation layouts, and keep the
reference's weight layouts (``x @ w`` with ``w`` as ``(in, out)``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import ModelConfig, Spec


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------
def embed_spec(cfg: ModelConfig) -> dict:
    return {"tok": Spec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                        init="embed", scale=1.0)}


def head_spec(cfg: ModelConfig) -> dict:
    if cfg.tie_embeddings:
        return {}
    return {"w": Spec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))}


def mlp_spec(cfg: ModelConfig, stacked: int = 0) -> dict:
    """SwiGLU MLP: gate+up projections (gate first) and down projection."""
    d, f = cfg.d_model, cfg.d_ff
    lead = (stacked,) if stacked else ()
    lax_ = ("layers",) if stacked else ()
    return {
        "wi": Spec(lead + (d, 2 * f), lax_ + ("embed", "mlp")),
        "wo": Spec(lead + (f, d), lax_ + ("mlp", "embed")),
    }


def norm_spec(cfg: ModelConfig, stacked: int = 0,
              dim: Optional[int] = None) -> Spec:
    d = dim or cfg.d_model
    if stacked:
        return Spec((stacked, d), ("layers", None), init="ones")
    return Spec((d,), (None,), init="ones")


# ---------------------------------------------------------------------------
# applies
# ---------------------------------------------------------------------------
def embed(params, tokens, cfg: ModelConfig, shd):
    """Token embedding lookup with a vocab-sharded table.  Ids split
    along the sequence (the ``seq -> model`` rule) are gathered over it
    first, as the table's vocab shards need every id; the lookup's
    partial sum over them is then scattered back along the sequence."""
    w = params["tok"].to(getattr(torch, cfg.compute_dtype))
    if shd.seq_sharded(tokens):
        tokens = shd.constraint(tokens, ("batch", None))
    if shd.mesh is not None and hasattr(tokens, "placements"):
        tokens = _gather_ids(shd, tokens, w)
    out = F.embedding(tokens, w)
    return shd.constraint(out, ("batch", "seq", None))


def _gather_ids(shd, tokens, w):
    """The ids, gathered over the mesh dims that shard the table's embed
    dim where DTensor would gather them there.

    On such a dim DTensor either gathers the ids (the table stays split by
    columns) or gathers the table, whichever moves fewer bytes.  When it
    gathers the ids of a vocab-sharded table it masks the vocab shards
    with the ungathered ids (a shape mismatch on a real 2-D mesh; a
    capture never applies the mask), so the port gathers them itself in
    that case: the same collective, issued before the lookup.  The bytes
    compared are DTensor's: each tensor's gathered size, divided over its
    other sharded dims.  A table whose vocab is whole is left to DTensor."""
    from torch.distributed.tensor import Replicate, Shard

    if Shard(0) not in w.placements:
        return tokens
    sizes = shd.mesh.shape
    dims = [i for i, p in enumerate(w.placements) if p == Shard(1)]

    def gathered(t):
        other = math.prod(sizes[i] for i, p in enumerate(t.placements)
                          if isinstance(p, Shard) and i not in dims)
        return t.numel() * t.element_size() / other

    if not dims or gathered(tokens) > gathered(w):
        return tokens
    return tokens.redistribute(shd.mesh, [
        Replicate() if i in dims else p
        for i, p in enumerate(tokens.placements)])


def mlp(params, x, cfg: ModelConfig, shd):
    """SwiGLU MLP; hidden dim sharded over the model axis (TP)."""
    dt = x.dtype
    h = shd.matmul(x, params["wi"].to(dt))
    h = shd.constraint(h, ("batch", "seq", "mlp"))
    gate, up = torch.chunk(h, 2, dim=-1)
    h = F.silu(gate) * up
    out = shd.matmul(h, params["wo"].to(dt))
    return shd.constraint(out, ("batch", "seq", None))


def lm_logits(params_head, params_embed, h, cfg: ModelConfig, shd):
    """Final logits; vocab sharded over the model axis."""
    dt = h.dtype
    if cfg.tie_embeddings:
        w = params_embed["tok"].to(dt).T
    else:
        w = params_head["w"].to(dt)
    return shd.constraint(shd.matmul(h, w), ("batch", "seq", "vocab"))


def chunked_lm_loss(params_head, params_embed, h, labels, cfg: ModelConfig,
                    shd, chunk: int = 512):
    """Cross-entropy without materializing (B,S,V) logits.

    One ``chunk`` of the sequence at a time: logits -> fp32 CE summed, labels
    below 0 ignored; a sequence that ``chunk`` does not divide is one chunk.
    Each chunk runs under ``torch.utils.checkpoint``, so its fp32 logits are
    freed after its forward and recomputed in its backward: at most one
    chunk's logits (B, chunk, V/tp) live at a time, where eager autograd
    would keep every chunk's for the backward (the reference's scan body
    holds the same cap with remat).
    """
    b, s, _ = h.shape
    if s % chunk != 0:
        chunk = s  # degenerate fallback (smoke tests with tiny seq)
    if cfg.tie_embeddings:
        w = params_embed["tok"].T
    else:
        w = params_head["w"]
    w = w.to(h.dtype)
    if shd.seq_sharded(h):
        return _seq_split_lm_loss(h, labels, w, shd, chunk)

    def body(hx, lx, w):
        logits = shd.constraint(hx @ w, ("batch", "seq", "vocab")).float()
        # laid out before the last dim goes: on a vocab-sharded mesh the
        # gather is a masked partial sum, reduced here (the reference's
        # psum over the vocab shards)
        return _nll_sum(logits, lx, lambda g: shd.constraint(
            g, ("batch", "seq", None)))

    nll = cnt = 0
    for c in range(0, s, chunk):
        n, v = checkpoint(body, h[:, c:c + chunk], labels[:, c:c + chunk], w,
                          use_reentrant=False)
        nll, cnt = nll + n, cnt + v
    return nll / torch.clamp_min(cnt, 1)


def _nll_sum(logits, labels, gold_layout=None):
    """(summed fp32 cross-entropy, count) of ``logits`` against
    ``labels``, labels below 0 ignored; ``gold_layout`` lays out the
    gathered gold logits before their last dim goes."""
    valid = labels >= 0
    lab = torch.clamp_min(labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lab[..., None])
    if gold_layout is not None:
        gold = gold_layout(gold)
    return ((logz - gold[..., 0]) * valid).sum(), valid.sum()


def _seq_split_lm_loss(h, labels, w, shd, chunk: int):
    """:func:`chunked_lm_loss` of a sequence split over ``model`` (the
    ``seq -> model`` rule): the head is gathered whole, as the logits'
    vocab has lost ``model`` to the sequence, and each rank runs its own
    rows one ``chunk / n`` at a time (``n`` the sequence shards: the same
    count of chunks as one process, each as many logits a rank as
    ``chunk`` rows over vocab shards).  Each rank's sums leave its step
    on a leading dim of their own and are summed there by DTensor (whose
    backward hands each rank the whole gradient)."""
    from torch.distributed.tensor import Replicate, Shard

    n = h.shape[1] // h.to_local().shape[1]
    out_pl = [Shard(0) if isinstance(p, Shard) else Replicate()
              for p in h.placements]

    def body(hx, lx, w):
        return _nll_sum((hx @ w).float(), lx)

    def local(hx, lx, w):
        s_loc = hx.shape[1]
        step = max(1, chunk // n)
        if s_loc % step:
            step = s_loc
        nll = cnt = 0
        for c in range(0, s_loc, step):
            a, v = checkpoint(body, hx[:, c:c + step], lx[:, c:c + step], w,
                              use_reentrant=False)
            nll, cnt = nll + a, cnt + v
        return nll.reshape(1), cnt.reshape(1)

    nll, cnt = shd.local(local, (h, labels, w),
                         (None, ("batch", "seq"), (None, None)),
                         out_placements=(out_pl, out_pl))
    return nll.sum() / torch.clamp_min(cnt.sum(), 1)


# ---------------------------------------------------------------------------
# rotary embeddings (half-split layout, as the reference)
# ---------------------------------------------------------------------------
def rope_freqs(dh: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                         device=device) / dh))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, dh); positions: (B, S) or (1, S) integer positions."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                     # (dh/2,)
    ang = positions[..., None].to(torch.float32) * freqs         # (B,S,dh/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
