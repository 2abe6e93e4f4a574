"""Shared neural layers (port of ``repro.models.layers``): embeddings, the
SwiGLU MLP, LM logits, the chunked LM loss and rotary embeddings.

All layers take ``(params, x, ...)`` plus the
:class:`~repro_torch.parallel.Sharder` for activation layouts, and keep the
reference's weight layouts (``x @ w`` with ``w`` as ``(in, out)``).
"""
from __future__ import annotations

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
    """Token embedding lookup with a vocab-sharded table."""
    w = params["tok"].to(getattr(torch, cfg.compute_dtype))
    out = F.embedding(tokens, w)
    return shd.constraint(out, ("batch", "seq", None))


def mlp(params, x, cfg: ModelConfig, shd):
    """SwiGLU MLP; hidden dim sharded over the model axis (TP)."""
    dt = x.dtype
    h = x @ params["wi"].to(dt)
    h = shd.constraint(h, ("batch", "seq", "mlp"))
    gate, up = torch.chunk(h, 2, dim=-1)
    h = F.silu(gate) * up
    out = h @ params["wo"].to(dt)
    return shd.constraint(out, ("batch", "seq", None))


def lm_logits(params_head, params_embed, h, cfg: ModelConfig, shd):
    """Final logits; vocab sharded over the model axis."""
    dt = h.dtype
    if cfg.tie_embeddings:
        w = params_embed["tok"].to(dt).T
    else:
        w = params_head["w"].to(dt)
    return shd.constraint(h @ w, ("batch", "seq", "vocab"))


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

    def body(hx, lx, w):
        logits = shd.constraint(hx @ w, ("batch", "seq", "vocab")).float()
        valid = lx >= 0
        lab = torch.clamp_min(lx, 0).long()
        logz = torch.logsumexp(logits, dim=-1)
        # laid out before the last dim goes: on a vocab-sharded mesh the
        # gather is a masked partial sum, reduced here (the reference's
        # psum over the vocab shards)
        gold = shd.constraint(torch.gather(logits, -1, lab[..., None]),
                              ("batch", "seq", None))[..., 0]
        return ((logz - gold) * valid).sum(), valid.sum()

    nll = cnt = 0
    for c in range(0, s, chunk):
        n, v = checkpoint(body, h[:, c:c + chunk], labels[:, c:c + chunk], w,
                          use_reentrant=False)
        nll, cnt = nll + n, cnt + v
    return nll / torch.clamp_min(cnt, 1)


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
