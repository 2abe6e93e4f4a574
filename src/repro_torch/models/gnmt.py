"""GNMT-style seq2seq (port of ``repro.models.gnmt``) -- the paper's
machine-translation application (§4.1, Table 2, Figs. 2-3).

A stacked LSTM encoder, a decoder with Luong attention, one training
objective.  The cells are plain tensor ops in a time loop, not
``nn.LSTM``: the gates split as ``i, f, g, o`` along the last dim with a
forget bias of +1 (cuDNN's layout and bias differ), and the decoder feeds
the attention context into its first layer's input.  Attention is scored
with the previous top hidden state before decoder layer 0, and again with
the new top state for the output.
"""
from __future__ import annotations

from typing import Optional

import torch

from .common import Spec, init_params, param_axes, param_shapes


def _lstm_spec(d_in, d_h):
    return {"wx": Spec((d_in, 4 * d_h), (None, "mlp")),
            "wh": Spec((d_h, 4 * d_h), (None, "mlp")),
            "b": Spec((4 * d_h,), ("mlp",), init="zeros")}


def gnmt_specs(vocab: int = 32000, d: int = 512, layers: int = 2):
    return {
        "embed_src": Spec((vocab, d), ("vocab", "embed"), init="embed"),
        "embed_tgt": Spec((vocab, d), ("vocab", "embed"), init="embed"),
        "enc": [_lstm_spec(d, d) for _ in range(layers)],
        "dec": [_lstm_spec(d if i else 2 * d, d) for i in range(layers)],
        "attn_w": Spec((d, d), (None, "mlp")),
        "out": Spec((2 * d, vocab), (None, "vocab")),
    }


def _cell(z, c):
    """One LSTM update from the gate pre-activations ``z``."""
    i, f, g, o = torch.chunk(z, 4, dim=-1)
    c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def _lstm_layer(p, xs, h, c):
    """xs: (B, S, Din) -> hs (B, S, Dh).  The input projection of every
    step is one matmul ahead of the loop."""
    zx = xs @ p["wx"] + p["b"]
    hs = []
    for t in range(xs.shape[1]):
        h, c = _cell(zx[:, t] + h @ p["wh"], c)
        hs.append(h)
    return torch.stack(hs, dim=1)


def _attend(h, keys, enc):
    score = torch.einsum("bd,bsd->bs", h, keys)
    return torch.einsum("bs,bsd->bd", torch.softmax(score, dim=-1), enc)


def gnmt_loss(params, batch):
    """batch: {"src": (B,S), "tgt": (B,T), "labels": (B,T)}."""
    src, tgt, labels = batch["src"], batch["tgt"], batch["labels"]
    b = src.shape[0]
    d = params["embed_src"].shape[1]

    enc = params["embed_src"][src.long()]
    h0 = enc.new_zeros((b, d))
    for lp in params["enc"]:
        enc = _lstm_layer(lp, enc, h0, h0)

    y = params["embed_tgt"][tgt.long()]
    keys = enc @ params["attn_w"]
    states = [(h0, h0) for _ in params["dec"]]
    outs = []
    for t in range(y.shape[1]):
        inp = y[:, t]
        new_states = []
        for li, lp in enumerate(params["dec"]):
            h, c = states[li]
            if li == 0:
                # attention context from the previous top hidden state
                inp = torch.cat([inp, _attend(states[-1][0], keys, enc)], -1)
            h, c = _cell(inp @ lp["wx"] + h @ lp["wh"] + lp["b"], c)
            new_states.append((h, c))
            inp = h
        states = new_states
        top = states[-1][0]
        outs.append(torch.cat([top, _attend(top, keys, enc)], -1))
    logits = (torch.stack(outs, dim=1) @ params["out"]).float()  # (B,T,V)
    valid = labels >= 0
    lab = labels.clamp(min=0).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, lab[..., None])[..., 0]
    loss = (nll * valid).sum() / valid.sum().clamp(min=1)
    return loss, {"xent": loss}


class GNMT:
    def __init__(self, vocab: int = 32000, d: int = 512, layers: int = 2):
        self.vocab, self.d, self.layers = vocab, d, layers

    def specs(self):
        return gnmt_specs(self.vocab, self.d, self.layers)

    def init(self, seed: int = 0, device="cuda",
             dtype: Optional[torch.dtype] = None):
        gen = torch.Generator(device=device).manual_seed(seed)
        return init_params(self.specs(), gen, device=device, dtype=dtype)

    def shapes(self, device="cuda", dtype: Optional[torch.dtype] = None):
        return param_shapes(self.specs(), device=device, dtype=dtype)

    def axes(self):
        return param_axes(self.specs())

    def loss_fn(self, params, batch):
        return gnmt_loss(params, batch)
