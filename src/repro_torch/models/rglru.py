"""RecurrentGemma / Griffin (port of ``repro.models.rglru``): RG-LRU
recurrent blocks and local-attention blocks.

Layer pattern (arXiv 2402.19427): repeating (recurrent, recurrent,
local-attn) superblocks, stacked, plus a stacked tail of leftover recurrent
layers (26 = 3*8 + 2).

RG-LRU (Real-Gated Linear Recurrent Unit)::

    r_t = sigmoid(W_a x_t + b_a)            recurrence gate
    i_t = sigmoid(W_x x_t + b_x)            input gate
    a_t = exp(-c * softplus(Lambda) * r_t)  diagonal decay, c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Where the port differs from the reference:

* The recurrence runs through the RG-LRU kernel wrapper
  (:func:`repro_torch.kernels.rglru.ops.rglru_scan`), one sequential pass;
  the reference's model computes the same function with a log-depth
  ``jax.lax.associative_scan``, so fp32 results differ in rounding only.
* A carried state enters the kernel as ``h0``; the reference folds it into
  the first step (``x_0 + a_0 * h``), which is the same value.
* The gate products run in fp32 with fp32 copies of ``w_a``/``w_x``, as the
  reference chooses (it casts both weights every call).
* The superblocks and the tail are Python loops over the stacked leaves
  (the reference scans them), and the temporal conv runs on local shards
  (it is depthwise, so no collective).
* ``decode_step`` writes the new recurrent states and k/v into the caller's
  cache tensors in place and advances ``len`` in place (the reference
  returns a new cache); the returned cache is the same dict.
* ``loss_fn`` keeps the reference's checkpointing, whatever ``remat``
  says: every superblock under the ``dots`` policy
  (:func:`~repro_torch.models.transformer.with_remat`), the tail layers
  without checkpointing.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru import ops as rglru_ops

from . import attention, layers
from .common import (ModelConfig, Spec, init_params, layer_of, param_axes,
                     param_shapes, rms_norm)
from .transformer import with_remat

RGLRU_C = 8.0
CACHE_DTYPE = torch.bfloat16      # the reference's prefill hard-codes bf16
STATE_DTYPE = torch.float32       # recurrent h and conv buffer, as init_rec_state
REC_AXES = ("batch", "seq", "rnn")


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------
def rglru_spec(cfg: ModelConfig, stacked: int = 0) -> dict:
    d, dr, cw = cfg.d_model, cfg.d_rnn_, cfg.conv_width
    lead = (stacked,) if stacked else ()
    lx = ("layers",) if stacked else ()
    return {
        # two input branches
        "w_gate": Spec(lead + (d, dr), lx + ("embed", "rnn")),     # gelu branch
        "w_rec_in": Spec(lead + (d, dr), lx + ("embed", "rnn")),   # conv branch
        # temporal depthwise conv
        "conv_w": Spec(lead + (cw, dr), lx + ("conv", "rnn"), scale=0.5),
        "conv_b": Spec(lead + (dr,), lx + ("rnn",), init="zeros"),
        # RG-LRU gates (dense, the reference's simplification of Griffin's
        # block-diagonal gates)
        "w_a": Spec(lead + (dr, dr), lx + ("rnn", None)),
        "b_a": Spec(lead + (dr,), lx + ("rnn",), init="zeros"),
        "w_x": Spec(lead + (dr, dr), lx + ("rnn", None)),
        "b_x": Spec(lead + (dr,), lx + ("rnn",), init="zeros"),
        "lam": Spec(lead + (dr,), lx + ("rnn",), init="rglru_a"),
        # output projection
        "w_out": Spec(lead + (dr, d), lx + ("rnn", "embed")),
    }


def rec_layer_spec(cfg: ModelConfig, stacked: int = 0) -> dict:
    return {
        "norm1": layers.norm_spec(cfg, stacked=stacked),
        "rec": rglru_spec(cfg, stacked=stacked),
        "norm2": layers.norm_spec(cfg, stacked=stacked),
        "mlp": layers.mlp_spec(cfg, stacked=stacked),
    }


def attn_layer_spec(cfg: ModelConfig, stacked: int = 0) -> dict:
    return {
        "norm1": layers.norm_spec(cfg, stacked=stacked),
        "attn": attention.attn_spec(cfg, stacked=stacked),
        "norm2": layers.norm_spec(cfg, stacked=stacked),
        "mlp": layers.mlp_spec(cfg, stacked=stacked),
    }


# ---------------------------------------------------------------------------
# RG-LRU core
# ---------------------------------------------------------------------------
def rglru_apply(p, x, cfg: ModelConfig, shd, state: Optional[dict] = None):
    """x: (B,S,Dr) conv output -> (h (B,S,Dr) fp32, h_last (B,Dr)).
    ``state["h"]`` (B,Dr), when given, is the carried recurrent state."""
    xf = x.float()

    def gate(w, b):
        # the product of rnn-sharded x and row-sharded w is a partial sum
        # over the model axis: laid out by rnn before the bias, explicitly,
        # as DTensor's own choice there differs between torch versions
        return torch.sigmoid(shd.constraint(xf @ w.float(), REC_AXES)
                             + b.float())

    r = gate(p["w_a"], p["b_a"])
    i = gate(p["w_x"], p["b_x"])
    log_a = -RGLRU_C * F.softplus(p["lam"].float()) * r
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a),
                                       1e-12)) * (i * xf)
    gated = shd.constraint(gated, REC_AXES)
    h0 = None if state is None else state["h"]
    h = shd.local(rglru_ops.rglru_scan, (gated, log_a, h0),
                  (REC_AXES, REC_AXES, rec_state_axes()["h"]))
    return h, h[:, -1]


def temporal_conv(p, x, cfg: ModelConfig, shd,
                  prev: Optional[torch.Tensor] = None):
    """Causal depthwise conv of width ``cw`` over x (B,S,Dr), on local
    shards.  ``prev``: the (B, cw-1, Dr) decode buffer (zeros when None).
    Returns ``(out (B,S,Dr), new buffer (B,cw-1,Dr))``."""
    cw = cfg.conv_width

    def conv(x, w, b, prev):
        s = x.shape[1]
        w = w.to(x.dtype)
        pad = (x.new_zeros((x.shape[0], cw - 1, x.shape[2])) if prev is None
               else prev.to(x.dtype))
        xp = torch.cat([pad, x], dim=1)                 # (B, S+cw-1, Dr)
        out = sum(xp[:, j:j + s] * w[j] for j in range(cw))
        return out + b.to(x.dtype), xp[:, s:]

    return shd.local(conv, (x, p["conv_w"], p["conv_b"], prev),
                     (REC_AXES, ("conv", "rnn"), ("rnn",),
                      rec_state_axes()["conv"]), out=(0, 0))


def recurrent_block(p, x, cfg: ModelConfig, shd,
                    state: Optional[dict] = None):
    """Griffin recurrent block.  x: (B,S,D) -> ``(out, new_state)`` with
    ``new_state = {"h": (B,Dr), "conv": (B,cw-1,Dr)}`` in fp32; ``state``
    None is the zero state."""
    dt = x.dtype
    gate = F.gelu(x @ p["w_gate"].to(dt), approximate="tanh")
    rec = shd.constraint(x @ p["w_rec_in"].to(dt), REC_AXES)
    rec, conv_buf = temporal_conv(p, rec, cfg, shd,
                                  None if state is None else state["conv"])
    h, h_last = rglru_apply(p, rec, cfg, shd, state)
    out = (gate.float() * h).to(dt) @ p["w_out"].to(dt)
    return out, {"h": h_last, "conv": conv_buf.to(STATE_DTYPE)}


def rec_state_shapes(cfg: ModelConfig, batch: int) -> dict:
    return {"h": (batch, cfg.d_rnn_),
            "conv": (batch, cfg.conv_width - 1, cfg.d_rnn_)}


def init_rec_state(cfg: ModelConfig, batch: int, device="cuda"):
    return {k: torch.zeros(shape, dtype=STATE_DTYPE, device=device)
            for k, shape in rec_state_shapes(cfg, batch).items()}


def rec_state_axes():
    return {"h": ("batch", "rnn"), "conv": ("batch", None, "rnn")}


def _store(shd, dst, src, axes):
    """``dst.copy_(src)`` on local shards, ``src`` laid out by ``axes``."""
    shd.local(lambda d, s: d.copy_(s), (dst, src), (None, axes))


def _stack(states: list) -> dict:
    if not states:
        return {}
    return {k: torch.stack([st[k] for st in states]) for k in states[0]}


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
class GriffinLM:
    """RecurrentGemma-style hybrid LM: (rec, rec, local-attn) superblocks
    and a tail of recurrent layers."""

    def __init__(self, cfg: ModelConfig):
        if cfg.attn_window <= 0:
            raise ValueError("the hybrid arch needs a local attention window")
        self.cfg = cfg
        self.n_super = cfg.n_layers // 3
        self.n_tail = cfg.n_layers - 3 * self.n_super   # trailing rec layers

    # ------------------------------------------------------------------
    # parameter declaration
    # ------------------------------------------------------------------
    def specs(self):
        cfg, ns, nt = self.cfg, self.n_super, self.n_tail
        out = {
            "embed": layers.embed_spec(cfg),
            "super": {
                "rec1": rec_layer_spec(cfg, stacked=ns),
                "rec2": rec_layer_spec(cfg, stacked=ns),
                "attn": attn_layer_spec(cfg, stacked=ns),
            },
            "final_norm": layers.norm_spec(cfg),
            "head": layers.head_spec(cfg),
        }
        if nt:
            out["tail"] = rec_layer_spec(cfg, stacked=nt)
        return out

    def init(self, seed: int = 0, device="cuda",
             dtype: Optional[torch.dtype] = None):
        """Random parameters from ``seed`` on ``device`` (``dtype``
        overrides the config's parameter dtype, e.g. bf16 at load)."""
        gen = torch.Generator(device=device).manual_seed(seed)
        return init_params(self.specs(), gen, self.cfg.param_dtype,
                           device=device, dtype=dtype)

    def shapes(self, device="cuda", dtype: Optional[torch.dtype] = None):
        """``torch.empty`` parameter stand-ins (allocation-free under
        ``FakeTensorMode``)."""
        return param_shapes(self.specs(), self.cfg.param_dtype,
                            device=device, dtype=dtype)

    def axes(self):
        return param_axes(self.specs())

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def _inputs(self, params, batch, shd):
        tokens = shd.shard(batch["tokens"], ("batch", "seq"))
        return layers.embed(params["embed"], tokens, self.cfg, shd)

    def _rec_layer(self, p, x, shd, state=None):
        cfg = self.cfg
        act = ("batch", "seq", None)
        h = rms_norm(x, p["norm1"], cfg.norm_eps, shd, act)
        out, new_state = recurrent_block(p["rec"], h, cfg, shd, state)
        x = x + out
        h = rms_norm(x, p["norm2"], cfg.norm_eps, shd, act)
        x = x + layers.mlp(p["mlp"], h, cfg, shd)
        return shd.constraint(x, act), new_state

    def _rec_step(self, p, x, shd, state):
        """A recurrent layer of a decode step: reads ``state`` and writes
        the new state into its tensors in place."""
        x, new = self._rec_layer(p, x, shd, state)
        for name, axes in rec_state_axes().items():
            _store(shd, state[name], new[name], axes)
        return x

    def _attn_layer(self, p, x, shd, cache):
        cfg = self.cfg
        act = ("batch", "seq", None)
        h = rms_norm(x, p["norm1"], cfg.norm_eps, shd, act)
        out, new_cache = attention.attention_block(p["attn"], h, cfg, shd,
                                                   cache=cache)
        x = x + out
        h = rms_norm(x, p["norm2"], cfg.norm_eps, shd, act)
        x = x + layers.mlp(p["mlp"], h, cfg, shd)
        return shd.constraint(x, act), new_cache

    def _logits(self, params, x, shd):
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps, shd,
                     ("batch", "seq", None))
        return layers.lm_logits(params.get("head"), params["embed"], x,
                                self.cfg, shd)

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def _super_fwd(self, x, sp, shd):
        x, _ = self._rec_layer(sp["rec1"], x, shd)
        x, _ = self._rec_layer(sp["rec2"], x, shd)
        x, _ = self._attn_layer(sp["attn"], x, shd, None)
        return x

    def _trunk(self, params, x, shd, remat: Optional[str] = None):
        """The superblocks, each under the ``dots`` policy whatever
        ``remat`` says (the reference's choice), then the tail."""
        sup = with_remat(lambda c, sp: self._super_fwd(c, sp, shd), "dots")
        for i in range(self.n_super):
            x = sup(x, layer_of(params["super"], i))
        for i in range(self.n_tail):
            x, _ = self._rec_layer(layer_of(params["tail"], i), x, shd)
        return x

    def loss_fn(self, params, batch, shd, remat: Optional[str] = None):
        """``(loss, {"xent", "aux"})`` of ``batch`` (``tokens``,
        ``labels``) through the chunked LM loss."""
        cfg = self.cfg
        x = self._inputs(params, batch, shd)
        x = self._trunk(params, x, shd, remat)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps, shd,
                     ("batch", "seq", None))
        labels = shd.shard(batch["labels"], ("batch", "seq"))
        loss = layers.chunked_lm_loss(params.get("head"), params["embed"], x,
                                      labels, cfg, shd)
        return loss, {"xent": loss, "aux": torch.zeros(
            (), dtype=torch.float32, device=loss.device)}

    # ------------------------------------------------------------------
    # serving: stacked per-group states
    # ------------------------------------------------------------------
    def _cache(self, batch, max_len, device, dtype, make):
        cfg, ns, nt = self.cfg, self.n_super, self.n_tail
        lmax = min(max_len, cfg.attn_window)                # ring buffer
        kv = (ns, batch, lmax, cfg.n_kv_heads, cfg.dh)

        def rec(n):
            return {k: make((n,) + shape, dtype=STATE_DTYPE, device=device)
                    for k, shape in rec_state_shapes(cfg, batch).items()}

        return {
            "rec1": rec(ns), "rec2": rec(ns),
            "attn": {"k": make(kv, dtype=dtype, device=device),
                     "v": make(kv, dtype=dtype, device=device)},
            "tail": rec(nt) if nt else {},
            "len": make((), dtype=torch.int32, device=device),
        }

    def init_cache(self, batch: int, max_len: int, device="cuda",
                   dtype: torch.dtype = CACHE_DTYPE):
        return self._cache(batch, max_len, device, dtype, torch.zeros)

    def cache_shapes(self, batch: int, max_len: int, device="cuda",
                     dtype: torch.dtype = CACHE_DTYPE):
        """``torch.empty`` cache stand-ins (allocation-free under
        ``FakeTensorMode``)."""
        return self._cache(batch, max_len, device, dtype, torch.empty)

    def cache_axes(self):
        """The cache's layout, the reference's: recurrent states by
        :func:`rec_state_axes`, the ring kv by
        :func:`~repro_torch.models.attention.kv_cache_axes` (its sequence
        over model: RecurrentGemma-2B's 2048-slot ring is 128 slots a rank
        on model 16, each rank decoding its slots and the ranks merging by
        log-sum-exp)."""
        ra = {k: ("stack",) + ax for k, ax in rec_state_axes().items()}
        kv = attention.kv_cache_axes()
        return {
            "rec1": ra, "rec2": ra,
            "attn": {"k": ("stack",) + kv["k"], "v": ("stack",) + kv["v"]},
            "tail": ra if self.n_tail else {},
            "len": (),
        }

    def decode_step(self, params, cache, batch, shd):
        """batch ``{"tokens": (B,1)}`` -> ``(logits (B,1,V), cache)``, the
        cache updated in place."""
        x = self._inputs(params, batch, shd)
        for i in range(self.n_super):
            sp = layer_of(params["super"], i)
            x = self._rec_step(sp["rec1"], x, shd, layer_of(cache["rec1"], i))
            x = self._rec_step(sp["rec2"], x, shd, layer_of(cache["rec2"], i))
            kv = {"k": cache["attn"]["k"][i], "v": cache["attn"]["v"][i],
                  "len": cache["len"]}
            x, _ = self._attn_layer(sp["attn"], x, shd, kv)
        for i in range(self.n_tail):
            x = self._rec_step(layer_of(params["tail"], i), x, shd,
                               layer_of(cache["tail"], i))
        cache["len"].add_(x.shape[1])
        return self._logits(params, x, shd), cache

    def prefill(self, params, batch, shd, max_len: Optional[int] = None):
        """Sequence prefill -> ``(last-token logits (B,V), cache)`` holding
        the recurrent states and the ring kv (``CACHE_DTYPE``)."""
        x = self._inputs(params, batch, shd)
        s = x.shape[1]
        spec = {"max_len": min(max_len or s, self.cfg.attn_window),
                "dtype": CACHE_DTYPE}
        rec1, rec2, ks, vs, tail = [], [], [], [], []
        for i in range(self.n_super):
            sp = layer_of(params["super"], i)
            x, s1 = self._rec_layer(sp["rec1"], x, shd)
            x, s2 = self._rec_layer(sp["rec2"], x, shd)
            x, kv = self._attn_layer(sp["attn"], x, shd, spec)
            rec1.append(s1)
            rec2.append(s2)
            ks.append(kv["k"])
            vs.append(kv["v"])
        for i in range(self.n_tail):
            x, st = self._rec_layer(layer_of(params["tail"], i), x, shd)
            tail.append(st)
        cache = {"rec1": _stack(rec1), "rec2": _stack(rec2),
                 "attn": {"k": torch.stack(ks), "v": torch.stack(vs)},
                 "tail": _stack(tail),
                 "len": torch.full((), s, dtype=torch.int32,
                                   device=batch["tokens"].device)}
        # the kernels take contiguous rows
        logits = self._logits(params, x[:, -1:].contiguous(), shd)
        return logits[:, 0], cache
