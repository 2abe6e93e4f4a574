"""Decoder-only transformer LM (port of the dense half of
``repro.models.transformer``): the dense, ``vlm`` and ``audio`` configs.
A config with ``input_mode == "embeddings"`` reads ``batch["embeds"]``
(the stubbed modality front end's output) in place of token ids.

Parameters keep the reference's stacked ``(L, ...)`` layout; the
reference's ``scan`` over layers is a Python loop that indexes layer ``l``
of each stacked tensor.  Its remat policies (``jax.checkpoint`` per layer)
are ``torch.utils.checkpoint`` per layer: ``full`` saves nothing,
``dots`` saves the outputs of the weight matmuls (``aten.mm``/``addmm``,
the dots without batch dims that the reference's policy keeps) and
recomputes everything else, the kernel ops included.  MoE waits for a
later port slice.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from . import attention, layers
from .common import (ModelConfig, init_params, layer_of, param_axes,
                     param_shapes, rms_norm)

CACHE_DTYPE = torch.bfloat16   # the reference's prefill hard-codes bf16
REMAT_POLICIES = ("none", "full", "dots")
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def with_remat(fn: Callable, policy: str) -> Callable:
    """``fn`` under the named remat policy: ``none`` as it is, ``full``
    checkpointed with nothing saved, ``dots`` with the weight matmuls'
    outputs saved."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}; want one of "
                         f"{REMAT_POLICIES}")
    if policy == "none":
        return fn
    kw = {} if policy == "full" else {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, _dots_policy)}
    return lambda *args: checkpoint(fn, *args, use_reentrant=False, **kw)


class TransformerLM:
    """Dense decoder-only LM over a nested dict of parameters."""

    def __init__(self, cfg: ModelConfig):
        if cfg.n_experts:
            raise NotImplementedError(
                "MoE models wait for a later port slice")
        self.cfg = cfg

    # ------------------------------------------------------------------
    # parameter declaration
    # ------------------------------------------------------------------
    def specs(self):
        cfg = self.cfg
        L = cfg.n_layers
        return {
            "embed": layers.embed_spec(cfg),
            "layers": {
                "norm1": layers.norm_spec(cfg, stacked=L),
                "attn": attention.attn_spec(cfg, stacked=L),
                "norm2": layers.norm_spec(cfg, stacked=L),
                "mlp": layers.mlp_spec(cfg, stacked=L),
            },
            "final_norm": layers.norm_spec(cfg),
            "head": layers.head_spec(cfg),
        }

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
        cfg = self.cfg
        if cfg.input_mode == "embeddings":
            # the kernels take contiguous rows; a step's embeddings may be
            # a view into a longer sequence
            x = batch["embeds"].to(getattr(torch, cfg.compute_dtype))
            return shd.shard(x.contiguous(), ("batch", "seq", None))
        tokens = shd.shard(batch["tokens"], ("batch", "seq"))
        return layers.embed(params["embed"], tokens, self.cfg, shd)

    def _layer_fn(self, x, lp, shd, cache=None):
        cfg = self.cfg
        act = ("batch", "seq", None)
        h = rms_norm(x, lp["norm1"], cfg.norm_eps, shd, act)
        attn_out, new_cache = attention.attention_block(
            lp["attn"], h, cfg, shd, cache=cache)
        x = x + attn_out
        h = rms_norm(x, lp["norm2"], cfg.norm_eps, shd, act)
        x = x + layers.mlp(lp["mlp"], h, cfg, shd)
        return shd.constraint(x, act), new_cache

    def loss_fn(self, params, batch, shd, remat: Optional[str] = None):
        """``(loss, {"xent", "aux"})`` of ``batch`` (``tokens``,
        ``labels``): each layer under the ``remat`` policy (None is
        ``dots``, as in the reference), then the chunked LM loss."""
        cfg = self.cfg
        x = self._inputs(params, batch, shd)
        layer = with_remat(lambda x, lp: self._layer_fn(x, lp, shd)[0],
                           remat or "dots")
        for l in range(cfg.n_layers):
            x = layer(x, layer_of(params["layers"], l))
        x = rms_norm(x, params["final_norm"], cfg.norm_eps, shd,
                     ("batch", "seq", None))
        labels = shd.shard(batch["labels"], ("batch", "seq"))
        loss = layers.chunked_lm_loss(params.get("head"), params["embed"], x,
                                      labels, cfg, shd)
        return loss, {"xent": loss, "aux": torch.zeros(
            (), dtype=torch.float32, device=loss.device)}

    def _logits(self, params, x, shd):
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps, shd,
                     ("batch", "seq", None))
        return layers.lm_logits(params.get("head"), params["embed"], x,
                                self.cfg, shd)

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, device="cuda",
                   dtype: torch.dtype = CACHE_DTYPE):
        cfg = self.cfg
        win = cfg.attn_window
        lmax = min(max_len, win) if win > 0 else max_len
        shape = (cfg.n_layers, batch, lmax, cfg.n_kv_heads, cfg.dh)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device),
                "len": torch.zeros((), dtype=torch.int32, device=device)}

    def cache_shapes(self, batch: int, max_len: int, device="cuda",
                     dtype: torch.dtype = CACHE_DTYPE):
        """``torch.empty`` cache stand-ins (allocation-free under
        ``FakeTensorMode``)."""
        cfg = self.cfg
        win = cfg.attn_window
        lmax = min(max_len, win) if win > 0 else max_len
        shape = (cfg.n_layers, batch, lmax, cfg.n_kv_heads, cfg.dh)
        return {"k": torch.empty(shape, dtype=dtype, device=device),
                "v": torch.empty(shape, dtype=dtype, device=device),
                "len": torch.empty((), dtype=torch.int32, device=device)}

    def cache_axes(self):
        """The stacked cache's layout, the reference's: layers unsharded,
        then :func:`~repro_torch.models.attention.kv_cache_axes` (batch
        over data, the sequence over model: a decode_32k cache of 32768
        slots is 2048 a rank on model 16)."""
        per_layer = attention.kv_cache_axes()
        return {"k": ("layers",) + per_layer["k"],
                "v": ("layers",) + per_layer["v"], "len": ()}

    def decode_step(self, params, cache, batch, shd):
        """batch ``{"tokens": (B,1)}`` (or ``{"embeds": (B,1,D)}``) ->
        ``(logits (B,1,V), cache)``.

        Writes the new token's k/v into ``cache["k"]``/``cache["v"]`` in
        place and advances ``cache["len"]`` in place (the reference returns
        a new cache); the returned cache is the same dict.
        """
        x = self._inputs(params, batch, shd)
        for l in range(self.cfg.n_layers):
            layer_cache = {"k": cache["k"][l], "v": cache["v"][l],
                           "len": cache["len"]}
            x, _ = self._layer_fn(x, layer_of(params["layers"], l), shd,
                                  cache=layer_cache)
        cache["len"].add_(x.shape[1])
        return self._logits(params, x, shd), cache

    def prefill(self, params, batch, shd, max_len: Optional[int] = None):
        """Full-sequence prefill -> ``(last-token logits (B,V), cache)``;
        the cache is ``CACHE_DTYPE`` whatever the compute dtype, as in the
        reference."""
        x = self._inputs(params, batch, shd)
        s = x.shape[1]
        max_len = max_len or s
        if self.cfg.attn_window > 0:
            max_len = min(max_len, self.cfg.attn_window)
        spec = {"max_len": max_len, "dtype": CACHE_DTYPE}
        ks, vs = [], []
        for l in range(self.cfg.n_layers):
            x, new_cache = self._layer_fn(
                x, layer_of(params["layers"], l), shd, cache=spec)
            ks.append(new_cache["k"])
            vs.append(new_cache["v"])
        cache = {"k": torch.stack(ks), "v": torch.stack(vs),
                 "len": torch.full((), s, dtype=torch.int32,
                                   device=x.device)}
        # the kernels take contiguous rows
        logits = self._logits(params, x[:, -1:].contiguous(), shd)
        return logits[:, 0], cache
