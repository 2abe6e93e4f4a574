"""Serving layer (port of ``repro.serve.serve``): batched prefill + decode.

PyTorch runs eagerly, so the "step makers" return plain closures over the
model and Sharder (the reference returns ``jax.jit``-ed steps with cache
shardings).  Decode updates the cache in place.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Optional

import torch

from repro_torch import spans
from repro_torch.parallel import Sharder

_calls = itertools.count()      # the ``call`` identifier of generate's spans


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int = 2048
    batch: int = 8
    cache_dtype: str = "bfloat16"
    temperature: float = 0.0             # 0 -> greedy


def make_prefill_step(model, shd: Sharder, serve_cfg: ServeConfig):
    """``prefill(params, batch) -> (last-token logits, cache)``."""
    def step(params, batch):
        return model.prefill(params, batch, shd, max_len=serve_cfg.max_len)
    return step


def make_decode_step(model, shd: Sharder, serve_cfg: ServeConfig):
    """``decode(params, cache, batch) -> (logits, cache)``; the cache is
    updated in place."""
    def step(params, cache, batch):
        return model.decode_step(params, cache, batch, shd)
    return step


def sample(logits: torch.Tensor, temperature: float = 0.0,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Greedy argmax, or a categorical draw at ``temperature`` from
    ``generator`` (fp32 logits of shape (B, V) -> (B,) token ids)."""
    with spans.span("serve.sample"):
        logits = logits.float()
        if temperature > 0:
            probs = torch.softmax(logits / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=generator)[:, 0]
        return torch.argmax(logits, dim=-1)


@torch.inference_mode()
def generate(model, params, prompts: torch.Tensor, shd: Sharder, *,
             steps: int = 16, max_len: int = 256, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             clock: Optional[Callable[[], None]] = None) -> torch.Tensor:
    """Greedy/temperature batched generation: one prefill, then
    ``steps - 1`` decode steps; returns the ``(B, steps)`` new token ids.
    ``clock`` (the caller's timer) is called after the prefill and
    after the last step."""
    with spans.span("serve.generate", call=next(_calls)):
        scfg = ServeConfig(max_len=max_len, batch=prompts.shape[0],
                           temperature=temperature)
        prefill = make_prefill_step(model, shd, scfg)
        decode = make_decode_step(model, shd, scfg)
        with spans.span("serve.prefill"):
            logits, cache = prefill(params, {"tokens": prompts})
            tok = sample(logits, temperature, generator)
        toks = [tok]
        if clock is not None:
            clock()
        for t in range(steps - 1):
            with spans.span("serve.decode_step", step=t):
                logits, cache = decode(params, cache, {"tokens": tok[:, None]})
                tok = sample(logits[:, -1], temperature, generator)
            toks.append(tok)
        out = torch.stack(toks, dim=1)
        if clock is not None:
            clock()
        return out
