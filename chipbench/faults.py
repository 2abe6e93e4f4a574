"""Faults planted underneath the timed path, to show that the correctness
check catches them (``chipbench/tests`` at a small size on the CPU;
``chipbench/readings.py --faults`` at a cell's own size on the card).

* ``stale_state``: a train step that returns its state unchanged (the
  optimizer's update skipped);
* ``half_batch``: a train step whose loss leaves out half of each
  microbatch's rows, the mean taken over the rest;
* ``stale_cache``: a decode step that leaves its cache's length where it
  was;
* ``half_batch_serve``: a prefill that computes the first half of the
  prompts and hands their logits and cache to the other half too;
* ``altered_token``: the first request's token altered where it is
  sampled.

The exchange between chips has no fault here: every cell runs on one.
"""
from __future__ import annotations

import contextlib
from unittest import mock

import torch

TRAIN = ("stale_state", "half_batch")
SERVE = ("stale_cache", "half_batch_serve", "altered_token")


@contextlib.contextmanager
def planted(name: str):
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.serve import serve as serve_mod
    from repro_torch.train import train as train_mod

    if name == "stale_state":
        from repro_torch.optim.optimizers import global_norm, lr_at_step

        def skip(params, grads, state, cfg, step):
            return params, state, {"lr": lr_at_step(cfg, step),
                                   "grad_norm": global_norm(grads)}
        patch = mock.patch.object(train_mod, "apply_updates", skip)
    elif name == "half_batch":
        orig = TransformerLM.loss_fn

        def half(self, params, batch, shd, remat=None):
            n = batch["tokens"].shape[0] // 2
            return orig(self, params, {k: v[:n] for k, v in batch.items()},
                        shd, remat)
        patch = mock.patch.object(TransformerLM, "loss_fn", half)
    elif name == "stale_cache":
        orig = TransformerLM.decode_step

        def stale(self, params, cache, batch, shd):
            logits, cache = orig(self, params, cache, batch, shd)
            cache["len"].sub_(batch["tokens"].shape[1])
            return logits, cache
        patch = mock.patch.object(TransformerLM, "decode_step", stale)
    elif name == "half_batch_serve":
        orig = TransformerLM.prefill

        def half(self, params, batch, shd, max_len=None):
            n = batch["tokens"].shape[0] // 2
            logits, cache = orig(self, params, {"tokens": batch["tokens"][:n]},
                                 shd, max_len)
            twice = {k: (torch.cat([v, v], dim=1) if v.dim() else v)
                     for k, v in cache.items()}
            return torch.cat([logits, logits]), twice
        patch = mock.patch.object(TransformerLM, "prefill", half)
    elif name == "altered_token":
        orig = serve_mod.sample

        def altered(logits, temperature=0.0, generator=None):
            tok = orig(logits, temperature, generator).clone()
            tok[0] = (tok[0] + 1) % logits.shape[-1]
            return tok
        patch = mock.patch.object(serve_mod, "sample", altered)
    else:
        raise KeyError(f"no fault {name!r}; have {TRAIN + SERVE}")
    with patch:
        yield
