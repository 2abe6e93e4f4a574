"""Plain AdamW (Loshchilov and Hutter, decoupled weight decay) with
global-norm clipping and a linear warm-up then cosine decay, over a dict
of float32 tensors.

The hyperparameters come from the configuration file's ``train`` section;
nothing of the program is read.  Per leaf and step ``t`` (from 1), with
``g`` the clipped gradient: ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 -
b2) g^2``, ``w -= lr * ((m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps) +
wd * w)``; the clip scales every gradient by ``min(1, clip / |g|)``.
"""
from __future__ import annotations

import math

import torch


def lr_at(h: dict, step: int) -> float:
    """Learning rate of the 0-based ``step``."""
    warm = min((step + 1) / max(1, h["warmup_steps"]), 1.0)
    prog = min(max((step - h["warmup_steps"])
                   / max(1, h["decay_steps"] - h["warmup_steps"]), 0.0), 1.0)
    cos = 0.5 * (1 + math.cos(math.pi * prog))
    return h["peak_lr"] * warm * (h["min_lr_ratio"]
                                  + (1 - h["min_lr_ratio"]) * cos)


def clip_factor(h: dict, grads: dict) -> float:
    """``min(1, clip / |g|)``, ``|g|`` the gradients' global norm."""
    norm = math.sqrt(sum(float(g.norm()) ** 2 for g in grads.values()))
    return min(1.0, h["grad_clip"] / max(norm, 1e-9))


@torch.no_grad()
def step(params: dict, grads: dict, state: dict, h: dict, t: int,
         clip: float) -> None:
    """One update in place; ``t`` is the 0-based step."""
    lr = lr_at(h, t)
    bc1 = 1 - h["b1"] ** (t + 1)
    bc2 = 1 - h["b2"] ** (t + 1)
    for name, w in params.items():
        g = grads[name] * clip
        s = state.setdefault(name, {"m": torch.zeros_like(w),
                                    "v": torch.zeros_like(w)})
        s["m"].mul_(h["b1"]).add_(g, alpha=1 - h["b1"])
        s["v"].mul_(h["b2"]).addcmul_(g, g, value=1 - h["b2"])
        del g
        upd = (s["m"] / bc1).div_((s["v"] / bc2).sqrt_().add_(h["eps"]))
        w.sub_(upd.add_(w, alpha=h["weight_decay"]).mul_(lr))
