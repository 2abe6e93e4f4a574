"""Optimizers (port of ``repro.optim.optimizers``): AdamW and Adafactor on
nested dicts of tensors, dtype-configurable states.

* moment dtype is configurable (``state_dtype``): bf16 moments (AdamW) or
  factored second moments (Adafactor) for the largest models;
* optimizer state inherits the parameter's logical sharding axes
  (:func:`opt_state_axes`), so ZeRO-3 falls out of the same rules table;
* global-norm gradient clipping, decoupled weight decay
  ``w - lr * (upd + wd * w)``, linear warm-up then cosine decay.

Where the port differs from the reference: :func:`apply_updates` updates
the parameters and the state *in place* and returns the same trees (the
reference returns new ones).  Its fp32 operations are the reference's, in
its order; only where each result is stored differs, so that one leaf's
update needs at most two fp32 temporaries of that leaf (the largest leaf of
RecurrentGemma-2B holds 655 M elements, and functional copies of every
leaf would not fit beside its state on one card).  ``torch.optim.AdamW``
is not used: it decays before the update (``w *= 1 - lr * wd``), rounds
differently, and has no Adafactor, no clipping and no fp32 master.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.common import tree_leaves, tree_unflatten


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"                  # adamw | adafactor
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"         # bf16 moments for XXL models
    # adafactor
    factored_min_dim: int = 128          # factor 2nd moment if both dims >=


def _f32(step, like=None) -> torch.Tensor:
    """``step`` as an fp32 tensor (a tensor keeps its device and layout)."""
    if torch.is_tensor(step):
        return step.to(torch.float32)
    device = like.device if like is not None else None
    return torch.tensor(float(step), dtype=torch.float32, device=device)


def lr_at_step(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warm-up to ``peak_lr``, then cosine decay to
    ``min_lr_ratio * peak_lr`` at ``decay_steps``; an fp32 scalar tensor."""
    step = _f32(step)
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.decay_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    scale = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.peak_lr * warm * scale


def _is_factored(cfg: OptConfig, shape) -> bool:
    return (cfg.name == "adafactor" and len(shape) >= 2
            and shape[-1] >= cfg.factored_min_dim
            and shape[-2] >= cfg.factored_min_dim)


# ---------------------------------------------------------------------------
# state init
# ---------------------------------------------------------------------------
def _zeros(p, shape, dtype):
    """Zeros of ``shape`` on ``p``'s device (laid out as ``p`` when the
    shapes agree)."""
    if tuple(shape) == tuple(p.shape):
        return torch.zeros_like(p, dtype=dtype)
    return torch.zeros(shape, dtype=dtype, device=p.device)


def init_opt_state(params, cfg: OptConfig):
    """Per leaf: AdamW ``m``/``v`` in ``state_dtype``; Adafactor ``m`` and
    either factored fp32 ``vr``/``vc`` or an fp32 ``v``; and an fp32 master
    copy ``w32`` of a bf16 parameter."""
    sdt = getattr(torch, cfg.state_dtype)

    def leaf(p):
        if cfg.name == "adamw":
            out = {"m": _zeros(p, p.shape, sdt), "v": _zeros(p, p.shape, sdt)}
        elif _is_factored(cfg, p.shape):
            out = {"m": _zeros(p, p.shape, sdt),
                   "vr": _zeros(p, p.shape[:-1], torch.float32),
                   "vc": _zeros(p, p.shape[:-2] + p.shape[-1:],
                                torch.float32)}
        else:
            out = {"m": _zeros(p, p.shape, sdt),
                   "v": _zeros(p, p.shape, torch.float32)}
        if p.dtype == torch.bfloat16:
            # bf16 model params with an fp32 master here (Megatron-style)
            out["w32"] = p.detach().to(torch.float32)
        return out

    return tree_unflatten(params, [leaf(p) for p in tree_leaves(params)])


def opt_state_axes(params_axes_tree, param_shapes_tree, cfg: OptConfig):
    """Logical axes tree matching :func:`init_opt_state`'s structure."""
    out = []
    for shp, ax in zip(tree_leaves(param_shapes_tree),
                       tree_leaves(params_axes_tree)):
        if cfg.name == "adamw" or not _is_factored(cfg, shp.shape):
            entry = {"m": ax, "v": ax}
        else:
            entry = {"m": ax, "vr": ax[:-1], "vc": ax[:-2] + ax[-1:]}
        if shp.dtype == torch.bfloat16:
            entry["w32"] = ax
        out.append(entry)
    return tree_unflatten(param_shapes_tree, out)


# ---------------------------------------------------------------------------
# update
# ---------------------------------------------------------------------------
def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in tree order) of each leaf's sum of
    squares in fp32."""
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


def leaves_up_to(tree, like) -> list:
    """The nodes of ``tree`` where ``like`` (same dict/list structure above
    them) has its leaves, in :func:`tree_leaves` order: each parameter's
    state dict of an optimizer state tree."""
    if isinstance(like, dict):
        return [n for k in sorted(like) for n in leaves_up_to(tree[k], like[k])]
    if isinstance(like, list):
        return [n for t, l in zip(tree, like) for n in leaves_up_to(t, l)]
    return [tree]


def _to_f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when fp32 (updated in place), else an fp32 copy."""
    return t if t.dtype == torch.float32 else t.float()


def _update_leaf(p, g, s, cfg: OptConfig, lr, clip, bc1, bc2):
    """One leaf of :func:`apply_updates`, in place, in the reference's
    order of fp32 operations (each step's formula on its right)."""
    gs = g.float() * clip                           # g = g * clip
    m = _to_f32(s["m"])
    m.mul_(cfg.b1)
    t = gs * (1 - cfg.b1)
    m.add_(t)                                       # m = b1*m + (1-b1)*g
    del t
    if "v" in s:
        v = _to_f32(s["v"])
        v.mul_(cfg.b2)
        t = gs * (1 - cfg.b2)
        t.mul_(gs)
        del gs
        v.add_(t)                                   # v = b2*v + (1-b2)*g*g
        del t
        if v is not s["v"]:
            s["v"].copy_(v)
        den = v / bc2
        del v
        den.sqrt_().add_(cfg.eps)                   # sqrt(v/bc2) + eps
    else:                                           # factored second moment
        g2 = gs * gs + 1e-30
        del gs
        s["vr"].mul_(cfg.b2).add_((1 - cfg.b2) * g2.mean(dim=-1))
        s["vc"].mul_(cfg.b2).add_((1 - cfg.b2) * g2.mean(dim=-2))
        del g2
        vhat_r = s["vr"] / bc2
        vhat_c = s["vc"] / bc2
        den = (vhat_r[..., None] * vhat_c[..., None, :]
               / torch.clamp_min(vhat_r.mean(-1)[..., None, None], 1e-30))
        den.sqrt_().add_(cfg.eps)
    upd = m / bc1
    upd.div_(den)                                   # (m/bc1) / den
    del den
    if m is not s["m"]:
        s["m"].copy_(m)                             # m.astype(state_dtype)
    del m
    master = s.get("w32")
    w = master if master is not None else _to_f32(p)
    upd.add_(cfg.weight_decay * w)                  # upd + wd*w
    upd.mul_(lr)
    w.sub_(upd)                                     # w - lr*(upd + wd*w)
    if w is not p:
        p.copy_(w)                                  # new_w.astype(p.dtype)


@torch.no_grad()
def apply_updates(params, grads, state, cfg: OptConfig, step):
    """One optimizer step, in place: returns ``(params, state, stats)``,
    the same trees updated, and ``stats = {"lr", "grad_norm"}`` (fp32
    scalar tensors).  ``step`` is the 0-based step (an int or a tensor)."""
    p_leaves = tree_leaves(params)
    lr = lr_at_step(cfg, _f32(step, p_leaves[0] if p_leaves else None))
    gnorm = global_norm(grads)
    clip = (torch.clamp(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9),
                        max=1.0)
            if cfg.grad_clip > 0 else 1.0)
    t = _f32(step, lr) + 1
    bc1 = 1 - torch.pow(cfg.b1, t)
    bc2 = 1 - torch.pow(cfg.b2, t)
    for p, g, s in zip(p_leaves, tree_leaves(grads),
                       leaves_up_to(state, params)):
        _update_leaf(p, g, s, cfg, lr, clip, bc1, bc2)
    return params, state, {"lr": lr, "grad_norm": gnorm}
