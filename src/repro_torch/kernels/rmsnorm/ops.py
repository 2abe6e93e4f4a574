"""RMSNorm wrapper: the CUDA kernel ``csrc/rmsnorm.cu`` for a CUDA tensor,
the plain version (:func:`.ref.rmsnorm_ref`) for a CPU tensor.

``launches`` counts the kernel launches (only the CUDA branch adds to it).
"""
from __future__ import annotations

import torch

from .. import build
from .ref import rmsnorm_ref

launches = 0


def _launch(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    global launches
    y = torch.empty_like(x)
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    if rows == 0:
        return y
    fn = build.library("rmsnorm").repro_rmsnorm
    err = fn(build.ptr(x), build.ptr(w), build.ptr(y), rows, d, eps,
             build.DTYPE_CODES[x.dtype], build.stream_of(x))
    build.check("rmsnorm", err)
    launches += 1
    return y


@torch.library.custom_op("repro_torch::rmsnorm", mutates_args=())
def _rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps)
    return _launch(x, w, eps)


@_rmsnorm.register_fake
def _(x, w, eps):
    return torch.empty_like(x)


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim of ``x`` (any leading shape, any row
    count); ``w`` of shape ``(D,)`` is rounded to x's dtype first."""
    if x.device != w.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")
    if w.shape != x.shape[-1:]:
        raise ValueError(f"w shape {tuple(w.shape)} != ({x.shape[-1]},)")
    if x.device.type == "cuda":
        if x.dtype not in build.DTYPE_CODES:
            raise TypeError(f"rmsnorm kernel takes f32/bf16/f16, not {x.dtype}")
        if not x.is_contiguous():
            raise ValueError("rmsnorm kernel needs a contiguous x")
    elif x.device.type not in ("cpu", "meta"):
        raise ValueError(f"rmsnorm runs on cuda or cpu, not {x.device}")
    return _rmsnorm(x, w.to(x.dtype).contiguous(), float(eps))
