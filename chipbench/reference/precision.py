"""The control's matmul: the reference's linear layers in FP8, the step
below the bfloat16 the configurations state.

Each operand is scaled per tensor so that its largest magnitude meets the
format's largest finite value, rounded to FP8 and scaled back; the
product is then taken in float32.  Forward operands are E4M3, the
gradient a backward multiplies by is E5M2 (the usual FP8 training
recipe).
"""
from __future__ import annotations

import torch

FORMATS = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def round_fp8(x: torch.Tensor, fmt=torch.float8_e4m3fn) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = FORMATS[fmt] / amax
    return (x * scale).to(fmt).to(x.dtype) / scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = round_fp8(a), round_fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = round_fp8(g, torch.float8_e5m2)
        da = qg @ qb.transpose(-1, -2)
        db = (qa.reshape(-1, qa.shape[-1]).transpose(0, 1)
              @ qg.reshape(-1, qg.shape[-1]))
        return da, db


def fp8_matmul(a, b):
    """``a @ b`` (``b`` a 2-D weight) with FP8 operands."""
    return _Fp8Matmul.apply(a, b)
