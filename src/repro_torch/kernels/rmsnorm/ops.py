"""RMSNorm wrapper: the CUDA kernels of ``csrc/rmsnorm.cu`` for a CUDA
tensor, the plain version (:func:`.ref.rmsnorm_ref`) for a CPU tensor.

Which kernel, and how it is launched, is :func:`rmsnorm_plan`'s choice from
the row count, the width, the dtype's size, the pointers' alignment and the
card's SM count.  ``launches`` counts the kernel launches (only the CUDA
branch adds to it).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .. import build
from .ref import rmsnorm_bwd, rmsnorm_ref

launches = 0

VARIANTS = {"scalar": 0, "lanes": 1, "block": 2}   # csrc/rmsnorm.cu's codes
# vectors a thread that the block kernel is compiled for, and its launch
# bound at each (the threads whose registers fit an SM)
MAX_THREADS = {1: 1024, 2: 512, 4: 512}
# threads a CTA of the lanes kernel, at most
LANES_CTA = 256
# threads an SM the block plan fills before it gives a thread more vectors
# or a CTA more rows: half the SM's 2048, since beyond that the registers
# of the two- and four-vector instances do not fit
THREADS_PER_SM = 1024


class Plan(NamedTuple):
    variant: str        # "lanes", "block" or "scalar"
    threads: int        # a CTA
    vpt: int            # 16-byte vectors a thread (1 for lanes and scalar)
    rows_per_cta: int


def _warps(n: int) -> int:
    return -(-n // 32) * 32


@functools.lru_cache(maxsize=256)
def rmsnorm_plan(rows: int, d: int, itemsize: int, aligned: bool,
                 sm_count: int) -> Plan:
    """The launch of ``rows`` rows of width ``d`` (``itemsize`` bytes an
    element; ``aligned``: x, w and y all 16-byte aligned) on a card of
    ``sm_count`` SMs.

    * A row whose bytes are not a multiple of 16, or a pointer that is not
      16-byte aligned, takes the scalar kernel: one CTA a row, about eight
      elements a thread.
    * A row of at most 32 vectors takes the lanes kernel: the power of two
      of lanes at or above its vector count, one vector each; a CTA of as
      many threads as put about one CTA on each SM, 32 to 256.
    * A wider row takes the block kernel, one CTA a row.  If every row's
      threads fit ``THREADS_PER_SM`` an SM at one vector a thread (decode's
      8 rows), one vector a thread and one row a CTA: one memory latency a
      CTA.  Else two vectors a thread (four for rows wider than 512 x 2
      vectors), preferring a count that splits the row into whole warps
      exactly, and the fewest rows a CTA, taken in turn with the next
      row's loads issued before this row's reduction, that keep every CTA
      resident at once (prefill's 1024 rows: two).  Rows too wide for 512
      threads x 4 vectors take the scalar kernel.
    """
    nvec, rem = divmod(d * itemsize, 16)
    scalar = Plan("scalar", min(1024, _warps(-(-d // 8))), 1, 1)
    if not aligned or rem or nvec == 0:
        return scalar
    if nvec <= 32:
        lanes = 1 << (nvec - 1).bit_length()
        per_sm = rows * lanes // sm_count
        threads = min(LANES_CTA, max(32, 1 << max(0, per_sm.bit_length() - 1)))
        return Plan("lanes", threads, 1, threads // lanes)
    shapes = [(vpt, _warps(-(-nvec // vpt))) for vpt in MAX_THREADS]
    shapes = [(vpt, t) for vpt, t in shapes if t <= MAX_THREADS[vpt]]
    if not shapes:
        return scalar
    budget = sm_count * THREADS_PER_SM
    if shapes[0][0] == 1 and rows * shapes[0][1] <= budget:
        return Plan("block", shapes[0][1], 1, 1)
    wide = [s for s in shapes if s[0] > 1]
    vpt, threads = ([s for s in wide if s[0] * s[1] == nvec] or wide)[0]
    return Plan("block", threads, vpt, -(-rows // max(1, budget // threads)))


def plan_for(x: torch.Tensor, w: torch.Tensor,
             y: torch.Tensor | None = None) -> Plan:
    """:func:`rmsnorm_plan` for these CUDA tensors (the SM count is read
    once per device)."""
    d = x.shape[-1]
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, w, y) if t is not None)
    return rmsnorm_plan(x.numel() // d, d, x.element_size(), aligned,
                        build.sm_count(x.device.index))


def _launch(x: torch.Tensor, w: torch.Tensor, eps: float,
            plan: Plan | None = None) -> torch.Tensor:
    global launches
    y = torch.empty_like(x)
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    if rows == 0:
        return y
    fn = build.library("rmsnorm").repro_rmsnorm
    plan = plan or plan_for(x, w, y)
    err = fn(build.ptr(x), build.ptr(w), build.ptr(y), rows, d, eps,
             build.DTYPE_CODES[x.dtype], VARIANTS[plan.variant], plan.threads,
             plan.vpt, plan.rows_per_cta, build.stream_of(x))
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


def _setup(ctx, inputs, output):
    x, w, ctx.eps = inputs
    ctx.save_for_backward(x, w)


def _backward(ctx, dy):
    x, w = ctx.saved_tensors
    return (*rmsnorm_bwd(dy, x, w, ctx.eps), None)


_rmsnorm.register_autograd(_backward, setup_context=_setup)


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
