"""Per-device compute and memory counts of an eager program (the port's
counterpart of ``repro.core.hlo_cost``).

The reference walks the compiled HLO: ``2·prod(result)·contraction`` for
every dot and convolution, fusion-boundary bytes, loop trip counts.  The
port has no HLO.  It counts while the program runs, with a dispatch-mode
hook over every aten (and custom) op that reaches the dispatcher:

* **FLOPs** -- ``torch.utils.flop_counter``'s formula for the op, when it
  has one (``mm``, ``addmm``, ``bmm``, ``baddbmm``, convolutions and their
  backward, ...).  The port's four kernel ops get formulas below that
  count what the reference's CPU HLO counts for the same call: flash
  attention, with or without its lse, the reference's ``chunked_attention``
  (full ``Sq x Skv`` score blocks -- masks remove no dot work -- or, with a
  window and more than one 512-row query chunk, ``window + 512`` keys a
  chunk), flash decode the whole cache (``decode_attention``), RMSNorm
  and the RG-LRU scan nothing (no dot).  The xLSTM ops (no kernel behind them) count what the
  reference's HLO does: the mLSTM parallel form every (query, key) pair,
  the sLSTM loop its recurrent products times its trip count.  Flash
  attention's backward op counts what the plain backward it replaces
  counts.  Eager code runs every loop iteration, so trip counts come for
  free.
* **bytes** -- each op's tensor inputs plus its tensor outputs, once each:
  the traffic of the eager run, which fuses nothing.  View ops (whose
  outputs alias an input: ``view``, ``t``, ``slice``, ``expand``, ...)
  and ops that allocate without writing move nothing and are skipped.
  The reference's memory term is XLA's fusion-boundary traffic instead,
  so the two differ by design; collectives count like any op, as the
  reference's HLO counts them.

**Per device.**  Under DTensor a mode on top of the stack would see global
shapes, so :class:`OpCostMode` (and the capturing interceptor, which feeds
an :class:`OpCounter`) step aside for a DTensor op and count the local ops
and collectives DTensor lowers it to: one device's work, replicated work
included, as the reference counts one SPMD device's module.  DTensor's
sharding propagator also runs each new op once on global-shape fake
stand-ins to learn its output's shape; those runs reach the mode too, are
no part of the program, and are not counted (they are cached, so counting
them would make a count depend on what ran before it).

``OpCostMode`` counts a live program too (real tensors on the card): the
custom ops dispatch as one op each, kernel or plain version alike, so a
live run and the same call under ``FakeTensorMode`` count the same.  Under
``inference_mode`` composite ops (``matmul``, ``linear``, ``to``,
``reshape``, ...) reach a mode undecomposed; the mode runs their
decomposition, as ``FlopCounterMode`` does, so inference mode counts what
grad mode counts.
"""
from __future__ import annotations

import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry, register_flop_formula

from repro_torch.kernels.flash_attention import ops as _fa_ops  # noqa: F401
from repro_torch.kernels.flash_decode import ops as _fd_ops  # noqa: F401
from repro_torch.kernels.rglru import ops as _rg_ops  # noqa: F401
from repro_torch.kernels.rmsnorm import ops as _rn_ops  # noqa: F401
from repro_torch.models import mlstm_parallel as _ml_ops  # noqa: F401
from repro_torch.models import slstm_scan as _sl_ops  # noqa: F401

# the reference's ``attend`` query chunk (``chunked_attention``'s default)
Q_CHUNK = 512

# ops that move no bytes although their schema is not a view: metadata
# (and every ``prim`` op: ``prim::device`` reaches a mode under
# FakeTensorMode only), allocation without a write, and the wait on a
# pending collective
_NO_TRAFFIC = {
    "_unsafe_view", "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "_local_scalar_dense", "wait_tensor", "sym_size",
    "sym_stride", "sym_numel", "sym_storage_offset", "set_",
}


@register_flop_formula([torch.ops.repro_torch.flash_attention,
                        torch.ops.repro_torch.flash_attention_lse])
def flash_attention_flop(q_shape, k_shape, v_shape, causal=True, window=0,
                         q_offset=0, *args, out_shape=None, **kwargs) -> int:
    """``4·B·H·Sq·Skv·dh`` (the score and the value products), with
    ``Skv`` cut to ``window + 512`` where the reference's chunked path
    slices the keys a chunk."""
    b, sq, h, dh = q_shape
    skv = k_shape[1]
    if sq > Q_CHUNK and window > 0 and skv > window + Q_CHUNK:
        skv = window + Q_CHUNK
    return 4 * b * h * sq * skv * dh


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def flash_attention_bwd_flop(do_shape, q_shape, k_shape, *args,
                             out_shape=None, **kwargs) -> int:
    """``12·B·H·Sq·Skv·dh``: what the plain backward (``attention_bwd``:
    the recomputed score and value products and the four gradient
    products, full score blocks) counts, so that a capture counts the same
    whichever backward its tensors take."""
    b, sq, h, dh = q_shape
    return 12 * b * h * sq * k_shape[1] * dh


@register_flop_formula(torch.ops.repro_torch.flash_decode)
def flash_decode_flop(q_shape, k_shape, v_shape, len_shape=None, window=0,
                      *args, out_shape=None, **kwargs) -> int:
    """``4·B·H·L·dh`` over the whole cache of ``L`` slots."""
    b, h, dh = q_shape
    return 4 * b * h * k_shape[1] * dh


@register_flop_formula(torch.ops.repro_torch.flash_decode_partial)
def flash_decode_partial_flop(q_shape, k_shape, v_shape, len_shape=None,
                              kv_offset=0, lmax=0, window=0, *args,
                              out_shape=None, **kwargs) -> int:
    """``4·B·H·L_local·dh`` over the shard's ``L_local`` slots: the shards'
    sum is :func:`flash_decode_flop` of the whole cache (the log-sum-exp
    merge holds no dot)."""
    b, h, dh = q_shape
    return 4 * b * h * k_shape[1] * dh


@register_flop_formula([torch.ops.repro_torch.rmsnorm,
                        torch.ops.repro_torch.rglru_scan,
                        torch.ops.repro_torch.rglru_scan_bwd])
def no_dot_flop(*args, out_shape=None, **kwargs) -> int:
    """RMSNorm and the RG-LRU scan, forward and backward, hold no dot: 0,
    as in the HLO count."""
    return 0


@register_flop_formula(torch.ops.repro_torch.mlstm_parallel)
def mlstm_parallel_flop(q_shape, k_shape, v_shape, log_f_shape=None,
                        itilde_shape=None, chunk=256, *args, out_shape=None,
                        **kwargs) -> int:
    """``4·B·S·S·nh·dh`` (the score and the value products over every
    (query, key) pair): the reference's single block, and its chunked scan
    over every (query chunk, key chunk) pair, masks remove no dot work."""
    b, s, nh, dh = q_shape
    return 4 * b * s * s * nh * dh


@register_flop_formula(torch.ops.repro_torch.mlstm_parallel_bwd)
def mlstm_parallel_bwd_flop(dh_shape, q_shape, *args, out_shape=None,
                            **kwargs) -> int:
    """Twice the forward's products: each product's transpose has two."""
    return 2 * mlstm_parallel_flop(q_shape, q_shape, q_shape)


@register_flop_formula(torch.ops.repro_torch.slstm_scan)
def slstm_scan_flop(xg_shape, r_shape, state_shape=None, chunk=256, *args,
                    out_shape=None, **kwargs) -> int:
    """The sLSTM loop's recurrent products: ``2·4·B·S·nh·dh·dh``, a
    ``(B, dh) x (dh, dh)`` product a gate, a head and a step, as the
    reference's scan body counts them times its trip count (the gate
    pre-activations are ordinary matmuls outside the op)."""
    b, s, g, d = xg_shape
    return 2 * g * b * s * d * r_shape[2]


@register_flop_formula(torch.ops.repro_torch.slstm_scan_bwd)
def slstm_scan_bwd_flop(dhs_shape, dcarry_shape, xg_shape, r_shape,
                        state_shape=None, chunk=256, *args, out_shape=None,
                        **kwargs) -> int:
    """Three times the forward's products: the reference's rematted
    backward runs each chunk's forward again, then its transpose's two
    products (the hidden state's and the recurrent matrices' gradients)."""
    return 3 * slstm_scan_flop(xg_shape, r_shape)


_PROPAGATE_CODE: list = []


def in_sharding_propagation() -> bool:
    """Whether the op being recorded is DTensor's sharding propagator
    running it on global-shape fake stand-ins (see the module docstring):
    its frame is on the stack a few frames up."""
    if not _PROPAGATE_CODE:
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        fn = getattr(ShardingPropagator,
                     "_propagate_tensor_meta_non_cached", None)
        _PROPAGATE_CODE.append(getattr(fn, "__code__", None))
    code = _PROPAGATE_CODE[0]
    frame = sys._getframe(2)
    for _ in range(32):
        if frame is None:
            return False
        if frame.f_code is code:
            return True
        frame = frame.f_back
    return False


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(t) for t in x)
    if isinstance(x, dict):
        return sum(_tensor_bytes(t) for t in x.values())
    return 0


class OpCounter:
    """Running FLOP and byte totals over the ops passed to :meth:`record`."""

    def __init__(self):
        self.flops = 0
        self.bytes = 0

    def record(self, func, args, kwargs, out) -> None:
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **(kwargs or {}), out_val=out))
        if func.is_view or func.namespace == "prim" \
                or func._overloadpacket.__name__ in _NO_TRAFFIC:
            return
        self.bytes += (_tensor_bytes(args) + _tensor_bytes(kwargs or {})
                       + _tensor_bytes(out))

    def cost(self) -> dict:
        """The reference's ``cost`` keys: ``flops``, ``bytes accessed``."""
        return {"flops": float(self.flops),
                "bytes accessed": float(self.bytes)}


class OpCostMode(TorchDispatchMode):
    """Count every op of the program run inside the mode, one device's
    (see the module docstring)::

        with OpCostMode() as mode:
            model.prefill(params, batch, shd, max_len=160)
        mode.cost()          # {"flops": ..., "bytes accessed": ...}
    """

    def __init__(self):
        super().__init__()
        self.counter = OpCounter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed._functional_collectives import \
            AsyncCollectiveTensor
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, (DTensor, AsyncCollectiveTensor))
               for t in types):
            return NotImplemented      # count the local ops it lowers to
        if func._overloadpacket not in flop_registry \
                and func is not torch.ops.prim.device.default:
            # under inference_mode a composite op (matmul, linear, to,
            # reshape, ...) reaches the mode whole: count what it runs
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if not in_sharding_propagation():
            self.counter.record(func, args, kwargs, out)
        return out

    def cost(self) -> dict:
        return self.counter.cost()


__all__ = ["OpCostMode", "OpCounter", "Q_CHUNK", "flash_attention_bwd_flop",
           "flash_attention_flop", "flash_decode_flop",
           "flash_decode_partial_flop", "in_sharding_propagation", "mlstm_parallel_bwd_flop",
           "mlstm_parallel_flop", "slstm_scan_bwd_flop", "slstm_scan_flop"]
