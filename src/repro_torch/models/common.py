"""Model substrate foundations (port of ``repro.models.common``): configs,
declarative parameter specs and the RMSNorm every block calls.

Models declare their parameters as nested dicts and lists of :class:`Spec`
(shape + logical sharding axes + initializer).  From that declaration come
``init_params`` (materialized tensors from a ``torch.Generator``),
``param_shapes`` (``torch.empty`` stand-ins: under ``FakeTensorMode`` they
allocate nothing) and ``param_axes`` (consumed by
:class:`~repro_torch.parallel.Sharder`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | vlm | audio | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # attention variants
    qk_norm: bool = False
    attn_window: int = 0             # 0 = full causal; >0 = sliding window
    rope_theta: float = 10000.0
    # layer pattern, cycled over depth: "attn" | "mlstm" | "slstm" | "rec"
    block_pattern: tuple[str, ...] = ("attn",)
    # modality frontend: "tokens" (LM) | "embeddings" (stubbed vlm/audio)
    input_mode: str = "tokens"
    tie_embeddings: bool = False
    # recurrent blocks
    conv_width: int = 4              # RG-LRU temporal conv width
    d_rnn: int = 0                   # RG-LRU recurrence width (0 -> d_model)
    mlstm_chunk: int = 256           # chunkwise-parallel mLSTM chunk length
    norm_eps: float = 1e-6
    # dtypes (strings to keep config hashable/serializable)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # long_500k eligibility (sub-quadratic attention / recurrent state)
    subquadratic: bool = False
    # optimizer preset for this scale ("adamw" | "adafactor")
    optimizer: str = "adamw"
    # optimizer state dtype (large models use bf16 moments to fit HBM)
    opt_state_dtype: str = "float32"

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_rnn_(self) -> int:
        return self.d_rnn or self.d_model

    def block_kind(self, layer: int) -> str:
        return self.block_pattern[layer % len(self.block_pattern)]

    @property
    def n_params(self) -> float:
        """Approximate total parameter count (embedding + blocks + head),
        the reference's formula (the dry run's MODEL_FLOPS take it)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        dh, nh, nkv = self.dh, self.n_heads, self.n_kv_heads
        per_block = {}
        attn = d * nh * dh + 2 * d * nkv * dh + nh * dh * d
        dense_mlp = 3 * d * f
        per_block["attn"] = attn + dense_mlp
        if self.n_experts:
            per_block["attn"] = (attn + self.n_experts * 3 * d * f
                                 + d * self.n_experts)
        dr = self.d_rnn_
        per_block["rec"] = (2 * d * dr + dr * self.conv_width + 2 * dr
                            + dr * d) + 3 * d * f
        di = 2 * d  # xlstm inner dim
        per_block["mlstm"] = (2 * d * di + 3 * di * (dh * nh) // max(1, nh)
                              + di * d)
        per_block["slstm"] = 4 * d * d + 4 * d * d + d * d
        total = 0.0
        for layer in range(self.n_layers):
            total += per_block.get(self.block_kind(layer), per_block["attn"])
        total += v * d * (1 if self.tie_embeddings else 2)
        return float(total)

    @property
    def n_params_active(self) -> float:
        """Active params per token (MoE counts top_k experts only)."""
        if not self.n_experts:
            return self.n_params
        d, f = self.d_model, self.d_ff
        inactive = (self.n_experts - self.top_k) * 3 * d * f * self.n_layers
        return self.n_params - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


# ---------------------------------------------------------------------------
# declarative parameter specs
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Spec:
    """One parameter leaf: shape + logical axes + initializer."""

    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]  # logical axis name per dim (None = replicated)
    init: str = "fan_in"             # fan_in | normal | zeros | ones | embed | rglru_a
    scale: float = 1.0
    dtype: Optional[str] = None      # None -> model param_dtype

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _leaves(tree, prefix=()):
    """``(path, leaf)`` pairs: dict keys in sorted order, lists in index
    order -- ``jax.tree.flatten``'s order, which fixes the reference's
    gradient bucket plan.  A tuple is a leaf (an axes entry)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def tree_paths(tree) -> list:
    """``(path, leaf)`` pairs in :func:`tree_leaves` order, ``path`` the
    tuple of dict keys and list indices down to the leaf."""
    return list(_leaves(tree))


def tree_leaves(tree) -> list:
    """The leaves of a nested dict/list in :func:`_leaves` order."""
    return [leaf for _, leaf in _leaves(tree)]


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [build(v) for v in node]
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _init_leaf(spec: Spec, gen: torch.Generator, dtype: torch.dtype,
               device) -> torch.Tensor:
    shape = spec.shape
    if spec.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if spec.init == "rglru_a":
        # Lambda such that a = sigmoid(Lambda) ** c lies in [0.9, 0.999]
        u = torch.rand(shape, generator=gen, device=device) * 0.099 + 0.9
        root = u ** (1.0 / 8.0)
        return torch.log(root / (1 - root)).to(dtype)
    if spec.init in ("normal", "embed"):
        std = spec.scale
    elif spec.init == "fan_in":
        # fan-in on the second-to-last dim (stacked leading dims ignored)
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        std = spec.scale / math.sqrt(max(1, fan_in))
    else:
        raise ValueError(f"unknown init {spec.init!r}")
    out = torch.empty(shape, dtype=dtype, device=device)
    # draw in fp32 one leading slice at a time, so a stacked (L, ...) leaf
    # never needs an fp32 copy of itself
    for part in (out if len(shape) >= 3 else (out,)):
        part.copy_(torch.randn(part.shape, generator=gen, device=device)
                   .mul_(std))
    return out


def init_params(specs, gen: torch.Generator, param_dtype: str = "float32",
                device="cuda", dtype: Optional[torch.dtype] = None):
    """Random parameters from ``gen`` (a ``torch.Generator`` on
    ``device``); ``dtype`` overrides every leaf's dtype (e.g. bf16 at
    load).  The values differ from the reference's ``jax.random`` ones:
    tests hand the reference's weights over with
    :func:`repro_torch.weights.from_jax_params`."""
    return tree_unflatten(specs, [
        _init_leaf(spec, gen, dtype or _dtype(spec.dtype or param_dtype),
                   device)
        for spec in tree_leaves(specs)])


def param_shapes(specs, param_dtype: str = "float32", device="cuda",
                 dtype: Optional[torch.dtype] = None):
    """``torch.empty`` stand-ins; under ``FakeTensorMode`` nothing is
    allocated (the analogue of the reference's ``ShapeDtypeStruct``s)."""
    return _map(specs, lambda s: torch.empty(
        s.shape, dtype=dtype or _dtype(s.dtype or param_dtype),
        device=device))


def param_axes(specs):
    return _map(specs, lambda s: s.axes)


def layer_of(tree, l: int):
    """Layer ``l`` of every stacked ``(L, ...)`` leaf of a nested dict (the
    slice the reference's ``scan`` over layers hands its body).  A leaf may
    also be a list of its ``L`` layers (the train step hands the loss one
    autograd leaf a layer)."""
    if isinstance(tree, dict):
        return {k: layer_of(v, l) for k, v in tree.items()}
    return tree[l]


# ---------------------------------------------------------------------------
# small numerics shared by every model
# ---------------------------------------------------------------------------
def rms_norm(x, w, eps: float = 1e-6, shd=None, axes=None):
    """RMSNorm through the kernel wrapper (plain version on CPU tensors).

    With a mesh-bound ``shd`` the kernel runs on local shards, ``x`` first
    laid out by ``axes`` (``None``: as it is) and ``w`` replicated.
    """
    if shd is None:
        return rmsnorm_ops.rmsnorm(x, w, eps)
    return shd.local(lambda a, b: rmsnorm_ops.rmsnorm(a, b, eps), (x, w),
                     (axes, (None,) * w.dim()))


def cross_entropy_loss(logits, labels, mask=None):
    """Mean token cross-entropy in fp32; labels < 0 are ignored."""
    logits = logits.float()
    valid = (labels >= 0) if mask is None else mask
    labels = torch.clamp_min(labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = (logz - gold) * valid
    return nll.sum() / torch.clamp_min(valid.sum(), 1)
