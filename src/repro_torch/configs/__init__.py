"""Architecture registry (port of ``repro.configs``): one module per
architecture, each exporting ``CONFIG`` (the published configuration),
``REDUCED`` (same family at test scale) and ``TRAIN`` (its train preset).
Every architecture of the reference is ported, in its order: the ``moe``
``grok_1_314b`` and ``llama4_maverick_400b_a17b``, the dense
``codeqwen15_7b``, ``granite_3_2b``, ``qwen3_8b`` and ``granite_20b``,
the ``ssm`` ``xlstm_1_3b``, the ``vlm`` ``chameleon_34b`` and ``audio``
``musicgen_medium`` (both read stub embeddings), and the hybrid
``recurrentgemma_2b``.

``input_specs(cfg, shape)`` builds ``torch.empty`` stand-ins for every
input of the step a shape exercises (train step / prefill / decode);
under ``FakeTensorMode`` they allocate nothing."""
from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.models.common import ModelConfig, ShapeConfig

ARCH_IDS = (
    "grok_1_314b",
    "llama4_maverick_400b_a17b",
    "codeqwen15_7b",
    "granite_3_2b",
    "qwen3_8b",
    "granite_20b",
    "xlstm_1_3b",
    "chameleon_34b",
    "musicgen_medium",
    "recurrentgemma_2b",
)

# archs whose attention is not quadratic-full -> they also run long_500k
LONG_CONTEXT_ARCHS = ("xlstm_1_3b", "recurrentgemma_2b")


def get(arch: str):
    """The config module of an arch id (dashes tolerated)."""
    name = arch.replace("-", "_").replace(".", "")
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; ported: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def config(arch: str, reduced: bool = False) -> ModelConfig:
    mod = get(arch)
    return mod.REDUCED if reduced else mod.CONFIG


def train_config(arch: str):
    return get(arch).TRAIN


def cells(include_long: bool = True):
    """All (arch, shape) cells of the ported architectures."""
    out = []
    for arch in ARCH_IDS:
        for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            if shape == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
                continue  # full-attention archs skip long_500k
            if not include_long and shape == "long_500k":
                continue
            out.append((arch, shape))
    return out


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                device="cuda") -> dict:
    """``torch.empty`` stand-ins of the batch of the step ``shape``
    exercises: tokens (and labels for a train step), int32; a decode step
    takes one new token against a ``seq_len``-deep cache."""
    b, s = shape.global_batch, shape.seq_len

    def empty(*dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device=device)

    seq = 1 if shape.kind == "decode" else s
    batch = {"tokens": empty(b, seq)}
    if shape.kind == "train":
        batch["labels"] = empty(b, s)
    if cfg.input_mode == "embeddings":
        # modality frontend stub: precomputed frame/patch embeddings
        batch["embeds"] = empty(b, seq, cfg.d_model, dtype=torch.bfloat16)
    return batch


def reduce_config(cfg: ModelConfig, **over) -> ModelConfig:
    """Same family, test scale (the reference's reduction, verbatim)."""
    nh = min(cfg.n_heads, 4)
    nkv = max(1, min(cfg.n_kv_heads, nh))
    if cfg.n_kv_heads == cfg.n_heads:
        nkv = nh
    d = 16 * nh
    repl = dict(
        name=cfg.name + "-reduced",
        n_layers=6 if cfg.family == "hybrid" else 4,
        d_model=d,
        n_heads=nh,
        n_kv_heads=nkv,
        head_dim=d // nh,
        d_ff=0 if cfg.d_ff == 0 else 4 * d,
        vocab_size=512,
        n_experts=min(cfg.n_experts, 4),
        top_k=min(cfg.top_k, 2),
        attn_window=32 if cfg.attn_window else 0,
        d_rnn=d if cfg.d_rnn else 0,
        mlstm_chunk=16,
    )
    repl.update(over)
    return dataclasses.replace(cfg, **repl)
