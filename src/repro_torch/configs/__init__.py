"""Architecture registry (port of ``repro.configs``): one module per
architecture, each exporting ``CONFIG`` (the published configuration) and
``REDUCED`` (same family at test scale).  Ported so far: ``qwen3_8b``
(dense) and ``recurrentgemma_2b`` (hybrid)."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.common import ModelConfig

ARCH_IDS = ("qwen3_8b", "recurrentgemma_2b")


def get(arch: str):
    """The config module of an arch id (dashes tolerated)."""
    name = arch.replace("-", "_").replace(".", "")
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; ported: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def config(arch: str, reduced: bool = False) -> ModelConfig:
    mod = get(arch)
    return mod.REDUCED if reduced else mod.CONFIG


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
