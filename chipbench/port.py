"""The system under test: the port's configuration of a cell, and its
launch counters.  The only module besides the loops that imports the
program."""
from __future__ import annotations

import dataclasses

# the port's config fields a configuration file's ``run`` section sets
FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
          "d_ff", "vocab_size", "n_experts", "top_k", "capacity_factor",
          "norm_eps", "rope_theta", "tie_embeddings", "param_dtype",
          "compute_dtype")
COUNTERS = {"flash_attention": ("flash_attention", "launches"),
            "flash_decode": ("flash_decode", "launches"),
            "rmsnorm": ("rmsnorm", "launches")}


def model_config(run: dict, log=None):
    """The port's ``ModelConfig`` for ``run``: the architecture's own, with
    every field the file states set from it; refused where the file's run
    needs what the port's transformer does not do."""
    from repro_torch import configs
    from repro_torch.models import moe

    base = configs.config(run["arch"])
    cfg = dataclasses.replace(base, **{f: run[f] for f in FIELDS})
    if log:
        moved = [f for f in FIELDS if getattr(base, f) != run[f]]
        log(f"[config] {run['arch']}: set from the file apart from the "
            f"port's own config: {moved or 'nothing'}")
    if cfg.family not in ("dense", "moe") or cfg.qk_norm or cfg.attn_window \
            or cfg.input_mode != "tokens" or cfg.block_pattern != ("attn",):
        raise ValueError(f"{run['arch']}: the benchmark's reference covers "
                         "the plain token transformer only")
    if run["n_experts"] and (moe.MOE_GROUP != run["moe_group"] or
                             moe.group_capacity(cfg, 1) != max(
                                 run["min_capacity"], 1)):
        raise ValueError("the port's MoE grouping or capacity floor differs "
                         "from the configuration file's")
    return cfg


def read_counters() -> dict:
    """The port's kernel launch counters (they count CUDA launches only)."""
    import importlib
    out = {}
    for op, (mod, attr) in COUNTERS.items():
        m = importlib.import_module(f"repro_torch.kernels.{mod}.ops")
        out[op] = getattr(m, attr)
    return out


def check_tree(model, flat: dict) -> None:
    """The drawn leaves against the port's parameter shapes."""
    from repro_torch.models.common import tree_paths
    want = {".".join(map(str, p)): tuple(t.shape)
            for p, t in tree_paths(model.shapes(device="meta"))}
    got = {n: tuple(t.shape) for n, t in flat.items()}
    if want != got:
        raise ValueError(f"weights layout differs from the port's: "
                         f"{sorted(set(want.items()) ^ set(got.items()))}")
