from .common import ModelConfig, Spec, init_params, param_axes, param_shapes
from .transformer import TransformerLM


def build_model(cfg: ModelConfig) -> TransformerLM:
    """The model for a config (dense transformers in this port slice)."""
    return TransformerLM(cfg)


__all__ = ["ModelConfig", "Spec", "TransformerLM", "build_model",
           "init_params", "param_axes", "param_shapes"]
