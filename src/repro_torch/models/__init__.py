from .common import ModelConfig, Spec, init_params, param_axes, param_shapes
from .gnmt import GNMT
from .resnet import ResNet18
from .rglru import GriffinLM
from .transformer import TransformerLM
from .xlstm import XLSTMLM


def build_model(cfg: ModelConfig):
    """The model for a config, by family as the reference's
    ``repro.models.api.build_model``: ``hybrid`` is :class:`GriffinLM`,
    ``ssm`` is :class:`XLSTMLM`; ``dense``, ``moe``, ``vlm`` and ``audio``
    run on the transformer backbone (:class:`TransformerLM`; a ``moe``
    config's layers take Mixture-of-Experts blocks).  The paper's
    applications (:class:`ResNet18`, :class:`GNMT`) take no
    ``ModelConfig``, as in the reference."""
    if cfg.family == "ssm":
        return XLSTMLM(cfg)
    if cfg.family == "hybrid":
        return GriffinLM(cfg)
    return TransformerLM(cfg)


__all__ = ["GNMT", "GriffinLM", "ModelConfig", "ResNet18", "Spec",
           "TransformerLM", "XLSTMLM", "build_model", "init_params",
           "param_axes", "param_shapes"]
