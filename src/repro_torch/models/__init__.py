from .common import ModelConfig, Spec, init_params, param_axes, param_shapes
from .gnmt import GNMT
from .resnet import ResNet18
from .rglru import GriffinLM
from .transformer import TransformerLM


def build_model(cfg: ModelConfig):
    """The model for a config, by family as the reference's
    ``repro.models.api.build_model``: ``hybrid`` is :class:`GriffinLM`,
    ``dense`` :class:`TransformerLM`; the other families wait for later
    port slices.  The paper's applications (:class:`ResNet18`,
    :class:`GNMT`) take no ``ModelConfig``, as in the reference."""
    if cfg.family == "hybrid":
        return GriffinLM(cfg)
    if cfg.family == "dense":
        return TransformerLM(cfg)
    raise NotImplementedError(
        f"model family {cfg.family!r} ({cfg.name}) is not ported yet")


__all__ = ["GNMT", "GriffinLM", "ModelConfig", "ResNet18", "Spec",
           "TransformerLM", "build_model", "init_params", "param_axes",
           "param_shapes"]
