"""Optimizers of the port (port of ``repro.optim``)."""
from .optimizers import (OptConfig, apply_updates, global_norm,
                         init_opt_state, lr_at_step, opt_state_axes)

__all__ = ["OptConfig", "init_opt_state", "apply_updates", "opt_state_axes",
           "lr_at_step", "global_norm"]
