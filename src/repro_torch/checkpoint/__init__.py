"""Checkpoints of the port (port of ``repro.checkpoint``), in the
reference's on-disk format."""
from .checkpoint import (AsyncCheckpointer, latest_step, restore_checkpoint,
                         save_checkpoint)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "AsyncCheckpointer"]
