"""Training pieces of the port: explicit DDP gradient synchronization."""
from . import ddp

__all__ = ["ddp"]
