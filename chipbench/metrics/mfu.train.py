"""Per cent of the bf16 peak (989 TFLOP/s): the model FLOPs of the
window's steps (6 N a token plus causal attention, no recompute; from the
configuration's shapes) over the traced window's time (``host_clock``)."""
from chipbench.readers import train_mfu


def read(run):
    return train_mfu(run)
