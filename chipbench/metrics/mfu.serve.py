"""Per cent: the whole step's share of the chip's peak.  Each prefill and
decode step's least time, the larger of its model FLOPs (routed experts
only) at 989 TFLOP/s and its least bytes (the weights it needs once, the
experts its tokens are routed to as the reference routed them, the cache
read and written) at 3.35 TB/s, summed over the window's steps and
divided by the traced window's time (``host_clock``)."""
from chipbench.readers import serve_mfu


def read(run):
    return serve_mfu(run)
