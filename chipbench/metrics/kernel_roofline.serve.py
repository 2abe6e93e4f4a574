"""Per cent: the port's kernels' least time (each input byte read once,
each output byte written once, and their operations, at the H100's peaks)
over their device time in the traced window (``device_trace``); the
kernels are ``readers.KERNELS``."""
from chipbench.readers import kernel_roofline


def read(run):
    return kernel_roofline(run)
