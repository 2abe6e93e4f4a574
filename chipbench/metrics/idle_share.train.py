"""Per cent of the traced window in which no operation ran on the device
(``device_trace``: the union of the device activities' intervals)."""
from chipbench.readers import idle_share


def read(run):
    return idle_share(run)
