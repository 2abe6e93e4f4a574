"""Tokens of the train steps run in the window over the window's time up
to the last step's end (``host_clock``)."""
from chipbench.readers import tokens_per_s


def read(run):
    return tokens_per_s(run)
