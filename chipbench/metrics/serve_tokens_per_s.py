"""Tokens generated by the window's ``generate`` calls over the window's
time up to the last call's end (``host_clock``)."""
from chipbench.readers import tokens_per_s


def read(run):
    return tokens_per_s(run)
