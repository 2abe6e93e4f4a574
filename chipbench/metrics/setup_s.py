"""Seconds from the process's start to the window's: imports, the port's
kernel build on a checkout's first run, the weights, the warm-up."""


def read(run):
    return run.setup_s
