"""Seconds from the process's start to the window's: imports, the CUDA
context, loading (in a checkout's first run, building) the kernels,
rendering the episode on the card and one warm episode."""


def read(run):
    return run.setup_s
