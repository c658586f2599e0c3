"""Seconds from the process's start to the window's: imports, the CUDA
context, kernel builds (or their cache), inputs from the seed, warm-up."""


def read(run, cell):
    return run.setup_s
