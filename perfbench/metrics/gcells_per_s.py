"""Useful cell-updates completed in the window (cells × steps of every
finished call), in billions, over the window's seconds on the host clock."""


def read(run, cell):
    return run.useful_cell_updates / run.window_s / 1e9
