"""Useful operations of the window (cell-updates × the configuration's
flops a cell) a second, over the card's peak for the dtype, in %.  It
counts useful steps only, so it reads the same work whatever runs it."""
from perfbench.yardstick import mfu_pct


def read(run, cell):
    if not run.useful_cell_updates:
        return None
    return mfu_pct(run.useful_cell_updates, cell.config["flops_per_cell"],
                   run.window_s, cell.config["dtype"])
