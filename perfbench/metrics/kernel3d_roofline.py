"""The 3-D stencil kernel's share of its roofline over the window, in %:
the bound of its traced launches (``yardstick.roofline_pct``) over their
summed traced time.  Nothing where the kernel did not run."""
from perfbench.yardstick import roofline_pct

KERNEL = "stream3d_kernel"   # csrc/stencil3d.cu


def read(run, cell):
    if run.trace is None:
        return None
    ops = run.trace.ops_named(KERNEL)
    return roofline_pct([(b - a) / 1e9 for _, a, b in ops], run.cells,
                        run.useful_cell_updates,
                        cell.config["flops_per_cell"], cell.config["dtype"])
