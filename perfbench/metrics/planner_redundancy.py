"""Cell-updates a sweep computes, trapezoid included (the program's
``geometry()["cell_updates"]``), over the useful ones (cells × depth)."""


def read(run, cell):
    if run.geometry is None or not run.depth:
        return None
    return run.geometry["cell_updates"] / (run.cells * run.depth)
