"""Stencil kernel launches (the kernel wrappers' exact counters) over the
window's ``.run`` calls."""


def read(run, cell):
    if not run.calls:
        return None
    return run.counters["kernel_launches"] / run.calls
