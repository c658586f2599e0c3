"""Share of the traced window, in %, in which nothing ran on the card, in
the serving cells: the union of the device operations' intervals, not a sum
of times (``trace.Trace.idle_pct``)."""


def read(run, cell):
    return None if run.trace is None else run.trace.idle_pct()
