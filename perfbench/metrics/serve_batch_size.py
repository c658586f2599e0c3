"""Requests the service resolved over the batches it dispatched, from the
service's own counters (``completed``, ``errored``, ``batches``)."""


def read(run, cell):
    batches = run.counters.get("batches", 0)
    if not batches:
        return None
    return (run.counters.get("completed", 0)
            + run.counters.get("errored", 0)) / batches
