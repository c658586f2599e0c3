"""The mean wait of a request from its admission to the start of the
dispatch that runs it, in ms on the service's clock: the service's own
counters ``queue_wait_ms`` over ``dispatched``.  Nothing where the service
keeps no such counters."""


def read(run, cell):
    dispatched = run.counters.get("dispatched", 0)
    if not dispatched:
        return None
    return run.counters["queue_wait_ms"] / dispatched
