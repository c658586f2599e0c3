"""The 95th percentile of the latencies of all requests due in the window,
each from its scheduled send time to its result complete on the card; a
request that failed or was refused counts as infinite."""
from perfbench.yardstick import percentile


def read(run, cell):
    return percentile(run.latencies_ms, 95) if run.latencies_ms else None
