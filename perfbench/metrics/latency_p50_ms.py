"""The median of the latencies, timed as the 95th percentile's are."""
from perfbench.yardstick import percentile


def read(run, cell):
    return percentile(run.latencies_ms, 50) if run.latencies_ms else None
