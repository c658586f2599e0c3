"""The host's own work a batch, in ms: the mean, over the program's
``repro_torch.serve.dispatch`` spans inside the traced window, of a
span's duration less the ``repro_torch.serve.sync`` time inside it (the
host blocked on the card).  Nothing where the program opens no such
span."""
import bisect

DISPATCH = "repro_torch.serve.dispatch"
SYNC = "repro_torch.serve.sync"


def read(run, cell):
    if run.trace is None:
        return None
    lo, hi = run.trace.window
    dispatches = sorted((a, b) for name, a, b in run.trace.spans
                        if name == DISPATCH and lo <= a and b <= hi)
    if not dispatches:
        return None
    starts = [a for a, _ in dispatches]
    host = sum(b - a for a, b in dispatches)
    for name, a, b in run.trace.spans:
        if name != SYNC:
            continue
        # the dispatch that opened this sync (one thread: spans nest)
        k = bisect.bisect_right(starts, a) - 1
        if k >= 0 and b <= dispatches[k][1]:
            host -= b - a
    return host / len(dispatches) / 1e6
