"""Host time of one stencil sweep in the kernel wrapper, in µs: the mean
duration of the program's ``repro_torch.launch.`` spans inside the traced
window (the wrapper's checks, the library lookup and the ctypes launch
call, on the profiler's clock).  Nothing where the program opens no such
span."""
PREFIX = "repro_torch.launch."


def read(run, cell):
    if run.trace is None:
        return None
    lo, hi = run.trace.window
    spans = [b - a for name, a, b in run.trace.spans
             if name.startswith(PREFIX) and lo <= a and b <= hi]
    return sum(spans) / len(spans) / 1e3 if spans else None
