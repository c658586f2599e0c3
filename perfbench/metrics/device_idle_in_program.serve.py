"""Share of the traced window, in %, in which nothing ran on the card
while the host was inside the program (some ``repro_torch.`` span open),
in the serving cells: the idle gaps of ``device_idle.serve`` intersected
with the union of the program's spans, by overlap and not by where a gap
began.  The rest of the idle window the host spent in the harness.
Nothing where the program opens no span."""
from perfbench.yardstick import union

PREFIX = "repro_torch."


def read(run, cell):
    if run.trace is None:
        return None
    program = [s[1:] for s in run.trace.spans if s[0].startswith(PREFIX)]
    if not program:
        return None
    device = [op[1:] for op in run.trace.device_ops]
    lo, hi = run.trace.window
    busy, _ = union(device, lo, hi)
    either, _ = union(device + program, lo, hi)
    # |idle ∩ program| = |device ∪ program| − |device|
    return 100.0 * (either - busy) / (hi - lo)
