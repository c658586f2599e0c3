"""What one measured window gives back, whatever drove it.

A generator (``generators/<name>.py``, named by a traffic mix) sets a
cell up, drives the program through the window and returns a :class:`Run`;
the metric readers and the check read nothing else.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc


@dataclasses.dataclass
class Run:
    """What one measured window gives the metric readers and the check."""
    setup_s: float
    window_s: float
    attempted: int
    failed: int                          # refused ones among them
    refused: int = 0                     # turned away at admission
    trace: object = None                 # trace.Trace of a --trace 1 run
    counters: dict = dataclasses.field(default_factory=dict)
    calls: int = 0                       # closed loop: calls made
    cells: int = 0                       # cells a kernel launch covers
    depth: int = 0                       # the program's sweep depth
    geometry: dict | None = None         # prog.geometry() at that depth
    useful_cell_updates: int = 0
    latencies_ms: list = dataclasses.field(default_factory=list)
    lateness_ms: list = dataclasses.field(default_factory=list)
    backlog_at_close: int = 0
    setup_stages: dict = dataclasses.field(default_factory=dict)
    notes: dict = dataclasses.field(default_factory=dict)  # for the line
    # (check name, program output, arguments of the reference's ``gap``):
    # each output the reference judges once the window has closed
    compare: list = dataclasses.field(default_factory=list)


@contextlib.contextmanager
def no_gc_pauses():
    """The window without the garbage collector: the harness's own
    per-request objects would otherwise set off full collections, tens
    of milliseconds each, at times that differ from run to run.  What
    set-up made is frozen out of later collections."""
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.unfreeze()
