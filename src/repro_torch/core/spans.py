"""Named spans at the port's layer boundaries, for ``torch.profiler``.

``span(name)`` is a ``torch.profiler.record_function`` range while a
profiler records the calling thread, and one shared no-op context
otherwise, so the stencil path pays a flag read (well under a
microsecond) for each span when nobody traces it.  There is no switch:
a profiler around the work is what turns the spans on.

Capture them around a ``.run`` or the stencil service, and open the
timeline in ``chrome://tracing`` or Perfetto::

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        y = prog.run(x, 600)             # or: core.pump() in a loop
        torch.cuda.synchronize()
    prof.export_chrome_trace("run.json")
    print(prof.key_averages().table(sort_by="cpu_time_total"))

The spans land in the profiler's event list beside the card's
operations, on the same clock, nested by the calls that opened them.
Every name starts with ``repro_torch.``:

  * ``repro_torch.serve.{admit,form,dispatch,stack,guard,sync,resolve,
    solo,backoff}`` -- :class:`~repro_torch.serve.stencil_service.ServiceCore`
    (its docstring says what each covers);
  * ``repro_torch.chain.{run,pad,crop,build}`` -- a program's sweep chain
    (``api/program.py``): one call's host work, the padded buffers and
    the copy in, the cast of the result, and building a chain on a cache
    miss;
  * ``repro_torch.launch.stencil2d`` / ``repro_torch.launch.stencil3d`` --
    one sweep in the kernel wrapper, named with its depth, CTA tile and
    batch (``repro_torch.launch.stencil2d t=5 tile=120x96 batch=3``);
    a tap set's first launch builds its library inside this span.

The gate answers for the calling thread: a worker thread of the asyncio
front door opens its spans only where the profiler records that thread
(each thread's spans nest on their own).
"""
from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()
_recording = torch.autograd._profiler_enabled


def span(name: str, *fields):
    """A profiler range named ``name`` (``name.format(*fields)`` when
    ``fields`` are given, formatted only while recording), or the shared
    no-op when no profiler records this thread."""
    if not _recording():
        return _OFF
    return torch.profiler.record_function(
        name.format(*fields) if fields else name)
