"""Spans around the calls into each layer, and the device trace of a
``--trace 1`` run.

The spans are ``torch.profiler.record_function`` ranges opened from the
benchmark's own files; they cost nothing when the run is not traced.
The trace is read from the profiler's raw events in memory (no file):
every operation that ran on the card (kernels, copies, fills) and every
span, on one clock in nanoseconds.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from perfbench import yardstick

WINDOW = "perfbench.window"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Trace:
    window: tuple[int, int]          # the traced window, ns
    device_ops: list                 # (name, start_ns, end_ns)
    spans: list                      # (name, start_ns, end_ns), host

    def ops_named(self, part: str) -> list:
        """Device operations inside the window whose name holds ``part``."""
        lo, hi = self.window
        return [op for op in self.device_ops
                if part in op[0] and lo <= op[1] and op[2] <= hi]

    def busy_s(self) -> float:
        """Seconds of the window in which some operation ran on the card:
        the union of their intervals, not a sum of their times."""
        covered, _ = yardstick.union([op[1:] for op in self.device_ops],
                                     *self.window)
        return covered / 1e9

    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def idle_pct(self) -> float:
        """Share of the window, in %, in which nothing ran on the card."""
        return 100.0 * (1.0 - self.busy_s() / self.window_s())

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time in the window, and
        the idle gaps summed by the innermost span open when each began."""
        lo, hi = self.window
        by_op: dict = {}
        for name, a, b in self.device_ops:
            if lo <= a and b <= hi:
                by_op[name] = by_op.get(name, 0) + (b - a)
        _, gaps = yardstick.union([op[1:] for op in self.device_ops], lo, hi)
        by_span: dict = {}
        for (a, b), owner in zip(gaps, self.innermost_spans(
                [g[0] for g in gaps])):
            by_span[owner] = by_span.get(owner, 0) + (b - a)

        def ranked(d):
            return [[k, v / 1e9] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {"device_ops": ranked(by_op), "idle_gaps": ranked(by_span)}

    def innermost_spans(self, times: list) -> list:
        """For each of the ascending ``times``, the innermost host span
        open then (the harness is one thread, so its spans nest)."""
        spans = sorted((s for s in self.spans if s[0] != WINDOW),
                       key=lambda s: (s[1], -s[2]))
        out, stack, i = [], [], 0
        for at in times:
            while i < len(spans) and spans[i][1] <= at:
                while stack and stack[-1][2] <= spans[i][1]:
                    stack.pop()
                stack.append(spans[i])
                i += 1
            while stack and stack[-1][2] <= at:
                stack.pop()
            out.append(stack[-1][0] if stack else "no span open")
        return out


def span(name: str, on: bool):
    """A profiler range named ``name`` when tracing, else nothing."""
    if on:
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


class Profiler:
    """``with Profiler(on) as p:`` traces the block on the card (CPU and
    CUDA activity) inside a ``perfbench.window`` span; ``p.trace`` is the
    :class:`Trace` afterwards, or None when ``on`` is false."""

    def __init__(self, on: bool):
        self.on = on
        self.trace = None
        self._prof = None

    def __enter__(self):
        if self.on:
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
            self._window = torch.profiler.record_function(WINDOW)
            self._window.__enter__()
        return self

    def __exit__(self, *exc):
        if not self.on:
            return False
        self._window.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.trace = read_events(
                self._prof.profiler.kineto_results.events())
        return False


def read_events(events) -> Trace:
    """A :class:`Trace` from the profiler's raw events."""
    device_ops, spans, window = [], [], None
    for e in events:
        start = e.start_ns()
        end = start + e.duration_ns()
        kind = e.activity_type() if hasattr(e, "activity_type") else None
        on_device = e.device_type() == torch.autograd.DeviceType.CUDA
        if on_device:
            if kind in DEVICE_ACTIVITIES or (kind is None
                                             and not e.is_user_annotation()):
                device_ops.append((e.name(), start, end))
        elif e.is_user_annotation():
            spans.append((e.name(), start, end))
            if e.name() == WINDOW:
                window = (start, end)
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    return Trace(window, device_ops, spans)
