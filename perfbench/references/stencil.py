"""The plain reference of a ``"kind": "stencil"`` configuration: its taps
applied step by step.

Plain PyTorch, one step at a time, with the boundary of the
configuration.  It takes the field it is handed and nothing the program
made: no plan, padded buffer or state.  ``dtype`` is what it computes
and stores each step in: the configuration's own precision for the
reference, a lower one for the control.
"""
from __future__ import annotations

import math

import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64,
          "bfloat16": torch.bfloat16}
# the nearest precision below each the configuration may state
CONTROL_DTYPE = {"float32": "bfloat16", "float64": "float32"}


def run(x: torch.Tensor, config: dict, steps: int,
        dtype: str | None = None) -> torch.Tensor:
    """``steps`` steps of ``config``'s taps on the field ``x`` (or on each
    field of a batch along the leading axes), returned in ``dtype``
    (default: the configuration's).  Zero Dirichlet: every cell outside
    the domain reads 0 at every step."""
    boundary = config["boundary"]
    if boundary != {"kind": "dirichlet", "value": 0.0}:
        raise ValueError(f"the reference holds zero Dirichlet only, got "
                         f"{boundary}")
    taps = [(tuple(off), float(c)) for off, c in config["taps"]]
    ndim = len(config["domain"])
    radius = max(abs(o) for off, _ in taps for o in off)
    dt = DTYPES[dtype or config["dtype"]]
    shape = tuple(x.shape[-ndim:])
    lead = tuple(x.shape[:-ndim])
    bufs = [torch.zeros(lead + tuple(n + 2 * radius for n in shape),
                        dtype=dt, device=x.device) for _ in range(2)]
    inner = (Ellipsis,) + tuple(slice(radius, radius + n) for n in shape)
    bufs[0][inner] = x.to(dt)

    def shifted(src, off):
        return src[(Ellipsis,) + tuple(slice(radius + o, radius + o + n)
                                       for o, n in zip(off, shape))]

    for _ in range(steps):
        src, dst = bufs
        out = dst[inner]
        (off0, c0), rest = taps[0], taps[1:]
        torch.mul(shifted(src, off0), c0, out=out)
        for off, c in rest:
            out.add_(shifted(src, off), alpha=c)
        bufs.reverse()
    return bufs[0][inner].clone()


def gap(config: dict, y, *, x: torch.Tensor, steps: int) -> float:
    """max |y − reference|, where the reference runs ``steps`` steps from
    ``x``: infinite for a missing, misshapen or non-finite answer."""
    if y is None or tuple(y.shape) != tuple(x.shape):
        return math.inf
    want = run(x, config, steps)
    err = float((y.to(want.dtype) - want).abs().max())
    return err if math.isfinite(err) else math.inf


def control(config: dict, *, x: torch.Tensor, steps: int) -> torch.Tensor:
    """The control's answer: the reference one precision below the
    configuration's, in the configuration's dtype."""
    low = run(x, config, steps, CONTROL_DTYPE[config["dtype"]])
    return low.to(DTYPES[config["dtype"]])
