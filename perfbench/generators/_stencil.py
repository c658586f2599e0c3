"""What the stencil generators share: the configuration's stencil as the
program defines it, and the faults the correctness check plants under
the program's timed path (``StencilProgram.run`` and ``run_batched``).

Faults: ``unchanged`` (a run returns its state unchanged), ``altered``
(every answer has one cell off by :data:`ALTERED_BY`), ``half_batch``
(a batch leaves its second half uncomputed), and ``control`` (the
reference one precision down, put in the program's place).
"""
from __future__ import annotations

import contextlib

ALTERED_BY = 0.01


def spec(cell):
    """The configuration's stencil, defined through the program's API."""
    from repro_torch.api import define_stencil

    config = cell.config
    if config.get("kind") != "stencil":
        raise ValueError(f"{cell.name}: a stencil mix needs a stencil "
                         f"configuration, got kind {config.get('kind')!r}")
    return define_stencil(
        [(tuple(off), c) for off, c in config["taps"]],
        name=config["name"], domain=tuple(config["domain"]),
        flops_per_cell=config["flops_per_cell"])


@contextlib.contextmanager
def plant(kind: str | None, cell):
    """``StencilProgram.run`` and ``run_batched`` replaced for the block
    by the fault ``kind`` (None: left as they are)."""
    from repro_torch.api.program import StencilProgram

    run0, batched0 = StencilProgram.run, StencilProgram.run_batched
    ndim = len(cell.config["domain"])

    def control(self, x, total_t=None):
        total_t = self.t if total_t is None else total_t
        return cell.reference.control(cell.config, x=x, steps=total_t)

    def unchanged(self, x, total_t=None):
        return x

    def alter(ys):
        ys = ys.clone()
        flat = ys.reshape(-1, ys[(0,) * (ys.dim() - ndim)].numel())
        flat[:, flat.shape[1] // 2] += ALTERED_BY
        return ys

    def half_batch(self, xs, total_t=None):
        ys = batched0(self, xs, total_t).clone()
        half = xs.shape[0] - xs.shape[0] // 2
        ys[half:] = xs[half:]
        return ys

    patches = {
        None: (run0, batched0),
        "control": (control, control),
        "unchanged": (unchanged, unchanged),
        "altered": (lambda self, x, t=None: alter(run0(self, x, t)),
                    lambda self, xs, t=None: alter(batched0(self, xs, t))),
        "half_batch": (run0, half_batch),
    }
    StencilProgram.run, StencilProgram.run_batched = patches[kind]
    try:
        yield
    finally:
        StencilProgram.run, StencilProgram.run_batched = run0, batched0
