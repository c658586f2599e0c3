"""The port's oracle: ``t`` plain, un-blocked steps on torch tensors
(counterpart of ``repro.kernels.ref``).

Zero Dirichlet by default: cells outside the array read as 0 at every
step.  Another ``boundary`` ghost-extends the field by one radius per
step with the boundary rule and applies the taps in valid mode over the
extension, the textbook per-step ghost-cell discretization.  The blocked
paths pin ghosts once per sweep instead; that the two agree is what the
boundary tests assert.  It runs on whatever device the tensor is on, so
it is the oracle on the CPU and on the card alike.
"""
from __future__ import annotations

import torch

from repro_torch.core.stencil_spec import StencilSpec
from repro_torch.kernels.taps import (check_boundary, engine_for,
                                      ghost_extend, is_zero_dirichlet)


def stencil_step(x: torch.Tensor, spec: StencilSpec,
                 boundary=None) -> torch.Tensor:
    """One Jacobi step of ``spec`` over the last ``spec.ndim`` axes."""
    engine = engine_for(spec.taps, spec.ndim)
    if is_zero_dirichlet(boundary):
        return engine.step(x)
    check_boundary(spec.taps, boundary, t=1)
    rad = spec.radius
    xe = ghost_extend(x, spec.ndim, rad, boundary)
    return engine.step(xe, crops=(rad,) * spec.ndim)


def reference(x: torch.Tensor, spec: StencilSpec, t: int,
              boundary=None) -> torch.Tensor:
    """``t`` un-blocked steps — the ground truth for temporal blocking."""
    for _ in range(t):
        x = stencil_step(x, spec, boundary)
    return x
