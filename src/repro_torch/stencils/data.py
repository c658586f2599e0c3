"""Domain initialization for the stencil suite (STENCILGEN-style test data),
made from a seed with numpy so that the port and the reference can be
handed the same field."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.stencil_spec import StencilSpec


def init_domain(spec: StencilSpec, shape=None, dtype=torch.float32,
                seed: int = 0, device=None) -> torch.Tensor:
    """Uniform values in [0, 1) (float32 from ``numpy.random.default_rng
    (seed)``), cast to ``dtype`` on ``device``.  ``device=None`` means the
    card, as for ``compile_stencil``, and raises without one (pass
    ``device="cpu"`` for a field on the CPU)."""
    shape = tuple(shape or spec.domain)
    arr = np.random.default_rng(seed).random(shape, dtype=np.float32)
    return torch.from_numpy(arr).to(device=resolve_device(device),
                                    dtype=dtype)


def reduced_domain(spec: StencilSpec, scale: int = 64):
    """A small domain with the aspect ratio of the paper's (Table 2)."""
    return tuple(max(2 * spec.radius + 2, d // scale) for d in spec.domain)
