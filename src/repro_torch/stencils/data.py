"""Domain initialization for the stencil suite (STENCILGEN-style test data),
made from a seed with numpy so that the port and the reference can be
handed the same field."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.stencil_spec import StencilSpec


def init_domain(spec: StencilSpec, shape=None, dtype=torch.float32,
                seed: int = 0, device="cpu") -> torch.Tensor:
    """Uniform values in [0, 1) (float32 from ``numpy.random.default_rng
    (seed)``), cast to ``dtype`` on ``device``."""
    shape = tuple(shape or spec.domain)
    arr = np.random.default_rng(seed).random(shape, dtype=np.float32)
    return torch.from_numpy(arr).to(device=device, dtype=dtype)


def reduced_domain(spec: StencilSpec, scale: int = 64):
    """A small domain with the aspect ratio of the paper's (Table 2)."""
    return tuple(max(2 * spec.radius + 2, d // scale) for d in spec.domain)
