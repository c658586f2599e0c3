"""Public compile-once API of the port (2-D slice).

    from repro_torch.api import Boundary, compile_stencil, define_stencil
    spec = define_stencil([((0, 0), 0.6), ((0, 1), 0.1), ...])  # any taps
    prog = compile_stencil(spec, shape, t=4, boundary=Boundary.periodic())
    y = prog.run(x, 64)

Programs run on the card by default; ``device="cpu"`` runs the plain
PyTorch version.  Importing this package initializes no CUDA context.
"""
from repro_torch.api.boundary import Boundary
from repro_torch.api.define import from_operator, parse_taps, spec_from_json
from repro_torch.api.program import (ProgramCache, StencilProgram,
                                     cache_stats, clear_caches,
                                     compile_stencil, plan_bucketed,
                                     resolve_compute_dtype, resolve_device,
                                     resolve_geometry, sweep_schedule)
from repro_torch.core.stencil_spec import (StencilSpec, define_stencil,
                                           spec_from_reference)

__all__ = [
    "Boundary",
    "ProgramCache",
    "StencilProgram",
    "StencilSpec",
    "cache_stats",
    "clear_caches",
    "compile_stencil",
    "define_stencil",
    "from_operator",
    "parse_taps",
    "plan_bucketed",
    "resolve_compute_dtype",
    "resolve_device",
    "resolve_geometry",
    "spec_from_json",
    "spec_from_reference",
    "sweep_schedule",
]
