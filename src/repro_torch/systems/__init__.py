"""Coupled multi-field stencil systems with fused temporal blocking, on
torch (counterpart of ``repro.systems``).

    from repro_torch.api import Boundary
    from repro_torch.systems import compile_system, get_system

    prog = compile_system(get_system("gray-scott"), (256, 256), t=4,
                          boundary=Boundary.periodic())
    out = prog.run({"u": u0, "v": v0}, 64)   # 16 fused multi-field sweeps

A system is named fields + per-pair linear couplings + an optional
registered pointwise reaction (``repro_torch.systems.reactions``); the
executor advances all fields inside one fused trapezoid-chained program,
so temporal blocking spans the coupling.  It runs in plain torch through
the port's tap engine on the fields' device.  Importing this package
initializes no CUDA context.
"""
from repro_torch.systems.library import (SYSTEMS, advection_diffusion,
                                         fdtd_acoustic, get_system,
                                         gray_scott, system_names)
from repro_torch.systems.program import (SystemProgram, clear_system_caches,
                                         compile_system, system_cache_stats,
                                         system_step)
from repro_torch.systems.reactions import (REACTIONS, Reaction,
                                           register_reaction)
from repro_torch.systems.spec import (SystemSpec, define_system,
                                      system_from_json, system_to_json)

__all__ = [
    "REACTIONS",
    "Reaction",
    "SYSTEMS",
    "SystemProgram",
    "SystemSpec",
    "advection_diffusion",
    "clear_system_caches",
    "compile_system",
    "define_system",
    "fdtd_acoustic",
    "get_system",
    "gray_scott",
    "register_reaction",
    "system_cache_stats",
    "system_from_json",
    "system_names",
    "system_step",
    "system_to_json",
]
