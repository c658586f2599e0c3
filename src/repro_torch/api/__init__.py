"""Public compile-once API of the port.

    from repro_torch.api import Boundary, compile_stencil, define_stencil
    spec = define_stencil([((0, 0), 0.6), ((0, 1), 0.1), ...])  # any taps
    prog = compile_stencil(spec, shape, t=4, boundary=Boundary.periodic())
    y = prog.run(x, 64)
    prog = compile_stencil(spec, shape, t=4, mesh=(2, 2), device="cpu")
    y = prog.run_sharded(x, 64)          # one halo exchange per 4 steps

The LM half has the same front door for attention:

    prog = compile_attention(heads=8, kv_heads=2, head_dim=64)
    out = prog.apply(q, k, v)            # the CUDA flash kernel on the card

Programs run on the card by default; ``device="cpu"`` runs the plain
PyTorch version.  Importing this package initializes no CUDA context.
"""
from repro_torch.api.attention import (AttentionProgram, AttentionSpec,
                                       attention_cache_stats,
                                       attention_program_for,
                                       clear_attention_caches,
                                       compile_attention)
from repro_torch.api.boundary import Boundary
from repro_torch.api.define import from_operator, parse_taps, spec_from_json
from repro_torch.api.program import (ProgramCache, StencilProgram,
                                     cache_stats, clear_caches,
                                     compile_stencil, plan_bucketed,
                                     resolve_compute_dtype,
                                     resolve_geometry, sweep_schedule)
from repro_torch.api.sharded import count_ppermutes, planned_exchange_rounds
from repro_torch.core.device import resolve_device
from repro_torch.core.stencil_spec import (StencilSpec, define_stencil,
                                           spec_from_reference)

__all__ = [
    "AttentionProgram",
    "AttentionSpec",
    "Boundary",
    "ProgramCache",
    "StencilProgram",
    "StencilSpec",
    "attention_cache_stats",
    "attention_program_for",
    "cache_stats",
    "clear_attention_caches",
    "clear_caches",
    "compile_attention",
    "compile_stencil",
    "count_ppermutes",
    "define_stencil",
    "from_operator",
    "parse_taps",
    "planned_exchange_rounds",
    "plan_bucketed",
    "resolve_compute_dtype",
    "resolve_device",
    "resolve_geometry",
    "spec_from_json",
    "spec_from_reference",
    "sweep_schedule",
]
