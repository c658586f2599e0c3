"""§5 of the paper, Practical Attainable Performance ``PP = P × V``, and the
port's hardware model: one NVIDIA H100.

The port's own copy of the roofline math in the reference's
``repro.core.roofline`` (``HardwareModel``, ``attainable``,
``desired_depth``, ``min_tile_width``; the equations are the paper's):

    T_gm  = a_gm · D_gm / B_gm · S_cell                     (Eq 2)
    T_sm  = a_sm · D_sm · t / B_sm · S_cell                 (Eq 3)
    T_cmp = a_cmp · D_cmp · t / THR_cmp                     (Eq 4)
    P     = D_all · t / max(T_gm, T_sm, T_cmp)              (Eq 5, 7)

``H100`` holds NVIDIA's SXM5 datasheet constants.  They are datasheet
numbers, not measurements: ``b_sm`` is derived from 128 bytes per clock
per SM at the 1.98 GHz boost clock, and ``t_dsync`` (here: the fixed cost
of one kernel launch, which the port pays once per sweep) is an estimate.
:func:`hardware_for` replaces the SM count, the per-block shared-memory
limit and the L2 size with what ``torch.cuda.get_device_properties``
reports when a card is present (an H100 PCIe differs from the SXM part).
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.stencil_spec import StencilSpec


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    name: str
    b_gm: float          # device memory bandwidth, B/s
    b_sm: float          # scratchpad (shared memory) bandwidth, B/s
    thr_cmp: float       # stencil-relevant compute throughput, FLOP/s
    t_dsync: float       # device-wide sync (here: launch) overhead, s
    s_cell: int          # bytes per cell
    onchip_bytes: float  # scratchpad one resident tile (one CTA) may claim
    # --- GPU-only fields (the reference's models have none of them) ---
    thr_cmp_fp64: float = 0.0     # FLOP/s outside the tensor cores, fp64
    sm_count: int = 0
    l2_bytes: float = 0.0


# NVIDIA H100 SXM5 datasheet: 3.35 TB/s HBM3, 67 / 34 TFLOP/s fp32 / fp64
# (non-tensor), 132 SMs, 227 KB (232,448 B) of opt-in shared memory per
# block, 50 MB L2.
H100 = HardwareModel(
    name="h100-sxm5-datasheet",
    b_gm=3.35e12,
    b_sm=132 * 128 * 1.98e9,  # derived: 128 B/clk/SM at boost clock
    thr_cmp=67e12,
    t_dsync=3e-6,             # estimate: one kernel launch
    s_cell=4,
    onchip_bytes=232448,
    thr_cmp_fp64=34e12,
    sm_count=132,
    l2_bytes=50e6,
)


def hardware_for(device) -> HardwareModel:
    """The H100 model for ``device``: datasheet constants, with the SM
    count, per-block opt-in shared memory and L2 size read from the card
    when ``device`` is a CUDA device (CPU devices get the datasheet model,
    since the CPU path runs no kernel that the model could size)."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return H100
    props = torch.cuda.get_device_properties(device)
    smem = int(getattr(props, "shared_memory_per_block_optin", 0)
               or H100.onchip_bytes)
    l2 = float(getattr(props, "L2_cache_size", 0) or H100.l2_bytes)
    sms = int(props.multi_processor_count)
    return dataclasses.replace(
        H100, name=f"cuda:{props.name}:{sms}sm:{smem}B",
        onchip_bytes=smem, l2_bytes=l2, sm_count=sms)


@dataclasses.dataclass(frozen=True)
class RooflineResult:
    t_gm: float
    t_sm: float
    t_cmp: float
    bottleneck: str          # 'gm' | 'sm' | 'cmp'
    p_cells_per_s: float     # Eq 7 (attainable)
    v: float                 # valid fraction
    pp_cells_per_s: float    # Eq 1 (practical attainable)
    gflops: float            # PP expressed in FLOP/s via flops_per_cell

    @property
    def t_stencil(self) -> float:
        return max(self.t_gm, self.t_sm, self.t_cmp)


def component_times(spec: StencilSpec, t: int, hw: HardwareModel, *,
                    rst: bool = True, d_all: float | None = None):
    """Eq 2–4 for a domain of ``d_all`` cells (default: the spec's)."""
    d_all = float(d_all if d_all is not None else math.prod(spec.domain))
    a_sm = spec.a_sm_rst if rst else spec.a_sm
    t_gm = spec.a_gm * d_all * hw.s_cell / hw.b_gm
    t_sm = a_sm * d_all * t * hw.s_cell / hw.b_sm
    t_cmp = spec.flops_per_cell * d_all * t / hw.thr_cmp
    return t_gm, t_sm, t_cmp, d_all


def v_dtile(t_stencil: float, hw: HardwareModel, n_syncs: int = 1) -> float:
    """Eq 11: valid fraction under device tiling with n syncs per tile."""
    return t_stencil / (t_stencil + hw.t_dsync * n_syncs)


def attainable(spec: StencilSpec, t: int, hw: HardwareModel, *,
               rst: bool = True, v: float = 1.0,
               d_all: float | None = None) -> RooflineResult:
    t_gm, t_sm, t_cmp, d_all = component_times(spec, t, hw, rst=rst,
                                               d_all=d_all)
    t_stencil = max(t_gm, t_sm, t_cmp)
    bn = ("gm", "sm", "cmp")[(t_gm, t_sm, t_cmp).index(t_stencil)]
    p = d_all * t / t_stencil
    pp = p * v
    return RooflineResult(t_gm, t_sm, t_cmp, bn, p, v, pp,
                          gflops=pp * spec.flops_per_cell)


def desired_depth(spec: StencilSpec, hw: HardwareModel, *,
                  rst: bool = True) -> float:
    """Eq 17 with D_sm == D_gm: minimum t that moves the bottleneck gm→sm."""
    a_sm = spec.a_sm_rst if rst else spec.a_sm
    return (spec.a_gm / hw.b_gm) * (hw.b_sm / a_sm)


def min_tile_width(spec: StencilSpec, hw: HardwareModel, *,
                   rst: bool = True) -> float:
    """Eq 23: minimum square-tile width so halo gm traffic stays
    sub-dominant."""
    a_sm = spec.a_sm_rst if rst else spec.a_sm
    return 4 * spec.a_gm * hw.b_sm / (a_sm * hw.b_gm) * spec.radius
