"""§5 of the paper, Practical Attainable Performance ``PP = P × V``, and the
port's hardware model: one NVIDIA H100.

The port's own copy of the roofline math in the reference's
``repro.core.roofline`` (``HardwareModel``, ``attainable``,
``desired_depth``, ``desired_depth_device_tiled``, ``min_tile_width``,
``spec_cost_summary``, ``halo_exchange_time``; the equations are the
paper's):

    T_gm  = a_gm · D_gm / B_gm · S_cell                     (Eq 2)
    T_sm  = a_sm · D_sm · t / B_sm · S_cell                 (Eq 3)
    T_cmp = a_cmp · D_cmp · t / THR_cmp                     (Eq 4)
    P     = D_all · t / max(T_gm, T_sm, T_cmp)              (Eq 5, 7)

``H100`` holds NVIDIA's SXM5 datasheet constants.  They are datasheet
numbers, not measurements: ``b_sm`` is derived from 128 bytes per clock
per SM at the 1.98 GHz boost clock, and ``t_dsync`` (here: the fixed cost
of one kernel launch, which the port pays once per sweep) is an estimate.
:func:`hardware_for` replaces the SM count, the per-block shared-memory
limit, the L2 size and the memory capacity with what
``torch.cuda.get_device_properties`` reports when a card is present (an
H100 PCIe differs from the SXM part).  ``hbm_bytes`` and ``mxu_flops``
(the dense bf16 tensor-core peak) are the LM dry run's terms, under the
reference's names.
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
    # --- interconnect, for the halo exchange of sharded runs ---
    b_ici: float = 0.0   # per-link bandwidth between devices, B/s
    ici_links: int = 0   # links per device usable for halo exchange
    # --- the LM dry run's terms (the reference's names) ---
    hbm_bytes: float = 0.0        # device memory capacity, B
    mxu_flops: float = 0.0        # dense bf16 matmul peak (tensor cores)


# NVIDIA H100 SXM5 datasheet: 989 TFLOP/s dense bf16 on the tensor cores
# (a datasheet number, not a measurement; it assumes the 700 W limit).
H100_BF16_TENSOR_FLOPS = 989e12
# NVIDIA H100 SXM5 datasheet: 495 TFLOP/s dense TF32 on the tensor cores
# (a datasheet number, not a measurement; it assumes the 700 W limit):
# the peak for float32 attention, whose products the kernels issue as
# TF32 mma
H100_TF32_TENSOR_FLOPS = 495e12
# NVIDIA H100 SXM5 datasheet: 80 GB of HBM3 (a datasheet number;
# ``hardware_for`` reads the card's own capacity where there is one).
H100_HBM_BYTES = 80e9


# NVIDIA H100 SXM5 datasheet: 3.35 TB/s HBM3, 67 / 34 TFLOP/s fp32 / fp64
# (non-tensor), 132 SMs, 227 KB (232,448 B) of opt-in shared memory per
# block, 50 MB L2, and fourth-generation NVLink: 900 GB/s per GPU over 18
# links, 50 GB/s a link (both directions together).
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
    b_ici=50e9,               # datasheet: 900 GB/s over 18 NVLink links
    ici_links=18,
    hbm_bytes=H100_HBM_BYTES,
    mxu_flops=H100_BF16_TENSOR_FLOPS,
)


def hardware_for(device) -> HardwareModel:
    """The H100 model for ``device``: datasheet constants, with the SM
    count, per-block opt-in shared memory, L2 size and device memory
    capacity (``total_memory``) read from the card when ``device`` is a
    CUDA device (CPU devices get the datasheet model,
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
        onchip_bytes=smem, l2_bytes=l2, sm_count=sms,
        hbm_bytes=float(props.total_memory))


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


def v_smtile(spec: StencilSpec, t: int, tile: tuple[int, ...]) -> float:
    """Eq 8 (2-D) / Eq 9 (3-D): valid fraction under overlapped tiling."""
    h = spec.halo(t)
    if spec.ndim == 2:
        return max(0.0, (tile[0] - h) / tile[0])
    return (max(0.0, (tile[0] - h) / tile[0])
            * max(0.0, (tile[1] - h) / tile[1]))


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


def desired_depth_device_tiled(spec: StencilSpec, hw: HardwareModel,
                               tile: tuple[int, int], *,
                               rst: bool = True) -> float:
    """Eq 18/19: depth at which sm time covers the (halo-inflated) gm time.

    D_gm = tile_x·tile_y + (tile_x+tile_y)·2·t·rad ; D_sm = tile_x·tile_y.
    Solve  a_sm·D_sm·t/B_sm  >  a_gm·D_gm/B_gm  for t.
    """
    a_sm = spec.a_sm_rst if rst else spec.a_sm
    tx, ty = tile
    d_sm = tx * ty
    # a_sm·d_sm/B_sm · t  >  a_gm·(d_sm + (tx+ty)·2·rad·t)/B_gm
    lhs_slope = a_sm * d_sm / hw.b_sm
    rhs_slope = spec.a_gm * (tx + ty) * 2 * spec.radius / hw.b_gm
    rhs_const = spec.a_gm * d_sm / hw.b_gm
    denom = lhs_slope - rhs_slope
    if denom <= 0:
        return math.inf
    return rhs_const / denom


def min_tile_width(spec: StencilSpec, hw: HardwareModel, *,
                   rst: bool = True) -> float:
    """Eq 23: minimum square-tile width so halo gm traffic stays
    sub-dominant."""
    a_sm = spec.a_sm_rst if rst else spec.a_sm
    return 4 * spec.a_gm * hw.b_sm / (a_sm * hw.b_gm) * spec.radius


# --------------------------------------------------- distributed extension ---
def halo_exchange_time(spec: StencilSpec, t: int, hw: HardwareModel,
                       shard_shape: tuple[int, ...],
                       n_neighbors: int = 2) -> float:
    """Beyond-paper: link time for a deep-halo (t·rad) exchange, amortized
    over the t steps it buys.  Exchanging once per t steps divides the
    per-step exchange cost by t — EBISU's sync amortization applied
    across devices.  On the H100 model the links are NVLink's (datasheet
    figures); shards that share one card copy on the device instead."""
    if hw.b_ici <= 0:
        return 0.0
    face = math.prod(shard_shape[1:]) if len(shard_shape) > 1 else 1
    halo_cells = spec.halo(t) * face * n_neighbors
    return halo_cells * hw.s_cell / (hw.b_ici * max(1, hw.ici_links // 2))


def spec_cost_summary(spec: StencilSpec, hw: HardwareModel = H100) -> dict:
    """The §5/§6 view of a spec: its cost-model numbers (derived or
    overridden — see ``stencil_spec.derive_cost_model``), whether each one
    matches the pure derivation, and the model's headline decisions
    (Eq 17 desired depth, Eq 23 minimum tile width, arithmetic intensity)
    on ``hw`` (default: the H100 datasheet model).  The CLI prints this
    for user-defined stencils so the derived cost model is inspectable."""
    from repro_torch.core.stencil_spec import derive_cost_model
    derived = derive_cost_model(spec.taps, spec.ndim)
    return {
        "name": spec.name,
        "ndim": spec.ndim,
        "radius": spec.radius,
        "npoints": spec.npoints,
        "shape_kind": spec.shape_kind,
        "tap_sum": spec.tap_sum,
        "flops_per_cell": spec.flops_per_cell,
        "a_sm": spec.a_sm,
        "a_sm_rst": spec.a_sm_rst,
        "a_gm": spec.a_gm,
        "overridden": sorted(k for k, v in derived.items()
                             if getattr(spec, k) != v),
        "arith_intensity": spec.flops_per_cell / (spec.a_gm * hw.s_cell),
        "desired_depth_eq17": desired_depth(spec, hw, rst=True),
        "min_tile_width_eq23": min_tile_width(spec, hw, rst=True),
    }


# ------------------------------------------------------------- attention --

def attention_hbm_bytes(b, s, sk, h, kv, hd, bytes_per_el=2) -> int:
    """Kernel device-memory traffic of one forward call: q, k, v read once
    and o written once (the reference's ``attention_hbm_bytes``)."""
    return bytes_per_el * (b * s * h * hd * 2 + 2 * b * sk * kv * hd)


def attention_valid_pairs(s: int, sk: int, *, causal: bool,
                          window: int | None) -> int:
    """Σ over the ``s`` queries of the keys the mask keeps (per batch row
    and head): causal keeps ``k <= q``, a window ``k > q - window``."""
    total = 0
    for q in range(s):
        hi = min(sk - 1, q) if causal else sk - 1
        lo = max(0, q - window + 1) if window is not None else 0
        total += max(0, hi - lo + 1)
    return total


def attention_bound(b, s, sk, h, kv, hd, *, causal: bool,
                    window: int | None, bytes_per_el: int,
                    flops_per_s: float = H100_BF16_TENSOR_FLOPS,
                    hw: HardwareModel = H100) -> dict:
    """The least time one forward call could take on ``hw``: the larger
    of its bytes over the memory rate and its masked work, ``4·hd`` flops
    per valid (query, key) pair per (batch row, head), over
    ``flops_per_s``."""
    pairs = attention_valid_pairs(s, sk, causal=causal, window=window)
    flops = 4 * hd * pairs * b * h
    nbytes = attention_hbm_bytes(b, s, sk, h, kv, hd, bytes_per_el)
    t_bytes, t_ops = nbytes / hw.b_gm, flops / flops_per_s
    return dict(pairs_per_head=pairs, flops=flops, bytes=nbytes,
                bytes_ms=t_bytes * 1e3, ops_ms=t_ops * 1e3,
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def attention_bwd_bound(b, s, sk, h, kv, hd, *, causal: bool,
                        window: int | None, bytes_per_el: int,
                        flops_per_s: float = H100_BF16_TENSOR_FLOPS,
                        hw: HardwareModel = H100) -> dict:
    """The least time one backward call could take on ``hw``: the larger
    of its bytes over the memory rate and its masked work over
    ``flops_per_s``.  Work: ``10·hd`` flops per valid (query, key) pair
    per (batch row, head) — the two recomputed products (``q·kᵀ`` and
    ``do·vᵀ``) and the three gradient products (``ds·k``, ``dsᵀ·q``,
    ``pᵀ·do``), the least any design does.  Bytes: q, k, v, o and do
    read once in the storage type, lse read once in float32, dq, dk and
    dv written once in the storage type."""
    pairs = attention_valid_pairs(s, sk, causal=causal, window=window)
    flops = 10 * hd * pairs * b * h
    # reads q, o, do and k, v; writes dq and dk, dv
    nbytes = (bytes_per_el * (4 * b * s * h * hd + 4 * b * sk * kv * hd)
              + 4 * b * h * s)
    t_bytes, t_ops = nbytes / hw.b_gm, flops / flops_per_s
    return dict(pairs_per_head=pairs, flops=flops, bytes=nbytes,
                bytes_ms=t_bytes * 1e3, ops_ms=t_ops * 1e3,
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")
