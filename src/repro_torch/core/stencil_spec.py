"""Stencil specs for the PyTorch port: tap sets, the derived §5 cost model,
and the paper's Table-2 registry.

This is the port's own copy of the reference's ``repro.core.stencil_spec``
(the port imports nothing of the reference package).  The two are held
equal by ``tests/test_torch_spec.py``: every Table-2 spec has the same
``signature`` and ``TABLE3_DEPTHS`` is the same table, so plans and
cost numbers cannot drift apart between the packages.

A stencil is a set of taps ``(offset, coefficient)`` applied to a regular
grid with zero (Dirichlet) boundary semantics by default.  ``ndim``,
``radius`` and ``shape_kind`` are derived from the offsets; the cost-model
quantities (``flops_per_cell``, ``a_sm``, ``a_sm_rst``) are derived from
the tap structure unless overridden, which is how Table 2 pins the
paper's published numbers.  Stencils carry no weights: the spec, the
boundary and the field are the whole state, so a reference spec crosses
into the port through :func:`spec_from_reference`.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import numbers
from typing import Tuple

Offset = Tuple[int, ...]

MAX_NDIM = 3
MAX_RADIUS = 8          # kernels/planner are validated up to this order
DEFAULT_DOMAINS = {2: (8192, 8192), 3: (512, 512, 512)}


@dataclasses.dataclass(frozen=True)
class StencilSpec:
    name: str
    ndim: int                      # 2 or 3
    radius: int                    # stencil order (paper: "Order")
    taps: Tuple[Tuple[Offset, float], ...]
    flops_per_cell: float          # derived (2/tap) unless overridden
    domain: Tuple[int, ...]        # evaluation domain (Table 2 / default)
    a_sm: float                    # smem accesses/cell w/o RST
    a_sm_rst: float                # smem accesses/cell w/  RST
    a_gm: float = 2.0              # §6.2: load+store per cell, perfect caching
    shape_kind: str = "star"       # "star" | "box"

    @property
    def npoints(self) -> int:
        return len(self.taps)

    @property
    def tap_sum(self) -> float:
        """Sum of tap coefficients — 1 for Jacobi-normalized sets; the
        affine Dirichlet closure depends on it."""
        return sum(c for _, c in self.taps)

    @property
    def signature(self) -> tuple:
        """Registry-free planning identity: the tap structure plus the
        cost-model numbers the §5/§6 machinery consumes.  Excludes
        ``name`` and ``domain`` — two differently-named specs with the
        same structure share plans; a cost override changes identity."""
        return (self.ndim, self.taps, self.flops_per_cell,
                self.a_sm, self.a_sm_rst, self.a_gm)

    def halo(self, t: int) -> int:
        """Halo depth for ``t`` temporally-blocked steps."""
        return self.radius * t


# ===================================================== derived geometry ====
def taps_radius(taps) -> int:
    """Largest |offset| component over the tap set."""
    return max((max((abs(o) for o in off), default=0) for off, _ in taps),
               default=0)


def classify_shape(taps) -> str:
    """'star' iff every tap moves along at most one axis, else 'box'.

    Matches the paper's star/box taxonomy: multi-point sets that are not
    full boxes (j3d17pt, poisson) fall on the box side — what matters to
    the kernels is whether the axis-separable star path applies.
    """
    for off, _ in taps:
        if sum(1 for o in off if o) > 1:
            return "box"
    return "star"


# =================================================== derived cost model ====
def derive_flops_per_cell(taps) -> float:
    """FLOPs per cell update: one fused multiply-add (2 FLOPs) per tap.

    This is the convention eight of the nine Table-2 rows use; the paper
    counts j2d25pt's blur FMAs as 1 FLOP each (25), which the registry
    keeps as a verbatim override .
    """
    return 2.0 * len(taps)


def derive_a_sm(taps) -> float:
    """Ideal scratchpad accesses per cell *without* register streaming:
    one read per tap plus one write of the produced cell.  Reproduces the
    ``a_sm`` column of Table 2 exactly for all nine benchmarks."""
    return float(len(taps) + 1)


def derive_a_sm_rst(taps, ndim: int) -> float:
    """Scratchpad accesses per cell *with* redundant register streaming.

    Counting model (calibrated to the paper's A100 implementations;
    reproduces the ``a_sm (RST)`` column of Table 2 exactly for all nine
    benchmarks — asserted by ``tests/test_define.py``):

    2-D — registers shift along the unit-stride x axis, so each distinct
    tap row (distinct ``dy``) costs one amortized smem read per cell, plus
    the result write:  ``rows(dy) + 1``.

    3-D — planes stream along z and each thread's register queue carries
    its own column, so taps at in-plane offset (0,0) are free; the rows of
    the dz=0 plane cost one amortized read each (x shifting, as in 2-D);
    the 2r+1-deep z queue pays an amortized lazy-shift overhead of ``r/2``
    per cell; and off-column taps in dz≠0 planes (box-family sets) force
    one extra amortized re-read of the shifted window:

        rows(dy | dz=0) + 1 + r/2 + [any tap with dz≠0 and (dy,dx)≠(0,0)]
    """
    rad = taps_radius(taps)
    if ndim == 2:
        rows = {off[0] for off, _ in taps}
        return float(len(rows) + 1)
    inplane_rows = {off[1] for off, _ in taps if off[0] == 0}
    off_column = any(off[0] != 0 and any(off[1:]) for off, _ in taps)
    rst = len(inplane_rows) + 1 + 0.5 * rad + (1.0 if off_column else 0.0)
    return max(2.0, min(rst, derive_a_sm(taps)))


def derive_cost_model(taps, ndim: int) -> dict:
    """The analytically derived §5 quantities for a tap set."""
    return dict(flops_per_cell=derive_flops_per_cell(taps),
                a_sm=derive_a_sm(taps),
                a_sm_rst=derive_a_sm_rst(taps, ndim))


# ============================================================ validation ===
def validate_taps(taps, *, min_radius: int = 1) -> tuple[int, int]:
    """Validate a raw tap set; returns ``(ndim, radius)``.

    Raises ``ValueError`` with a precise message naming the offending tap
    for: empty sets, non-integer or mixed-arity offsets, unsupported
    dimensionality, duplicate offsets, non-finite or zero coefficients,
    and radii outside ``[min_radius, MAX_RADIUS]``.  Single-field specs
    keep the default ``min_radius=1`` (a pure center tap has nothing to
    temporally block); coupled systems pass ``min_radius=0`` because an
    identity-only coupling (e.g. a reaction partner's pointwise feed) is
    legitimate — the *system* radius still has to clear 1.
    """
    taps = tuple(taps)
    if not taps:
        raise ValueError("stencil needs a non-empty tap set; got no taps")
    first = taps[0][0]
    try:
        ndim = len(first)
    except TypeError:
        raise ValueError(
            f"tap offsets must be tuples of ints; got {first!r}") from None
    if not 2 <= ndim <= MAX_NDIM:
        raise ValueError(
            f"stencils must be 2-D or 3-D; offset {tuple(first)} is "
            f"{ndim}-D")
    seen: dict[tuple, float] = {}
    for off, c in taps:
        off = tuple(off)
        if len(off) != ndim:
            raise ValueError(
                f"inconsistent offset arity: {off} is {len(off)}-D but the "
                f"first tap {tuple(first)} is {ndim}-D — every offset must "
                f"have the same number of components")
        if not all(isinstance(o, numbers.Integral)
                   and not isinstance(o, bool) for o in off):
            raise ValueError(
                f"tap offset {off} has non-integer components; offsets are "
                "integer grid displacements")
        off = tuple(int(o) for o in off)   # normalize numpy ints
        if off in seen:
            raise ValueError(
                f"duplicate tap offset {off} (coefficients {seen[off]:g} "
                f"and {c:g}); merge them into one tap")
        if not math.isfinite(c):
            raise ValueError(f"tap {off} has non-finite coefficient {c!r}")
        if c == 0.0:
            raise ValueError(
                f"tap {off} has zero coefficient; drop it — zero taps "
                "inflate the derived cost model without contributing")
        seen[off] = float(c)
    radius = taps_radius(taps)
    if radius < min_radius:
        raise ValueError(
            "stencil radius is 0 (only the center tap?); temporal blocking "
            "needs at least one neighbor tap (radius >= 1)")
    if radius > MAX_RADIUS:
        raise ValueError(
            f"stencil radius {radius} exceeds the supported bound "
            f"{MAX_RADIUS} (offset {max((off for off, _ in taps), key=taps_radius_of)}"
            f"); deep-halo tiling above this order is untested")
    return ndim, radius


def taps_radius_of(off) -> int:
    return max(abs(o) for o in off)


def validate_spec(spec: StencilSpec) -> StencilSpec:
    """Validate an assembled spec (``compile_stencil`` calls this, so
    hand-built ``StencilSpec`` instances get the same precise errors as
    ``define_stencil`` input)."""
    ndim, radius = validate_taps(spec.taps)
    if spec.ndim != ndim:
        raise ValueError(
            f"{spec.name}: ndim={spec.ndim} but the tap offsets are "
            f"{ndim}-D")
    if spec.radius != radius:
        raise ValueError(
            f"{spec.name}: radius={spec.radius} but the tap set reaches "
            f"{radius} (max |offset| component); set radius={radius}")
    if len(spec.domain) != ndim:
        raise ValueError(
            f"{spec.name}: domain {spec.domain} is {len(spec.domain)}-D "
            f"for a {ndim}-D tap set")
    if any(d < 2 * radius + 2 for d in spec.domain):
        raise ValueError(
            f"{spec.name}: domain {spec.domain} has an extent smaller than "
            f"2·radius+2 = {2 * radius + 2}; the halo would cover it")
    for field in ("flops_per_cell", "a_sm", "a_sm_rst", "a_gm"):
        v = getattr(spec, field)
        if not (math.isfinite(v) and v > 0):
            raise ValueError(f"{spec.name}: {field}={v!r} must be a "
                             "positive finite number")
    return spec


# =============================================================== builder ===
def define_stencil(taps, *, name: str | None = None, normalize: bool = False,
                   domain: Tuple[int, ...] | None = None,
                   flops_per_cell: float | None = None,
                   a_sm: float | None = None,
                   a_sm_rst: float | None = None,
                   a_gm: float = 2.0) -> StencilSpec:
    """Build a :class:`StencilSpec` from a user tap set.

    ``ndim``, ``radius`` and ``shape_kind`` are derived from the offsets;
    ``flops_per_cell`` / ``a_sm`` / ``a_sm_rst`` are derived from the tap
    structure  unless explicitly overridden — which is
    how the Table-2 registry pins the paper's verbatim numbers.

    ``normalize=True`` rescales the coefficients to sum to 1 (Jacobi
    weights): iterates stay bounded under deep blocking and every
    boundary condition's exact reduction applies.
    ``domain`` is the evaluation domain used when planning without an
    explicit shape; defaults to ``DEFAULT_DOMAINS[ndim]``.
    """
    taps = tuple((tuple(off), float(c)) for off, c in taps)
    ndim, radius = validate_taps(taps)
    # post-validation normalization: components are Integral, so int() is
    # exact (numpy ints become plain ints — clean hashing/repr in keys)
    taps = tuple((tuple(int(o) for o in off), c) for off, c in taps)
    if normalize:
        taps = _norm(taps)
    cost = derive_cost_model(taps, ndim)
    if flops_per_cell is not None:
        cost["flops_per_cell"] = float(flops_per_cell)
    if a_sm is not None:
        cost["a_sm"] = float(a_sm)
    if a_sm_rst is not None:
        cost["a_sm_rst"] = float(a_sm_rst)
    spec = StencilSpec(
        name=name or f"user{ndim}d{len(taps)}pt",
        ndim=ndim, radius=radius, taps=taps,
        domain=tuple(domain) if domain is not None else DEFAULT_DOMAINS[ndim],
        a_gm=float(a_gm), shape_kind=classify_shape(taps), **cost)
    return validate_spec(spec)


def _norm(taps):
    """Normalize coefficients to sum to 1 (Jacobi smoothing weights).

    Keeps iterates bounded for arbitrarily deep temporal blocking, which makes
    the blocked-vs-reference equivalence tests numerically meaningful.
    """
    s = sum(c for _, c in taps)
    if s == 0:
        raise ValueError(
            "cannot normalize a tap set whose coefficients sum to 0 "
            "(e.g. a raw Laplacian); embed it in an update like "
            "u + alpha*L(u) first — see repro_torch.api.define.diffusion")
    return tuple((o, c / s) for o, c in taps)


def star_taps(ndim: int, radius: int, center_w: float = 2.0,
              arm_w: float = 1.0, normalize: bool = True):
    taps = [((0,) * ndim, center_w)]
    for ax in range(ndim):
        for r in range(1, radius + 1):
            for sgn in (-1, 1):
                off = [0] * ndim
                off[ax] = sgn * r
                taps.append((tuple(off), arm_w / r))
    return _norm(taps) if normalize else tuple(taps)


def box_taps(ndim: int, radius: int, center_w: float = 4.0,
             normalize: bool = True):
    taps = []
    for off in itertools.product(range(-radius, radius + 1), repeat=ndim):
        w = center_w if all(o == 0 for o in off) else 1.0 / (1 + sum(abs(o) for o in off))
        taps.append((tuple(off), w))
    return _norm(taps) if normalize else tuple(taps)


def gaussian_taps(radius: int = 2, ndim: int = 2, sigma: float = 1.2):
    """Gaussian blur weights (j2d25pt in the suite is the 5x5 instance)."""
    taps = []
    for off in itertools.product(range(-radius, radius + 1), repeat=ndim):
        w = math.exp(-sum(o * o for o in off) / (2 * sigma * sigma))
        taps.append((tuple(off), w))
    return _norm(taps)


def j3d17pt_taps():
    """17-point radius-1 stencil: full 3x3 box in the z=0 plane (9 taps) plus
    the 4 in-plane-diagonal taps in each of the z=+-1 planes (8 taps).

    The paper does not give the exact tap set (it refers to [25, 40]); any
    17-point radius-1 set is a faithful stand-in because Table 2's
    flops/cell and a_sm — which are what the performance model consumes —
    are taken from the paper, and correctness is defined against our own
    oracle.
    """
    taps = []
    for dy, dx in itertools.product((-1, 0, 1), repeat=2):
        taps.append(((0, dy, dx), 2.0 if (dy, dx) == (0, 0) else 1.0))
    for dz in (-1, 1):
        for dy, dx in ((-1, -1), (-1, 1), (1, -1), (1, 1)):
            taps.append(((dz, dy, dx), 0.5))
    return _norm(taps)


def poisson19_taps():
    """Classic 19-point 3-D Poisson stencil: center + 6 faces + 12 edges."""
    taps = []
    for off in itertools.product((-1, 0, 1), repeat=3):
        dist = sum(abs(o) for o in off)
        if dist == 0:
            taps.append((off, 6.0))
        elif dist == 1:
            taps.append((off, 1.0))
        elif dist == 2:
            taps.append((off, 0.5))
    return _norm(taps)


# ---------------------------------------------------------------- Table 2 ---
# The paper's evaluation domains; ``flops_per_cell`` / ``a_sm`` / ``a_sm_rst``
# are passed as verbatim overrides of the derivation (they are the published
# Table-2 values; the derivation reproduces them).
_PAPER_3D = (2560, 288, 384)


def _table2(name, taps, flops, domain, a_sm, a_sm_rst):
    return define_stencil(taps, name=name, domain=domain,
                          flops_per_cell=flops, a_sm=a_sm, a_sm_rst=a_sm_rst)


TABLE2: dict[str, StencilSpec] = {
    "j2d5pt": _table2("j2d5pt", star_taps(2, 1), 10, (8352, 8352), 6, 4),
    "j2d9pt": _table2("j2d9pt", star_taps(2, 2), 18, (8064, 8064), 10, 6),
    "j2d9pt-gol": _table2("j2d9pt-gol", box_taps(2, 1), 18, (8784, 8784), 10, 4),
    "j2d25pt": _table2("j2d25pt", gaussian_taps(2), 25, (8640, 8640), 26, 6),
    "j3d7pt": _table2("j3d7pt", star_taps(3, 1), 14, _PAPER_3D, 8, 4.5),
    "j3d13pt": _table2("j3d13pt", star_taps(3, 2), 26, _PAPER_3D, 14, 7),
    "j3d17pt": _table2("j3d17pt", j3d17pt_taps(), 34, _PAPER_3D, 18, 5.5),
    "j3d27pt": _table2("j3d27pt", box_taps(3, 1), 54, _PAPER_3D, 28, 5.5),
    "poisson": _table2("poisson", poisson19_taps(), 38, _PAPER_3D, 20, 5.5),
}

# Paper Table 3 — depth of temporal blocking chosen by each implementation.
TABLE3_DEPTHS = {
    #              STENCILGEN AN5D DRSTENCIL ARTEMIS EBISU
    "j2d5pt":     dict(stencilgen=4, an5d=10, drstencil=3, artemis=12, ebisu=12),
    "j2d9pt":     dict(stencilgen=4, an5d=5, drstencil=2, artemis=6, ebisu=8),
    "j2d9pt-gol": dict(stencilgen=4, an5d=7, drstencil=2, artemis=6, ebisu=6),
    "j2d25pt":    dict(stencilgen=2, an5d=5, drstencil=2, artemis=3, ebisu=4),
    "j3d7pt":     dict(stencilgen=4, an5d=6, drstencil=3, artemis=3, ebisu=8),
    "j3d13pt":    dict(stencilgen=2, an5d=4, drstencil=2, artemis=1, ebisu=5),
    "j3d17pt":    dict(stencilgen=2, an5d=3, drstencil=2, artemis=2, ebisu=6),
    "j3d27pt":    dict(stencilgen=2, an5d=3, drstencil=None, artemis=2, ebisu=5),
    "poisson":    dict(stencilgen=4, an5d=3, drstencil=2, artemis=2, ebisu=6),
}


def get(name: str) -> StencilSpec:
    try:
        return TABLE2[name]
    except KeyError:
        raise KeyError(
            f"unknown Table-2 stencil {name!r} (choose from {list(TABLE2)});"
            " arbitrary stencils need no registry — build one with "
            "repro_torch.api.define_stencil(taps)") from None


def names() -> list[str]:
    return list(TABLE2)


_REFERENCE_FIELDS = ("name", "ndim", "radius", "taps", "flops_per_cell",
                     "domain", "a_sm", "a_sm_rst", "a_gm", "shape_kind")


def spec_from_reference(obj) -> StencilSpec:
    """The port's :class:`StencilSpec` for a reference spec.

    ``obj`` is any object (or mapping) with the reference spec's fields
    (``name, ndim, radius, taps, flops_per_cell, domain, a_sm, a_sm_rst,
    a_gm, shape_kind``) — a ``repro.core.stencil_spec.StencilSpec``, a
    ``dataclasses.asdict`` of one, or a JSON-loaded dict.  Offsets and
    coefficients are normalized to plain ints and floats and the result
    is validated, so ``spec_from_reference(r).signature`` equals the
    reference's own ``r.signature``.
    """
    get_field = obj.get if isinstance(obj, dict) else (
        lambda k: getattr(obj, k))
    f = {k: get_field(k) for k in _REFERENCE_FIELDS}
    f["taps"] = tuple((tuple(int(o) for o in off), float(c))
                      for off, c in f["taps"])
    f["domain"] = tuple(int(d) for d in f["domain"])
    for k in ("flops_per_cell", "a_sm", "a_sm_rst", "a_gm"):
        f[k] = float(f[k])
    f["ndim"], f["radius"] = int(f["ndim"]), int(f["radius"])
    return validate_spec(StencilSpec(**f))
