"""Stencil builders for the port: named operators and the JSON / CLI
adapters (counterpart of ``repro.api.define``).

    from repro_torch.api import compile_stencil, define_stencil
    spec = define_stencil([((0, 0), 0.6), ((0, 1), 0.15), ((0, -1), 0.05),
                           ((1, 0), 0.1), ((-1, 0), 0.1)])   # anisotropic
    prog = compile_stencil(spec, (512, 512), t=4)
    y = prog.run(x, 64)

    from repro_torch.api.define import from_operator
    heat = from_operator("diffusion", ndim=2, alpha=0.1)     # u + a*lap(u)

Pure Python over the port's spec layer.
"""
from __future__ import annotations

import json

from repro_torch.core.stencil_spec import (StencilSpec, box_taps,
                                           define_stencil, gaussian_taps,
                                           star_taps)

# 1-D second-derivative coefficients by order of accuracy (2nd/4th):
# the radius-r Laplacian is their sum over axes.
_D2 = {1: ((0, -2.0), (1, 1.0), (-1, 1.0)),
       2: ((0, -2.5), (1, 4 / 3), (-1, 4 / 3), (2, -1 / 12), (-2, -1 / 12))}


def _lap_taps(ndim: int, radius: int, scale: float = 1.0):
    if radius not in _D2:
        raise ValueError(f"laplacian supports radius 1 or 2, got {radius}")
    acc: dict[tuple, float] = {}
    for ax in range(ndim):
        for off1, c in _D2[radius]:
            off = tuple(off1 if a == ax else 0 for a in range(ndim))
            acc[off] = acc.get(off, 0.0) + c * scale
    return tuple(acc.items())


def laplacian(ndim: int = 2, radius: int = 1, *,
              scale: float = 1.0) -> StencilSpec:
    """The raw discrete Laplacian ``∇²`` (2nd- or 4th-order star).

    Its coefficients sum to 0 — zero-Dirichlet and periodic run exactly;
    non-zero Dirichlet needs ``t=1`` sweeps (the affine closure with
    ``s = 0``).  For a Jacobi-style smoother use :func:`diffusion`.
    """
    return define_stencil(_lap_taps(ndim, radius, scale),
                          name=f"lap{ndim}d-r{radius}")


def diffusion(ndim: int = 2, radius: int = 1, *,
              alpha: float = 0.1) -> StencilSpec:
    """Explicit heat step ``u + α·∇²u`` — taps sum to 1, so every
    boundary reduction (including the Dirichlet constant shift) is exact
    at any depth.  FTCS stability wants ``α ≤ 1/(2·ndim)``."""
    taps = dict(_lap_taps(ndim, radius, alpha))
    center = (0,) * ndim
    taps[center] = taps.get(center, 0.0) + 1.0
    # at the stability limit alpha = 1/(2*ndim) the center weight is
    # exactly 0 — a valid pure-neighbor smoother, not a user error
    taps = {off: c for off, c in taps.items() if c != 0.0}
    return define_stencil(tuple(taps.items()),
                          name=f"heat{ndim}d-r{radius}")


def blur(ndim: int = 2, radius: int = 2, *,
         sigma: float = 1.2) -> StencilSpec:
    """Normalized Gaussian blur box (the j2d25pt family, any ndim/radius)."""
    return define_stencil(gaussian_taps(radius, ndim=ndim, sigma=sigma),
                          name=f"blur{ndim}d-r{radius}")


def star(ndim: int = 2, radius: int = 1, *, center_w: float = 2.0,
         arm_w: float = 1.0, normalize: bool = True) -> StencilSpec:
    """Custom star (axis-aligned arms, ``arm_w/r`` falloff)."""
    return define_stencil(
        star_taps(ndim, radius, center_w, arm_w, normalize=normalize),
        name=f"star{ndim}d-r{radius}")


def box(ndim: int = 2, radius: int = 1, *, center_w: float = 4.0,
        normalize: bool = True) -> StencilSpec:
    """Custom dense box (``1/(1+manhattan)`` falloff)."""
    return define_stencil(
        box_taps(ndim, radius, center_w, normalize=normalize),
        name=f"box{ndim}d-r{radius}")


OPERATORS = {"laplacian": laplacian, "diffusion": diffusion, "blur": blur,
             "star": star, "box": box}


def from_operator(kind: str, **params) -> StencilSpec:
    """Build a spec from a named operator: laplacian | diffusion | blur |
    star | box (each takes ``ndim``/``radius`` plus its own knobs).

        from repro_torch.api import compile_stencil, from_operator
        heat = from_operator("diffusion", ndim=2, alpha=0.1)
        prog = compile_stencil(heat, (64, 64), t=2)
    """
    try:
        build = OPERATORS[kind]
    except KeyError:
        raise ValueError(f"unknown operator {kind!r}; choose from "
                         f"{sorted(OPERATORS)}") from None
    return build(**params)


# ------------------------------------------------------------ CLI adapters --
def parse_taps(text: str):
    """Parse a JSON tap list ``[[[dz, dy, dx], coeff], ...]`` (offsets of
    any supported arity) into the tuple form ``define_stencil`` takes.

        from repro_torch.api import define_stencil, parse_taps
        spec = define_stencil(parse_taps('[[[0,0],0.6],[[0,1],0.4]]'))
    """
    try:
        raw = json.loads(text)
    except ValueError as e:
        raise ValueError(
            f"--taps is JSON like '[[[0,0],0.6],[[0,1],0.1],...]': {e}"
        ) from None
    if not isinstance(raw, list):
        raise ValueError(f"--taps must be a JSON list of [offset, coeff] "
                         f"pairs, got {type(raw).__name__}")
    taps = []
    for item in raw:
        if (not isinstance(item, list) or len(item) != 2
                or not isinstance(item[0], list)):
            raise ValueError(
                f"each tap is [offset, coeff] (e.g. [[0,1], 0.25]); "
                f"got {item!r}")
        off, c = item
        if any(o != int(o) for o in off):
            raise ValueError(
                f"tap offset {off} has non-integer components; offsets "
                "are integer grid displacements")
        taps.append((tuple(int(o) for o in off), float(c)))
    return tuple(taps)


def spec_from_json(source) -> StencilSpec:
    """Build a spec from a JSON object (or a path to one):

        {"taps": [[[0,0],0.6],...], "name": "mine", "normalize": true,
         "domain": [4096, 4096], "flops_per_cell": 10, "a_sm": 6,
         "a_sm_rst": 4, "a_gm": 2.0}

    ``taps`` is required (or ``"operator": {"kind": "diffusion", ...}``);
    everything else is optional — omitted cost-model fields are derived
    from the tap structure.

    A JSON object with a ``"fields"`` key is a coupled *system* spec and
    dispatches to :func:`repro_torch.systems.system_from_json`, returning
    a :class:`~repro_torch.systems.spec.SystemSpec` (compile it with
    ``repro_torch.systems.compile_system``).
    """
    if isinstance(source, str):
        with open(source) as f:
            obj = json.load(f)
    else:
        obj = dict(source)
    if "fields" in obj:
        from repro_torch.systems import system_from_json
        return system_from_json(obj)
    if "operator" in obj:
        op = dict(obj["operator"])
        if "kind" not in op:
            raise ValueError(
                "spec JSON 'operator' object needs a 'kind' key, e.g. "
                '{"operator": {"kind": "diffusion", "ndim": 2}}; choose '
                f"from {sorted(OPERATORS)}")
        return from_operator(op.pop("kind"), **op)
    if "taps" not in obj:
        raise ValueError("spec JSON needs a 'taps' list (or an 'operator' "
                         "object); see repro_torch.api.define.spec_from_json")
    taps = parse_taps(json.dumps(obj["taps"]))
    kw = {k: obj[k] for k in ("name", "normalize", "flops_per_cell",
                              "a_sm", "a_sm_rst", "a_gm") if k in obj}
    if "domain" in obj:
        kw["domain"] = tuple(int(d) for d in obj["domain"])
    return define_stencil(taps, **kw)
