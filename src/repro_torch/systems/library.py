"""Three worked coupled systems (the port's copy of
``repro.systems.library``): the ``systems/`` counterpart of the
Table-2 registry — pre-built, parameterized, and driven through exactly
the open ``define_system`` path (specs are *input* to the machinery, the
registry is convenience).

  * ``gray-scott`` — the classic 2-field reaction-diffusion pattern
    former: diffusion self-couplings plus the registered ``gray_scott``
    kinetics (forward Euler, dt folded into the coefficients).
  * ``fdtd-acoustic`` — 2-D collocated-grid acoustic FDTD: pressure and
    two velocity components exchanging central-difference derivative
    couplings (antisymmetric taps — fine at any depth: systems re-pin
    non-periodic ghosts per step).  A simple collocated scheme, not a
    staggered Yee grid — DESIGN.md §16 records the assumption.
  * ``advection-diffusion`` — two species diffusing with an upwind
    advection drift on ``a`` (asymmetric taps) and a pointwise linear
    exchange between the species (identity cross-couplings: the
    radius-0 coupling case).

        from repro_torch.systems import compile_system, get_system
        prog = compile_system(get_system("gray-scott"), (256, 256), t=4)
"""
from __future__ import annotations

from repro_torch.systems.spec import SystemSpec, define_system


def _merge(*tapsets):
    acc: dict[tuple, float] = {}
    for taps in tapsets:
        for off, c in taps:
            acc[off] = acc.get(off, 0.0) + c
    return tuple((off, c) for off, c in acc.items() if c != 0.0)


def _ident(c: float = 1.0):
    return (((0, 0), c),)


def _lap(scale: float):
    """5-point Laplacian × scale."""
    return (((0, 0), -4.0 * scale), ((0, 1), scale), ((0, -1), scale),
            ((1, 0), scale), ((-1, 0), scale))


def _dx(c: float):
    """Central x-derivative × c (axis 1)."""
    return (((0, 1), 0.5 * c), ((0, -1), -0.5 * c))


def _dy(c: float):
    """Central y-derivative × c (axis 0)."""
    return (((1, 0), 0.5 * c), ((-1, 0), -0.5 * c))


def gray_scott(Du: float = 0.16, Dv: float = 0.08, F: float = 0.035,
               k: float = 0.065) -> SystemSpec:
    """Gray–Scott reaction-diffusion:  u' = u + Du·∇²u − u·v² + F(1−u),
    v' = v + Dv·∇²v + u·v² − (F+k)·v  (the u-spots/v-stripes regime)."""
    return define_system(
        fields=("u", "v"),
        couplings={("u", "u"): _merge(_ident(), _lap(Du)),
                   ("v", "v"): _merge(_ident(), _lap(Dv))},
        reactions=("gray_scott", {"F": F, "k": k}),
        name="gray-scott")


def fdtd_acoustic(kappa: float = 0.3, beta: float = 0.25) -> SystemSpec:
    """2-D acoustic FDTD on a collocated grid (p, vx, vy):

        p'  = p  − κ·(∂x vx + ∂y vy)
        vx' = vx − β·∂x p
        vy' = vy − β·∂y p

    Central differences; κ/β fold bulk modulus, density and dt."""
    return define_system(
        fields=("p", "vx", "vy"),
        couplings={("p", "p"): _ident(),
                   ("p", "vx"): _dx(-kappa),
                   ("p", "vy"): _dy(-kappa),
                   ("vx", "vx"): _ident(),
                   ("vx", "p"): _dx(-beta),
                   ("vy", "vy"): _ident(),
                   ("vy", "p"): _dy(-beta)},
        name="fdtd-acoustic")


def advection_diffusion(Da: float = 0.15, Db: float = 0.1,
                        ux: float = 0.4, uy: float = 0.2,
                        gamma: float = 0.05) -> SystemSpec:
    """Two exchanging species: ``a`` advects (first-order upwind for
    positive (ux, uy)) and diffuses; ``b`` only diffuses; both relax
    toward each other at rate γ (identity cross-couplings — the
    radius-0 coupling case the spec layer explicitly allows)."""
    adv = (((0, 0), -(ux + uy)), ((0, -1), ux), ((-1, 0), uy))
    return define_system(
        fields=("a", "b"),
        couplings={("a", "a"): _merge(_ident(1.0 - gamma), _lap(Da), adv),
                   ("a", "b"): _ident(gamma),
                   ("b", "b"): _merge(_ident(1.0 - gamma), _lap(Db)),
                   ("b", "a"): _ident(gamma)},
        name="advection-diffusion")


SYSTEMS = {"gray-scott": gray_scott,
           "fdtd-acoustic": fdtd_acoustic,
           "advection-diffusion": advection_diffusion}


def get_system(name: str, **params) -> SystemSpec:
    """Build a library system by name (``**params`` override the
    defaults of its builder)."""
    try:
        build = SYSTEMS[name]
    except KeyError:
        raise KeyError(
            f"unknown system {name!r} (choose from {sorted(SYSTEMS)}); "
            "arbitrary systems need no registry — build one with "
            "repro_torch.systems.define_system(fields, couplings)") from None
    return build(**params)


def system_names() -> list[str]:
    return sorted(SYSTEMS)
