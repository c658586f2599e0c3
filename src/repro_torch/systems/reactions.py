"""Named pointwise reaction terms for coupled systems (the port's copy of
``repro.systems.reactions``: a reaction maps torch tensors here).

A reaction is the nonlinear, *zero-radius* part of a system update: after
every linear coupling has been applied for a temporal step, the reaction
maps ``(lin, prev) -> new`` cell-by-cell, where ``lin[f]`` is field
``f``'s accumulated linear update and ``prev[f]`` is its pre-step value
on the same (possibly trapezoid-narrowed) extent.  Because it reads no
neighbors, a reaction never changes the system radius — the deep-halo
geometry is derived from the couplings alone.

Reactions are *registered by name* so a
:class:`~repro_torch.systems.spec.SystemSpec` stays a hashable value
object (program/plan cache keys, JSON round-trip): the spec stores a
:class:`Reaction` — ``(name, params)`` — and the executor resolves the
callable through :data:`REACTIONS` at build time.  Register your own
with :func:`register_reaction`:

    @register_reaction("fisher", flops=4.0)
    def _fisher(r=1.0):
        def rx(lin, prev):
            return {f: lin[f] + r * prev[f] * (1.0 - prev[f]) for f in lin}
        return rx
"""
from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass(frozen=True)
class Reaction:
    """A registered reaction by name plus its (sorted, hashable) params.

        Reaction.make("gray_scott", {"F": 0.035, "k": 0.065})
    """

    name: str
    params: tuple[tuple[str, float], ...] = ()

    @staticmethod
    def make(name: str, params: dict | None = None) -> "Reaction":
        items = tuple(sorted((str(k), float(v))
                             for k, v in (params or {}).items()))
        return Reaction(name, items)

    def as_dict(self) -> dict:
        return dict(self.params)

    def __repr__(self) -> str:
        ps = ", ".join(f"{k}={v:g}" for k, v in self.params)
        return f"Reaction({self.name}{', ' + ps if ps else ''})"


# name -> (factory, flops_per_cell): factory(**params) returns the
# pointwise map ``rx(lin, prev) -> new`` over field dicts; flops is the
# per-cell estimate the system cost model adds (DESIGN.md §16).
REACTIONS: dict[str, tuple[Callable, float]] = {}


def register_reaction(name: str, *, flops: float = 0.0):
    """Decorator: register a reaction factory under ``name``.

    The factory takes the reaction's scalar parameters as keyword
    arguments and returns the ``rx(lin, prev) -> new`` callable; ``new``
    must hold a value for every field in ``lin``.
    """
    def deco(factory):
        REACTIONS[name] = (factory, float(flops))
        return factory
    return deco


def resolve_reaction(reaction: Reaction | None):
    """The executable ``rx(lin, prev)`` for a spec's reaction (or
    ``None``), with an unknown name refused naming the registry."""
    if reaction is None:
        return None
    try:
        factory, _ = REACTIONS[reaction.name]
    except KeyError:
        raise ValueError(
            f"unknown reaction {reaction.name!r}; registered reactions: "
            f"{sorted(REACTIONS)} — add one with "
            "repro_torch.systems.register_reaction") from None
    return factory(**reaction.as_dict())


def reaction_flops(reaction: Reaction | None) -> float:
    if reaction is None:
        return 0.0
    try:
        return REACTIONS[reaction.name][1]
    except KeyError:
        raise ValueError(
            f"unknown reaction {reaction.name!r}; registered reactions: "
            f"{sorted(REACTIONS)}") from None


# ------------------------------------------------------------- built-ins ----
@register_reaction("gray_scott", flops=9.0)
def _gray_scott(F: float = 0.035, k: float = 0.065):
    """Gray–Scott kinetics on fields ``u`` (activator feed) and ``v``:

        u' = lin_u − u·v² + F·(1 − u)
        v' = lin_v + u·v² − (F + k)·v

    ``lin_*`` already carries identity + diffusion (the self-couplings),
    so this is the classic forward-Euler reaction-diffusion step.
    """
    def rx(lin, prev):
        u, v = prev["u"], prev["v"]
        uvv = u * v * v
        return {"u": lin["u"] - uvv + F * (1.0 - u),
                "v": lin["v"] + uvv - (F + k) * v}
    return rx
