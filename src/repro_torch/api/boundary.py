"""Boundary conditions for the port's stencil programs (counterpart of
``repro.api.boundary``): zero or constant Dirichlet, periodic, reflect
and Neumann, each a compile-time property of a program.

Only zero Dirichlet runs natively: the padded layout keeps zeros outside
the domain.  ``dirichlet(v≠0)`` runs through the affine closure
``u_t = Z_t(u_0 − v) + v·s^t`` (exact for tap sum ``s = 1`` at any depth,
or for one-step sweeps); periodic, reflect and neumann extend the field
by ``t·rad`` ghost cells once per sweep, run the zero-Dirichlet sweep and
crop.  ``validate_for`` refuses at compile time what a fused chain
cannot run exactly (``repro_torch.kernels.taps.check_boundary``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.kernels.taps import check_boundary

KINDS = ("dirichlet", "periodic", "reflect", "neumann")


@dataclasses.dataclass(frozen=True)
class Boundary:
    """A boundary condition: ``kind`` ∈ {dirichlet, periodic, reflect,
    neumann}; ``value`` is the Dirichlet constant or the Neumann flux.
    Immutable and hashable: it is part of every program cache key.

        from repro_torch.api import Boundary, compile_stencil
        prog = compile_stencil(spec, (512, 512), t=4,
                               boundary=Boundary.periodic())
    """

    kind: str
    value: float = 0.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown boundary kind {self.kind!r}; "
                             f"expected one of {KINDS}")
        if self.kind in ("periodic", "reflect") and self.value != 0.0:
            raise ValueError(f"{self.kind} boundary takes no value")

    @staticmethod
    def dirichlet(value: float = 0.0) -> "Boundary":
        """Constant ``value`` outside the domain at every time step."""
        return Boundary("dirichlet", float(value))

    @staticmethod
    def periodic() -> "Boundary":
        """Wrap-around (torus) domain."""
        return Boundary("periodic")

    @staticmethod
    def reflect() -> "Boundary":
        """Mirror boundary: ``ghost(-k) = u(k)`` about the edge cell."""
        return Boundary("reflect")

    @staticmethod
    def neumann(flux: float = 0.0) -> "Boundary":
        """Flux boundary: ``ghost(-k) = u(k-1) + k·flux`` (zero-flux
        insulation by default)."""
        return Boundary("neumann", float(flux))

    @property
    def is_zero_dirichlet(self) -> bool:
        return self.kind == "dirichlet" and self.value == 0.0

    def validate_for(self, spec, t: int | None = None) -> None:
        """Raise ``ValueError`` if a ``t``-step chain of ``spec`` cannot
        run exactly under this boundary."""
        check_boundary(spec.taps, self, t)

    def __repr__(self) -> str:
        if self.kind == "dirichlet":
            return f"Boundary.dirichlet({self.value:g})"
        if self.kind == "neumann" and self.value != 0.0:
            return f"Boundary.neumann({self.value:g})"
        return f"Boundary.{self.kind}()"


ZERO = Boundary.dirichlet(0.0)
