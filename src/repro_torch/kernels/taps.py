"""The slice-based tap engine on torch tensors: the port's one numerical
definition of "apply the taps" (counterpart of ``repro.kernels.taps``).

Semantics: *zero-fill* shifts.  A tap reads a static slice of a
zero-padded buffer, never a roll, so everything outside the array reads
as 0.  The oracle (``kernels/ref.py``) and the plain version of the CUDA
kernel (``kernels/stencil2d.py``) both step through this engine, and the
CUDA kernel sums the taps in the same order.

Two application paths, as in the reference:

  * generic — pad the tap axes once, then one slice + FMA per tap;
  * star    — axis-wise accumulation (center term, then the arms of each
              axis), for tap sets whose taps move along one axis at most.

Both support per-axis *valid* mode (``crops``): a cropped axis is not
padded, the output shrinks by ``crops[a]`` on each side and every tap
reads true neighbours.  ``chain_trapezoid`` narrows the live region by
one radius per step, AN5D-style.

Boundaries other than zero Dirichlet are reduced to it with the same
rules and refusals as the reference: ``check_boundary`` says whether a
chain is exact, ``ghost_extend`` pins the ghost halo (the program's
sweep chain and the oracle apply the reduction).
"""
from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn.functional as F

Taps = Sequence[tuple[tuple[int, ...], float]]


def tap_radius(taps: Taps) -> int:
    """Largest |offset| component — the pad the generic path needs."""
    return max((max(abs(o) for o in off) for off, _ in taps), default=0)


def split_star(taps: Taps, ndim: int):
    """Split a star tap set into ``(center_coeff, per-axis arms)``, or
    ``None`` if a tap moves along more than one axis."""
    center = 0.0
    arms: list[list[tuple[int, float]]] = [[] for _ in range(ndim)]
    for off, c in taps:
        nz = [i for i, o in enumerate(off) if o]
        if not nz:
            center += c
        elif len(nz) == 1:
            arms[nz[0]].append((off[nz[0]], c))
        else:
            return None
    return center, arms


def _zero_pad(x: torch.Tensor, per_axis: Sequence[int]) -> torch.Tensor:
    """Zero-pad the last ``len(per_axis)`` axes of ``x`` by ``per_axis[a]``
    cells on both sides."""
    pad: list[int] = []
    for p in reversed(per_axis):
        pad += [p, p]
    return F.pad(x, pad) if any(per_axis) else x


def apply_taps_generic(x: torch.Tensor, taps: Taps, ndim: int,
                       crops: Sequence[int] | None = None) -> torch.Tensor:
    """One stencil application on the last ``ndim`` axes of ``x``; a
    cropped axis runs in valid mode (see the module docstring)."""
    rad = tap_radius(taps)
    lead = x.dim() - ndim
    crops = tuple(crops) if crops is not None else (0,) * ndim
    for a, c in enumerate(crops):
        if c and c < max(abs(off[a]) for off, _ in taps):
            raise ValueError(f"crop {c} on axis {a} is narrower than the "
                             "taps' reach")
    xp = _zero_pad(x, [0 if c else rad for c in crops])
    base = [c if c else rad for c in crops]
    out_n = [n - 2 * c for n, c in zip(x.shape[lead:], crops)]
    acc = None
    for off, c in taps:
        idx = (Ellipsis,) + tuple(
            slice(b + o, b + o + n) for b, o, n in zip(base, off, out_n))
        term = xp[idx] * c
        acc = term if acc is None else acc + term
    return acc


def apply_taps_star(x: torch.Tensor, center: float,
                    arms: Sequence[Sequence[tuple[int, float]]], ndim: int,
                    crops: Sequence[int] | None = None) -> torch.Tensor:
    """Axis-wise accumulation for star tap sets (same ``crops`` rules)."""
    lead = x.dim() - ndim
    crops = tuple(crops) if crops is not None else (0,) * ndim

    def crop_axes(exclude: int = -1):
        idx = [slice(None)] * x.dim()
        for b, cp in enumerate(crops):
            if cp and b != exclude:
                idx[lead + b] = slice(cp, x.shape[lead + b] - cp)
        return idx

    acc = x[tuple(crop_axes())] * center
    for a, axis_arms in enumerate(arms):
        if not axis_arms:
            continue
        axis = lead + a
        rad = max(abs(o) for o, _ in axis_arms)
        n = x.shape[axis]
        cp = crops[a]
        if cp and cp < rad:
            raise ValueError(f"crop {cp} on axis {a} is narrower than the "
                             f"arm radius {rad}")
        if cp:
            xp, base, out_a = x, cp, n - 2 * cp
        else:
            per_axis = [0] * ndim
            per_axis[a] = rad
            xp, base, out_a = _zero_pad(x, per_axis), rad, n
        for off, c in axis_arms:
            idx = crop_axes(exclude=a)
            idx[axis] = slice(base + off, base + off + out_a)
            acc = acc + xp[tuple(idx)] * c
    return acc


class TapEngine:
    """A tap set bound to its cheapest application path.

    ``step(x, mask)`` applies one step to the last ``ndim`` axes of ``x``
    with zero-fill shifts, then multiplies by ``mask`` (the Dirichlet
    domain mask; ``None`` when the array edge is the domain boundary).
    """

    def __init__(self, taps: Taps, ndim: int):
        self.taps = tuple(taps)
        self.ndim = ndim
        self.radius = tap_radius(taps)
        self._star = split_star(taps, ndim)

    def step(self, x: torch.Tensor, mask: torch.Tensor | None = None,
             crops: Sequence[int] | None = None) -> torch.Tensor:
        if self._star is not None:
            center, arms = self._star
            out = apply_taps_star(x, center, arms, self.ndim, crops)
        else:
            out = apply_taps_generic(x, self.taps, self.ndim, crops)
        return out if mask is None else out * mask

    def chain(self, x: torch.Tensor, t: int,
              mask: torch.Tensor | None = None) -> torch.Tensor:
        """``t`` steps, each masked."""
        for _ in range(t):
            x = self.step(x, mask)
        return x

    def chain_trapezoid(self, x: torch.Tensor, t: int,
                        axes: Sequence[int] = (0,),
                        post=None) -> torch.Tensor:
        """``t`` valid-mode steps, shrinking ``axes`` by one radius each;
        ``post(v, s)`` (optional) runs after step ``s`` (kernels re-pin
        the domain boundary there).  Cells at distance ≥ ``t·rad`` from
        the narrowed edges equal ``chain(x, t)`` cropped by ``t·rad``."""
        crops = tuple(self.radius if a in axes else 0
                      for a in range(self.ndim))
        for s in range(1, t + 1):
            x = self.step(x, crops=crops)
            if post is not None:
                x = post(x, s)
        return x


@functools.lru_cache(maxsize=None)
def engine_for(taps: Taps, ndim: int) -> TapEngine:
    """Memoized engine per (taps, ndim) — specs are hashable tuples."""
    return TapEngine(taps, ndim)


# ------------------------------------------------------------ boundaries ----
# ``boundary`` objects are duck-typed: anything with ``.kind``/``.value``
# (see repro_torch.api.boundary).

def is_zero_dirichlet(boundary) -> bool:
    return (boundary is None
            or (boundary.kind == "dirichlet" and boundary.value == 0.0))


def tap_sum(taps: Taps) -> float:
    """Sum of tap coefficients ``s``, the contraction factor of the affine
    Dirichlet closure ``u_1 = Z(u_0 − v) + v·s``."""
    return sum(c for _, c in taps)


def check_boundary(taps: Taps, boundary, t: int | None = None) -> None:
    """Raise ``ValueError`` when a ``t``-step fused chain of ``taps``
    cannot run exactly under ``boundary`` through the zero-Dirichlet
    reductions (``t=None``: depth unknown).

    * dirichlet(v≠0): the affine closure ``Z_t(u − v) + v·s^t`` is exact
      iff the tap sum ``s == 1`` or ``t == 1``;
    * reflect: needs per-axis mirror-symmetric taps;
    * neumann(flux): exact at ``t == 1`` for any taps; deeper chains need
      mirror-symmetric taps and ``flux == 0``.
    """
    depth = "unknown" if t is None else t
    if is_zero_dirichlet(boundary) or boundary.kind == "periodic":
        return
    if boundary.kind == "neumann":
        if t == 1:
            return
        mirror = _mirror_defect(taps)
        if mirror is not None:
            off, c, a = mirror
            raise ValueError(
                f"neumann boundary at chain depth t={depth} needs a "
                f"mirror-symmetric tap set (the one-fill-per-sweep "
                f"symmetric extension must evolve as the mirror of the "
                f"interior); tap {off} (coeff {c:g}) has no axis-{a} "
                "mirror.  Fix: compile with t=1 (ghosts re-pinned every "
                "step, exact for any taps), or symmetrize the taps")
        if boundary.value != 0.0:
            raise ValueError(
                f"neumann(flux={boundary.value:g}) with a fused chain "
                f"t={depth} steps deep: the constant-flux ghost ramp is "
                "only consistent under per-step refills.  Fix: compile with "
                "t=1, or use neumann() with zero flux")
        return
    if boundary.kind == "dirichlet":
        s = tap_sum(taps)
        if abs(s - 1.0) > 1e-6 and t != 1:
            raise ValueError(
                f"dirichlet({boundary.value:g}) with taps summing to "
                f"s={s:.6g}: the affine closure u_t = Z_t(u - v) + v*s^t "
                f"is exact only for s == 1 or single-step sweeps, and this "
                f"chain is t={depth} steps deep. Fix: compile with t=1, "
                "normalize the taps to sum 1 "
                "(define_stencil(..., normalize=True)), or use "
                "dirichlet(0)/periodic, which are exact for any tap sum")
        return
    if boundary.kind == "reflect":
        mirror = _mirror_defect(taps)
        if mirror is not None:
            off, c, a = mirror
            raise ValueError(
                f"reflect boundary needs a mirror-symmetric tap set; "
                f"tap {off} (coeff {c:g}) has no axis-{a} mirror")
        return
    raise ValueError(f"unknown boundary kind {boundary.kind!r}")


def _mirror_defect(taps: Taps):
    """First tap breaking per-axis mirror symmetry as ``(off, coeff,
    axis)``, or ``None`` for a symmetric set."""
    coeff = dict(taps)
    for off, c in taps:
        for a in range(len(off)):
            m = tuple(-o if i == a else o for i, o in enumerate(off))
            if abs(coeff.get(m, 0.0) - c) > 1e-9:
                return off, c, a
    return None


def _ghost_index(n: int, halo: int, kind: str, device) -> torch.Tensor:
    """Source index of each of the ``n + 2·halo`` cells of an extended
    axis under a wrap / mirror rule (any ``halo``, even wider than ``n``)."""
    i = torch.arange(-halo, n + halo, device=device)
    if kind == "periodic":
        return i % n
    if kind == "reflect":                 # ghost(-k) = u(k)
        if n == 1:
            return torch.zeros_like(i)
        m = i % (2 * n - 2)
        return torch.where(m < n, m, 2 * n - 2 - m)
    m = i % (2 * n)                       # symmetric: ghost(-k) = u(k-1)
    return torch.where(m < n, m, 2 * n - 1 - m)


def ghost_extend(x: torch.Tensor, ndim: int, halo: int,
                 boundary) -> torch.Tensor:
    """Extend the last ``ndim`` axes of ``x`` by ``halo`` ghost cells per
    side, filled by the boundary rule: constant (dirichlet), wrap
    (periodic), mirror (reflect), or face-mirror plus a ramp of slope
    ``flux`` (neumann: ``ghost(-k) = u(k-1) + k·flux``; corners add the
    per-axis ramps).  The fills match ``numpy.pad``'s constant / wrap /
    reflect / symmetric modes."""
    lead = x.dim() - ndim
    if boundary.kind == "dirichlet":
        pad: list[int] = []
        for _ in range(ndim):
            pad += [halo, halo]
        return F.pad(x, pad, value=boundary.value)
    kind = "symmetric" if boundary.kind == "neumann" else boundary.kind
    xe = x
    for a in range(ndim):
        axis = lead + a
        idx = _ghost_index(x.shape[axis], halo, kind, x.device)
        xe = xe.index_select(axis, idx)
    if boundary.kind == "neumann" and boundary.value != 0.0:
        for a in range(ndim):
            axis = lead + a
            n = x.shape[axis]
            i = torch.arange(xe.shape[axis], device=x.device)
            dist = torch.clamp(torch.maximum(halo - i, i - (halo + n - 1)),
                               min=0)
            shape = [1] * xe.dim()
            shape[axis] = xe.shape[axis]
            xe = xe + (dist.to(xe.dtype) * boundary.value).reshape(shape)
    return xe
