"""What the tap-set headers of the stencil templates share: the grouping
of ``kernel_taps`` by the offsets a kernel reads once, and the C
preprocessor list that carries each group's taps.

``csrc/stencil3d.cu`` reads each in-plane offset ``(dy, dx)`` of a plane
once and adds it into the partial sum of every ``dz`` that uses it
(``kernels/stencil3d_gen.py``); ``csrc/stencil2d.cu`` reads each column
offset ``dx`` of an input row once and adds it into the accumulator of
every ``dy`` that uses it (``kernels/stencil2d_gen.py``).  Both headers
write the coefficients as exact hexadecimal literals of the float64
value (``float.hex``): the kernel casts each to its type, as the plain
version does.  Nothing here imports CUDA or builds anything.
"""
from __future__ import annotations

Group = tuple  # (*key offsets, ((term offset, coefficient), ...))


def group_taps(offsets, coef, key_axes: tuple[int, ...],
               term_axis: int) -> tuple[Group, ...]:
    """The taps grouped by their offsets on ``key_axes``, in order of
    first appearance: ``((*key, ((term, coef), ...)), ...)`` with each
    group's terms (the offset on ``term_axis`` and the coefficient) in
    tap order.  ``offsets`` holds one integer array per axis."""
    groups: dict[tuple[int, ...], list[tuple[int, float]]] = {}
    for q in range(len(coef)):
        key = tuple(int(offsets[a][q]) for a in key_axes)
        groups.setdefault(key, []).append((int(offsets[term_axis][q]),
                                           float(coef[q])))
    return tuple((*key, tuple(terms)) for key, terms in groups.items())


def group_macro(name: str, group: str, tap: str,
                groups: tuple[Group, ...]) -> list[str]:
    """The lines of ``#define name(group, tap)``, which expands to
    ``group(key..., tap(term, coefficient) ...)`` for each group, the
    coefficients as ``float.hex`` literals."""
    lines = [f"#define {name}({group}, {tap}) \\"]
    for *key, terms in groups:
        body = " ".join(f"{tap}({z}, {c.hex()})" for z, c in terms)
        lines.append(f"  {group}({', '.join(map(str, key))}, {body}) \\")
    lines.append("")
    return lines
