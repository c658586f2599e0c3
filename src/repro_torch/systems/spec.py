"""Coupled multi-field system specs: the open definition layer, lifted
(the port's copy of ``repro.systems.spec``; pure Python, no torch).

A *system* is a set of named fields advanced together, where each field's
update is a sum of linear stencil couplings from (possibly other) fields
plus an optional pointwise reaction:

    f'  =  Σ_{(f, g) ∈ couplings} taps_{f,g} ⊛ g   then   reaction

``define_system`` is the one constructor, the multi-field twin of
``repro_torch.core.stencil_spec.define_stencil``: it validates every
per-pair tap set through the same ``validate_taps`` machinery
(``min_radius=0`` — an identity-only coupling such as a reaction
partner's pointwise feed is legitimate; the *system* radius still has to
clear 1), derives the geometry and cost model from the coupling
structure, and returns an immutable, hashable :class:`SystemSpec`:

  * ``radius`` — the system radius: max over all coupling pairs.  One
    temporal step of the whole system reaches ``radius`` cells, so deep
    blocking extends every field by ``t·radius`` regardless of which
    pair contributed the reach (the shared-cache lesson of Wittmann et
    al.: the blocking geometry must span *all* fields updated per step).
  * cost model — flops per cell summed over destination fields (2 per
    tap, as in the single-field derivation) plus the reaction's
    registered estimate; ``a_gm = 2·n_fields`` (one load + one store per
    cell *per field* under perfect caching, §6.2 lifted).

``signature`` is the registry-free planning/caching identity (structure
only, no names) — ``compile_system`` keys its program cache on it.
JSON round-trip via :func:`system_to_json` / :func:`system_from_json`
(``repro_torch.api.spec_from_json`` dispatches here on a ``"fields"`` key).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Sequence, Tuple

from repro_torch.core.stencil_spec import (MAX_RADIUS, taps_radius,
                                           validate_taps)
from repro_torch.systems.reactions import (Reaction, reaction_flops,
                                     resolve_reaction)

Taps = Tuple[Tuple[Tuple[int, ...], float], ...]
Pair = Tuple[str, str]          # (dst, src)

DEFAULT_DOMAINS = {2: (512, 512), 3: (96, 96, 96)}


@dataclasses.dataclass(frozen=True)
class SystemSpec:
    name: str
    ndim: int
    radius: int                                  # max over coupling pairs
    fields: Tuple[str, ...]                      # declaration order
    couplings: Tuple[Tuple[Pair, Taps], ...]     # sorted by (dst, src)
    reaction: Reaction | None
    flops_per_cell: float                        # summed over dst + reaction
    a_gm: float                                  # 2·n_fields (§6.2 lifted)
    domain: Tuple[int, ...]

    @property
    def nfields(self) -> int:
        return len(self.fields)

    @property
    def signature(self) -> tuple:
        """Registry-free caching identity: the coupling structure and the
        reaction, not the system's name — two differently-named systems
        with identical structure share compiled programs."""
        return (self.ndim, self.fields, self.couplings, self.reaction)

    def halo(self, t: int) -> int:
        """Deep-block halo: every field extends ``t·radius`` per side."""
        return self.radius * t

    def taps_into(self, dst: str) -> Tuple[Tuple[str, Taps], ...]:
        """The ``(src, taps)`` couplings feeding field ``dst``."""
        return tuple((src, taps) for (d, src), taps in self.couplings
                     if d == dst)

    def per_field_flops(self) -> dict[str, float]:
        """Per-destination-field flops/cell (2 per tap, reaction spread
        evenly) — the generalized §5 counting model."""
        out = {f: 0.0 for f in self.fields}
        for (dst, _), taps in self.couplings:
            out[dst] += 2.0 * len(taps)
        rx = reaction_flops(self.reaction)
        for f in out:
            out[f] += rx / len(self.fields)
        return out

    def __repr__(self) -> str:
        return (f"SystemSpec({self.name}, fields={list(self.fields)}, "
                f"ndim={self.ndim}, radius={self.radius}, "
                f"couplings={len(self.couplings)}, "
                f"reaction={self.reaction!r})")


# =============================================================== builder ===
def define_system(fields: Sequence[str], couplings, reactions=None, *,
                  name: str | None = None,
                  domain: Tuple[int, ...] | None = None) -> SystemSpec:
    """Build a validated :class:`SystemSpec`.

        from repro_torch.systems import define_system
        sys = define_system(
            fields=["u", "v"],
            couplings={("u", "u"): u_taps, ("v", "v"): v_taps},
            reactions=("gray_scott", {"F": 0.035, "k": 0.065}))

    ``couplings`` maps ``(dst, src)`` field-name pairs to tap sets (any
    mapping or iterable of ``((dst, src), taps)`` pairs).  ``reactions``
    is ``None``, a registered reaction name, ``(name, params)``, or a
    :class:`~repro_torch.systems.reactions.Reaction`.  Every field must be
    the destination of at least one coupling (its update is undefined
    otherwise — feed it an identity coupling ``{(f, f): (((0,)*ndim,
    1.0),)}`` to carry it unchanged into the reaction).
    """
    fields = tuple(str(f) for f in fields)
    if not fields:
        raise ValueError("a system needs at least one field; got none")
    dup = {f for f in fields if fields.count(f) > 1}
    if dup:
        raise ValueError(f"duplicate field name(s) {sorted(dup)}; field "
                         "names must be unique")

    items = list(couplings.items()) if hasattr(couplings, "items") \
        else list(couplings)
    if not items:
        raise ValueError("a system needs at least one coupling; got none "
                         "(couplings={(dst, src): taps, ...})")
    norm: dict[Pair, Taps] = {}
    ndim = None
    for pair, taps in items:
        pair = tuple(pair)
        if len(pair) != 2 or not all(isinstance(p, str) for p in pair):
            raise ValueError(
                f"coupling keys are (dst, src) field-name pairs; got "
                f"{pair!r}")
        dst, src = pair
        for end, role in ((dst, "destination"), (src, "source")):
            if end not in fields:
                raise ValueError(
                    f"coupling ({dst!r}, {src!r}) has a dangling {role} "
                    f"{end!r} — not one of the declared fields "
                    f"{list(fields)}")
        if pair in norm:
            raise ValueError(
                f"duplicate coupling ({dst!r}, {src!r}); merge the tap "
                "sets into one coupling per (dst, src) pair")
        taps = tuple((tuple(int(o) for o in off), float(c))
                     for off, c in taps)
        nd, _ = validate_taps(taps, min_radius=0)
        if ndim is None:
            ndim = nd
        elif nd != ndim:
            raise ValueError(
                f"coupling ({dst!r}, {src!r}) has {nd}-D offsets but the "
                f"system is {ndim}-D — every coupling must share one "
                "dimensionality")
        norm[pair] = taps

    uncovered = [f for f in fields if not any(d == f for d, _ in norm)]
    if uncovered:
        raise ValueError(
            f"field(s) {uncovered} are the destination of no coupling, so "
            "their update is undefined; add an identity self-coupling "
            "{(f, f): (((0,)*ndim, 1.0),)} to carry them into the "
            "reaction")

    radius = max(taps_radius(t) for t in norm.values())
    if radius < 1:
        raise ValueError(
            "system radius is 0 (every coupling is identity-only); "
            "temporal blocking needs at least one spatial tap somewhere "
            "(radius >= 1)")
    assert radius <= MAX_RADIUS     # per-pair validate_taps enforced it

    if reactions is None or isinstance(reactions, Reaction):
        reaction = reactions
    elif isinstance(reactions, str):
        reaction = Reaction.make(reactions)
    else:
        rname, params = reactions
        reaction = Reaction.make(rname, params)
    resolve_reaction(reaction)      # unknown names refused at define time

    flops = (sum(2.0 * len(t) for t in norm.values())
             + reaction_flops(reaction))
    spec = SystemSpec(
        name=name or f"sys{ndim}d{len(fields)}f",
        ndim=ndim, radius=radius, fields=fields,
        couplings=tuple(sorted(norm.items())),
        reaction=reaction, flops_per_cell=flops,
        a_gm=2.0 * len(fields),
        domain=tuple(domain) if domain is not None else DEFAULT_DOMAINS[ndim])
    return spec


# ========================================================= JSON round-trip ==
def system_to_json(spec: SystemSpec) -> dict:
    """A JSON-safe dict that :func:`system_from_json` rebuilds exactly
    (field order, per-pair taps, reaction by registered name)."""
    return {
        "name": spec.name,
        "fields": list(spec.fields),
        "couplings": [[dst, src, [[list(off), c] for off, c in taps]]
                      for (dst, src), taps in spec.couplings],
        "reaction": (None if spec.reaction is None else
                     {"name": spec.reaction.name,
                      "params": spec.reaction.as_dict()}),
        "domain": list(spec.domain),
    }


def system_from_json(source) -> SystemSpec:
    """Rebuild a :class:`SystemSpec` from :func:`system_to_json` output
    (a dict, a JSON string, or a path to a JSON file).

        spec2 = system_from_json(system_to_json(spec))
        assert spec2.signature == spec.signature
    """
    if isinstance(source, str):
        if source.lstrip().startswith("{"):
            obj = json.loads(source)
        else:
            with open(source) as f:
                obj = json.load(f)
    else:
        obj = dict(source)
    if "fields" not in obj or "couplings" not in obj:
        raise ValueError(
            "system JSON needs 'fields' and 'couplings' keys — see "
            "repro_torch.systems.system_to_json for the schema")
    couplings = {}
    for entry in obj["couplings"]:
        if len(entry) != 3:
            raise ValueError(
                f"each coupling entry is [dst, src, taps]; got {entry!r}")
        dst, src, taps = entry
        couplings[(dst, src)] = tuple(
            (tuple(int(o) for o in off), float(c)) for off, c in taps)
    rx = obj.get("reaction")
    reactions = None if rx is None else (rx["name"], rx.get("params", {}))
    kw = {}
    if "domain" in obj:
        kw["domain"] = tuple(int(d) for d in obj["domain"])
    return define_system(obj["fields"], couplings, reactions,
                         name=obj.get("name"), **kw)
