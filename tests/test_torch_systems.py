"""Coupled multi-field systems of the port (``repro_torch.systems``) against
the reference's (``repro.systems``), mirroring ``tests/test_systems.py``:
the three shipped systems across the boundary × depth matrix, batched and
lockstep runs, the fused chain equal to lockstep, signature cache-keying,
the JSON round trip and ``spec_from_json`` dispatch, the cost model, and
the structural refusals.

Every field is numpy-seeded and handed to both packages; the port's
programs compute in plain torch on the CPU here (the fields' device).
Tolerance: 2e-5, the reference suite's own.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Boundary as RefBoundary
from repro.api import spec_from_json as ref_spec_from_json
from repro.systems import compile_system as ref_compile
from repro.systems import get_system as ref_get
from repro.systems import system_to_json as ref_to_json
from repro_torch.api import Boundary, spec_from_json
from repro_torch.core import roofline as trl
from repro_torch.systems import (SystemSpec, compile_system, define_system,
                                 get_system, system_from_json, system_names,
                                 system_to_json)
from repro_torch.systems import program as sprog

SHAPE = (28, 24)
SYSTEM_NAMES = ("gray-scott", "fdtd-acoustic", "advection-diffusion")
BOUNDARIES = {"periodic": ("periodic", 0.0), "neumann": ("neumann", 0.0),
              "dirichlet": ("dirichlet", 0.3)}
TOL = 2e-5

IDENT = (((0, 0), 1.0),)
LAP01 = (((0, 0), 0.6), ((0, 1), 0.1), ((0, -1), 0.1),
         ((1, 0), 0.1), ((-1, 0), 0.1))


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny tensors: torch's default intra-op threads only oversubscribe
    the CPU the other test workers share."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def arrays(fields, shape=SHAPE, seed=0, batch=None):
    rng = np.random.default_rng(seed)
    shp = shape if batch is None else (batch,) + shape
    return {f: rng.uniform(0.2, 0.8, shp).astype(np.float32) for f in fields}


def as_torch(arrs):
    return {f: torch.from_numpy(v) for f, v in arrs.items()}


def as_jax(arrs):
    return {f: jnp.asarray(v) for f, v in arrs.items()}


def assert_fields_close(got, want, fields, tol=TOL):
    for f in fields:
        np.testing.assert_allclose(np.asarray(got[f]), np.asarray(want[f]),
                                   atol=tol, rtol=tol, err_msg=f)


@pytest.mark.parametrize("bkey", list(BOUNDARIES))
@pytest.mark.parametrize("t", [1, 2, 4])
@pytest.mark.parametrize("name", SYSTEM_NAMES)
def test_system_run_matches_reference(name, t, bkey):
    """The three systems × t ∈ {1, 2, 4} × {periodic, neumann, dirichlet}:
    the port's fused chain (remainder sweep included) against the
    reference's ``SystemProgram.run``."""
    kind, value = BOUNDARIES[bkey]
    spec = get_system(name)
    arrs = arrays(spec.fields, seed=t)
    total = 2 * t + 1
    got = compile_system(spec, SHAPE, t=t,
                         boundary=Boundary(kind, value)).run(as_torch(arrs),
                                                             total)
    want = ref_compile(ref_get(name), SHAPE, t=t,
                       boundary=RefBoundary(kind, value)).run(as_jax(arrs),
                                                              total)
    assert all(got[f].dtype == torch.float32 for f in spec.fields)
    assert_fields_close(got, want, spec.fields)


@pytest.mark.parametrize("name", SYSTEM_NAMES)
def test_batched_and_lockstep_match_reference(name):
    """``run_batched`` against the reference's and against a loop of the
    port's ``.run`` (equal), ``run_lockstep`` against the reference's,
    and the fused chain against lockstep."""
    spec = get_system(name)
    b = Boundary.neumann()
    prog = compile_system(spec, SHAPE, t=3, boundary=b)
    ref = ref_compile(ref_get(name), SHAPE, t=3,
                      boundary=RefBoundary("neumann"))
    batch = arrays(spec.fields, seed=4, batch=2)
    got = prog.run_batched(as_torch(batch), 7)
    assert_fields_close(got, ref.run_batched(as_jax(batch), 7), spec.fields)
    for i in range(2):
        one = prog.run({f: torch.from_numpy(v[i]) for f, v in batch.items()},
                       7)
        for f in spec.fields:
            assert torch.equal(got[f][i], one[f])
    arrs = arrays(spec.fields, seed=5)
    lock = prog.run_lockstep(as_torch(arrs), 5)
    assert_fields_close(lock, ref.run_lockstep(as_jax(arrs), 5), spec.fields)
    for boundary in (Boundary.periodic(), Boundary.neumann()):
        p = compile_system(spec, SHAPE, t=4, boundary=boundary)
        assert_fields_close(p.run(as_torch(arrs), 8),
                            p.run_lockstep(as_torch(arrs), 8), spec.fields)


def test_apply_defaults_and_identity():
    spec = get_system("gray-scott")
    prog = compile_system(spec, SHAPE, t=3, boundary=Boundary.periodic())
    f0 = as_torch(arrays(spec.fields))
    a, r = prog.apply(f0), prog.run(f0, 3)
    for f in spec.fields:
        assert torch.equal(a[f], r[f])
    assert prog.run(f0, 0)["u"] is f0["u"]
    fb = as_torch(arrays(spec.fields, batch=2))
    assert prog.run_batched(fb, 0)["v"] is fb["v"]
    d = prog.run_batched(fb)                  # total_t defaults to t
    for f in spec.fields:
        assert torch.equal(d[f], prog.run_batched(fb, 3)[f])
    with pytest.raises(ValueError, match="depth must be >= 1"):
        prog.apply(f0, t=0)
    f64 = compile_system(spec, SHAPE, t=2, dtype=torch.float64)
    out = f64.run({f: v.double() for f, v in f0.items()}, 3)
    assert out["u"].dtype == torch.float64


def test_signature_cache_keying():
    """Programs are memoized on the system *signature*, as in the
    reference: renamed systems share a program; couplings, reaction
    params, depth and boundary split the key; the JSON round trip keeps
    it."""
    gs = get_system("gray-scott")
    renamed = SystemSpec(**{**gs.__dict__, "name": "my-gs"})
    a = compile_system(gs, SHAPE, t=2)
    assert compile_system(renamed, SHAPE, t=2) is a
    assert compile_system(gs, SHAPE, t=3) is not a
    assert compile_system(gs, SHAPE, t=2,
                          boundary=Boundary.periodic()) is not a
    assert compile_system(gs, SHAPE, t=2, dtype=torch.float64) is not a
    tweaked = get_system("gray-scott", F=0.04)
    assert tweaked.signature != gs.signature
    assert compile_system(tweaked, SHAPE, t=2) is not a
    rt = system_from_json(system_to_json(gs))
    assert rt.signature == gs.signature
    assert compile_system(rt, SHAPE, t=2) is a
    stats = a.cache_stats()
    assert {"system_programs", "system_runners"} <= set(stats)
    assert stats["system_programs"]["hits"] >= 2


@pytest.mark.parametrize("name", SYSTEM_NAMES)
def test_json_round_trip_and_dispatch(name):
    """The port's JSON is the reference's, both ways, and
    ``spec_from_json`` dispatches a ``"fields"`` object to the systems."""
    spec = get_system(name)
    obj = system_to_json(spec)
    assert obj == ref_to_json(ref_get(name))
    rt = system_from_json(obj)
    assert rt.signature == spec.signature
    assert (rt.name, rt.fields, rt.domain) == (spec.name, spec.fields,
                                               spec.domain)
    got = spec_from_json(obj)
    assert isinstance(got, SystemSpec) and got.signature == spec.signature
    assert got.fields == ref_spec_from_json(obj).fields
    with pytest.raises(ValueError, match="'fields' and 'couplings'"):
        system_from_json({"fields": ["u"]})


def structure(spec):
    """A system's signature with its reaction as plain values (the two
    packages' ``Reaction`` classes differ)."""
    rx = spec.reaction
    return spec.signature[:3] + ((rx.name, rx.params) if rx else None,)


def test_library_and_cost_model():
    """The spec layer and the cost model equal the reference's."""
    assert system_names() == sorted(SYSTEM_NAMES)
    with pytest.raises(KeyError, match="unknown system"):
        get_system("navier-stokes")
    for name in SYSTEM_NAMES:
        mine, ref = get_system(name), ref_get(name)
        assert (structure(mine), mine.radius, mine.flops_per_cell,
                mine.a_gm, mine.per_field_flops()) == (
            structure(ref), ref.radius, ref.flops_per_cell, ref.a_gm,
            ref.per_field_flops())
        c = compile_system(mine, SHAPE, t=2).cost()
        rc = ref_compile(ref, SHAPE, t=2).cost()
        assert c == rc
    gs = get_system("gray-scott")
    c = compile_system(gs, SHAPE, t=2).cost()
    assert c["hbm_bytes_per_step"] == 4.0 * SHAPE[0] * SHAPE[1] * 4
    assert trl.H100.s_cell == 4


def test_refusals():
    """The reference's structural refusals, message for message."""
    with pytest.raises(ValueError, match="dangling source 'w'"):
        define_system(["u"], {("u", "w"): LAP01})
    with pytest.raises(ValueError, match="dangling destination 'w'"):
        define_system(["u"], {("w", "u"): LAP01})
    with pytest.raises(ValueError, match="duplicate field"):
        define_system(["u", "u"], {("u", "u"): LAP01})
    with pytest.raises(ValueError, match="destination of no coupling"):
        define_system(["u", "v"], {("u", "u"): LAP01})
    with pytest.raises(ValueError, match="radius is 0"):
        define_system(["u", "v"], {("u", "v"): IDENT, ("v", "u"): IDENT,
                                   ("u", "u"): IDENT, ("v", "v"): IDENT})
    far = (((0, 0), 0.5), ((0, 9), 0.5))
    with pytest.raises(ValueError, match="radius 9 exceeds"):
        define_system(["u"], {("u", "u"): far})
    with pytest.raises(ValueError, match="unknown reaction 'nope'"):
        define_system(["u"], {("u", "u"): LAP01}, reactions="nope")
    spec = get_system("gray-scott")
    prog = compile_system(spec, SHAPE, t=1)
    f0 = as_torch(arrays(spec.fields))
    with pytest.raises(ValueError, match="every field shares one domain"):
        prog.run(dict(f0, v=torch.zeros((8, 8))), 2)
    with pytest.raises(ValueError, match="every field shares one domain"):
        prog.run_batched(f0, 2)                    # missing batch axis
    with pytest.raises(ValueError, match="has fields"):
        prog.run({"u": f0["u"]}, 2)
    with pytest.raises(ValueError, match="several devices"):
        prog.run(dict(f0, v=torch.zeros(SHAPE, device="meta")), 2)
    lap3 = (((0, 0, 0), 0.5), ((0, 0, 1), 0.25), ((0, 0, -1), 0.25))
    with pytest.raises(ValueError, match="share one dimensionality"):
        define_system(["u", "v"], {("u", "u"): LAP01, ("v", "v"): lap3})
    with pytest.raises(ValueError, match="halo would cover"):
        compile_system(spec, (3, 3), t=1)
    with pytest.raises(ValueError, match="is 2-D"):
        compile_system(spec, (16, 16, 16), t=1)
    with pytest.raises(ValueError, match="depth must be >= 1"):
        compile_system(spec, SHAPE, t=0)
    with pytest.raises(ValueError, match="compute_dtype"):
        compile_system(spec, SHAPE, t=1, dtype=torch.float16,
                       compute_dtype=torch.float16)


def test_radius_zero_cross_coupling_and_numpy_fields(monkeypatch):
    """Identity-only couplings are legitimate while the system radius
    clears 1 (the reference's case); and fields that are not tensors go
    to the card, so without one the program refuses them, as the port's
    front doors do."""
    taps = {("u", "u"): LAP01, ("u", "v"): (((0, 0), 0.05),),
            ("v", "v"): IDENT, ("v", "u"): (((0, 0), -0.05),)}
    spec = define_system(["u", "v"], taps)
    assert spec.radius == 1
    from repro.systems import define_system as ref_define
    ref = ref_compile(ref_define(["u", "v"], taps), SHAPE, t=2,
                      boundary=RefBoundary("neumann"))
    arrs = arrays(spec.fields, seed=9)
    got = compile_system(spec, SHAPE, t=2,
                         boundary=Boundary.neumann()).run(as_torch(arrs), 4)
    assert_fields_close(got, ref.run(as_jax(arrs), 4), spec.fields)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        compile_system(spec, SHAPE, t=2).run(arrs, 1)


def test_system_step_reaction_must_cover_every_field():
    from repro_torch.systems.reactions import Reaction, register_reaction

    @register_reaction("drops_v_port_test")
    def _drops_v():
        return lambda lin, prev: {"u": lin["u"]}

    try:
        spec = define_system(["u", "v"], {("u", "u"): LAP01,
                                          ("v", "v"): LAP01},
                             reactions=Reaction.make("drops_v_port_test"))
        prog = compile_system(spec, SHAPE, t=1)
        with pytest.raises(ValueError, match="returned no value"):
            prog.run(as_torch(arrays(spec.fields)), 1)
    finally:
        from repro_torch.systems.reactions import REACTIONS
        REACTIONS.pop("drops_v_port_test", None)
        sprog.clear_system_caches()
