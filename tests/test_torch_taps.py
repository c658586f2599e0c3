"""The port's tap engine and oracle (``repro_torch.kernels.taps`` /
``ref``) against the reference's, on the same numpy-seeded fields.

Tolerance 2e-5 (f32), the reference suite's own for stencils: the two
engines sum the taps in the same order, so the gap is rounding only.
The reference oracle is taken as ``reference_unrolled``, its Python-loop
form (the same ``stencil_step`` per step as ``reference``), which saves
a ``fori_loop`` compile per call.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.boundary import Boundary as RefBoundary
from repro.core import stencil_spec as ref_spec
from repro.kernels import ref as jref
from repro.kernels import taps as jtaps
from repro_torch.api.boundary import Boundary
from repro_torch.core import stencil_spec as tspec
from repro_torch.kernels import ref as tref
from repro_torch.kernels import taps as ttaps

SPECS_2D = [n for n, s in tspec.TABLE2.items() if s.ndim == 2]
BOUNDARIES = {
    "dirichlet0": ("dirichlet", 0.0),
    "dirichlet0.7": ("dirichlet", 0.7),
    "periodic": ("periodic", 0.0),
    "reflect": ("reflect", 0.0),
    "neumann": ("neumann", 0.0),
}
TOL = 2e-5


def field(shape, seed=0):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def both(kind, value):
    return Boundary(kind, value), RefBoundary(kind, value)


@pytest.mark.parametrize("name", SPECS_2D)
@pytest.mark.parametrize("t", [1, 2, 4])
@pytest.mark.parametrize("bkey", list(BOUNDARIES))
def test_reference_matches_jax(name, t, bkey):
    tb, jb = both(*BOUNDARIES[bkey])
    x = field((37, 53), seed=t)
    want = np.asarray(jref.reference_unrolled(
        jnp.asarray(x), ref_spec.get(name), t, boundary=jb))
    got = tref.reference(torch.from_numpy(x), tspec.get(name), t,
                         boundary=tb).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


ASYM = [((0, 0), 0.5), ((0, 1), 0.3), ((1, 0), 0.2)]      # sums to 1
UNNORM = [((0, 0), 1.0), ((0, 1), 0.5), ((0, -1), 0.5)]   # sums to 2


@pytest.mark.parametrize("taps,kind,value,t", [
    (ASYM, "reflect", 0.0, 1),
    (ASYM, "neumann", 0.0, 2),
    (UNNORM, "dirichlet", 0.7, 2),
    (tspec.get("j2d5pt").taps, "neumann", 0.3, 2),
])
def test_check_boundary_refuses_what_the_reference_refuses(taps, kind,
                                                           value, t):
    tb, jb = both(kind, value)
    with pytest.raises(ValueError) as je:
        jtaps.check_boundary(tuple(taps), jb, t)
    with pytest.raises(ValueError) as te:
        ttaps.check_boundary(tuple(taps), tb, t)
    assert str(te.value).split(":")[0] == str(je.value).split(":")[0]


@pytest.mark.parametrize("taps,kind,value", [
    (ASYM, "neumann", 0.3),          # t=1 is exact for any taps and flux
    (UNNORM, "dirichlet", 0.7),      # t=1 affine closure, any tap sum
])
def test_depth_one_oracle_matches_jax_where_deeper_chains_refuse(taps, kind,
                                                                  value):
    tb, jb = both(kind, value)
    x = field((20, 23))
    want = np.asarray(jref.reference_unrolled(
        jnp.asarray(x), ref_spec.define_stencil(taps), 3, boundary=jb))
    got = tref.reference(torch.from_numpy(x), tspec.define_stencil(taps), 3,
                         boundary=tb).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kind,value", [("dirichlet", 0.3),
                                        ("periodic", 0.0),
                                        ("reflect", 0.0),
                                        ("neumann", 0.0),
                                        ("neumann", 0.25)])
@pytest.mark.parametrize("halo", [1, 3, 7])
def test_ghost_extend_matches_jax(kind, value, halo):
    """Halo 7 is wider than the 5-cell axis: the fill keeps wrapping or
    mirroring, as ``numpy.pad`` does."""
    tb, jb = both(kind, value)
    x = field((2, 5, 6))
    want = np.asarray(jtaps.ghost_extend(jnp.asarray(x), 2, halo, jb))
    got = ttaps.ghost_extend(torch.from_numpy(x), 2, halo, tb).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", SPECS_2D)
def test_chain_trapezoid_interior_equals_chain(name):
    spec = tspec.get(name)
    eng = ttaps.engine_for(spec.taps, 2)
    x = torch.from_numpy(field((30, 41)))
    t, h = 3, spec.halo(3)
    full = eng.chain(x, t)
    trap = eng.chain_trapezoid(x, t, axes=(0, 1))
    assert trap.shape == (30 - 2 * h, 41 - 2 * h)
    torch.testing.assert_close(trap, full[h:-h, h:-h], atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", SPECS_2D)
def test_engine_step_matches_jax_engine(name):
    x = field((3, 17, 19))
    for crops in (None, (0, 2), (2, 2)):
        want = np.asarray(jtaps.engine_for(ref_spec.get(name).taps, 2).step(
            jnp.asarray(x), crops=crops))
        got = ttaps.engine_for(tspec.get(name).taps, 2).step(
            torch.from_numpy(x), crops=crops).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
