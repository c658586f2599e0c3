"""The program's leftovers of the port (``StencilProgram.run_batched`` and
``.run_padded``) against the reference package.

Every program here is compiled with ``device="cpu"``, so each sweep runs
the kernel's plain version; on the card the same chain launches one
kernel per sweep for the whole batch (``tests/test_torch_cuda.py``).
The fields are numpy-seeded and handed to both packages: the batched
chain must equal a loop of the port's own ``.run`` bit for bit, and the
reference's ``run_batched`` (its vmapped chain, Pallas interpret mode)
within its suite's 2e-5.  ``run_padded`` mirrors the reference's
``tests/test_program.py`` (the padded carry equals ``.run``, and every
refusal).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Boundary as RefBoundary
from repro.api import compile_stencil as jax_compile
from repro.core import stencil_spec as ref_spec
from repro_torch.api import Boundary, compile_stencil
from repro_torch.core import stencil_spec as tspec
from repro_torch.kernels import stencil2d as st
from repro_torch.kernels import stencil3d as st3

TOL = 2e-5
# (name, domain): the 2-D and 3-D Table-2 stencils of the matrix
CASES = [("j2d5pt", (23, 29)), ("j2d9pt", (21, 18)), ("j3d7pt", (6, 5, 7))]
BOUNDARIES = {"dirichlet0": ("dirichlet", 0.0),
              "periodic": ("periodic", 0.0),
              "neumann": ("neumann", 0.0)}


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny tensors: torch's default intra-op threads only oversubscribe
    the CPU the other test workers share."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def fields(shape, batch=2, seed=0):
    return np.random.default_rng(seed).random((batch,) + shape,
                                              dtype=np.float32)


@pytest.mark.parametrize("name,shape", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("t", [1, 2, 4])
@pytest.mark.parametrize("bkey", list(BOUNDARIES))
def test_run_batched_matches_loop_and_reference(name, shape, t, bkey):
    """A batch through one chain == a loop of ``.run`` (bit for bit),
    and the reference's vmapped ``run_batched`` within 2e-5; a remainder
    sweep when ``t > 1``."""
    kind, value = BOUNDARIES[bkey]
    xs = fields(shape, seed=t)
    prog = compile_stencil(tspec.get(name), shape, t=t,
                           boundary=Boundary(kind, value), device="cpu")
    total = 2 * t + 1
    got = prog.run_batched(torch.from_numpy(xs), total)
    assert got.shape == xs.shape and got.dtype == torch.float32
    for i in range(len(xs)):
        assert torch.equal(got[i], prog.run(torch.from_numpy(xs[i]), total))
    ref = jax_compile(ref_spec.get(name), shape, t=t,
                      boundary=RefBoundary(kind, value), interpret=True)
    want = np.asarray(ref.run_batched(jnp.asarray(xs), total))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


@pytest.fixture
def fresh_chains():
    """Chains are memoized per program: drop them before and after, so a
    patched sweep takes part and leaves no chain behind."""
    from repro_torch.api.program import RUNNER_CACHE
    RUNNER_CACHE.clear()
    yield
    RUNNER_CACHE.clear()


def test_run_batched_one_sweep_per_schedule_entry(monkeypatch, fresh_chains):
    """The batch rides the sweeps: each sweep of the schedule is one call
    of the padded sweep with the batch axis on its buffers (one launch on
    the card), whatever the batch."""
    for name, shape, wrapper in (("j2d5pt", (23, 29), st),
                                 ("j3d7pt", (9, 8, 11), st3)):
        fn = "ebisu2d_padded" if wrapper is st else "ebisu3d_padded"
        calls = []
        real = getattr(wrapper, fn)

        def counted(xp, *a, real=real, **kw):
            calls.append(tuple(xp.shape))
            return real(xp, *a, **kw)

        monkeypatch.setattr("repro_torch.api.program." + fn, counted)
        prog = compile_stencil(tspec.get(name), shape, t=3, device="cpu")
        prog.run_batched(torch.from_numpy(fields(shape, batch=3)), 7)
        assert len(calls) == 3                     # sweeps of 3, 3, 1
        assert all(c[0] == 3 and len(c) == len(shape) + 1 for c in calls)


def test_run_batched_defaults_and_refusals():
    shape = (23, 29)
    prog = compile_stencil(tspec.get("j2d5pt"), shape, t=2, device="cpu")
    xs = torch.from_numpy(fields(shape))
    assert torch.equal(prog.run_batched(xs), prog.run_batched(xs, prog.t))
    assert prog.run_batched(xs, 0) is xs
    with pytest.raises(ValueError, match="compiled for shape"):
        prog.run_batched(xs[0])                    # missing batch axis
    with pytest.raises(ValueError, match="compiled for shape"):
        prog.run_batched(torch.zeros((2, 23, 30)))  # wrong trailing shape
    stream = compile_stencil(tspec.get("j2d5pt"), shape, t=2, mode="stream",
                             device="cpu")
    with pytest.raises(ValueError, match="use apply"):
        stream.run_batched(xs, 4)
    p3 = compile_stencil(tspec.get("j3d7pt"), (9, 8, 11), t=2,
                         device="cpu")
    with pytest.raises(ValueError, match="compiled for shape"):
        p3.run_batched(torch.zeros((9, 8, 11)))


def test_run_batched_bf16_storage_and_f64():
    """The dtype policy holds on the batch axis: bf16 storage steps in
    f32 and comes back bf16; f64 computes in f64."""
    shape = (21, 18)
    xs = torch.from_numpy(fields(shape))
    for dtype in (torch.bfloat16, torch.float64):
        prog = compile_stencil(tspec.get("j2d9pt"), shape, t=2, dtype=dtype,
                               device="cpu")
        got = prog.run_batched(xs.to(dtype), 5)
        assert got.dtype == dtype
        for i in range(len(xs)):
            assert torch.equal(got[i], prog.run(xs[i].to(dtype), 5))


# ------------------------------------------------------------ run_padded --
def test_run_padded_carry_matches_run():
    """The reference's ``test_run_padded_donated_carry_matches_run``: the
    caller's padded buffer, chained, equals ``.run`` on the domain."""
    spec = tspec.get("j2d5pt")
    shape = (45, 70)
    x = torch.from_numpy(np.random.default_rng(3).random(shape,
                                                         dtype=np.float32))
    prog = compile_stencil(spec, shape, t=3, device="cpu")
    bh, bw = prog.geometry()["block"]
    hp, wp = st.padded_shape_2d(spec, 3, bh, bw, *shape)
    assert prog.padded_shape == (hp, wp)
    xp = torch.zeros((hp, wp))
    xp[:shape[0], :shape[1]] = x
    out = prog.run_padded(xp, 9)
    assert out.shape == (hp, wp)
    torch.testing.assert_close(out[:shape[0], :shape[1]], prog.run(x, 9),
                               atol=0, rtol=0)
    assert not out[shape[0]:].any() and not out[:, shape[1]:].any()
    ref = jax_compile(ref_spec.get("j2d5pt"), shape, t=3, interpret=True)
    want = np.asarray(ref.run(jnp.asarray(x.numpy()), 9))
    np.testing.assert_allclose(out[:shape[0], :shape[1]].numpy(), want,
                               atol=TOL, rtol=TOL)
    xp0 = torch.zeros((hp, wp))
    assert prog.run_padded(xp0, 0) is xp0


def test_run_padded_refusals():
    """Each refusal of the reference's ``run_padded`` (and the shape and
    divisibility its jitted chain asserts), with its message."""
    shape = (45, 70)
    prog = compile_stencil(tspec.get("j2d5pt"), shape, t=3, device="cpu")
    xp = torch.zeros(prog.padded_shape)
    p3 = compile_stencil(tspec.get("j3d7pt"), (12, 9, 11), t=2,
                         device="cpu")
    with pytest.raises(ValueError, match="padded-carry"):
        p3.run_padded(xp, 4)
    stream = compile_stencil(tspec.get("j2d5pt"), (32, 32), t=2,
                             mode="stream", device="cpu")
    with pytest.raises(ValueError, match="padded-carry"):
        stream.run_padded(torch.zeros((64, 128)), 4)
    periodic = compile_stencil(tspec.get("j2d5pt"), shape, t=3,
                               boundary=Boundary.periodic(), device="cpu")
    with pytest.raises(ValueError, match="padded-carry"):
        periodic.run_padded(xp, 3)
    with pytest.raises(ValueError, match="compute buffer"):
        prog.run_padded(xp.double(), 3)
    with pytest.raises(ValueError, match="padded_shape"):
        prog.run_padded(torch.zeros(shape), 3)
    with pytest.raises(ValueError, match="uniform sweep depth"):
        prog.run_padded(xp, 4)
    with pytest.raises(ValueError, match="carry is on meta"):
        prog.run_padded(torch.zeros(prog.padded_shape, device="meta"), 3)
