"""The 3-D half of the port's front door (``compile_stencil`` →
``StencilProgram.apply`` / ``.run`` for the 3-D Table-2 stencils) and the
2-D ``mode="stream"`` sweep, against the reference package.

Every program here is compiled with ``device="cpu"``, so each sweep runs
the z-streaming kernel's plain version; the fields are numpy-seeded and
handed to both packages.  The oracle is the reference's
``repro.kernels.ref.reference_unrolled``; three cases also go through
the reference's own ``compile_stencil`` (Pallas interpret mode).
Tolerances are the reference suite's: 2e-5 for f32, 0.06 for bf16
storage.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import compile_stencil as jax_compile
from repro.api.boundary import Boundary as RefBoundary
from repro.core import stencil_spec as ref_spec
from repro.kernels import ref as jref
from repro_torch.api import Boundary, compile_stencil, program
from repro_torch.core import stencil_spec as tspec
from repro_torch.kernels import stencil3d as st3
from repro_torch.launch import stencil_run

SPECS_3D = [n for n, s in tspec.TABLE2.items() if s.ndim == 3]
SPECS_2D = [n for n, s in tspec.TABLE2.items() if s.ndim == 2]
BOUNDARIES = {
    "dirichlet0": ("dirichlet", 0.0),
    "dirichlet0.7": ("dirichlet", 0.7),
    "periodic": ("periodic", 0.0),
    "reflect": ("reflect", 0.0),
    "neumann": ("neumann", 0.0),
}
SHAPE = (19, 13, 21)


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny tensors: torch's default intra-op threads only oversubscribe
    the CPU the other test workers share."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def field(shape=SHAPE, seed=0):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def jax_reference(x, name, steps, kind="dirichlet", value=0.0):
    return np.asarray(jref.reference_unrolled(
        jnp.asarray(x), ref_spec.get(name), steps,
        boundary=RefBoundary(kind, value)))


@pytest.mark.parametrize("name", SPECS_3D)
@pytest.mark.parametrize("t", [1, 2, 3])
def test_apply_and_run_match_reference(name, t):
    prog = compile_stencil(tspec.get(name), SHAPE, t=t, device="cpu")
    x = field(seed=t)
    total = 2 * t + 1                       # remainder sweep when t > 1
    y1 = prog.apply(torch.from_numpy(x))
    yT = prog.run(torch.from_numpy(x), total)
    assert y1.dtype == torch.float32 and tuple(yT.shape) == SHAPE
    np.testing.assert_allclose(y1.numpy(), jax_reference(x, name, t),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(yT.numpy(), jax_reference(x, name, total),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("name", ["j3d7pt", "j3d27pt"])
@pytest.mark.parametrize("bkey", list(BOUNDARIES))
def test_boundaries_match_reference(name, bkey):
    kind, value = BOUNDARIES[bkey]
    prog = compile_stencil(tspec.get(name), SHAPE, t=2,
                           boundary=Boundary(kind, value), device="cpu")
    x = field(seed=5)
    y1 = prog.apply(torch.from_numpy(x))
    yT = prog.run(torch.from_numpy(x), 5)
    np.testing.assert_allclose(y1.numpy(),
                               jax_reference(x, name, 2, kind, value),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(yT.numpy(),
                               jax_reference(x, name, 5, kind, value),
                               atol=2e-5, rtol=2e-5)


def test_bf16_storage():
    xb = torch.from_numpy(field(seed=2)).to(torch.bfloat16)
    prog = compile_stencil(tspec.get("j3d17pt"), SHAPE, t=3,
                           dtype=torch.bfloat16, device="cpu")
    assert prog.compute_dtype == torch.float32
    yT = prog.run(xb, 7)
    assert yT.dtype == torch.bfloat16
    np.testing.assert_allclose(
        yT.float().numpy(), jax_reference(xb.float().numpy(), "j3d17pt", 7),
        atol=0.06, rtol=0.06)


def test_f64_compute():
    """Against plain float64 numpy steps, independent of both packages'
    tap engines."""
    x = field(seed=4).astype(np.float64)
    spec = tspec.get("poisson")
    prog = compile_stencil(spec, SHAPE, t=3, dtype=torch.float64,
                           device="cpu")
    got = prog.run(torch.from_numpy(x), 7)
    assert got.dtype == torch.float64
    want = x
    for _ in range(7):
        xp = np.pad(want, 1)
        want = sum(c * xp[1 + dz:1 + dz + SHAPE[0], 1 + dy:1 + dy + SHAPE[1],
                          1 + dx:1 + dx + SHAPE[2]]
                   for (dz, dy, dx), c in spec.taps)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12, rtol=1e-12)


@pytest.mark.parametrize("name,call", [("j3d7pt", "run"),
                                       ("j3d27pt", "apply")])
def test_matches_reference_program(name, call):
    """The reference's own compiled 3-D program (Pallas streaming
    kernel, interpret mode) and the port's: one star, one box."""
    x = field((12, 10, 16), seed=9)
    ref_prog = jax_compile(ref_spec.get(name), x.shape, t=2)
    mine = compile_stencil(tspec.get(name), x.shape, t=2, device="cpu")
    if call == "run":
        want, got = ref_prog.run(jnp.asarray(x), 5), mine.run(
            torch.from_numpy(x), 5)
    else:
        want, got = ref_prog.apply(jnp.asarray(x)), mine.apply(
            torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_stream_apply_matches_reference_program():
    """``mode="stream"`` on both sides: the reference's lifted Pallas
    streaming sweep (interpret mode) and the port's."""
    x = field((16, 24), seed=3)
    want = jax_compile(ref_spec.get("j2d9pt"), x.shape, t=2,
                       mode="stream").apply(jnp.asarray(x))
    prog = compile_stencil(tspec.get("j2d9pt"), x.shape, t=2,
                           mode="stream", device="cpu")
    np.testing.assert_allclose(prog.apply(torch.from_numpy(x)).numpy(),
                               np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("name", SPECS_2D)
@pytest.mark.parametrize("bkey", ["dirichlet0", "periodic"])
def test_stream_apply_matches_reference(name, bkey):
    kind, value = BOUNDARIES[bkey]
    x = field((37, 53), seed=7)
    prog = compile_stencil(tspec.get(name), x.shape, t=3, mode="stream",
                           boundary=Boundary(kind, value), device="cpu")
    y = prog.apply(torch.from_numpy(x))
    assert tuple(y.shape) == x.shape
    np.testing.assert_allclose(y.numpy(),
                               jax_reference(x, name, 3, kind, value),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("bkey", ["dirichlet0.7", "reflect", "neumann"])
def test_stream_apply_resolves_the_boundary_before_lifting(bkey):
    kind, value = BOUNDARIES[bkey]
    x = field((37, 53), seed=8)
    prog = compile_stencil(tspec.get("j2d5pt"), x.shape, t=4, mode="stream",
                           boundary=Boundary(kind, value), device="cpu")
    g = prog.geometry()
    assert g["padded"][1] == 1 and g["tiled"][1] is False
    np.testing.assert_allclose(prog.apply(torch.from_numpy(x)).numpy(),
                               jax_reference(x, "j2d5pt", 4, kind, value),
                               atol=2e-5, rtol=2e-5)


def test_stream_refusals():
    prog = compile_stencil(tspec.get("j2d5pt"), (37, 53), t=2,
                           mode="stream", device="cpu")
    with pytest.raises(ValueError, match="use apply"):
        prog.run(torch.zeros((37, 53)), 4)
    with pytest.raises(ValueError, match="3-D"):
        compile_stencil(tspec.get("j3d7pt"), SHAPE, mode="stream",
                        device="cpu")
    with pytest.raises(ValueError, match="3-D"):
        compile_stencil(tspec.get("j3d7pt"), (19, 13), device="cpu")
    with pytest.raises(ValueError, match="EbisuPlan, None or 'auto'"):
        compile_stencil(tspec.get("j3d7pt"), SHAPE, plan="request",
                        device="cpu")


def test_run_counts_one_sweep_per_schedule_entry(monkeypatch):
    """``run(x, 2t+1)`` is sweeps of depth t, t, 1 — three calls of the
    padded 3-D sweep, over two ping-pong buffers."""
    calls = []
    real = st3.ebisu3d_padded

    def spy(xp, spec, t, **kw):
        calls.append((t, xp.data_ptr(), kw["out"].data_ptr()))
        return real(xp, spec, t, **kw)

    monkeypatch.setattr(program, "ebisu3d_padded", spy)
    program.clear_caches()          # chains built earlier hold the real one
    prog = compile_stencil(tspec.get("j3d13pt"), SHAPE, t=2, device="cpu")
    prog.run(torch.from_numpy(field()), 5)
    assert [c[0] for c in calls] == [2, 2, 1]
    assert calls[0][1] == calls[1][2] and calls[0][2] == calls[1][1]


def test_introspection():
    prog = compile_stencil(tspec.get("j3d13pt"), SHAPE, t=2,
                           boundary=Boundary.periodic(), device="cpu")
    assert prog.compute_shape() == (19 + 8, 13 + 8, 21 + 8)
    g = prog.geometry()
    zc, ty, tx = g["block"]
    assert g["halo"] == 4 and g["ring"] == 6
    assert g["padded"][0] % zc == 0 and g["smem_bytes"] <= 232448
    assert prog.cost().pp_cells_per_s > 0 and prog.cost(1).v == 1.0
    assert prog.plan.block[0] >= 1 and len(prog.plan.block) == 3
    fp = prog.fingerprint()
    assert fp["shape"] == list(SHAPE) and fp["mode"] == "fused"
    stream = compile_stencil(tspec.get("j2d5pt"), (37, 53), mode="stream",
                             device="cpu")
    assert len(stream.plan.block) == 3 and stream.geometry()["padded"][1] == 1


def test_cli_3d_on_cpu(capsys):
    stencil_run.main(["--device", "cpu", "--scale", "64", "--stencil",
                      "j3d7pt,poisson", "--boundary", "periodic"])
    out = capsys.readouterr().out.strip().splitlines()
    assert [line.split()[1] for line in out] == ["j3d7pt", "poisson"]
    assert all("maxerr=" in line for line in out)


def test_large_tap_set_runs_like_the_reference():
    """The 343-tap box of radius 3 through ``compile_stencil(...).run``,
    against the reference's own ``compile_stencil(...).run`` (Pallas
    interpret mode) within 2e-5; a remainder sweep included."""
    from repro.api import define as ref_define
    from repro_torch.api import define as tdefine

    spec, rspec = tdefine.box(3, radius=3), ref_define.box(3, radius=3)
    shape = (12, 10, 14)
    x = np.random.default_rng(3).random(shape, dtype=np.float32)
    got = compile_stencil(spec, shape, t=2, device="cpu").run(
        torch.from_numpy(x), 5)
    want = jax_compile(rspec, shape, t=2, interpret=True).run(
        jnp.asarray(x), 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
