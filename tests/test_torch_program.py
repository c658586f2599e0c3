"""The port's front door (``repro_torch.api.compile_stencil`` →
``StencilProgram.apply`` / ``.run``) against the reference package.

Every program here is compiled with ``device="cpu"``, so each sweep runs
the kernel's plain version; the fields are numpy-seeded and handed to
both packages.  The oracle is the reference's ``repro.kernels.ref``
(``reference_unrolled``: the same steps as ``reference``, one compile
fewer per call);
one case per boundary kind also goes through the reference's own
``compile_stencil(...).run`` (Pallas interpret mode).  Tolerances are the
reference suite's: 2e-5 for f32, 0.06 for bf16 storage.
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
from repro_torch.kernels import stencil2d as st
from repro_torch.launch import stencil_run

SPECS_2D = [n for n, s in tspec.TABLE2.items() if s.ndim == 2]
BOUNDARIES = {
    "dirichlet0": ("dirichlet", 0.0),
    "dirichlet0.7": ("dirichlet", 0.7),
    "periodic": ("periodic", 0.0),
    "reflect": ("reflect", 0.0),
    "neumann": ("neumann", 0.0),
}
SHAPE = (37, 53)


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


@pytest.mark.parametrize("name", SPECS_2D)
@pytest.mark.parametrize("t", [1, 2, 4])
@pytest.mark.parametrize("bkey", list(BOUNDARIES))
def test_apply_and_run_match_reference(name, t, bkey):
    kind, value = BOUNDARIES[bkey]
    prog = compile_stencil(tspec.get(name), SHAPE, t=t,
                           boundary=Boundary(kind, value), device="cpu")
    x = field(seed=t)
    total = 2 * t + 1                       # remainder sweep when t > 1
    y1 = prog.apply(torch.from_numpy(x))
    yT = prog.run(torch.from_numpy(x), total)
    assert y1.dtype == torch.float32 and tuple(yT.shape) == SHAPE
    np.testing.assert_allclose(y1.numpy(),
                               jax_reference(x, name, t, kind, value),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(yT.numpy(),
                               jax_reference(x, name, total, kind, value),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("bkey", list(BOUNDARIES))
def test_run_matches_reference_program(bkey):
    """The reference's own compiled program (Pallas strip kernel, interpret
    mode) and the port's, T=10 at t=4."""
    kind, value = BOUNDARIES[bkey]
    name = "j2d9pt"
    x = field((40, 56), seed=9)
    want = jax_compile(ref_spec.get(name), x.shape, t=4,
                       boundary=RefBoundary(kind, value)).run(
        jnp.asarray(x), 10)
    got = compile_stencil(tspec.get(name), x.shape, t=4,
                          boundary=Boundary(kind, value),
                          device="cpu").run(torch.from_numpy(x), 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("name", SPECS_2D)
def test_bf16_storage(name):
    x = field(seed=2)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    prog = compile_stencil(tspec.get(name), SHAPE, t=4,
                           dtype=torch.bfloat16, device="cpu")
    assert prog.compute_dtype == torch.float32
    y1, yT = prog.apply(xb), prog.run(xb, 10)
    assert y1.dtype == yT.dtype == torch.bfloat16
    xf = xb.float().numpy()
    np.testing.assert_allclose(y1.float().numpy(), jax_reference(xf, name, 4),
                               atol=0.06, rtol=0.06)
    np.testing.assert_allclose(yT.float().numpy(),
                               jax_reference(xf, name, 10), atol=0.06,
                               rtol=0.06)


def numpy_reference_f64(x, taps, steps):
    """Plain float64 zero-Dirichlet steps in numpy, independent of both
    packages' tap engines."""
    rad = max(max(abs(o) for o in off) for off, _ in taps)
    h, w = x.shape
    for _ in range(steps):
        xp = np.pad(x, rad)
        x = sum(c * xp[rad + dy:rad + dy + h, rad + dx:rad + dx + w]
                for (dy, dx), c in taps)
    return x


@pytest.mark.parametrize("name", SPECS_2D)
def test_f64_compute(name):
    x = field(seed=4).astype(np.float64)
    prog = compile_stencil(tspec.get(name), SHAPE, t=4, dtype=torch.float64,
                           device="cpu")
    assert prog.compute_dtype == torch.float64
    got = prog.run(torch.from_numpy(x), 10)
    assert got.dtype == torch.float64
    want = numpy_reference_f64(x, tspec.get(name).taps, 10)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12, rtol=1e-12)


def test_f32_storage_with_f64_compute():
    x = field(seed=6)
    prog = compile_stencil(tspec.get("j2d5pt"), SHAPE, t=3,
                           compute_dtype=torch.float64, device="cpu")
    got = prog.run(torch.from_numpy(x), 7)
    assert got.dtype == torch.float32
    want = numpy_reference_f64(x.astype(np.float64),
                               tspec.get("j2d5pt").taps, 7)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


def test_no_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        compile_stencil(tspec.get("j2d5pt"), SHAPE)


@pytest.mark.parametrize("call,exc,match", [
    # mesh=, run_sharded and the campaigns are ported: these ids now hold
    # the refusals of those paths that remain
    (lambda: compile_stencil(tspec.get("j3d7pt"), (16, 16, 16),
                             device="cpu").run_sharded(
                                 torch.zeros((16, 16, 16)), 4),
     ValueError, "mesh-compiled"),
    (lambda: compile_stencil(tspec.get("j2d5pt"), SHAPE, mode="stream",
                             device="cpu").run_sharded(torch.zeros(SHAPE),
                                                       4),
     ValueError, "mesh-compiled"),
    # mode="tuned" is ported: these ids hold its refusals (t=, mesh=)
    (lambda: compile_stencil(tspec.get("j2d5pt"), SHAPE, mode="tuned", t=2,
                             device="cpu"),
     ValueError, "drop t="),
    (lambda: compile_stencil(tspec.get("j2d5pt"), (36, 53), mode="tuned",
                             mesh=(2, 1), device="cpu"),
     ValueError, "single-device"),
    (lambda: _prog().run_sharded_resumable(torch.zeros(SHAPE), 4,
                                           store=None),
     ValueError, "mesh-compiled"),
    (lambda: _prog().run_resumable(torch.zeros(SHAPE), 4, store=None,
                                   every=0),
     ValueError, "every must be >= 1"),
    # run_batched and run_padded are ported: their ids hold refusals on a
    # 3-D program (neumann under a mesh; plan=None, the deprecated shims'
    # request-default tiles, is ported too: what it still refuses, a
    # plan that is neither an EbisuPlan, None nor "auto")
    (lambda: compile_stencil(tspec.get("j3d7pt"), (16, 16, 16), t=1,
                             mesh=(2, 1), boundary=Boundary.neumann(),
                             device="cpu"),
     ValueError, "does not support neumann"),
    (lambda: compile_stencil(tspec.get("j3d7pt"), (16, 16, 16), plan=(8, 8),
                             device="cpu"),
     ValueError, "EbisuPlan, None or 'auto'"),
], ids=["3d", "stream", "tuned", "mesh", "run_sharded", "run_resumable",
        "run_batched", "run_padded"])
def test_refusals_name_the_roadmap_item(call, exc, match):
    """What the port refuses: nothing names a ROADMAP item any more;
    ``mode="tuned"``, the sharded and campaign paths and ``plan=`` refuse
    what the reference refuses."""
    with pytest.raises(exc, match=match):
        call()


def _prog(**kw):
    return compile_stencil(tspec.get("j2d5pt"), SHAPE, t=2, device="cpu",
                           **kw)


def test_bad_inputs_raise():
    prog = _prog()
    with pytest.raises(ValueError, match="shape"):
        prog.apply(torch.zeros((10, 10)))
    with pytest.raises(ValueError, match="field is on meta"):
        prog.apply(torch.zeros(SHAPE, device="meta"))
    with pytest.raises(ValueError, match="unknown mode"):
        _prog(mode="bogus")
    with pytest.raises(ValueError, match="compute_dtype"):
        _prog(compute_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="normalize"):
        compile_stencil(tspec.define_stencil(
            [((0, 0), 1.0), ((0, 1), 0.5), ((1, 0), 0.5)]), SHAPE, t=2,
            boundary=Boundary.dirichlet(0.5), device="cpu")


def test_numpy_field_and_identity():
    prog = _prog()
    x = field()
    xt = torch.from_numpy(x)
    torch.testing.assert_close(prog.apply(x), prog.apply(xt))
    assert prog.run(xt, 0) is xt


def test_cache_stats_and_memoized_programs():
    program.clear_caches()
    a = _prog()
    b = _prog()
    assert a is b
    s = a.cache_stats()
    assert s["programs"]["hits"] >= 1 and s["programs"]["size"] >= 1
    x = torch.from_numpy(field())
    hits = s["runners"]["hits"]
    a.run(x, 5)
    a.run(x, 5)
    a.apply(x)
    s2 = a.cache_stats()
    assert s2["runners"]["hits"] == hits + 1
    assert s2["runners"]["size"] == 2
    program.clear_caches()
    assert program.cache_stats()["programs"]["size"] == 0


def test_introspection():
    prog = compile_stencil(tspec.get("j2d9pt"), SHAPE, t=3,
                           boundary=Boundary.periodic(), device="cpu")
    g = prog.geometry()
    assert prog.compute_shape() == (37 + 12, 53 + 12)
    bh, bw = g["block"]
    assert g["halo"] == 6 and bw % 32 == 0
    assert g["padded"][0] % bh == 0 and g["padded"][1] % bw == 0
    assert g["padded"][0] >= 49 and g["padded"][1] >= 65
    assert g["fetched_cells"] == (bh + 12) * (bw + 12)
    assert g["smem_bytes"] <= prog.hw.onchip_bytes
    assert prog.cost().pp_cells_per_s > 0 and prog.cost(1).v == 1.0
    fp = prog.fingerprint()
    assert fp["device"] == "cpu" and fp["t"] == 3
    assert fp["boundary"] == "Boundary.periodic()"
    assert "j2d9pt" in repr(prog)


def test_run_counts_one_sweep_per_schedule_entry(monkeypatch):
    """``run(x, 2t+1)`` is sweeps of depth t, t, 1 — three calls of the
    padded sweep, over two ping-pong buffers."""
    calls = []
    real = st.ebisu2d_padded

    def spy(xp, spec, t, **kw):
        calls.append((t, xp.data_ptr(), kw["out"].data_ptr()))
        return real(xp, spec, t, **kw)

    monkeypatch.setattr(program, "ebisu2d_padded", spy)
    prog = compile_stencil(tspec.get("j2d5pt"), (30, 40), t=4, device="cpu")
    prog.run(torch.from_numpy(field((30, 40))), 9)
    assert [c[0] for c in calls] == [4, 4, 1]
    assert calls[0][1] == calls[1][2] and calls[0][2] == calls[1][1]


@pytest.mark.parametrize("depth", [1, 3, 5])
def test_apply_is_one_sweep_of_any_depth(monkeypatch, depth):
    """``apply(x, d)`` is one sweep of depth ``d`` through the program's
    sweep chain, whatever the program's own depth, under a ghost-pinned
    boundary too."""
    calls = []
    real = st.ebisu2d_padded

    def spy(xp, spec, t, **kw):
        calls.append(t)
        return real(xp, spec, t, **kw)

    monkeypatch.setattr(program, "ebisu2d_padded", spy)
    prog = compile_stencil(tspec.get("j2d9pt"), SHAPE, t=2,
                           boundary=Boundary.reflect(), device="cpu")
    x = field(seed=depth)
    y = prog.apply(torch.from_numpy(x), t=depth)
    assert calls == [depth]
    np.testing.assert_allclose(y.numpy(),
                               jax_reference(x, "j2d9pt", depth, "reflect"),
                               atol=2e-5, rtol=2e-5)


def test_apply_refuses_a_depth_the_boundary_cannot_run():
    """Dirichlet(v != 0) with an unnormalized tap set is exact at depth 1
    only: the program compiles at t=1 and refuses a deeper sweep."""
    spec = tspec.define_stencil([((0, 0), 0.5), ((0, 1), 0.2),
                                 ((1, 0), 0.2)])
    prog = compile_stencil(spec, SHAPE, t=1,
                           boundary=Boundary.dirichlet(0.7), device="cpu")
    x = torch.from_numpy(field())
    prog.apply(x)
    with pytest.raises(ValueError, match="t=2"):
        prog.apply(x, t=2)


def test_cli_on_cpu(capsys):
    stencil_run.main(["--device", "cpu", "--scale", "64"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == len(tspec.TABLE2)              # 2-D and 3-D
    for line, name in zip(out, tspec.TABLE2):
        assert line.startswith(f"[stencil] {name}") and "maxerr=" in line
    stencil_run.main(["--device", "cpu", "--scale", "128", "--stencil",
                      "j2d5pt", "--t", "9", "--boundary", "periodic"])
    assert "run(T=9" in capsys.readouterr().out


@pytest.mark.parametrize("kind,radius", [("box", 6), ("blur", 8)],
                         ids=["box-r6-169taps", "blur-r8-289taps"])
def test_large_tap_sets_run_like_the_reference(kind, radius):
    """The 2-D sets past the 128 taps of earlier libraries (169 and 289
    taps) through ``compile_stencil(...).run``, against the reference's
    own ``compile_stencil(...).run`` (Pallas interpret mode) within
    2e-5; a remainder sweep included."""
    from repro.api import define as ref_define
    from repro_torch.api import define as tdefine

    spec = getattr(tdefine, kind)(2, radius=radius)
    rspec = getattr(ref_define, kind)(2, radius=radius)
    shape = (40, 36)
    x = field(shape, seed=radius)
    got = compile_stencil(spec, shape, t=2, device="cpu").run(
        torch.from_numpy(x), 5)
    want = jax_compile(rspec, shape, t=2, interpret=True).run(
        jnp.asarray(x), 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
