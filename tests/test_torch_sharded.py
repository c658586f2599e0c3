"""The port's sharded deep-halo execution (``compile_stencil(..., mesh=)``
→ ``StencilProgram.run_sharded``, ``repro_torch.core.distributed``,
``repro_torch.launch.mesh``) against the reference package.

Every mesh here is a mesh of CPU shards (``device="cpu"``), driven by one
process, as the reference's multi-device tests drive 8 faked CPU devices
in one process.  Each shard is its own tensor; slabs move between shards
by copies.  The oracle is the reference's per-step ``repro.kernels.ref``
(``reference_unrolled``) on the same numpy-seeded field, which is what
the reference's CLI checks ``run_sharded`` against (the reference's own
``run_sharded`` needs faked devices set before jax starts, which this
process cannot give).  Tolerances are the reference suite's: 2e-5 for
the sharded runs (0.06 for bf16 storage), 1e-4 for the
``make_distributed_stencil`` cases of ``multidev_stencil_child.py``.
The refusals, ``validate_mesh_for``, ``shard_extents`` and
``planned_exchange_rounds`` are held to the reference's directly.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import sharded as ref_sharded
from repro.api.boundary import Boundary as RefBoundary
from repro.core import stencil_spec as ref_spec
from repro.core.distributed import \
    make_distributed_stencil as ref_make_distributed
from repro.kernels import ref as jref
from repro_torch.api import (Boundary, compile_stencil, count_ppermutes,
                             planned_exchange_rounds)
from repro_torch.api import sharded
from repro_torch.core import stencil_spec as tspec
from repro_torch.core.distributed import make_distributed_stencil, ppermute
from repro_torch.launch import mesh as tmesh

TOL = 2e-5

# the reference child's unnormalized custom spec
CUSTOM_TAPS = (((0, 0), 0.55), ((0, 1), 0.2), ((0, -1), 0.1),
               ((1, 0), 0.08), ((-1, 0), 0.04))


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny tensors: torch's default intra-op threads only oversubscribe
    the CPU the other test workers share."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def specs(name):
    """(port spec, reference spec) of a Table-2 name or ``aniso5``."""
    if name == "aniso5":
        return (tspec.define_stencil(CUSTOM_TAPS, name="aniso5"),
                ref_spec.define_stencil(CUSTOM_TAPS, name="aniso5"))
    return tspec.get(name), ref_spec.get(name)


def domain_for(spec):
    """The reference child's sizing: uniform shards on (2, 4) and (1, 8),
    shard >= 4*rad; the trailing 3-D dim unsharded and small."""
    rad = spec.radius
    dims = [8 * rad, 32 * rad]
    if spec.ndim == 3:
        dims.append(max(2 * rad + 2, 8))
    return tuple(dims)


def field(shape, seed=0):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def oracle(x, ref, steps, boundary=("dirichlet", 0.0)):
    return np.asarray(jref.reference_unrolled(
        jnp.asarray(x), ref, steps, boundary=RefBoundary(*boundary)))


def port_boundary(kind, value):
    return Boundary(kind, value)


# (name, mesh, t, boundary, shape or None): cut from the reference child's
# 9 specs + aniso5 × 2 meshes × 3 depths × 2 boundaries, with its spot
# cases (reflect, Dirichlet(0.7) at t = 4, Dirichlet(0.3) at t = 1), a
# 3-D spec on a 2-D mesh in both mesh shapes, and one 3-D mesh
MATRIX = [
    ("j2d5pt", (2, 4), 4, ("periodic", 0.0), None),
    ("j2d5pt", (1, 8), 2, ("dirichlet", 0.0), None),
    ("j2d9pt", (2, 4), 2, ("dirichlet", 0.0), None),
    ("j2d9pt-gol", (2, 4), 4, ("periodic", 0.0), None),
    ("j2d25pt", (1, 8), 1, ("periodic", 0.0), None),
    ("j2d25pt", (2, 4), 2, ("dirichlet", 0.0), None),
    ("j3d7pt", (2, 4), 4, ("dirichlet", 0.0), None),
    ("j3d7pt", (1, 8), 2, ("periodic", 0.0), None),
    ("j3d13pt", (2, 4), 2, ("periodic", 0.0), None),
    ("j3d17pt", (1, 8), 4, ("dirichlet", 0.0), None),
    ("j3d27pt", (2, 4), 1, ("periodic", 0.0), None),
    ("poisson", (2, 4), 2, ("dirichlet", 0.0), None),
    ("aniso5", (2, 4), 4, ("periodic", 0.0), None),
    ("aniso5", (1, 8), 1, ("dirichlet", 0.0), None),
    ("j2d9pt", (1, 8), 4, ("reflect", 0.0), (16, 96)),
    ("j2d5pt", (2, 4), 2, ("reflect", 0.0), (16, 64)),
    ("j3d7pt", (2, 4), 1, ("reflect", 0.0), (8, 32, 6)),
    ("j2d9pt", (1, 8), 4, ("dirichlet", 0.7), (16, 96)),
    ("aniso5", (2, 4), 1, ("dirichlet", 0.3), (8, 32)),
    ("j3d27pt", (2, 2, 2), 2, ("periodic", 0.0), (8, 8, 8)),
]


@pytest.mark.parametrize(
    "name,mesh,t,boundary,shape", MATRIX,
    ids=[f"{n}-{'x'.join(map(str, m))}-t{t}-{b[0]}{b[1] or ''}"
         for n, m, t, b, _ in MATRIX])
def test_run_sharded_matches_oracle(name, mesh, t, boundary, shape):
    """T = 2t+1 (full, full, remainder block) on a mesh of CPU shards
    against the reference's per-step oracle within 2e-5, with the
    exchange counter read around the run."""
    spec, ref = specs(name)
    shape = shape or domain_for(spec)
    x = field(shape)
    prog = compile_stencil(spec, shape, t=t, mesh=mesh, device="cpu",
                           boundary=port_boundary(*boundary))
    steps = 2 * t + 1
    before = ppermute.calls
    got = prog.run_sharded(torch.from_numpy(x), steps)
    axes = sum(1 for n in mesh if n > 1)
    assert ppermute.calls - before == (planned_exchange_rounds(steps, t)
                                       * 2 * axes)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), oracle(x, ref, steps, boundary),
                               atol=TOL, rtol=TOL)


def test_bf16_storage_and_identity():
    """bf16 storage computes in f32 and lands back in bf16, within the
    reference suite's bf16 tolerance of the oracle; T = 0 is the
    identity."""
    spec, ref = specs("j2d5pt")
    prog = compile_stencil(spec, (8, 32), t=2, mesh=(2, 4), device="cpu",
                           dtype=torch.bfloat16)
    x = field((8, 32))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    yb = prog.run_sharded(xb, 5)
    assert yb.dtype == torch.bfloat16
    want = oracle(xb.float().numpy(), ref, 5)
    np.testing.assert_allclose(yb.float().numpy(), want, atol=0.06,
                               rtol=0.06)
    assert prog.run_sharded(xb, 0) is xb


def test_mesh_of_one_is_run():
    """A mesh of total size 1 falls back to ``.run``, bit for bit."""
    spec = tspec.get("j2d9pt")
    x = torch.from_numpy(field((24, 40)))
    prog = compile_stencil(spec, (24, 40), t=3, mesh=(1, 1), device="cpu")
    single = compile_stencil(spec, (24, 40), t=3, device="cpu")
    before = ppermute.calls
    assert torch.equal(prog.run_sharded(x, 7), single.run(x, 7))
    assert ppermute.calls == before
    assert prog.fingerprint()["mesh"] == {"shard0": 1, "shard1": 1}


def test_stream_program_runs_sharded():
    """The runner ignores ``mode``, as the reference's does: a 2-D
    ``mode="stream"`` program runs sharded like a fused one."""
    spec, ref = specs("j2d5pt")
    x = field((32, 64))
    prog = compile_stencil(spec, (32, 64), t=3, mode="stream", mesh=(2, 2),
                           device="cpu")
    got = prog.run_sharded(torch.from_numpy(x), 7)
    np.testing.assert_allclose(got.numpy(), oracle(x, ref, 7), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("name,mesh,t,total", [
    ("j2d5pt", (2, 4), 4, 9), ("j3d7pt", (1, 8), 2, 6),
    ("j2d9pt", (2, 4), 2, 5)])
def test_exchange_counts(name, mesh, t, total):
    """One exchange round per temporal block — NOT per time step: the
    counter equals ``planned_exchange_rounds(T, t) × 2 × sharded axes``,
    and the reference plans the same rounds."""
    spec = tspec.get(name)
    shape = domain_for(spec)
    prog = compile_stencil(spec, shape, t=t, mesh=mesh, device="cpu",
                           boundary=Boundary.periodic())
    fn = sharded.build_sharded_runner(prog, total)
    axes = sum(1 for n in mesh if n > 1)
    blocks = planned_exchange_rounds(total, t)
    assert blocks == ref_sharded.planned_exchange_rounds(total, t)
    got = count_ppermutes(fn, torch.from_numpy(field(shape)))
    assert got == blocks * 2 * axes
    assert got < total * 2 * axes


def ref_mesh(shape):
    """A stand-in for a reference Mesh: ``validate_mesh_for`` and
    ``shard_extents`` read only its axis names and shape."""
    names = tuple(f"shard{k}" for k in range(len(shape)))
    return types.SimpleNamespace(axis_names=names,
                                 shape=dict(zip(names, shape)))


def cpu_mesh(shape):
    return tmesh.make_stencil_mesh(shape, devices=["cpu"] * int(
        np.prod(shape)))


@pytest.mark.parametrize("name,shape,mesh,t,boundary", [
    ("j2d5pt", (17, 32), (2, 4), 2, ("dirichlet", 0.0)),
    ("j2d5pt", (8, 32), (2, 4), 8, ("dirichlet", 0.0)),
    ("j2d9pt", (16, 96), (1, 8), 6, ("reflect", 0.0)),
    ("j2d5pt", (8, 32), (2, 4), 2, ("neumann", 0.0)),
    ("j3d7pt", (16, 16, 8), (2, 2), 2, ("periodic", 0.0)),
])
def test_validate_mesh_matches_reference(name, shape, mesh, t, boundary):
    """The port's refusals are the reference's, word for word, and so
    are the shard extents of what both accept."""
    spec, ref = specs(name)
    args = (shape, None, t)

    def outcome(fn, sp, m, b):
        try:
            fn(sp, shape, m, t, b)
        except ValueError as e:
            return str(e)
        return None

    got = outcome(sharded.validate_mesh_for, spec, cpu_mesh(mesh),
                  port_boundary(*boundary))
    want = outcome(ref_sharded.validate_mesh_for, ref, ref_mesh(mesh),
                   RefBoundary(*boundary))
    assert got == want, args
    if want is None:
        assert (sharded.shard_extents(shape, cpu_mesh(mesh))
                == ref_sharded.shard_extents(shape, ref_mesh(mesh)))


def test_compile_refusals():
    """The reference's refusals at compile and run time."""
    spec = tspec.get("j2d5pt")
    with pytest.raises(ValueError, match="divisible.*pad the domain"):
        compile_stencil(spec, (17, 32), t=2, mesh=(2, 4), device="cpu")
    with pytest.raises(ValueError, match="one neighbor hop.*Reduce t"):
        compile_stencil(spec, (8, 32), t=8, mesh=(2, 4), device="cpu")
    with pytest.raises(ValueError, match="mesh has 3 axes"):
        compile_stencil(spec, (8, 32), t=2, mesh=(2, 2, 2), device="cpu")
    with pytest.raises(ValueError, match="neumann"):
        compile_stencil(spec, (8, 32), t=1, mesh=(2, 4), device="cpu",
                        boundary=Boundary.neumann())
    with pytest.raises(TypeError, match="mesh must be"):
        compile_stencil(spec, (8, 32), t=2, mesh="2x4", device="cpu")
    with pytest.raises(ValueError, match="positive ints"):
        tmesh.make_stencil_mesh((2, 0))
    with pytest.raises(RuntimeError, match="need 256 devices"):
        tmesh.make_production_mesh()       # no host has 256 visible GPUs
    prog = compile_stencil(spec, (8, 32), t=2, device="cpu")
    with pytest.raises(ValueError, match="mesh-compiled"):
        prog.run_sharded(torch.zeros((8, 32)), 4)
    with pytest.raises(ValueError, match="mesh-compiled"):
        prog.run_sharded_resumable(torch.zeros((8, 32)), 4, store=None)


def test_mesh_devices(monkeypatch):
    """Without ``devices=`` a mesh takes the visible GPUs and refuses
    too few, naming ``devices=``; a repeated device is a mesh of one
    device's shards; the cache key and the ``[sharded]`` summary name
    the devices."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="need 4 devices, have 0.*"
                                           "devices="):
        tmesh.make_stencil_mesh((2, 2))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        compile_stencil(tspec.get("j2d5pt"), (8, 32), t=1, mesh=(2, 2))
    m = tmesh.make_stencil_mesh((2, 2), devices=["cpu"] * 4)
    assert m.axis_names == ("shard0", "shard1") and m.size == 4
    assert m.shape == {"shard0": 2, "shard1": 2}
    assert m.devices.shape == (2, 2)
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    assert sharded.mesh_key(m) == (("shard0", "shard1"), (2, 2),
                                   ("cpu",) * 4)
    assert tmesh.device_summary(m.devices.flat) == "cpux4"
    assert tmesh.ensure_fake_devices(3) == [torch.device("cpu")] * 3
    assert sharded.sharded_partition_spec(3, m) == ("shard0", "shard1",
                                                    None)
    # a Mesh puts the program on its first device
    prog = compile_stencil(tspec.get("j2d5pt"), (8, 32), t=1, mesh=m)
    assert prog.device == torch.device("cpu") and prog.mesh is m


# multidev_stencil_child.py's cases, at its shapes
DIST_CASES = [
    ("j2d5pt", (64, 48), {0: "x"}, (8,), ("x",), 6, 3),
    ("j2d9pt-gol", (32, 64), {0: "x", 1: "y"}, (4, 2), ("x", "y"), 4, 2),
    ("j2d9pt", (48, 32), {0: "x", 1: "y"}, (2, 4), ("x", "y"), 4, 2),
    ("j3d7pt", (32, 16, 20), {0: "z", 1: "y"}, (4, 2), ("z", "y"), 4, 2),
    ("j3d27pt", (16, 16, 12), {0: "z", 1: "y"}, (2, 4), ("z", "y"), 2, 1),
    ("poisson", (24, 16, 12), {0: "z"}, (8,), ("z",), 3, 3),
]


@pytest.mark.parametrize("name,shape,dim_to_axis,mesh_shape,axes,total,"
                         "block", DIST_CASES,
                         ids=[c[0] for c in DIST_CASES])
def test_make_distributed_stencil(name, shape, dim_to_axis, mesh_shape,
                                  axes, total, block):
    """The plain deep-halo scheme on CPU shards against the reference's
    per-step oracle within 1e-4, with one exchange per direction per
    sharded axis per block."""
    spec, ref = specs(name)
    mesh = tmesh.make_mesh(mesh_shape, axes,
                           devices=["cpu"] * int(np.prod(mesh_shape)))
    fn, layout = make_distributed_stencil(spec, mesh, dim_to_axis, shape,
                                          total, block)
    x = field(shape)
    before = ppermute.calls
    got = layout.assemble(fn(layout.split(torch.from_numpy(x))), "cpu")
    assert ppermute.calls - before == total // block * 2 * len(dim_to_axis)
    np.testing.assert_allclose(got.numpy(), oracle(x, ref, total),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("inner", ["jnp", "stub"])
def test_distributed_one_device_matches_reference(inner):
    """On a one-device mesh the port's scheme equals the reference's
    ``make_distributed_stencil`` run on the one CPU device (the n == 1
    local pad, and the ``stub`` inner)."""
    spec, ref = specs("j2d9pt")
    shape, x = (24, 20), field((24, 20))
    rmesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("x",))
    rfn, _ = ref_make_distributed(ref, rmesh, {0: "x"}, shape, 4, 2,
                                  inner=inner)
    want = np.asarray(rfn(jnp.asarray(x)))
    mesh = tmesh.make_mesh((1,), ("x",), devices=["cpu"])
    fn, layout = make_distributed_stencil(spec, mesh, {0: "x"}, shape, 4, 2,
                                          inner=inner)
    got = layout.assemble(fn(layout.split(torch.from_numpy(x))), "cpu")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


def test_shards_are_separate_tensors():
    """The split gives each mesh position its own storage, and the
    exchange hands a shard its neighbour's rows through a received copy:
    poisoning the global field after the split changes nothing."""
    spec = tspec.get("j2d5pt")
    prog = compile_stencil(spec, (16, 32), t=2, mesh=(2, 2), device="cpu")
    layout = sharded.operand_sharding(prog)
    x = torch.from_numpy(field((16, 32)))
    shards = layout.split(x)
    ptrs = {s.data_ptr() for s in shards.flat}
    assert len(ptrs) == 4 and x.data_ptr() not in ptrs
    want = prog.run_sharded(x, 5)
    x2 = x.clone()
    shards = layout.split(x2)
    x2.fill_(float("nan"))
    assert torch.equal(layout.assemble(shards, "cpu"), x)
    assert torch.equal(prog.run_sharded(x, 5), want)
