"""The port's CUDA kernels on a card: each test is marked ``cuda`` and skips
without a CUDA device (the kernels have no CPU mode).  This file imports
no JAX, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain version on the same padded input
(the stencil kernels also against a second launch, bit for bit), and whole
programs against the port's oracle.  Tolerances: 2e-5 for f32
(the reference suite's), 1e-12 for f64 (rounding of a different
summation grouping only).
"""
import numpy as np
import pytest
import torch

from repro_torch.api import Boundary, compile_stencil
from repro_torch.core import stencil_spec as tspec
from repro_torch.kernels import ref
from repro_torch.kernels import stencil2d as st
from repro_torch.kernels import stencil3d as st3
from repro_torch.launch.stencil_registers import dense_spec, probe_specs

SPECS_2D = [n for n, s in tspec.TABLE2.items() if s.ndim == 2]
BOUNDARIES = [Boundary.dirichlet(0.0), Boundary.dirichlet(0.7),
              Boundary.periodic(), Boundary.reflect(), Boundary.neumann()]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def field(shape, seed=0):
    return torch.from_numpy(
        np.random.default_rng(seed).random(shape, dtype=np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("name", SPECS_2D)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,t,bh,bw", [((37, 53), 3, 16, 32),
                                           ((200, 300), 4, 40, 64),
                                           ((33, 70), 4, 3, 32)])
def test_kernel_matches_plain(cuda_device, name, dtype, shape, t, bh, bw):
    kernel_vs_plain_2d(tspec.get(name), dtype, shape, t, bh, bw,
                       cuda_device)


def kernel_vs_plain_2d(spec, dtype, shape, t, bh, bw, device, dirty=False):
    """Two launches of the 2-D kernel on one padded input, equal bit for
    bit, and held to the plain version; ``dirty`` fills the padding with
    values the sweep must read as 0."""
    hp, wp = st.padded_shape_2d(spec, t, bh, bw, *shape)
    xp = torch.zeros((hp, wp), dtype=dtype, device=device)
    xp[:shape[0], :shape[1]] = field(shape).to(device)
    if dirty:
        xp[shape[0]:] = 7.0
        xp[:, shape[1]:] = -3.0
    kw = dict(height=shape[0], width=shape[1], bh=bh, bw=bw)
    before = st.ebisu2d_padded.launches
    got = st.ebisu2d_padded(xp, spec, t, **kw)
    again = st.ebisu2d_padded(xp, spec, t, **kw)
    torch.cuda.synchronize()
    assert st.ebisu2d_padded.launches == before + 2
    assert torch.equal(got, again)          # a missing barrier would race
    want = st.ebisu2d_padded_plain(xp, spec, t, height=shape[0],
                                   width=shape[1])
    tol = 2e-5 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)
    assert not got[shape[0]:].any() and not got[:, shape[1]:].any()


# 2-D custom tap sets: asymmetric at radius 4, 128 taps at radius 8 (the
# kernel's bounds), and sets with no reach along one axis
# (tests/test_torch_stencil2d.py replays them on the CPU)
ASYM_R4_2D = tspec.define_stencil(
    [((0, 0), 0.3), ((-4, 1), 0.05), ((3, -2), 0.07), ((1, 4), 0.06),
     ((-2, -3), 0.08), ((0, 2), 0.1), ((2, 0), 0.09), ((-1, -1), 0.11)],
    name="asym-r4", normalize=True)
CUSTOM_2D = {s.name: s for s in (
    ASYM_R4_2D, dense_spec(8, ndim=2),
    tspec.define_stencil([((0, 0), 0.5), ((0, 2), 0.25), ((0, -1), 0.25)],
                         name="x-only"),
    tspec.define_stencil([((0, 0), 0.5), ((3, 0), 0.25), ((-1, 0), 0.25)],
                         name="y-only"))}
# (shape, t, bh, bw, interior share): most CTAs interior (the variant
# without domain tests), every CTA an edge one, and (share None) regions
# whose rows R does not divide at any step (13 + 2·(t-s)·reach rows)
EDGE_TILINGS_2D = [((300, 400), 2, 16, 32, 0.5),
                   ((37, 53), 2, 16, 32, 0.0),
                   ((261, 197), 3, 13, 64, None)]


def spec_2d(name):
    return CUSTOM_2D.get(name) or tspec.get(name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", SPECS_2D + ["asym-r4", "dense-2d-r8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,t,bh,bw,share", EDGE_TILINGS_2D)
def test_kernel_2d_interior_and_edge_ctas_match_plain(
        cuda_device, name, dtype, shape, t, bh, bw, share):
    spec = spec_2d(name)
    sched = st.tile_schedule(spec, t, bh, bw, *shape,
                             torch.tensor([], dtype=dtype).element_size())
    interior = sched["interior_ctas"]
    if share is None:
        assert all(s["ny"] % s["rows"] for s in sched["steps"])
    else:
        assert (interior > share * sched["ctas"] if share
                else interior == 0)
    kernel_vs_plain_2d(spec, dtype, shape, t, bh, bw, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CUSTOM_2D))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,t,bh,bw", [((37, 53), 1, 16, 32),
                                           ((50, 70), 2, 5, 32)])
def test_kernel_2d_custom_taps_match_plain(cuda_device, name, dtype, shape,
                                           t, bh, bw):
    kernel_vs_plain_2d(CUSTOM_2D[name], dtype, shape, t, bh, bw, cuda_device,
                       dirty=True)


@pytest.mark.cuda
@pytest.mark.parametrize("name", SPECS_2D)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_2d_dirty_padding(cuda_device, name, dtype):
    """Garbage in the padding never leaks into the domain, and the
    padding comes back zero, in interior and edge CTAs alike."""
    kernel_vs_plain_2d(tspec.get(name), dtype, (95, 140), 2, 16, 32,
                       cuda_device, dirty=True)


@pytest.mark.cuda
def test_stencil2d_build_has_no_spills(cuda_device):
    """ptxas's report of every 2-D tap-set library the card tests build,
    and of a star and a dense 128-tap set at each radius 1..8 (built in
    parallel): no instantiation (f32 and f64) stores a spill or keeps a
    stack frame, and each fits 64 registers (two CTAs of 512 threads on
    an SM)."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _build

    specs = ([tspec.get(n) for n in SPECS_2D] + list(CUSTOM_2D.values())
             + probe_specs(ndim=2))
    headers = list(dict.fromkeys(st.tapset_header(s) for s in specs))
    with ThreadPoolExecutor(len(headers)) as pool:
        list(pool.map(lambda h: _build.build("stencil2d", h), headers))
    for spec in specs:
        frames = _build.ptxas_frames(
            _build.build_log("stencil2d", st.tapset_header(spec)))
        assert len(frames) == 2, (spec.name, frames)
        for kernel, (regs, spill, stack) in frames.items():
            assert spill == 0 and stack == 0, (spec.name, kernel, spill,
                                               stack)
            assert regs <= 64, (spec.name, kernel, regs)


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_run(cuda_device):
    spec = tspec.get("j2d5pt")
    xp = torch.zeros((64, 64), device=cuda_device)
    with pytest.raises(ValueError, match="alias"):
        st.ebisu2d_padded(xp, spec, 2, height=60, width=60, bh=8, bw=32,
                          out=xp)
    with pytest.raises(ValueError, match="float32 or float64"):
        st.ebisu2d_padded(xp.half(), spec, 2, height=60, width=60, bh=8,
                          bw=32)
    with pytest.raises(RuntimeError, match="launch failed"):
        big = torch.zeros((1024, 1024), device=cuda_device)
        st.ebisu2d_padded(big, spec, 64, height=1000, width=1000, bh=512,
                          bw=512)           # far beyond shared memory


@pytest.mark.cuda
@pytest.mark.parametrize("name", SPECS_2D)
@pytest.mark.parametrize("boundary", BOUNDARIES, ids=repr)
def test_program_matches_oracle(cuda_device, name, boundary):
    prog = compile_stencil(tspec.get(name), (300, 200), t=4,
                           boundary=boundary)
    assert prog.device.type == "cuda"
    x = field((300, 200)).to(cuda_device)
    before = st.ebisu2d_padded.launches
    y = prog.run(x, 9)
    torch.cuda.synchronize()
    assert st.ebisu2d_padded.launches == before + 3
    torch.testing.assert_close(
        y, ref.reference(x, prog.spec, 9, boundary=boundary),
        atol=2e-5, rtol=2e-5)


# ------------------------------------------------------------------ 3-D ----
SPECS_3D = [n for n, s in tspec.TABLE2.items() if s.ndim == 3]
# (shape, t, zc, ty, tx): ragged chunks and tiles, a tile narrower than
# the halo, untiled axes, one chunk per CTA column
TILINGS_3D = [((19, 13, 21), 2, 5, 4, 8),
              ((23, 17, 40), 3, 7, 2, 32),
              ((16, 20, 70), 2, 16, None, 32),
              ((21, 9, 33), 1, 4, None, None)]


def padded_3d(shape, t, spec, zc, ty, tx, dtype, device, seed=0):
    zp, yp, xp = st3.padded_shape_3d(spec, t, shape, zc=zc, ty=ty, tx=tx)
    buf = torch.zeros((zp, yp, xp), dtype=dtype, device=device)
    buf[:shape[0], :shape[1], :shape[2]] = field(shape, seed).to(device)
    return buf


@pytest.mark.cuda
@pytest.mark.parametrize("name", SPECS_3D)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,t,zc,ty,tx", TILINGS_3D)
def test_kernel_3d_matches_plain(cuda_device, name, dtype, shape, t, zc, ty,
                                 tx):
    spec = tspec.get(name)
    xp = padded_3d(shape, t, spec, zc, ty, tx, dtype, cuda_device)
    kw = dict(zdim=shape[0], ydim=shape[1], xdim=shape[2])
    before = st3.ebisu3d_padded.launches
    got = st3.ebisu3d_padded(xp, spec, t, zc=zc, ty=ty, tx=tx, **kw)
    again = st3.ebisu3d_padded(xp, spec, t, zc=zc, ty=ty, tx=tx, **kw)
    torch.cuda.synchronize()
    assert st3.ebisu3d_padded.launches == before + 2
    assert torch.equal(got, again)          # a missing barrier would race
    want = st3.ebisu3d_padded_plain(xp, spec, t, **kw)
    tol = 2e-5 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("name", SPECS_2D)
@pytest.mark.parametrize("tx", [None, 32])
def test_kernel_lifted_2d_matches_plain(cuda_device, name, tx):
    spec = tspec.lift_2d_to_3d(tspec.get(name))
    shape, t = (45, 1, 77), 3
    xp = padded_3d(shape, t, spec, 8, None, tx, torch.float32, cuda_device)
    kw = dict(zdim=shape[0], ydim=1, xdim=shape[2])
    got = st3.ebisu3d_padded(xp, spec, t, zc=8, tx=tx, **kw)
    want = st3.ebisu3d_padded_plain(xp, spec, t, **kw)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


# an asymmetric radius-2 tap set whose dz != 0 taps sit off the centre
# column, and the 125-tap radius-2 box (tests/test_torch_stencil3d.py
# replays both on the CPU)
ASYM_R2 = tspec.define_stencil(
    [((0, 0, 0), 0.31), ((-2, 0, 1), 0.07), ((1, -1, 0), 0.11),
     ((2, 1, -2), 0.05), ((-1, 2, 0), 0.13), ((0, 0, -1), 0.09),
     ((1, 0, 1), 0.1), ((0, -2, 2), 0.06), ((-2, -1, -1), 0.08)],
    name="asym-r2", normalize=True)
BOX_R2 = tspec.define_stencil(tspec.box_taps(3, 2), name="box-r2",
                              normalize=True)
# radius 4 (a star) and radius 8, the kernel's bound (a star with taps off
# its axes): few cells a thread, 2·rad partial sums each
STAR_R4 = tspec.define_stencil(tspec.star_taps(3, 4), name="star-r4",
                               normalize=True)
ASYM_R8 = tspec.define_stencil(
    list(tspec.star_taps(3, 8)) + [((-8, 3, -5), 0.02), ((7, -8, 8), 0.03),
                                   ((5, 6, -7), 0.01)],
    name="asym-r8", normalize=True)
CUSTOM_3D = {s.name: s for s in (ASYM_R2, BOX_R2, STAR_R4, ASYM_R8,
                                  dense_spec(8))}
# radius 8 fits fewer cells a thread (3 in f32, 1 in f64): TILINGS_3D's
# second and third would need more than 512 threads
TILINGS_R8 = [TILINGS_3D[0], ((23, 17, 40), 2, 7, 2, 8), TILINGS_3D[3],
              ((16, 12, 40), 1, 16, None, 16)]
CUSTOM_CASES_3D = [(n, *tl) for n in ("asym-r2", "box-r2", "star-r4")
                   for tl in TILINGS_3D] + [(n, *tl)
                                            for n in ("asym-r8", "dense-r8")
                                            for tl in TILINGS_R8]
# (shape, t, zc, ty, tx, interior share): most CTAs interior (the
# variant without domain tests), and every CTA an edge one
EDGE_TILINGS_3D = [((96, 96, 96), 2, 8, 8, 8, 0.5),
                   ((24, 40, 44), 2, 24, None, None, 0.0)]


def spec_3d(name):
    return CUSTOM_3D.get(name) or tspec.get(name)


def interior_ctas(spec, t, shape, *, zc, ty=None, tx=None):
    """How many CTAs of a launch run the kernel's interior variant (no
    domain test): those whose input column, the z span and the in-plane
    rim, lies inside the domain."""
    geom = st3.launch_geometry_3d(spec, t, shape, zc=zc, ty=ty, tx=tx)
    halo = geom["halo"]
    _, ty, tx = geom["block"]
    _, tiled_y, tiled_x = geom["tiled"]

    def inside(n, tile, dim, tiled):
        if not tiled:
            return n                # an untiled axis loads the domain
        return sum(1 for i in range(n)
                   if i * tile - halo >= 0 and (i + 1) * tile + halo <= dim)

    gz, gy, gx = geom["grid"]
    return (inside(gz, zc, shape[0], True) * inside(gy, ty, shape[1], tiled_y)
            * inside(gx, tx, shape[2], tiled_x))


def kernel_vs_plain_3d(spec, dtype, shape, t, zc, ty, tx, device):
    xp = padded_3d(shape, t, spec, zc, ty, tx, dtype, device)
    kw = dict(zdim=shape[0], ydim=shape[1], xdim=shape[2])
    before = st3.ebisu3d_padded.launches
    got = st3.ebisu3d_padded(xp, spec, t, zc=zc, ty=ty, tx=tx, **kw)
    again = st3.ebisu3d_padded(xp, spec, t, zc=zc, ty=ty, tx=tx, **kw)
    torch.cuda.synchronize()
    assert st3.ebisu3d_padded.launches == before + 2
    assert torch.equal(got, again)          # a missing barrier would race
    want = st3.ebisu3d_padded_plain(xp, spec, t, **kw)
    tol = 2e-5 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,shape,t,zc,ty,tx", CUSTOM_CASES_3D)
def test_kernel_3d_custom_taps_match_plain(cuda_device, name, dtype, shape,
                                           t, zc, ty, tx):
    kernel_vs_plain_3d(spec_3d(name), dtype, shape, t, zc, ty, tx,
                       cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("name", SPECS_3D + ["asym-r2", "box-r2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,t,zc,ty,tx,share", EDGE_TILINGS_3D)
def test_kernel_3d_interior_and_edge_ctas_match_plain(
        cuda_device, name, dtype, shape, t, zc, ty, tx, share):
    spec = spec_3d(name)
    g = st3.launch_geometry_3d(spec, t, shape, zc=zc, ty=ty, tx=tx)
    interior = interior_ctas(spec, t, shape, zc=zc, ty=ty, tx=tx)
    assert (interior > share * np.prod(g["grid"]) if share
            else interior == 0)
    kernel_vs_plain_3d(spec, dtype, shape, t, zc, ty, tx, cuda_device)


@pytest.mark.cuda
def test_stencil3d_build_has_no_spills(cuda_device):
    """ptxas's report of every tap-set library the card tests build, and
    of a star and a dense 128-tap set at each radius 3..8 (built in
    parallel): no instantiation (f32 and f64) stores a spill or keeps a
    stack frame, and each fits 128 registers (512 threads on an SM)."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _build

    specs = ([tspec.get(n) for n in SPECS_3D]
             + [tspec.lift_2d_to_3d(tspec.get(n)) for n in SPECS_2D]
             + list(CUSTOM_3D.values()) + probe_specs(range(3, 9)))
    headers = list(dict.fromkeys(st3.tapset_header(s) for s in specs))
    with ThreadPoolExecutor(len(headers)) as pool:
        list(pool.map(lambda h: _build.build("stencil3d", h), headers))
    for spec in specs:
        frames = _build.ptxas_frames(
            _build.build_log("stencil3d", st3.tapset_header(spec)))
        assert len(frames) == 2, (spec.name, frames)
        for kernel, (regs, spill, stack) in frames.items():
            assert spill == 0 and stack == 0, (spec.name, kernel, spill,
                                               stack)
            assert regs <= 128, (spec.name, kernel, regs)


@pytest.mark.cuda
def test_stencil3d_launch_shape_matches_the_planner(cuda_device):
    """The C launcher's threads and shared memory, at the planner's cells
    per thread, equal the Python helpers the planner and the CPU replay
    read; it refuses what the planner finds no spread for."""
    for spec, shape, t, zc, ty, tx in [
            (tspec.get("j3d7pt"), (2560, 288, 384), 8, 427, 32, 32),
            (tspec.get("j3d13pt"), (2560, 288, 384), 5, 233, 29, 32),
            (tspec.get("j3d27pt"), (2560, 288, 384), 5, 214, 32, 64),
            (tspec.lift_2d_to_3d(tspec.get("j2d5pt")), (8352, 1, 8352), 12,
             597, None, 928),
            (BOX_R2, (24, 40, 44), 2, 24, None, None),
            (ASYM_R2, (19, 13, 21), 2, 5, 4, 8),
            (ASYM_R8, (23, 17, 40), 2, 7, 3, 16),
            (ASYM_R8, (16, 20, 70), 2, 16, None, 32)]:
        for itemsize in (4, 8):
            g = st3.launch_geometry_3d(spec, t, shape, zc=zc, ty=ty, tx=tx,
                                       itemsize=itemsize)
            if g["threads"] is None:
                with pytest.raises(RuntimeError, match="refuses"):
                    st3.launch_shape(spec, t, shape, g, itemsize)
                continue
            block, smem = st3.launch_shape(spec, t, shape, g, itemsize)
            assert (block, smem) == (g["threads"], g["kernel_smem_bytes"])
            assert smem <= g["smem_bytes"]


@pytest.mark.cuda
def test_kernel_3d_refuses_what_it_cannot_run(cuda_device):
    spec = tspec.get("j3d7pt")
    xp = torch.zeros((16, 16, 32), device=cuda_device)
    kw = dict(zdim=16, ydim=16, xdim=32, zc=16)
    with pytest.raises(ValueError, match="alias"):
        st3.ebisu3d_padded(xp, spec, 2, out=xp, **kw)
    with pytest.raises(ValueError, match="float32 or float64"):
        st3.ebisu3d_padded(xp.half(), spec, 2, **kw)
    with pytest.raises(RuntimeError, match="launch failed"):
        big = torch.zeros((64, 256, 256), device=cuda_device)
        st3.ebisu3d_padded(big, spec, 16, zdim=64, ydim=256, xdim=256,
                           zc=64)           # far beyond shared memory
    with pytest.raises(RuntimeError, match="launch failed"):
        st3.ebisu3d_padded(xp, spec, 33, **kw)     # past the depth bound
    with pytest.raises(RuntimeError, match="launch failed"):
        # 92 x 92 cells of j3d13pt at t=1 fit shared memory, not the 512
        # threads x 16 cells (64 registers of partial sums) of radius 2
        wide = torch.zeros((8, 92, 92), device=cuda_device)
        st3.ebisu3d_padded(wide, tspec.get("j3d13pt"), 1, zdim=8, ydim=92,
                           xdim=92, zc=8)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["j3d7pt", "j3d27pt"])
@pytest.mark.parametrize("boundary", BOUNDARIES, ids=repr)
def test_program_3d_matches_oracle(cuda_device, name, boundary):
    shape = (40, 36, 70)
    prog = compile_stencil(tspec.get(name), shape, t=3, boundary=boundary)
    x = field(shape).to(cuda_device)
    before = st3.ebisu3d_padded.launches
    y1 = prog.apply(x)
    y = prog.run(x, 7)
    torch.cuda.synchronize()
    assert st3.ebisu3d_padded.launches == before + 4
    torch.testing.assert_close(
        y1, ref.reference(x, prog.spec, 3, boundary=boundary),
        atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(
        y, ref.reference(x, prog.spec, 7, boundary=boundary),
        atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("name", SPECS_2D)
def test_stream_apply_matches_oracle(cuda_device, name):
    prog = compile_stencil(tspec.get(name), (300, 200), t=4, mode="stream")
    x = field((300, 200)).to(cuda_device)
    before = st3.ebisu3d_padded.launches
    y = prog.apply(x)
    torch.cuda.synchronize()
    assert st3.ebisu3d_padded.launches == before + 1
    torch.testing.assert_close(y, ref.reference(x, prog.spec, 4),
                               atol=2e-5, rtol=2e-5)


# ------------------------ batches, the padded carry, large tap sets ----
@pytest.mark.cuda
@pytest.mark.parametrize("name,shape", [("j2d5pt", (300, 200)),
                                        ("j2d25pt", (130, 170)),
                                        ("j3d7pt", (40, 36, 70)),
                                        ("j3d27pt", (30, 26, 40))])
@pytest.mark.parametrize("boundary", [Boundary.dirichlet(0.0),
                                      Boundary.periodic()], ids=repr)
def test_run_batched_is_one_launch_a_sweep_and_equals_a_loop(
        cuda_device, name, shape, boundary):
    """A batch of three fields: one kernel launch per sweep for the whole
    batch (sweeps of 4, 4 and 1), bit for bit the loop of ``.run``, and
    the oracle within 2e-5."""
    spec = tspec.get(name)
    wrapper = (st.ebisu2d_padded if spec.ndim == 2
               else st3.ebisu3d_padded)
    prog = compile_stencil(spec, shape, t=4, boundary=boundary)
    xs = torch.stack([field(shape, seed=i) for i in range(3)]).to(
        cuda_device)
    before = wrapper.launches
    ys = prog.run_batched(xs, 9)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 3
    loop = torch.stack([prog.run(x, 9) for x in xs])
    assert torch.equal(ys, loop)
    for i, x in enumerate(xs):
        torch.testing.assert_close(
            ys[i], ref.reference(x, spec, 9, boundary=boundary),
            atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
def test_kernels_take_a_batch_in_their_grid(cuda_device):
    """The wrappers' batch axis on the kernels directly: each field of a
    launch equals its own launch bit for bit, edge CTAs included; the
    3-D kernel folds the fields into its grid's z."""
    spec = tspec.get("j2d9pt")
    hp, wp = st.padded_shape_2d(spec, 3, 16, 32, 70, 90)
    xs = torch.stack([field((hp, wp), seed=i) for i in range(5)]).to(
        cuda_device)
    kw = dict(height=70, width=90, bh=16, bw=32)
    got = st.ebisu2d_padded(xs, spec, 3, **kw)
    for i in range(5):
        assert torch.equal(got[i], st.ebisu2d_padded(xs[i], spec, 3, **kw))
    spec3 = tspec.get("j3d13pt")
    g = st3.launch_geometry_3d(spec3, 2, (19, 13, 21), zc=5, ty=4, tx=8)
    xs3 = torch.stack([field(g["padded"], seed=i) for i in range(4)]).to(
        cuda_device)
    kw3 = dict(zdim=19, ydim=13, xdim=21, zc=5, ty=4, tx=8)
    got3 = st3.ebisu3d_padded(xs3, spec3, 2, **kw3)
    for i in range(4):
        assert torch.equal(got3[i], st3.ebisu3d_padded(xs3[i], spec3, 2,
                                                       **kw3))
        torch.testing.assert_close(
            got3[i], st3.ebisu3d_padded_plain(xs3[i], spec3, 2,
                                              **{k: kw3[k] for k in
                                                 ("zdim", "ydim", "xdim")}),
            atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_run_padded_on_card_equals_run(cuda_device, dtype):
    prog = compile_stencil(tspec.get("j2d5pt"), (300, 200), t=4,
                           dtype=dtype)
    x = field((300, 200)).to(device=cuda_device, dtype=dtype)
    xp = torch.zeros(prog.padded_shape, dtype=dtype, device=cuda_device)
    xp[:300, :200] = x
    before = st.ebisu2d_padded.launches
    out = prog.run_padded(xp, 12)
    torch.cuda.synchronize()
    assert st.ebisu2d_padded.launches == before + 3
    assert torch.equal(out[:300, :200], prog.run(x, 12))
    assert not out[300:].any() and not out[:, 200:].any()


def large_sets():
    """The sets past the 128 taps of earlier libraries: 169 and 289 taps
    in 2-D, 343 in 3-D."""
    from repro_torch.api.define import blur, box

    return {"box2d-r6": box(2, radius=6), "blur2d-r8": blur(2, radius=8),
            "box3d-r3": box(3, radius=3)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["box2d-r6", "blur2d-r8", "box3d-r3"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_large_tap_sets_run_on_the_card(cuda_device, name, dtype):
    """``compile_stencil(...).run`` of each large set on a CUDA tensor
    (the launches that refused them before), held to the oracle; the
    kernel against its plain version and a second launch bit for bit."""
    spec = large_sets()[name]
    shape = (150, 170) if spec.ndim == 2 else (24, 30, 40)
    prog = compile_stencil(spec, shape, t=2, dtype=dtype)
    x = field(shape).to(device=cuda_device, dtype=dtype)
    y = prog.run(x, 5)
    tol = 2e-5 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(y, ref.reference(x, spec, 5), atol=tol,
                               rtol=tol)
    g = prog.geometry()
    if spec.ndim == 2:
        kernel_vs_plain_2d(spec, dtype, shape, 2, *g["block"], cuda_device,
                           dirty=True)
    else:
        kernel_vs_plain_3d(spec, dtype, shape, 2, *g["block"], cuda_device)


@pytest.mark.cuda
def test_large_tap_set_builds_have_no_spills(cuda_device):
    """ptxas's report of the large sets and of dense sets at the caps (169,
    225 and 289 taps at radius 6–8 in 2-D; 343 taps at radius 3–8 and
    ``MAX_TAPS`` in 3-D), built in parallel: no instantiation stores a
    spill or keeps a stack frame."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _build

    jobs = [("stencil2d", st.tapset_header(s)) for s in (
        [large_sets()["box2d-r6"], large_sets()["blur2d-r8"]]
        + probe_specs(range(6, 9), 2, [289]))]
    jobs += [("stencil3d", st3.tapset_header(s)) for s in (
        [large_sets()["box3d-r3"]]
        + probe_specs(range(3, 9), 3, [343, st3.MAX_TAPS]))]
    jobs = list(dict.fromkeys(jobs))
    with ThreadPoolExecutor(len(jobs)) as pool:
        list(pool.map(lambda job: _build.build(*job), jobs))
    for job in jobs:
        frames = _build.ptxas_frames(_build.build_log(*job))
        assert len(frames) == 2, (job[0], frames)
        for kernel, (regs, spill, stack) in frames.items():
            assert spill == 0 and stack == 0, (kernel, spill, stack)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,dtype", [(72, torch.float32),
                                      (64, torch.float16),
                                      (320, torch.bfloat16)])
def test_auto_attention_takes_chunked_where_the_kernel_refuses(
        cuda_device, hd, dtype):
    """``impl="auto"`` on CUDA tensors with a head_dim or dtype the
    kernels refuse runs the chunked path (no kernel launch) and matches
    the dense oracle."""
    from repro_torch.api import compile_attention
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.attention import dense_attention

    q, k, v = qkv(2, 128, 4, 2, hd, dtype, cuda_device)
    prog = compile_attention(heads=4, kv_heads=2, head_dim=hd, dtype=dtype,
                             q_chunk=64, kv_chunk=64)
    before = fa.flash_attention_fwd.launches
    out = prog.apply(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before
    want = dense_attention(q.float(), k.float(), v.float())
    tol = 2e-5 if dtype == torch.float32 else 0.06
    torch.testing.assert_close(out.float(), want, atol=tol, rtol=tol)
    with pytest.raises(ValueError, match="cannot launch"):
        compile_attention(heads=4, kv_heads=2, head_dim=hd, dtype=dtype,
                          q_chunk=64, kv_chunk=64, impl="cuda").apply(q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gray-scott", "fdtd-acoustic",
                                  "advection-diffusion"])
def test_systems_on_card_match_cpu_f64(cuda_device, name):
    """A coupled system on CUDA fields stays on the card, launches no
    stencil kernel, and matches the same program on the CPU in float64;
    ``run_batched`` equals a loop of ``.run`` there."""
    from repro_torch.systems import compile_system, get_system

    spec = get_system(name)
    rng = np.random.default_rng(1)
    arrs = {f: rng.uniform(0.2, 0.8, (2, 96, 80)).astype(np.float32)
            for f in spec.fields}
    for boundary in (Boundary.periodic(), Boundary.neumann(),
                     Boundary.dirichlet(0.3)):
        prog = compile_system(spec, (96, 80), t=4, boundary=boundary)
        before = (st.ebisu2d_padded.launches, st3.ebisu3d_padded.launches)
        got = prog.run_batched({f: torch.from_numpy(v).to(cuda_device)
                                for f, v in arrs.items()}, 9)
        assert (st.ebisu2d_padded.launches,
                st3.ebisu3d_padded.launches) == before
        cpu = compile_system(spec, (96, 80), t=4, boundary=boundary,
                             dtype=torch.float64)
        for i in range(2):
            one = prog.run({f: torch.from_numpy(v[i]).to(cuda_device)
                            for f, v in arrs.items()}, 9)
            want = cpu.run({f: torch.from_numpy(v[i]).double()
                            for f, v in arrs.items()}, 9)
            for f in spec.fields:
                assert got[f].device.type == "cuda"
                assert torch.equal(got[f][i], one[f])
                torch.testing.assert_close(got[f][i].cpu().double(),
                                           want[f], atol=1e-4, rtol=1e-4)


# ------------------------------------------------------- flash attention ----
def qkv(b, s, h, kv, hd, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
            .to(device=device, dtype=dtype)
            for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd))]


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 64, 80, 96, 128, 144, 256])
@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
@pytest.mark.parametrize("window", [None, 64, 32, 47])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda_device, hd, groups, causal, window,
                                    dtype):
    """Out and lse of the kernel of each dtype (bf16: the tensor-core
    kernel; float32: the 3xTF32 tensor-core kernel) against its plain
    version; S = 200
    is no multiple of the 64-row tile, windows of 64 and 32 sit on the
    64- and 32-key tile edges, and a window of 47 puts a warp's 16 rows
    on a window edge (the bf16 kernel's keep-whole test).  Tolerances:
    the reference suite's 2e-5 for f32 out, 1e-4 for lse; bf16 out within
    1e-4 + 2^-6·|want| per element, two units in the last place (both
    round one float32 result to bf16, so a sound kernel is at most one
    unit away)."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = qkv(2, 200, 2 * groups, 2, hd, dtype, cuda_device)
    before = fa.flash_attention_fwd.launches
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + 1
    want, want_lse = fa.flash_attention_fwd_plain(q, k, v, causal=causal,
                                                  window=window)
    atol, rtol = ((2e-5, 2e-5) if dtype == torch.float32
                  else (1e-4, 2.0 ** -6))
    assert out.dtype == dtype and lse.shape == (2, 2 * groups, 200)
    torch.testing.assert_close(out.float(), want.float(), atol=atol,
                               rtol=rtol)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    alone = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + 2
    assert torch.equal(alone, out)          # the lse-off instantiation


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_strided_inputs_and_fully_masked_rows(cuda_device,
                                                           dtype):
    """q, k, v read in place from a fused (B, S, 3, H, hd) buffer (bf16:
    rows 16-byte aligned, so no copy); S >= Sk + window gives rows with
    no valid key (the reference averages every key for them, with the lse
    -1e30).  Tolerances as in ``test_flash_kernel_matches_plain``."""
    from repro_torch.kernels import flash_attention as fa

    atol, rtol = ((2e-5, 2e-5) if dtype == torch.float32
                  else (1e-4, 2.0 ** -6))
    rng = np.random.default_rng(1)
    fused = torch.from_numpy(rng.standard_normal((2, 96, 3, 4, 32),
                                                 dtype=np.float32))
    fused = fused.to(cuda_device, dtype)
    q, k, v = fused[:, :, 0], fused[:, :, 1, :2], fused[:, :, 2, :2]
    copies = fa.flash_attention_fwd.copies
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True, window=24)
    assert fa.flash_attention_fwd.copies == copies
    want, want_lse = fa.flash_attention_fwd_plain(q, k, v, causal=True,
                                                  window=24)
    torch.testing.assert_close(out.float(), want.float(), atol=atol,
                               rtol=rtol)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    kk, vv = k[:, :40].contiguous(), v[:, :40].contiguous()
    out, lse = fa.flash_attention_fwd(q.contiguous(), kk, vv, causal=True,
                                      window=8)
    want, want_lse = fa.flash_attention_fwd_plain(q, kk, vv, causal=True,
                                                  window=8)
    torch.testing.assert_close(out.float(), want.float(), atol=atol,
                               rtol=rtol)
    dead = slice(40 + 8 - 1, 96)                  # rows that keep no key
    mean = vv.float().mean(1, keepdim=True).repeat_interleave(2, dim=2)
    torch.testing.assert_close(out[:, dead].float(),
                               mean.expand_as(out[:, dead]).to(dtype).float(),
                               atol=atol, rtol=rtol)
    assert (lse[:, :, dead] == -1e30).all()
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
def test_flash_kernel_refuses_what_it_cannot_run(cuda_device):
    from repro_torch.kernels import flash_attention as fa

    q, k, v = qkv(1, 64, 2, 1, 72, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="multiples of 16"):
        fa.flash_attention_fwd(q, k, v)
    q, k, v = qkv(1, 64, 2, 1, 288, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="up to 256"):
        fa.flash_attention_fwd(q, k, v)
    q, k, v = qkv(1, 64, 2, 1, 64, torch.float16, cuda_device)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention_fwd(q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["h2o-danube-1.8b", "qwen3-14b"])
def test_reduced_serve_kernel_path_matches_chunked(cuda_device, name):
    """The reduced-width serving path on the card: the prefill with the
    kernel (``flash_pallas``) against the chunked path (``flash_jnp``),
    same weights; greedy tokens equal."""
    import dataclasses

    import repro_torch.configs as C
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer
    from repro_torch.models.params import init_params
    from repro_torch.serve import serve_step

    cfg = dataclasses.replace(C.get_config(name).reduced(), q_chunk=32,
                              kv_chunk=32, swa_window=48)
    model = init_params(transformer.build_model(cfg, cuda_device),
                        torch.Generator(cuda_device).manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 128), device=cuda_device,
                         generator=torch.Generator(cuda_device).manual_seed(1))
    out = {}
    for impl in ("flash_pallas", "flash_jnp"):
        c = dataclasses.replace(cfg, attention_impl=impl)
        before = fa.flash_attention_fwd.launches
        logits, _ = transformer.prefill(c, model, {"tokens": toks}, 140)
        launched = fa.flash_attention_fwd.launches - before
        assert launched == (cfg.n_layers if impl == "flash_pallas" else 0)
        out[impl] = (logits, serve_step.greedy_generate(c, model, toks, 4,
                                                        140))
    torch.testing.assert_close(out["flash_pallas"][0], out["flash_jnp"][0],
                               atol=1e-4, rtol=1e-4)
    assert torch.equal(out["flash_pallas"][1], out["flash_jnp"][1])


# the bfloat16 forward route: csrc/flash_attention_mma.cu (tensor cores)
@pytest.mark.cuda
def test_flash_fwd_dispatch_reaches_the_kernel_of_each_dtype(cuda_device,
                                                             monkeypatch):
    """A CUDA bf16 input loads the bf16 tensor-core library, a float32
    one the 3xTF32 library; neither reaches the plain version (made to
    raise)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    loaded = []
    library = _build.library

    def record(name):
        loaded.append(name)
        return library(name)

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA input reached the plain version")

    monkeypatch.setattr(_build, "library", record)
    monkeypatch.setattr(fa, "flash_attention_fwd_plain", refuse)
    for dtype, name in ((torch.bfloat16, "flash_attention_mma"),
                        (torch.float32, "flash_attention_tf32")):
        q, k, v = qkv(1, 130, 4, 2, 80, dtype, cuda_device)
        before = fa.flash_attention_fwd.launches
        out, _ = fa.flash_attention_fwd(q, k, v, causal=True, window=64)
        torch.cuda.synchronize()
        assert loaded[-1] == name and out.dtype == dtype
        assert fa.flash_attention_fwd.launches == before + 1


@pytest.mark.cuda
def test_flash_fwd_bf16_repeat_is_bit_identical(cuda_device):
    """No atomics and a fixed order of sums: two launches agree bit for
    bit, out and lse (the training path recomputes the forward under
    remat)."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = qkv(2, 1024, 8, 2, 80, torch.bfloat16, cuda_device, seed=5)
    first = fa.flash_attention_fwd(q, k, v, causal=True, window=256)
    again = fa.flash_attention_fwd(q, k, v, causal=True, window=256)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_fwd_bf16_unaligned_rows_are_copied_and_counted(cuda_device):
    """q at a 2-byte offset and k with a row stride of hd + 4 are copied
    first, counted in ``flash_attention_fwd.copies``, and give the aligned
    inputs' result bit for bit; the launcher called directly on an
    unaligned input refuses it."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = qkv(2, 96, 4, 2, 32, torch.bfloat16, cuda_device, seed=7)
    want = fa.flash_attention_fwd(q, k, v, causal=True, window=24)
    buf = torch.empty(q.numel() + 8, dtype=torch.bfloat16, device=cuda_device)
    q_odd = buf[1:1 + q.numel()].view(q.shape)
    q_odd.copy_(q)
    k_wide = torch.zeros((2, 96, 2, 36), dtype=torch.bfloat16,
                         device=cuda_device)[..., :32]
    k_wide.copy_(k)
    before = fa.flash_attention_fwd.copies
    got = fa.flash_attention_fwd(q_odd, k_wide, v, causal=True, window=24)
    assert fa.flash_attention_fwd.copies == before + 2
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._launch(q_odd, k, v, True, 24, True)


@pytest.mark.cuda
def test_flash_fwd_mma_build_has_no_spills(cuda_device):
    """ptxas's report of the tensor-core forward kernel: every
    instantiation (head dim bounds 64, 80, 128 and 256, lse on and off)
    stores no spill."""
    from repro_torch.kernels import _build

    usage = _build.ptxas_usage(_build.build_log("flash_attention_mma"))
    assert len(usage) == 8, usage
    for bound in (64, 80, 128, 256):
        for lse in ("Lb0E", "Lb1E"):
            found = [u for name, u in usage.items()
                     if "ffm_kernel" in name and f"ILi{bound}E" in name
                     and lse in name]
            assert len(found) == 1, (bound, lse, usage)
            assert found[0][1] == 0, (bound, lse, found)


@pytest.mark.cuda
def test_flash_fwd_mma_tiles_match_the_library(cuda_device):
    """``fwd_tiles`` (which ``fwd_issued_flops`` counts with) mirrors the
    CUDA source: the shared memory the library reports is what those
    tiles take (Q once, K and V double-buffered, rows of hd + 8), at
    every hd."""
    from repro_torch.kernels import flash_attention as fa

    for hd in range(16, 257, 16):
        bq, bk = fa.fwd_tiles(hd)
        assert fa.smem_bytes(hd) == (bq + 4 * bk) * (hd + 8) * 2


# ---------------------------------------------- flash attention backward ----
def _f64_reference(q, k, v, do, causal, window):
    """dq, dk, dv of the plain backward computed in float64 from the
    exact float64 forward (dense, for small shapes)."""
    from repro_torch.core.online_softmax import attention_mask
    from repro_torch.kernels import flash_attention as fa

    b, s, h, hd = q.shape
    kv = k.shape[2]
    q64, k64, v64, do64 = (x.double() for x in (q, k, v, do))
    kr = k64.repeat_interleave(h // kv, dim=2)
    vr = v64.repeat_interleave(h // kv, dim=2)
    sc = torch.einsum("bqhd,bkhd->bhqk", q64, kr) / hd ** 0.5
    ok = attention_mask(torch.arange(s, device=q.device),
                        torch.arange(k.shape[1], device=q.device),
                        causal=causal, window=window)
    sc = torch.where(ok, sc, torch.tensor(-1e30, dtype=torch.float64,
                                          device=q.device))
    lse = torch.logsumexp(sc, dim=-1)                       # (b, h, s)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, -1), vr)
    return fa.flash_attention_bwd_plain(q64, k64, v64, do64, out, lse,
                                        causal=causal, window=window)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 80, 128, 256])
@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernels_match_plain(cuda_device, hd, groups, causal,
                                       window, dtype):
    """dq, dk, dv of the two backward kernels against the plain version
    on the forward kernel's out and lse; S = 200 is no multiple of the
    tiles.  Tolerances: 1e-4 in f32 (the reference suite's gradient
    tolerance), and the f32 kernels also against the plain version run
    in f64 from the exact forward; bf16 within 1e-4 + 2^-6·|want| per
    element (both round one float32 result)."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = qkv(2, 200, 2 * groups, 2, hd, dtype, cuda_device)
    do = qkv(2, 200, 2 * groups, 2, hd, dtype, cuda_device, seed=1)[0]
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    before = (fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkdv.launches)
    got = fa.flash_attention_bwd(q, k, v, do, out, lse, causal=causal,
                                 window=window)
    torch.cuda.synchronize()
    assert (fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkdv.launches) == (before[0] + 1,
                                                      before[1] + 1)
    want = fa.flash_attention_bwd_plain(q, k, v, do, out, lse, causal=causal,
                                        window=window)
    atol, rtol = ((1e-4, 1e-4) if dtype == torch.float32
                  else (1e-4, 2.0 ** -6))
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        torch.testing.assert_close(a.float(), b.float(), atol=atol,
                                   rtol=rtol)
    if dtype == torch.float32:
        for a, b in zip(got, _f64_reference(q, k, v, do, causal, window)):
            torch.testing.assert_close(a.double(), b, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_flash_bwd_strided_inputs_and_rows_without_keys(cuda_device):
    """q, k, v read in place from a fused (B, S, 3, H, hd) buffer; S >=
    Sk + window leaves rows with no key, which get no gradient."""
    from repro_torch.kernels import flash_attention as fa

    rng = np.random.default_rng(4)
    fused = torch.from_numpy(rng.standard_normal((2, 96, 3, 4, 32),
                                                 dtype=np.float32))
    fused = fused.to(cuda_device)
    q = fused[:, :, 0]
    k, v = fused[:, :40, 1, :2], fused[:, :40, 2, :2]
    do = torch.from_numpy(rng.standard_normal((2, 96, 4, 32),
                                              dtype=np.float32))
    do = do.to(cuda_device)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True, window=24)
    got = fa.flash_attention_bwd(q, k, v, do, out, lse, causal=True,
                                 window=24)
    want = fa.flash_attention_bwd_plain(q, k, v, do, out, lse, causal=True,
                                        window=24)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    assert (got[0][:, 40 + 24 - 1:] == 0).all()


@pytest.mark.cuda
def test_flash_bwd_refuses_what_it_cannot_run(cuda_device):
    from repro_torch.kernels import flash_attention as fa

    for hd, dtype, msg in [(72, torch.float32, "multiples of 16"),
                           (288, torch.float32, "up to 256"),
                           (64, torch.float16, "float32 or bfloat16")]:
        q, k, v = qkv(1, 64, 2, 1, hd, dtype, cuda_device)
        lse = torch.zeros((1, 2, 64), device=cuda_device)
        with pytest.raises(ValueError, match=msg):
            fa.flash_attention_bwd(q, k, v, q, q, lse)


# the bfloat16 route: csrc/flash_attention_bwd_mma.cu (tensor cores)
BWD_MASKS = [(True, None), (True, 40), (False, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("hd", list(range(16, 257, 16)))
@pytest.mark.parametrize("groups", [1, 2, 4])
@pytest.mark.parametrize("causal,window", BWD_MASKS,
                         ids=["causal", "window", "none"])
def test_flash_bwd_bf16_kernels_match_plain(cuda_device, monkeypatch, hd,
                                            groups, causal, window):
    """The tensor-core kernels against the plain version at every head
    dim they serve, with ragged S and Sk (no multiple of any tile; S > Sk
    at odd multiples of 16, S < Sk at even ones), each gradient within
    1e-4 + 2^-6·|want| per element.  The plain version is made to raise
    during the kernels' call: a bf16 CUDA input never reaches it."""
    from repro_torch.kernels import flash_attention as fa

    s, sk = (133, 97) if hd // 16 % 2 else (97, 160)
    rng = np.random.default_rng(hd + groups)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)).to(cuda_device, torch.bfloat16)
        for shape in ((2, s, 2 * groups, hd), (2, sk, 2, hd),
                      (2, sk, 2, hd), (2, s, 2 * groups, hd)))
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    want = fa.flash_attention_bwd_plain(q, k, v, do, out, lse, causal=causal,
                                        window=window)

    def refuse(*args, **kwargs):
        raise AssertionError("a bf16 CUDA input reached the plain version")

    monkeypatch.setattr(fa, "flash_attention_bwd_plain", refuse)
    before = (fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkdv.launches,
              fa.flash_attention_bwd.copies)
    got = fa.flash_attention_bwd(q, k, v, do, out, lse, causal=causal,
                                 window=window)
    torch.cuda.synchronize()
    assert (fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkdv.launches,
            fa.flash_attention_bwd.copies) == (before[0] + 1,
                                               before[1] + 1, before[2])
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        torch.testing.assert_close(a.float(), b.float(), atol=1e-4,
                                   rtol=2.0 ** -6)


@pytest.mark.cuda
def test_flash_bwd_bf16_repeat_is_bit_identical(cuda_device):
    """No atomics and a fixed order of sums: two launches agree bit for
    bit."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = qkv(1, 1024, 8, 2, 80, torch.bfloat16, cuda_device, seed=5)
    do = qkv(1, 1024, 8, 2, 80, torch.bfloat16, cuda_device, seed=6)[0]
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True, window=256)
    first = fa.flash_attention_bwd(q, k, v, do, out, lse, causal=True,
                                   window=256)
    again = fa.flash_attention_bwd(q, k, v, do, out, lse, causal=True,
                                   window=256)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_bwd_bf16_strided_and_unaligned_inputs(cuda_device):
    """q, k, v read in place from a fused (B, S, 3, H, hd) buffer (rows
    16-byte aligned: no copy); q at a 2-byte offset and do with a row
    stride of hd + 4 are copied first, counted; a kernel launched
    directly on an unaligned input refuses it."""
    from repro_torch.kernels import flash_attention as fa

    rng = np.random.default_rng(7)
    fused = torch.from_numpy(rng.standard_normal(
        (2, 96, 3, 4, 32), dtype=np.float32)).to(cuda_device, torch.bfloat16)
    q, k, v = fused[:, :, 0], fused[:, :, 1, :2], fused[:, :, 2, :2]
    do = torch.from_numpy(rng.standard_normal(
        (2, 96, 4, 36), dtype=np.float32)).to(cuda_device,
                                              torch.bfloat16)[..., :32]
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True, window=24)
    want = fa.flash_attention_bwd_plain(q, k, v, do, out, lse, causal=True,
                                        window=24)
    before = fa.flash_attention_bwd.copies
    got = fa.flash_attention_bwd(q, k, v, do, out, lse, causal=True,
                                 window=24)
    assert fa.flash_attention_bwd.copies == before + 1         # do
    buf = torch.empty(q.numel() + 8, dtype=torch.bfloat16,
                      device=cuda_device)
    q_odd = buf[1:1 + q.numel()].view(q.shape)
    q_odd.copy_(q)
    got_odd = fa.flash_attention_bwd(q_odd, k, v, do, out, lse,
                                     causal=True, window=24)
    assert fa.flash_attention_bwd.copies == before + 3         # q, do
    for a, b, c in zip(got, got_odd, want):
        assert torch.equal(a, b)
        torch.testing.assert_close(a.float(), c.float(), atol=1e-4,
                                   rtol=2.0 ** -6)
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention_bwd_dq(q_odd, k, v, do.contiguous(), lse, delta,
                                  torch.empty_like(q), causal=True,
                                  window=24)


@pytest.mark.cuda
def test_flash_bwd_mma_build_has_no_spills(cuda_device):
    """ptxas's report of the tensor-core kernels: every instantiation (head
    dim bounds 64, 80, 128 and 256: minicpm-2b, h2o-danube-1.8b, qwen3-14b,
    gemma-7b, and every other hd below each bound) stores no spill."""
    from repro_torch.kernels import _build

    usage = _build.ptxas_usage(_build.build_log("flash_attention_bwd_mma"))
    assert len(usage) == 8, usage
    for bound in (64, 80, 128, 256):
        for kern in ("fbm_dq_kernel", "fbm_dkdv_kernel"):
            found = [u for name, u in usage.items()
                     if kern in name and f"ILi{bound}E" in name]
            assert len(found) == 1, (kern, bound, usage)
            assert found[0][1] == 0, (kern, bound, found)


@pytest.mark.cuda
def test_flash_bwd_mma_tiles_match_the_library(cuda_device):
    """``bwd_tiles`` (which ``bwd_issued_flops`` counts with) mirrors the
    CUDA source: the shared memory the library reports is what those
    tiles take, at every hd."""
    from repro_torch.kernels import flash_attention as fa

    for hd in range(16, 257, 16):
        t = fa.bwd_tiles(hd)
        row = (hd + 8) * 2
        assert fa.bwd_smem_bytes(0, hd) == \
            (2 * t["dq"][0] + 4 * t["dq"][1]) * row
        assert fa.bwd_smem_bytes(1, hd) == \
            (2 * t["dkdv"][0] + 4 * t["dkdv"][1]) * row + 16 * t["dkdv"][1]


# the float32 route: csrc/flash_attention_tf32.cu and
# csrc/flash_attention_bwd_tf32.cu (3xTF32 on the tensor cores)
@pytest.mark.cuda
def test_flash_tf32_builds_have_no_spills(cuda_device):
    """ptxas's report of the 3xTF32 kernels: every instantiation (head dim
    bounds 64, 80, 128 and 256; the forward with the lse on and off)
    exists and stores no spill."""
    from repro_torch.kernels import _build

    fwd = _build.ptxas_usage(_build.build_log("flash_attention_tf32"))
    bwd = _build.ptxas_usage(_build.build_log("flash_attention_bwd_tf32"))
    assert len(fwd) == 8 and len(bwd) == 8, (fwd, bwd)
    for bound in (64, 80, 128, 256):
        for usage, kerns in ((fwd, ("Lb0E", "Lb1E")),
                             (bwd, ("fbt_dq_kernel", "fbt_dkdv_kernel"))):
            for kern in kerns:
                found = [u for name, u in usage.items()
                         if kern in name and f"ILi{bound}E" in name]
                assert len(found) == 1, (kern, bound, usage)
                assert found[0][1] == 0, (kern, bound, found)


@pytest.mark.cuda
def test_flash_tf32_tiles_match_the_library(cuda_device):
    """``fwd_tiles`` and ``bwd_tiles`` for float32 (which the issued-flop
    counts use) mirror the CUDA sources: the shared memory each library
    reports is what those tiles take (rows of hd + 4 floats), at every
    hd, and fits one CTA's 227 KB."""
    from repro_torch.kernels import flash_attention as fa

    f32 = torch.float32
    for hd in range(16, 257, 16):
        row = (hd + 4) * 4
        bq, bk = fa.fwd_tiles(hd, f32)
        assert fa.smem_bytes(hd, f32) == (bq + 4 * bk) * row
        t = fa.bwd_tiles(hd, f32)
        assert fa.bwd_smem_bytes(0, hd, f32) == \
            (2 * t["dq"][0] + 4 * t["dq"][1]) * row
        assert fa.bwd_smem_bytes(1, hd, f32) == \
            (2 * t["dkdv"][0] + 4 * t["dkdv"][1]) * row + 16 * t["dkdv"][1]
        assert max(fa.smem_bytes(hd, f32), fa.bwd_smem_bytes(0, hd, f32),
                   fa.bwd_smem_bytes(1, hd, f32)) <= 232448


@pytest.mark.cuda
@pytest.mark.parametrize("hd", list(range(16, 257, 16)))
@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("causal,window", BWD_MASKS,
                         ids=["causal", "window", "none"])
def test_flash_tf32_kernels_match_plain(cuda_device, monkeypatch, hd,
                                        groups, causal, window):
    """The 3xTF32 forward and backward kernels against their plain
    versions at every head dim they serve, with ragged S and Sk (no
    multiple of any tile; S > Sk at odd multiples of 16, S < Sk at even
    ones): out within 2e-5, lse within 1e-4, each gradient within 1e-4.
    The plain versions are made to raise during the kernels' calls: a
    float32 CUDA input never reaches them."""
    from repro_torch.kernels import flash_attention as fa

    s, sk = (133, 97) if hd // 16 % 2 else (97, 160)
    rng = np.random.default_rng(hd + groups)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)).to(cuda_device)
        for shape in ((2, s, 2 * groups, hd), (2, sk, 2, hd),
                      (2, sk, 2, hd), (2, s, 2 * groups, hd)))
    want, want_lse = fa.flash_attention_fwd_plain(q, k, v, causal=causal,
                                                  window=window)
    want_grads = fa.flash_attention_bwd_plain(q, k, v, do, want, want_lse,
                                              causal=causal, window=window)

    def refuse(*args, **kwargs):
        raise AssertionError("a float32 CUDA input reached the plain version")

    monkeypatch.setattr(fa, "flash_attention_fwd_plain", refuse)
    monkeypatch.setattr(fa, "flash_attention_bwd_plain", refuse)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    got = fa.flash_attention_bwd(q, k, v, do, want, want_lse, causal=causal,
                                 window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, want, atol=2e-5, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)
    for a, b in zip(got, want_grads):
        assert a.dtype == torch.float32 and a.shape == b.shape
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_flash_tf32_repeat_is_bit_identical(cuda_device):
    """No atomics and a fixed order of sums: two launches of the float32
    forward and backward agree bit for bit."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = qkv(1, 1024, 8, 2, 80, torch.float32, cuda_device, seed=5)
    do = qkv(1, 1024, 8, 2, 80, torch.float32, cuda_device, seed=6)[0]
    first = fa.flash_attention_fwd(q, k, v, causal=True, window=256)
    again = fa.flash_attention_fwd(q, k, v, causal=True, window=256)
    grads = [fa.flash_attention_bwd(q, k, v, do, *first, causal=True,
                                    window=256) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(first + grads[0], again + grads[1]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_tf32_unaligned_rows_are_copied_and_counted(cuda_device):
    """The float32 kernels copy rows by 16 bytes too: q at a 4-byte offset
    and k with a row stride of hd + 2 are copied (and counted) before the
    forward's launch, do so before the backward's; the results equal the
    aligned inputs' bit for bit, and a kernel launched directly on an
    unaligned input refuses it."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = qkv(2, 96, 4, 2, 32, torch.float32, cuda_device, seed=7)
    do = qkv(2, 96, 4, 2, 32, torch.float32, cuda_device, seed=8)[0]
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True, window=24)
    grads = fa.flash_attention_bwd(q, k, v, do, out, lse, causal=True,
                                   window=24)
    buf = torch.empty(q.numel() + 4, device=cuda_device)
    q_odd = buf[1:1 + q.numel()].view(q.shape)
    q_odd.copy_(q)
    k_wide = torch.zeros((2, 96, 2, 34), device=cuda_device)[..., :32]
    k_wide.copy_(k)
    before = (fa.flash_attention_fwd.copies, fa.flash_attention_bwd.copies)
    got = fa.flash_attention_fwd(q_odd, k_wide, v, causal=True, window=24)
    got_grads = fa.flash_attention_bwd(q_odd, k_wide, v, do, out, lse,
                                       causal=True, window=24)
    assert (fa.flash_attention_fwd.copies, fa.flash_attention_bwd.copies) \
        == (before[0] + 2, before[1] + 2)
    for a, b in zip(got + got_grads, (out, lse) + grads):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._launch(q_odd, k, v, True, 24, True)


@pytest.mark.cuda
def test_reduced_train_step_on_card_launch_counts(cuda_device):
    """One step of reduced h2o-danube-1.8b (remat, 2 microbatches) on the
    card: the forward kernel launches twice per layer and microbatch,
    each backward kernel once; the step's parameters agree with the
    chunked path's (``flash_jnp``) within 2e-4."""
    import dataclasses

    import repro_torch.configs as C
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer
    from repro_torch.models.params import init_params
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step

    cfg = dataclasses.replace(C.get_config("h2o-danube-1.8b").reduced(),
                              q_chunk=32, kv_chunk=32, swa_window=48,
                              remat=True, microbatches=2)
    toks = torch.randint(0, cfg.vocab, (4, 128), device=cuda_device,
                         generator=torch.Generator(cuda_device).manual_seed(1))
    params = {}
    for impl in ("flash_pallas", "flash_jnp"):
        c = dataclasses.replace(cfg, attention_impl=impl)
        model = init_params(transformer.build_model(c, cuda_device),
                            torch.Generator(cuda_device).manual_seed(0))
        state = opt.init_state(model)
        counts = (fa.flash_attention_fwd.launches,
                  fa.flash_attention_bwd_dq.launches,
                  fa.flash_attention_bwd_dkdv.launches)
        make_train_step(c, opt.OptConfig(lr=1e-3, warmup=1))(
            model, state, {"tokens": toks, "labels": toks})
        torch.cuda.synchronize()
        launched = (fa.flash_attention_fwd.launches - counts[0],
                    fa.flash_attention_bwd_dq.launches - counts[1],
                    fa.flash_attention_bwd_dkdv.launches - counts[2])
        per = cfg.n_layers * cfg.microbatches
        assert launched == ((2 * per, per, per) if impl == "flash_pallas"
                            else (0, 0, 0))
        params[impl] = dict(model.named_parameters())
    for n, p in params["flash_pallas"].items():
        torch.testing.assert_close(p, params["flash_jnp"][n], atol=2e-4,
                                   rtol=2e-4)


# ---- the other LM families on the card -----------------------------------
def _family(arch, device, **kw):
    import dataclasses

    import repro_torch.configs as C
    from repro_torch.models import transformer
    from repro_torch.models.params import init_params

    cfg = dataclasses.replace(C.get_config(arch).reduced(), q_chunk=32,
                              kv_chunk=32, **kw)
    model = init_params(transformer.build_model(cfg, device),
                        torch.Generator(device).manual_seed(0))
    return cfg, model


@pytest.mark.cuda
def test_hybrid_prefill_launches_once_per_shared_invocation(cuda_device):
    """Reduced zamba2 with 5 layers and ``attn_every`` 2: the shared
    block runs at layers 0, 2 and 4, so a prefill launches the forward
    kernel 3 times, and its logits and shared caches agree with the
    chunked path's within 1e-4 (f32)."""
    import dataclasses

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer

    cfg, model = _family("zamba2-2.7b", cuda_device, n_layers=5,
                         attention_impl="flash_pallas")
    assert transformer.n_shared_invocations(cfg) == 3
    toks = torch.randint(0, cfg.vocab, (2, 128), device=cuda_device,
                         generator=torch.Generator(cuda_device).manual_seed(1))
    before = fa.flash_attention_fwd.launches
    logits, cache = transformer.prefill(cfg, model, {"tokens": toks}, 136)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + 3
    assert len(cache["shared_attn"]) == 3
    want, want_cache = transformer.prefill(
        dataclasses.replace(cfg, attention_impl="flash_jnp"), model,
        {"tokens": toks}, 136)
    torch.testing.assert_close(logits, want, atol=1e-4, rtol=1e-4)
    for got, ref in zip(cache["shared_attn"], want_cache["shared_attn"]):
        for key in ("k", "v", "slot_pos"):
            torch.testing.assert_close(got[key], ref[key], atol=1e-4,
                                       rtol=1e-4)


@pytest.mark.cuda
def test_encoder_forward_launches_bidirectional(cuda_device, monkeypatch):
    """Reduced hubert-xlarge: the encoder's prefill launches the forward
    kernel once per layer, every launch bidirectional, and its logits
    agree with the chunked path's within 1e-4 (f32)."""
    import dataclasses

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer

    cfg, model = _family("hubert-xlarge", cuda_device,
                         attention_impl="flash_pallas")
    gen = torch.Generator(cuda_device).manual_seed(1)
    frames = torch.randn((2, 128, cfg.d_model), device=cuda_device,
                         generator=gen)
    batch = {"frames": frames,
             "mask": torch.rand((2, 128), device=cuda_device,
                                generator=gen) < 0.2}
    flags = []
    launch = fa._launch

    def spy(q, k, v, causal, window, with_lse):
        flags.append(causal)
        return launch(q, k, v, causal, window, with_lse)

    monkeypatch.setattr(fa, "_launch", spy)
    before = fa.flash_attention_fwd.launches
    logits, cache = transformer.prefill(cfg, model, batch, 0)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + cfg.n_layers
    assert flags == [False] * cfg.n_layers and cache == {}
    want, _ = transformer.prefill(
        dataclasses.replace(cfg, attention_impl="flash_jnp"), model, batch, 0)
    torch.testing.assert_close(logits, want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("capacity_factor", [1.25, 1.0])
@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_moe_block_on_card_matches_cpu(cuda_device, capacity_factor, act):
    """``apply_moe`` at granite's 40 experts (48 slots), top-8, on the
    card against the same call on the CPU, f32, within 1e-4: the
    routing, the dropped slots (at capacity 1.0) and the bucket scatter
    agree, and a second call on the card is equal bit for bit."""
    from repro_torch.models import moe

    defs, e = moe.moe_defs(64, 96, 40, act=act)
    gen = torch.Generator().manual_seed(2)
    p = {k: torch.randn(d.shape, generator=gen) * d.fan_in() ** -0.5
         for k, d in defs.items()}
    x = torch.randn((3, 200, 64), generator=gen)
    kw = dict(n_experts=40, n_padded=e, top_k=8, act=act,
              capacity_factor=capacity_factor)
    want, want_aux = moe.apply_moe(x, p, **kw)
    pc = {k: v.to(cuda_device) for k, v in p.items()}
    got, aux = moe.apply_moe(x.to(cuda_device), pc, **kw)
    again, _ = moe.apply_moe(x.to(cuda_device), pc, **kw)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(aux.cpu(), want_aux, atol=1e-4, rtol=1e-4)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_hybrid_train_step_on_card_launch_counts(cuda_device):
    """One step of reduced zamba2 (remat) on the card: the shared block's
    2 invocations launch the forward kernel twice each (forward and
    recompute) and each backward kernel once; the parameters agree with
    the chunked path's within 2e-4."""
    import dataclasses

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step

    toks = torch.randint(0, 256, (2, 128), device=cuda_device,
                         generator=torch.Generator(cuda_device).manual_seed(1))
    params = {}
    for impl in ("flash_pallas", "flash_jnp"):
        cfg, model = _family("zamba2-2.7b", cuda_device, remat=True,
                             attention_impl=impl)
        state = opt.init_state(model)
        counts = (fa.flash_attention_fwd.launches,
                  fa.flash_attention_bwd_dq.launches,
                  fa.flash_attention_bwd_dkdv.launches)
        make_train_step(cfg, opt.OptConfig(lr=1e-3, warmup=1))(
            model, state, {"tokens": toks, "labels": toks})
        torch.cuda.synchronize()
        launched = (fa.flash_attention_fwd.launches - counts[0],
                    fa.flash_attention_bwd_dq.launches - counts[1],
                    fa.flash_attention_bwd_dkdv.launches - counts[2])
        assert launched == ((4, 2, 2) if impl == "flash_pallas"
                            else (0, 0, 0))
        params[impl] = dict(model.named_parameters())
    for n, p in params["flash_pallas"].items():
        torch.testing.assert_close(p, params["flash_jnp"][n], atol=2e-4,
                                   rtol=2e-4)


# ---- sharded runs and campaigns on the card ---------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("name,shape,boundary", [
    ("j2d5pt", (96, 128), Boundary.dirichlet(0.0)),
    ("j2d9pt", (96, 128), Boundary.periodic()),
    ("j2d5pt", (96, 128), Boundary.reflect()),
    ("j3d7pt", (32, 24, 40), Boundary.dirichlet(0.0)),
])
def test_sharded_one_card_mesh(cuda_device, name, shape, boundary):
    """A (2, 2) mesh of ``cuda:0`` × 4: every shard and slab stays on the
    card, no stencil kernel launches, the exchange counter reads one
    round per block, and the result is within 2e-5 of ``.run`` (and bit
    for bit a second run); a mesh of size 1 is ``.run``, launches
    included."""
    from repro_torch.api import planned_exchange_rounds
    from repro_torch.core.distributed import ppermute
    from repro_torch.launch.mesh import make_stencil_mesh

    spec = tspec.get(name)
    x = field(shape).to(cuda_device)
    mesh = make_stencil_mesh((2, 2), devices=[cuda_device] * 4)
    prog = compile_stencil(spec, shape, t=3, mesh=mesh, boundary=boundary)
    single = compile_stencil(spec, shape, t=3, boundary=boundary)
    launches = (st.ebisu2d_padded.launches, st3.ebisu3d_padded.launches)
    calls = ppermute.calls
    got = prog.run_sharded(x, 7)
    torch.cuda.synchronize()
    assert (st.ebisu2d_padded.launches, st3.ebisu3d_padded.launches) == \
        launches
    assert ppermute.calls - calls == planned_exchange_rounds(7, 3) * 2 * 2
    assert got.device == x.device
    assert torch.equal(got, prog.run_sharded(x, 7))
    torch.testing.assert_close(got, single.run(x, 7), atol=2e-5, rtol=2e-5)
    one = compile_stencil(spec, shape, t=3, boundary=boundary,
                          mesh=make_stencil_mesh((1, 1),
                                                 devices=[cuda_device]))
    before = st.ebisu2d_padded.launches + st3.ebisu3d_padded.launches
    assert torch.equal(one.run_sharded(x, 7), single.run(x, 7))
    torch.cuda.synchronize()
    assert (st.ebisu2d_padded.launches + st3.ebisu3d_padded.launches
            - before) == 2 * 3


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape", [("j2d5pt", (96, 128)),
                                        ("j3d7pt", (32, 24, 40))])
def test_card_campaign_bitexact(cuda_device, tmp_path, name, shape):
    """A campaign on the card crashed after leg 2 and resumed equals
    ``.run`` bit for bit, and launches one kernel a sweep of its legs."""
    from repro_torch.api import sweep_schedule
    from repro_torch.resilient import (CampaignStore, leg_schedule,
                                       resume_campaign)

    spec = tspec.get(name)
    x = field(shape).to(cuda_device)
    prog = compile_stencil(spec, shape, t=3)
    want = prog.run(x, 11)
    store = CampaignStore(str(tmp_path))

    class Crash(Exception):
        pass

    def crash(leg, steps_done):
        if leg == 2:
            store.wait()
            raise Crash()

    before = st.ebisu2d_padded.launches + st3.ebisu3d_padded.launches
    with pytest.raises(Crash):
        prog.run_resumable(x, 11, store=store, on_leg=crash)
    rep = resume_campaign(prog, store)
    torch.cuda.synchronize()
    assert rep.result.device == x.device and torch.equal(rep.result, want)
    legs = leg_schedule(11, 3)
    sweeps = sum(len(sweep_schedule(n, 3)) for _, n in legs)
    # legs 1-2 before the crash, 3-4 after it: no leg runs twice
    assert (st.ebisu2d_padded.launches + st3.ebisu3d_padded.launches
            - before) == sweeps


# the stencil service and measured tuning on the card
# (tests/test_torch_serve.py and tests/test_torch_tuning.py hold them
# against the reference on the CPU)
@pytest.mark.cuda
@pytest.mark.parametrize("name,shape,t,steps", [("j2d5pt", (200, 300), 4, 9),
                                                ("j3d7pt", (24, 40, 72), 2,
                                                 5)])
def test_service_batch_launches_one_sweep_for_all(cuda_device, name, shape,
                                                  t, steps):
    """Three requests coalesce into one ``run_batched``: one launch a
    sweep for the whole batch, each result equal to its ``.run``."""
    from repro_torch.api import sweep_schedule
    from repro_torch.faults import SimClock
    from repro_torch.serve.stencil_service import (ServeRequest,
                                                   ServiceConfig,
                                                   ServiceCore)

    spec = tspec.get(name)
    wrapper = st.ebisu2d_padded if spec.ndim == 2 else st3.ebisu3d_padded
    core = ServiceCore(ServiceConfig(max_batch=4, device="cuda"),
                       clock=SimClock())
    xs = [field(shape, seed=i) for i in range(3)]
    before = wrapper.launches
    tks = [core.submit(ServeRequest(spec, x.numpy(), total_t=steps, t=t,
                                    tenant=f"t{i}"))
           for i, x in enumerate(xs)]
    core.drain()
    torch.cuda.synchronize()
    assert wrapper.launches - before == len(sweep_schedule(steps, t))
    prog = compile_stencil(spec, shape, t=t)
    for x, tk in zip(xs, tks):
        assert tk.ok and tk.batched_width == 3
        assert tk.result().device.type == "cuda"
        torch.testing.assert_close(tk.result(), prog.run(x.cuda(), steps),
                                   atol=2e-5, rtol=0)


@pytest.mark.cuda
def test_service_asyncio_on_card(cuda_device):
    """The asyncio front door dispatches on worker threads: every request
    resolves, on the card, to its ``.run``; the launches are counted."""
    import asyncio

    from repro_torch.serve.stencil_service import (ServeRequest,
                                                   ServiceConfig,
                                                   StencilService)

    spec, shape = tspec.get("j2d5pt"), (96, 128)
    xs = [field(shape, seed=i) for i in range(8)]

    async def go():
        svc = StencilService(ServiceConfig(max_batch=4, batch_window_ms=1.0,
                                           device="cuda"))
        await svc.start()
        try:
            return await asyncio.gather(*[svc.submit(ServeRequest(
                spec, x, total_t=6, t=3)) for x in xs])
        finally:
            await svc.stop()

    before = st.ebisu2d_padded.launches
    ys = asyncio.run(go())
    torch.cuda.synchronize()
    assert st.ebisu2d_padded.launches > before
    prog = compile_stencil(spec, shape, t=3)
    for x, y in zip(xs, ys):
        torch.testing.assert_close(y, prog.run(x.cuda(), 6), atol=2e-5,
                                   rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape", [("j2d5pt", (256, 320)),
                                        ("j3d7pt", (32, 48, 96))])
def test_tuned_program_on_card(cuda_device, tmp_path, name, shape):
    """``tune`` on the card (CUDA events) persists a native-tier record a
    tuned compile replays with zero timing; the tuned program launches
    its sweeps and agrees with the oracle."""
    from repro_torch.api import sweep_schedule
    from repro_torch.tuning import search
    from repro_torch.tuning.plandb import hw_fingerprint

    spec = tspec.get(name)
    res = search.tune(spec, shape, db=str(tmp_path), budget=12,
                      max_candidates=4)
    assert res.record["key"]["tier"] == "native"
    assert res.record["key"]["hw"] == hw_fingerprint("cuda")
    before = search.TIMING["calls"]
    prog = compile_stencil(spec, shape, mode="tuned", plan_db=str(tmp_path))
    assert search.TIMING["calls"] == before
    assert prog.tuned["source"] == "plandb" and prog.device.type == "cuda"
    wrapper = st.ebisu2d_padded if spec.ndim == 2 else st3.ebisu3d_padded
    x = field(shape, seed=5).cuda()
    steps = 2 * prog.t + 1
    launches = wrapper.launches
    y = prog.run(x, steps)
    torch.cuda.synchronize()
    assert wrapper.launches - launches == len(sweep_schedule(steps, prog.t))
    torch.testing.assert_close(y, ref.reference(x, spec, steps), atol=2e-5,
                               rtol=0)


# ---- LM-side parallelism on a one-card mesh ------------------------------
def _lm_mesh(device):
    from repro_torch.launch.mesh import ensure_fake_devices, make_host_mesh

    return make_host_mesh(2, 2, devices=ensure_fake_devices(4, device))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "granite-moe-3b-a800m",
                                  "mamba2-130m", "zamba2-2.7b",
                                  "internvl2-1b"])
def test_mesh_prefill_decode_on_card(cuda_device, arch):
    """Reduced ``arch`` on a (2, 2) mesh of ``cuda:0`` × 4, the flash
    kernel in every shard: prefill and two decode steps within 1e-4 of
    the unsharded path on the card, greedy tokens equal (f32), and the
    forward kernel launched once per attending layer per shard."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer
    from repro_torch.models.parallel import MeshModel

    cfg, model = _family(arch, cuda_device, attention_impl="flash_pallas")
    mesh = _lm_mesh(cuda_device)
    mcfg = cfg.with_mesh(mesh)
    mm = MeshModel(mcfg, mesh, model)
    g = torch.Generator(cuda_device).manual_seed(1)
    s = 64 - (cfg.vlm_patches if cfg.family == "vlm" else 0)
    batch = {"tokens": torch.randint(0, cfg.vocab, (4, s), generator=g,
                                     device=cuda_device)}
    if cfg.family == "vlm":
        batch["patches"] = torch.randn((4, cfg.vlm_patches,
                                        cfg.vlm_patch_dim), generator=g,
                                       device=cuda_device)
    want, wc = transformer.prefill(cfg, model, batch, 80)
    before = fa.flash_attention_fwd.launches
    got, gc = transformer.prefill(mcfg, mm, batch, 80)
    torch.cuda.synchronize()
    calls = {"ssm": 0, "hybrid": transformer.n_shared_invocations(cfg)}.get(
        cfg.family, cfg.n_layers)
    assert fa.flash_attention_fwd.launches - before == 4 * calls
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    tok = torch.argmax(want[:, -1], dim=-1)[:, None]
    for i in range(2):
        w, wc = transformer.decode_step(cfg, model, wc, tok, 64 + i)
        o, gc = transformer.decode_step(mcfg, mm, gc, tok, 64 + i)
        torch.testing.assert_close(o, w, atol=1e-4, rtol=1e-4)
        assert torch.equal(torch.argmax(o[:, -1], -1),
                           torch.argmax(w[:, -1], -1))
        tok = torch.argmax(w[:, -1], dim=-1)[:, None]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "granite-moe-3b-a800m",
                                  "mamba2-130m"])
def test_mesh_train_step_on_card(cuda_device, arch, monkeypatch):
    """One train step of reduced ``arch`` (remat, 2 microbatches) on a
    (2, 2) mesh of ``cuda:0`` × 4 against the unsharded step on the card:
    parameters within 2e-4 (f32, lr 1e-3; the MoE's aux loss weighed
    0.01: the expert-parallel aux is the data shards' mean by design, so
    the unsharded step takes each data shard's aux of the dense dispatch
    and their mean), and the flash kernels launched per shard: the
    forward twice per attending layer and microbatch, each backward
    kernel once."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import moe
    from repro_torch.models.parallel import MeshModel
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step

    cfg, model = _family(arch, cuda_device, attention_impl="flash_pallas",
                         remat=True, microbatches=2, moe_aux_weight=0.01)
    mesh = _lm_mesh(cuda_device)
    mcfg = cfg.with_mesh(mesh)
    mm = MeshModel(mcfg, mesh, model)
    toks = torch.randint(0, cfg.vocab, (4, 64), device=cuda_device,
                         generator=torch.Generator(cuda_device).manual_seed(1))
    batch = {"tokens": toks, "labels": toks}
    ocfg = opt.OptConfig(lr=1e-3, warmup=1)
    dense = moe.apply_moe

    def ep_aux(x, p, **kw):
        y, _ = dense(x, p, **kw)
        return y, sum(dense(xd, p, **kw)[1] for xd in x.chunk(2)) / 2

    with monkeypatch.context() as m:
        m.setattr(moe, "apply_moe", ep_aux)
        make_train_step(cfg, ocfg)(model, opt.init_state(model), batch)
    counts = (fa.flash_attention_fwd.launches,
              fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkdv.launches)
    make_train_step(mcfg, ocfg)(mm, opt.init_state(mm), batch)
    torch.cuda.synchronize()
    per = 0 if cfg.family == "ssm" else cfg.n_layers * 2 * 4
    assert (fa.flash_attention_fwd.launches - counts[0],
            fa.flash_attention_bwd_dq.launches - counts[1],
            fa.flash_attention_bwd_dkdv.launches - counts[2]) == \
        (2 * per, per, per)
    got = mm.state_dict(cuda_device)
    for n, p in model.named_parameters():
        torch.testing.assert_close(got[n], p.detach(), atol=2e-4, rtol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kv,hd,window", [
    (2, 2048, 16, 4, 80, 1024),     # h2o-danube's heads on a model shard
    (1, 2048, 16, 4, 80, 1024),     # ... and a training microbatch row
    (2, 2048, 12, 4, 64, None)])    # granite-moe's heads on a model shard
def test_flash_fwd_at_shard_shapes(cuda_device, dtype, b, s, h, kv, hd,
                                   window):
    """The flash forward at the per-shard head counts a (2, 2) mesh gives
    the full-width configs (GQA kept), against its plain version: f32
    within 2e-5, bf16 within two units in the last place per element."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(cuda_device).manual_seed(3)
    q, k, v = (torch.randn(sh, generator=g, device=cuda_device).to(dtype)
               for sh in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)))
    out, lse = fa.flash_attention_fwd(q, k, v, window=window)
    want, want_lse = fa.flash_attention_fwd_plain(q, k, v, window=window)
    if dtype == torch.float32:
        torch.testing.assert_close(out, want, atol=2e-5, rtol=2e-5)
    else:
        lim = 1e-4 + 2.0 ** -6 * want.double().abs()
        assert bool(((out.double() - want.double()).abs() <= lim).all())
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_at_shard_shape(cuda_device, dtype):
    """The flash backward kernels at the per-shard shape of a (2, 2)
    mesh's h2o-danube train step (one row, 16 of 32 heads, 4 kv heads,
    hd 80, windowed), against their plain version: f32 within 1e-4, bf16
    within two units in the last place per element."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(cuda_device).manual_seed(4)
    b, s, h, kv, hd, window = 1, 2048, 16, 4, 80, 1024
    q, k, v, do = (torch.randn(sh, generator=g, device=cuda_device).to(dtype)
                   for sh in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd),
                              (b, s, h, hd)))
    out, lse = fa.flash_attention_fwd(q, k, v, window=window)
    got = fa.flash_attention_bwd(q, k, v, do, out, lse, window=window)
    want = fa.flash_attention_bwd_plain(q, k, v, do, out, lse, window=window)
    for a, w in zip(got, want):
        if dtype == torch.float32:
            torch.testing.assert_close(a, w, atol=1e-4, rtol=1e-4)
        else:
            lim = 1e-4 + 2.0 ** -6 * w.double().abs()
            assert bool(((a.double() - w.double()).abs() <= lim).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape,t", [("j2d5pt", (200, 300), 4),
                                          ("j2d25pt", (130, 97), 2),
                                          ("j3d7pt", (40, 33, 70), 3),
                                          ("j3d27pt", (24, 20, 36), 2)])
def test_plan_none_launches_the_kernel(cuda_device, name, shape, t):
    """``compile_stencil(plan=None)`` on the card launches the kernel at
    the request-default tile, once a sweep, never the plain version, and
    the deprecated shim ``ops.ebisu_stencil`` is that program; both are
    held to the planned program within 1e-4."""
    import warnings

    from repro_torch.kernels import ops

    spec = tspec.get(name)
    x = field(shape).to(cuda_device)
    prog = compile_stencil(spec, shape, t=t, plan=None, device=cuda_device)
    counter = st.ebisu2d_padded if spec.ndim == 2 else st3.ebisu3d_padded
    before = counter.launches
    got = prog.run(x, 2 * t + 1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        shim = ops.ebisu_stencil(x, spec, t)
    torch.cuda.synchronize()
    assert counter.launches == before + 4       # t, t, 1, then the shim's
    want = compile_stencil(spec, shape, t=t, device=cuda_device)
    assert float((got - want.run(x, 2 * t + 1)).abs().max()) < 1e-4
    assert torch.equal(shim, prog.apply(x))
    assert float((shim - want.apply(x)).abs().max()) < 1e-4
