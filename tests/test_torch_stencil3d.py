"""The 3-D sweep of the port (``repro_torch.kernels.stencil3d``): the
roofline term it copies from the reference, the planner,
the launch geometry, the tap-set header generator, and the CUDA kernel's
z-streaming schedule.

The CUDA kernel itself runs only on a card (tests marked ``cuda`` in
``tests/test_torch_cuda.py``).  On the CPU its schedule is held by
:func:`emulate_stream`, which replays what every CTA does: one thread
level per time step, ``B`` planes per barrier, each level's two batches
of plane buffers (one written, one read), the input copied one batch
ahead into level 0's spare batch, the z partial sums of every cell
summed in the kernel's order (plane by plane, offsets in the
generator's grouping), the in-plane narrowing on tiled axes, the zero
frame of untiled ones, the interior/edge split of the masks, and which
planes reach the output.  Every plane buffer carries a tag, the plane
last written there: a read whose tag is not the plane it wants (not yet
written, or already overwritten) fails, and so does an iteration that
writes a buffer it also reads, which is the race a missing barrier would
be.

Tolerances: 1e-6 between the emulator and the plain version (the same
taps, summed in another order), 2e-5 against the reference (its suite's
own).
"""
import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import define as ref_define
from repro.core import roofline as ref_rl
from repro.core import stencil_spec as ref_spec
from repro.kernels import ref as jref
from repro_torch.api import compile_stencil
from repro_torch.api import define as tdefine
from repro_torch.core import planner as tplanner
from repro_torch.core import roofline as trl
from repro_torch.core import stencil_spec as tspec
from repro_torch.kernels import _build
from repro_torch.kernels import stencil2d as st2
from repro_torch.kernels import stencil3d as st3
from repro_torch.kernels import stencil3d_gen as gen
from repro_torch.launch import stencil_registers as regs

SPECS_3D = [n for n, s in tspec.TABLE2.items() if s.ndim == 3]
SPECS_2D = [n for n, s in tspec.TABLE2.items() if s.ndim == 2]


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny tensors: torch's default intra-op threads only oversubscribe
    the CPU the other test workers share."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def field(shape, seed=0):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def padded(x: np.ndarray, layout) -> torch.Tensor:
    xp = torch.zeros(layout, dtype=torch.float32)
    xp[tuple(slice(0, n) for n in x.shape)] = torch.from_numpy(x)
    return xp


def emulate_stream(xp, spec, t, shape, zc, ty, tx):
    """The CUDA kernel's per-CTA schedule, replayed CTA by CTA; returns
    the output and the shared-memory bytes its plane buffers held.  A
    leading batch axis of ``xp`` folds into the grid's z as the kernel
    folds it: z block ``field · chunks + chunk``, each CTA reading and
    writing its field's layout alone."""
    zdim, ydim, xdim = shape
    layout = xp.shape
    fields = xp.reshape((-1,) + tuple(layout[-3:]))
    geom = st3.launch_geometry_3d(spec, t, shape, zc=zc, ty=ty, tx=tx)
    assert geom["threads"] is not None, "the kernel refuses this launch"
    rings = tplanner.ring_extents_3d(spec, t, shape, ty, tx)
    (ty, tx), (tiled_y, tiled_x) = rings["tile"], rings["tiled"]
    fy, fx = rings["frame"]
    ext = rings["extents"]
    rad, halo = spec.radius, geom["halo"]
    span = zc + 2 * halo
    nb = -(-span // tplanner.planes_per_barrier(rad))
    b_planes = tplanner.planes_per_barrier(rad)
    groups = gen.tap_groups(spec.taps)
    sy, sx = (rad if tiled_y else 0), (rad if tiled_x else 0)
    outs = torch.full_like(fields, float("nan"))

    def region(s, tiled, tile_org, frame, dim, extent):
        """(first index, count, global coordinate of index 0) of the
        cells level ``s`` computes (level 0: loads) on one axis."""
        if tiled:
            return 0, extent, tile_org - (t - s) * rad
        return frame, dim, -frame

    def inside(gz, gys, gxs):
        return (((gys >= 0) & (gys < ydim))[:, None]
                & ((gxs >= 0) & (gxs < xdim))[None, :] & (0 <= gz < zdim))

    gz_n, gy_n, gx_n = geom["grid"]
    updates = 0
    for bz in range(gz_n * len(fields)):
        field_, cz = divmod(bz, gz_n)
        xp, out = fields[field_], outs[field_]
        for cy in range(gy_n):
            for cx in range(gx_n):
                z_base = cz * zc - halo
                reg = [(region(s, tiled_y, cy * ty, fy, ydim, ext[s][0]),
                        region(s, tiled_x, cx * tx, fx, xdim, ext[s][1]))
                       for s in range(t + 1)]
                (y0, ny, yo), (x0, nx, xo) = reg[0]
                interior = (z_base >= 0 and z_base + span <= zdim
                            and yo + y0 >= 0 and yo + y0 + ny <= ydim
                            and xo + x0 >= 0 and xo + x0 + nx <= xdim)
                # buffers[s][parity][b], zeroed once; tags: plane held
                bufs = [[[torch.zeros(ext[s]) for _ in range(b_planes)]
                         for _ in range(2)] for s in range(t)]
                tags = [[[None] * b_planes for _ in range(2)]
                        for _ in range(t)]
                acc = {s: torch.zeros((2 * rad,) + (reg[s][0][1],
                                                    reg[s][1][1]))
                       for s in range(1, t + 1)}
                for it in range(nb + t):
                    seen = [[[b.clone() for b in par] for par in lev]
                            for lev in bufs]              # at the barrier
                    seen_tags = [[list(par) for par in lev] for lev in tags]
                    reads, writes = set(), set()
                    if it < nb:                  # cp.async, batch it
                        for b in range(b_planes):
                            p = it * b_planes + b
                            if p >= span:
                                continue
                            gz = z_base + p
                            gys = torch.arange(yo + y0, yo + y0 + ny)
                            gxs = torch.arange(xo + x0, xo + x0 + nx)
                            ok = inside(gz, gys, gxs)
                            assert not interior or ok.all()
                            sub = xp[min(max(gz, 0), xp.shape[0] - 1)][
                                gys.clamp(0, xp.shape[1] - 1)][
                                :, gxs.clamp(0, xp.shape[2] - 1)]
                            bufs[0][it & 1][b][y0:y0 + ny, x0:x0 + nx] = (
                                sub if interior
                                else torch.where(ok, sub, torch.zeros(())))
                            tags[0][it & 1][b] = p
                            writes.add((0, it & 1, b))
                    for s in range(1, t + 1):
                        m = it - s
                        if not 0 <= m < nb:
                            continue
                        (ly0, lny, lyo), (lx0, lnx, lxo) = reg[s]
                        gys = torch.arange(lyo + ly0, lyo + ly0 + lny)
                        gxs = torch.arange(lxo + lx0, lxo + lx0 + lnx)
                        for b in range(b_planes):
                            p_in = m * b_planes - (s - 1) * rad + b
                            p_out = p_in - rad
                            w = list(acc[s]) + [torch.zeros((lny, lnx))]
                            if (s - 1) * rad <= p_in < span - (s - 1) * rad:
                                par = (it - 1) & 1
                                assert seen_tags[s - 1][par][b] == p_in, (
                                    s, it, b, seen_tags[s - 1][par][b], p_in)
                                reads.add((s - 1, par, b))
                                src = seen[s - 1][par][b]
                                for dy, dx, terms in groups:
                                    r0, c0 = ly0 + sy + dy, lx0 + sx + dx
                                    v = src[r0:r0 + lny, c0:c0 + lnx]
                                    for dz, c in terms:
                                        w[rad - dz] = w[rad - dz] + c * v
                            acc[s] = torch.stack(w[1:])
                            if not s * rad <= p_out < span - s * rad:
                                continue
                            updates += lny * lnx
                            gz = z_base + p_out
                            ok = inside(gz, gys, gxs)
                            assert not interior or ok.all()
                            o = w[0] if interior else torch.where(
                                ok, w[0], torch.zeros(()))
                            if s < t:
                                bufs[s][it & 1][b][ly0:ly0 + lny,
                                                   lx0:lx0 + lnx] = o
                                tags[s][it & 1][b] = p_out
                                writes.add((s, it & 1, b))
                            else:
                                out[gz, gys[0]:gys[-1] + 1,
                                    gxs[0]:gxs[-1] + 1] = o
                    assert not reads & writes, (it, reads & writes)
    assert updates == len(fields) * geom["cell_updates"]
    smem = 4 * sum(b.numel() for lev in bufs for par in lev for b in par)
    return outs.reshape(layout), smem


# (shape, t, zc, ty, tx): zc not dividing zdim, tiles narrower than the
# halo, an untiled y, an untiled plane
TILINGS = [((13, 11, 21), 2, 5, 4, 8),
           ((11, 9, 17), 3, 4, 2, 5),
           ((12, 7, 19), 2, 5, None, 6),
           ((9, 6, 10), 2, 4, None, None)]


@pytest.mark.parametrize("name", ["j3d7pt", "j3d13pt", "j3d27pt"])
@pytest.mark.parametrize("shape,t,zc,ty,tx", TILINGS)
def test_stream_schedule_matches_plain(name, shape, t, zc, ty, tx):
    spec = tspec.get(name)
    geom = st3.launch_geometry_3d(spec, t, shape, zc=zc, ty=ty, tx=tx)
    xp = padded(field(shape, seed=t), geom["padded"])
    got, smem = emulate_stream(xp, spec, t, shape, zc, ty, tx)
    kw = dict(zip(("zdim", "ydim", "xdim"), shape))
    want = st3.ebisu3d_padded_plain(xp, spec, t, **kw)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    assert smem == geom["kernel_smem_bytes"]
    assert smem <= tplanner.smem_bytes_3d(spec, t, shape, ty, tx, 4)


@pytest.mark.parametrize("name", ["j2d5pt", "j2d9pt-gol"])
@pytest.mark.parametrize("tx", [None, 7])
def test_stream_schedule_lifted_2d(name, tx):
    """The lifted 2-D spec: y extent 1 and y reach 0, so its rings are
    single rows, and the streamed axis carries no overlapped halo."""
    spec = tspec.lift_2d_to_3d(tspec.get(name))
    shape, t = (14, 1, 20), 3
    geom = st3.launch_geometry_3d(spec, t, shape, zc=5, tx=tx)
    assert geom["tiled"][1] is False and geom["padded"][1] == 1
    xp = padded(field(shape, seed=1), geom["padded"])
    got, smem = emulate_stream(xp, spec, t, shape, 5, None, tx)
    want = st3.ebisu3d_padded_plain(xp, spec, t, zdim=14, ydim=1, xdim=20)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    assert smem == geom["kernel_smem_bytes"] <= geom["smem_bytes"]
    ref2d = np.asarray(jref.reference_unrolled(
        jnp.asarray(field((14, 20), seed=1)), ref_spec.get(name), t))
    np.testing.assert_allclose(got[:14, 0, :20].numpy(), ref2d, atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("name", SPECS_3D)
def test_plain_sweep_matches_reference(name):
    shape, t = (19, 13, 21), 3
    geom = st3.launch_geometry_3d(tspec.get(name), t, shape, zc=6, ty=5,
                                  tx=32)
    x = field(shape, seed=2)
    got = st3.ebisu3d_padded(padded(x, geom["padded"]), tspec.get(name), t,
                             zdim=19, ydim=13, xdim=21, zc=6, ty=5, tx=32)
    want = np.asarray(jref.reference_unrolled(jnp.asarray(x),
                                              ref_spec.get(name), t))
    np.testing.assert_allclose(got[:19, :13, :21].numpy(), want, atol=2e-5,
                               rtol=2e-5)
    assert not got[19:].any() and not got[:, 13:].any()
    whole = st3.ebisu3d(torch.from_numpy(x), tspec.get(name), t, zc=6, ty=5,
                        tx=32)
    torch.testing.assert_close(whole, got[:19, :13, :21], atol=0, rtol=0)


@pytest.mark.parametrize("name", SPECS_3D)
def test_v_smtile_matches_reference(name):
    for t in (1, 3, 6):
        for tile in [(32, 32), (9, 32), (64, 128), (288, 384)]:
            assert (trl.v_smtile(tspec.get(name), t, tile)
                    == ref_rl.v_smtile(ref_spec.get(name), t, tile))


@pytest.mark.parametrize("name", SPECS_3D)
@pytest.mark.parametrize("itemsize", [4, 8])
def test_h100_plan_3d_fits_and_fills_the_card(name, itemsize):
    spec = tspec.get(name)
    p = tplanner.plan(spec, trl.H100, itemsize=itemsize)
    assert p.smem_bytes <= 232448 and 0 < p.pp.v < 1
    # the paper's own EBISU depth (Table 3) at the paper domain
    t = tspec.TABLE3_DEPTHS[name]["ebisu"]
    zc, ty, tx, resident = tplanner.fit_tile_3d(spec, t, spec.domain,
                                                trl.H100, itemsize)
    assert tx % 32 == 0 and ty < 288
    assert tplanner.smem_bytes_3d(spec, t, spec.domain, ty, tx,
                                  itemsize) <= 232448
    geom = st3.launch_geometry_3d(spec, t, spec.domain, zc=zc, ty=ty, tx=tx,
                                  itemsize=itemsize)
    assert np.prod(geom["grid"]) >= 132
    assert resident * (geom["smem_bytes"] + 1024) <= 233472


def test_plan_3d_lowers_depth_until_a_tile_fits():
    spec = tspec.get("j3d13pt")                          # radius 2
    assert tplanner.fit_tile_3d(spec, 14, spec.domain, trl.H100, 8) is None
    p = tplanner.plan(spec, trl.H100, max_t=14, itemsize=8)
    assert p.t < 14 and p.block[2] % 32 == 0


def test_geometry_and_padding():
    spec = tspec.get("j3d13pt")                          # radius 2
    g = st3.launch_geometry_3d(spec, 3, (19, 13, 70), zc=5, ty=4, tx=32)
    assert g["block"] == (5, 4, 32) and g["halo"] == 6
    assert g["padded"] == (20, 16, 96) and g["grid"] == (4, 4, 3)
    assert g["tiled"] == (True, True, True) and g["ring"] == 6
    assert g["fetched_cells"] == (5 + 12) * (4 + 12) * (32 + 12)
    g = st3.launch_geometry_3d(spec, 3, (19, 13, 70), zc=19, ty=13)
    assert g["padded"] == (19, 13, 70) and g["tiled"] == (True, False, False)
    assert g["fetched_cells"] == (19 + 12) * 13 * 70
    assert st3.chunk_geometry(spec, 3, 7) == (7, 6)
    assert tplanner.resolve_axis(13, 20) == (13, False)
    assert tplanner.resolve_axis(13, None) == (13, False)
    with pytest.raises(ValueError):
        st3.chunk_geometry(spec, 3, 0)


def test_wrapper_checks_and_counts():
    spec = tspec.get("j3d7pt")
    xp = torch.zeros((16, 12, 20))
    before = st3.ebisu3d_padded.launches
    out = torch.empty_like(xp)
    kw = dict(zdim=14, ydim=12, xdim=20, zc=8)
    assert st3.ebisu3d_padded(xp, spec, 1, out=out, **kw) is out
    assert st3.ebisu3d_padded.launches == before      # CPU: no kernel
    with pytest.raises(ValueError, match="not the layout"):
        st3.ebisu3d_padded(xp, spec, 1, **{**kw, "zc": 5})
    with pytest.raises(ValueError, match="3-D"):
        st3.ebisu3d_padded(xp, tspec.get("j2d5pt"), 1, **kw)
    with pytest.raises(ValueError, match="cuda or cpu"):
        st3.ebisu3d_padded(torch.zeros((16, 12, 20), device="meta"), spec,
                           1, **kw)


def test_kernel_taps_order_and_limits():
    dz, dy, dx, c = st3.kernel_taps(tspec.get("j3d13pt").taps)  # star r2
    assert (dz[0], dy[0], dx[0]) == (0, 0, 0)                 # center
    assert not dy[1:5].any() and not dx[1:5].any()            # then z
    assert not dz[5:9].any() and not dx[5:9].any()            # then y
    assert not dz[9:].any() and not dy[9:].any()              # then x
    assert abs(c.sum() - 1.0) < 1e-12
    box = tspec.get("j3d27pt").taps                           # tap order
    dz, dy, dx, _ = st3.kernel_taps(box)
    assert [tuple(map(int, o)) for o in zip(dz, dy, dx)] == [o for o, _ in box]
    dz, dy, dx, c = st3.kernel_taps(tspec.box_taps(3, 3))     # 343 taps
    assert len(c) == 343 and abs(c.sum() - 1.0) < 1e-12
    # every set validate_spec accepts: up to the 17^3 box of radius 8
    assert st3.MAX_TAPS == (2 * tspec.MAX_RADIUS + 1) ** 3 == 4913
    with pytest.raises(ValueError, match="at most 4913 taps"):
        st3.kernel_taps(tspec.box_taps(3, 9))                 # 6859 taps


# ------------------------------------------------ the tap-set header ----
# an asymmetric radius-2 tap set whose dz != 0 taps sit off the centre
# column (the Table-2 stars keep theirs on it)
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


def header_taps(text):
    """``[(dz, dy, dx, coef)]`` of a generated header, in its order."""
    out = []
    for dy, dx, body in re.findall(r"OFFSET\((-?\d+), (-?\d+), (.*)\) \\",
                                   text):
        for dz, lit in re.findall(r"TAP\((-?\d+), ([-+0-9a-fA-Fxp.]+)\)",
                                  body):
            out.append((int(dz), int(dy), int(dx), float.fromhex(lit)))
    return out


def define(text, name):
    return int(re.search(rf"#define {name} (\d+)", text).group(1))


@pytest.mark.parametrize("spec", [tspec.get(n) for n in SPECS_3D]
                         + [tspec.lift_2d_to_3d(tspec.get(n))
                            for n in SPECS_2D]
                         + [ASYM_R2, BOX_R2, STAR_R4, ASYM_R8,
                            regs.dense_spec(8)],
                         ids=lambda s: s.name)
def test_header_holds_kernel_taps_bit_exact(spec):
    text = gen.header(spec.taps)
    got = header_taps(text)
    dz, dy, dx, c = st3.kernel_taps(spec.taps)
    want = list(zip(map(int, dz), map(int, dy), map(int, dx), map(float, c)))
    assert sorted(got) == sorted(want)          # bit-exact coefficients
    # within each in-plane offset, the terms keep kernel_taps order
    for dyx in {(q[1], q[2]) for q in want}:
        assert ([q for q in got if (q[1], q[2]) == dyx]
                == [q for q in want if (q[1], q[2]) == dyx])
    rad = spec.radius
    assert define(text, "ST3_RADIUS") == rad
    assert define(text, "ST3_NTAPS") == len(want)
    assert define(text, "ST3_REACH_Y") == tplanner.axis_reach(spec, 1)
    assert define(text, "ST3_REACH_X") == tplanner.axis_reach(spec, 2)
    assert define(text, "ST3_PLANES") == tplanner.planes_per_barrier(rad)
    assert define(text, "ST3_SLOTS_F32") == tplanner.max_cells_per_thread(
        rad, 4)
    assert define(text, "ST3_SLOTS_F64") == tplanner.max_cells_per_thread(
        rad, 8)
    assert [(y, x) for y, x, _ in gen.tap_groups(spec.taps)] == list(
        dict.fromkeys((q[1], q[2]) for q in want))


def test_tapset_library_path_keys_on_header_and_flags(monkeypatch):
    j7 = tspec.get("j3d7pt")
    same = tspec.define_stencil(j7.taps, name="another-name")
    path = _build.library_path("stencil3d", st3.tapset_header(j7))
    assert _build.library_path("stencil3d", st3.tapset_header(same)) == path
    bumped = [(off, c * (1 + 2 ** -40)) for off, c in j7.taps]
    assert _build.library_path(
        "stencil3d", gen.header(tuple(bumped))) != path
    assert _build.library_path(
        "stencil3d", st3.tapset_header(tspec.get("j3d27pt"))) != path
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path("stencil3d", st3.tapset_header(j7)) != path
    with pytest.raises(ValueError, match="template"):
        _build.library_path("stencil3d")
    with pytest.raises(ValueError, match="template"):
        _build.library_path("flash_attention", "// a header")


@pytest.mark.parametrize("spec", [ASYM_R2, BOX_R2], ids=lambda s: s.name)
@pytest.mark.parametrize("shape,t,zc,ty,tx", [((11, 10, 13), 2, 4, 3, 5),
                                              ((9, 7, 8), 1, 9, None, None)])
def test_stream_schedule_custom_taps(spec, shape, t, zc, ty, tx):
    """Radius 2 with ``B = 3`` planes per barrier, asymmetric taps off
    the centre column, and the 125-tap box."""
    geom = st3.launch_geometry_3d(spec, t, shape, zc=zc, ty=ty, tx=tx)
    xp = padded(field(shape, seed=5), geom["padded"])
    got, smem = emulate_stream(xp, spec, t, shape, zc, ty, tx)
    want = st3.ebisu3d_padded_plain(xp, spec, t, **dict(zip(
        ("zdim", "ydim", "xdim"), shape)))
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    assert smem == geom["kernel_smem_bytes"] <= geom["smem_bytes"]


@pytest.mark.parametrize("spec", [STAR_R4, ASYM_R8], ids=lambda s: s.name)
def test_stream_schedule_high_radius(spec):
    """Radius 4 and 8: ``B = 3 < rad + 1`` planes per barrier, tiles
    narrower than the halo, an untiled x."""
    shape, t, zc, ty, tx = (11, 10, 13), 1, 4, 3, None
    geom = st3.launch_geometry_3d(spec, t, shape, zc=zc, ty=ty, tx=tx)
    assert geom["cells_per_thread"] <= tplanner.max_cells_per_thread(
        spec.radius, 8)
    xp = padded(field(shape, seed=6), geom["padded"])
    got, smem = emulate_stream(xp, spec, t, shape, zc, ty, tx)
    want = st3.ebisu3d_padded_plain(xp, spec, t, **dict(zip(
        ("zdim", "ydim", "xdim"), shape)))
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    assert smem == geom["kernel_smem_bytes"] <= geom["smem_bytes"]


def test_register_probe_tap_sets():
    """The tap sets the register probe and the card tests build: a star
    and a dense set at each radius, within the kernel's tap limit, and
    headers at the planner's budget or another."""
    specs = regs.probe_specs()
    assert [s.radius for s in specs] == [r for r in range(1, 9)
                                         for _ in (0, 1)]
    for spec in specs:
        assert len(spec.taps) <= st3.MAX_TAPS
        text, k32, k64 = regs.header_at(spec, None)
        assert text == gen.header(spec.taps)
        assert (k32, k64) == (tplanner.max_cells_per_thread(spec.radius, 4),
                              tplanner.max_cells_per_thread(spec.radius, 8))
    dense = regs.dense_spec(8)
    assert len(dense.taps) == 128 and dense.radius == 8
    text, k32, k64 = regs.header_at(dense, 64)
    assert (k32, k64) == (4, 2)
    assert define(text, "ST3_SLOTS_F32") == 4
    assert define(text, "ST3_SLOTS_F64") == 2


def test_kernel_bounds_cap_the_planner():
    """The planner's 3-D tiles fit the kernel's thread and register
    bounds at the paper's domain in both dtypes; a launch past them has
    no spread, and the planner lowers the depth instead."""
    for name in SPECS_3D:
        spec = tspec.get(name)
        t = tspec.TABLE3_DEPTHS[name]["ebisu"]
        for itemsize in (4, 8):
            zc, ty, tx, _ = tplanner.fit_tile_3d(spec, t, spec.domain,
                                                 trl.H100, itemsize)
            threads, k = tplanner.kernel_threads_3d(spec, t, spec.domain, ty,
                                                    tx, itemsize)
            assert sum(threads) <= tplanner.KERNEL_THREADS_3D
            assert k <= tplanner.max_cells_per_thread(spec.radius, itemsize)
            assert sum(n * k for n in threads) >= sum(
                ny * nx for ny, nx in tplanner.level_regions_3d(
                    spec, t, spec.domain, ty, tx))
    j7 = tspec.get("j3d7pt")
    assert tplanner.kernel_threads_3d(j7, 16, (64, 256, 256), None, None,
                                      4) is None
    assert tplanner.kernel_threads_3d(j7, 33, (4, 4, 4), None, None,
                                      4) is None
    geom = st3.launch_geometry_3d(j7, 16, (64, 256, 256), zc=64)
    assert geom["threads"] is None and geom["cells_per_thread"] is None
    wide = tspec.define_stencil(tspec.star_taps(3, 4), normalize=True)
    shape = (64, 300, 300)
    fit = tplanner.fit_tile_3d(wide, 3, shape, trl.H100, 4)
    assert fit is not None
    assert tplanner.kernel_threads_3d(wide, 3, shape, *fit[1:3], 4)


def test_stream_schedule_large_tap_set_with_a_batch():
    """The 343-tap box of radius 3 replayed on a batch of two fields,
    folded into the grid's z as the kernel folds it: the replay equals
    the plain version, each field its own sweep, and the reference
    within 2e-5."""
    spec, rspec = tdefine.box(3, radius=3), ref_define.box(3, radius=3)
    shape, t, zc, ty, tx = (8, 9, 10), 1, 3, 5, None
    geom = st3.launch_geometry_3d(spec, t, shape, zc=zc, ty=ty, tx=tx)
    xs = [field(shape, seed=21 + i) for i in range(2)]
    xp = torch.stack([padded(x, geom["padded"]) for x in xs])
    got, smem = emulate_stream(xp, spec, t, shape, zc, ty, tx)
    kw = dict(zip(("zdim", "ydim", "xdim"), shape))
    plain = st3.ebisu3d_padded_plain(xp, spec, t, **kw)
    torch.testing.assert_close(got, plain, atol=1e-6, rtol=0)
    assert smem == geom["kernel_smem_bytes"]
    for i, x in enumerate(xs):
        assert torch.equal(plain[i], st3.ebisu3d_padded_plain(xp[i], spec, t,
                                                              **kw))
        want = np.asarray(jref.reference_unrolled(jnp.asarray(x), rspec, t))
        np.testing.assert_allclose(got[i, :8, :9, :10].numpy(), want,
                                   atol=2e-5, rtol=2e-5)


def test_wrapper_takes_a_batch_axis():
    """``(B, zp, yp, xp)`` is B fields in one call (one launch on the
    card, its z chunks folded into the grid's z); the z extent caps the
    batch."""
    spec = tspec.get("j3d7pt")
    kw = dict(zdim=14, ydim=12, xdim=20, zc=8)
    xs = torch.from_numpy(np.stack([field((16, 12, 20), seed=i)
                                    for i in range(3)]))
    before = st3.ebisu3d_padded.launches
    out = st3.ebisu3d_padded(xs, spec, 2, **kw)
    assert st3.ebisu3d_padded.launches == before      # CPU: no kernel
    for i in range(3):
        assert torch.equal(out[i], st3.ebisu3d_padded(xs[i], spec, 2, **kw))
    with pytest.raises(ValueError, match="not the layout"):
        st3.ebisu3d_padded(xs[None], spec, 2, **kw)
    many = torch.zeros((1, 16, 12, 20)).expand(st3.MAX_GRID_Z // 2 + 1, -1,
                                               -1, -1)
    with pytest.raises(ValueError, match="z chunks over the batch"):
        st3.ebisu3d_padded(many, spec, 2, **kw)


def test_compile_refuses_a_set_over_the_cap_for_the_card(monkeypatch):
    """No set that validate_spec accepts is over either kernel's cap, so
    ``compile_stencil`` refuses none for the card (the radius-8 boxes,
    289 and 4913 taps, get past the spec checks to the device, which the
    CPU lacks); a set past the caps is refused by the spec checks, before
    any kernel, naming the radius bound."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for spec, shape in ((tdefine.box(2, radius=8), (40, 40)),
                        (tdefine.box(3, radius=8), (40, 40, 40))):
        assert len(spec.taps) == (st3.MAX_TAPS if spec.ndim == 3
                                  else 289)
        header = (st3 if spec.ndim == 3 else st2).tapset_header(spec)
        assert f"NTAPS {len(spec.taps)}" in header
        with pytest.raises(RuntimeError, match='device="cpu"'):
            compile_stencil(spec, shape)
    over = dataclasses.replace(tdefine.box(3, radius=3),
                               taps=tuple(tspec.box_taps(3, 9)), radius=9)
    with pytest.raises(ValueError, match="radius"):
        compile_stencil(over, (40, 40, 40), device="cpu")
