"""The 3-D sweep of the port (``repro_torch.kernels.stencil3d``): the ring
algebra and the roofline term it copies from the reference, the planner,
the launch geometry, and the CUDA kernel's z-streaming schedule.

The CUDA kernel itself runs only on a card (tests marked ``cuda`` in
``tests/test_torch_cuda.py``).  On the CPU its schedule is held by
:func:`emulate_stream`, which replays what every CTA does: the rings of
the port's ``MultiQueueLayout``, one input plane per iteration, every
level lagged by ``rad + 1`` planes, the in-plane narrowing on tiled
axes, the zero frame of untiled ones, the masks, and which planes reach
the output.  It reads each iteration's rings as they stood at the
iteration's barrier and fails if an iteration writes a slot it also
reads, which is the race a missing barrier would be.

Tolerances: 1e-6 between the emulator and the plain version (the same
sums in the same order), 2e-5 against the reference (its suite's own).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import multiqueue as ref_mq
from repro.core import roofline as ref_rl
from repro.core import stencil_spec as ref_spec
from repro.kernels import ref as jref
from repro_torch.core import multiqueue as mq
from repro_torch.core import planner as tplanner
from repro_torch.core import roofline as trl
from repro_torch.core import stencil_spec as tspec
from repro_torch.kernels import stencil3d as st3

SPECS_3D = [n for n, s in tspec.TABLE2.items() if s.ndim == 3]
SPECS_2D = [n for n, s in tspec.TABLE2.items() if s.ndim == 2]


def field(shape, seed=0):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def padded(x: np.ndarray, layout) -> torch.Tensor:
    xp = torch.zeros(layout, dtype=torch.float32)
    xp[tuple(slice(0, n) for n in x.shape)] = torch.from_numpy(x)
    return xp


def emulate_stream(xp, spec, t, shape, zc, ty, tx):
    """The CUDA kernel's per-CTA schedule, replayed CTA by CTA; returns
    the output and the shared-memory bytes the rings held."""
    zdim, ydim, xdim = shape
    geom = st3.launch_geometry_3d(spec, t, shape, zc=zc, ty=ty, tx=tx)
    rings = tplanner.ring_extents_3d(spec, t, shape, ty, tx)
    (ty, tx), (tiled_y, tiled_x) = rings["tile"], rings["tiled"]
    fy, fx = rings["frame"]
    ext = rings["extents"]
    rad = spec.radius
    halo = geom["halo"]
    span = zc + 2 * halo
    layout = mq.kernel_layout(t, rad)
    dz, dy, dx, coef = st3.kernel_taps(spec.taps)
    sy, sx = (rad if tiled_y else 0), (rad if tiled_x else 0)
    out = torch.full_like(xp, float("nan"))
    gz_n, gy_n, gx_n = geom["grid"]

    def region(s, tiled, tile_org, frame, dim, extent):
        """(first index, count, global coordinate of index 0) of the
        cells level ``s`` computes on one in-plane axis."""
        if tiled:
            return 0, extent, tile_org - (t - s) * rad
        return frame, dim, -frame

    for cz in range(gz_n):
        for cy in range(gy_n):
            for cx in range(gx_n):
                ring = [torch.zeros((layout.ring,) + ext[s])
                        for s in range(t)]
                z_base = cz * zc - halo
                for k in range(span + t):
                    seen = [r.clone() for r in ring]   # at the barrier
                    reads, writes = set(), set()
                    if k < span:
                        y0, ny, yo = region(0, tiled_y, cy * ty, fy, ydim,
                                            ext[0][0])
                        x0, nx, xo = region(0, tiled_x, cx * tx, fx, xdim,
                                            ext[0][1])
                        gz = z_base + k
                        gys = torch.arange(yo + y0, yo + y0 + ny)
                        gxs = torch.arange(xo + x0, xo + x0 + nx)
                        plane = torch.zeros((ny, nx))
                        if 0 <= gz < zdim:
                            ok = (((gys >= 0) & (gys < ydim))[:, None]
                                  & ((gxs >= 0) & (gxs < xdim))[None, :])
                            sub = xp[gz][gys.clamp(0, xp.shape[1] - 1)][
                                :, gxs.clamp(0, xp.shape[2] - 1)]
                            plane = torch.where(ok, sub, plane)
                        ring[0][layout.slot(k), y0:y0 + ny,
                                x0:x0 + nx] = plane
                        writes.add((0, layout.slot(k)))
                    for s in range(1, t + 1):
                        # one plane behind what is producible per level
                        j = layout.producible(s, k) - s
                        if not s * rad <= j <= span - 1 - s * rad:
                            continue
                        y0, ny, yo = region(s, tiled_y, cy * ty, fy, ydim,
                                            ext[s][0])
                        x0, nx, xo = region(s, tiled_x, cx * tx, fx, xdim,
                                            ext[s][1])
                        win = {p: layout.slot(p)
                               for p in layout.window(s, j)}
                        reads |= {(s - 1, q) for q in win.values()}
                        acc = None
                        for q in range(len(coef)):
                            src = seen[s - 1][win[j + int(dz[q])]]
                            r0, c0 = y0 + sy + int(dy[q]), x0 + sx + int(dx[q])
                            term = src[r0:r0 + ny, c0:c0 + nx] * float(coef[q])
                            acc = term if acc is None else acc + term
                        gz = z_base + j
                        gys = torch.arange(yo + y0, yo + y0 + ny)
                        gxs = torch.arange(xo + x0, xo + x0 + nx)
                        ok = (((gys >= 0) & (gys < ydim))[:, None]
                              & ((gxs >= 0) & (gxs < xdim))[None, :]
                              & (0 <= gz < zdim))
                        acc = torch.where(ok, acc, torch.zeros(()))
                        if s < t:
                            ring[s][layout.slot(j), y0:y0 + ny,
                                    x0:x0 + nx] = acc
                            writes.add((s, layout.slot(j)))
                        else:
                            out[gz, gys[0]:gys[-1] + 1,
                                gxs[0]:gxs[-1] + 1] = acc
                    assert not reads & writes, (k, reads & writes)
    smem = 4 * sum(r.numel() for r in ring)
    return out, smem


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
    assert smem == tplanner.smem_bytes_3d(spec, t, shape, ty, tx, 4)
    assert smem == geom["smem_bytes"]


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
    assert smem == geom["smem_bytes"]
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


def test_multiqueue_copy_matches_reference():
    """The port's layout is the reference's in its "shifting" addressing,
    the one the kernel uses."""
    for depth, rad in [(1, 1), (5, 2), (8, 1), (3, 4)]:
        a = ref_mq.MultiQueueLayout.make(depth, rad, "shifting")
        b = mq.MultiQueueLayout.make(depth, rad)
        assert (a.depth, a.radius, a.ring) == dataclasses.astuple(b)
        assert a.live_span() == b.live_span()
        for z in range(40):
            assert a.slot(z) == b.slot(z)
            for s in range(1, depth + 1):
                assert a.producible(s, z) == b.producible(s, z)
                assert a.window(s, z) == b.window(s, z)
        a.check()
        b.check()
    with pytest.raises(ValueError, match="clobber"):
        mq.MultiQueueLayout(2, 1, 3).check()
    assert mq.kernel_layout(8, 1).ring == 4
    assert mq.kernel_layout(5, 2).ring == 6


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
    with pytest.raises(ValueError, match="at most"):
        st3.kernel_taps(tspec.box_taps(3, 3))                 # 343 taps
