"""The 2-D sweep of the port (``repro_torch.kernels.stencil2d``): its plain
version against the reference's Pallas strip kernel (interpret mode), the
launch geometry, and the CUDA kernel's tile schedule.

The CUDA kernel itself runs only on a card (tests marked ``cuda``, which
skip elsewhere).  On the CPU its schedule is held by
:func:`emulate_tiles`, which replays what every CTA does — load a
``(bh + 2·halo) × (bw + 2·halo)`` window zero outside the domain, take
``t`` valid-mode steps that narrow one radius per side, mask to the
domain after each, write the inner ``bh × bw`` — so the tiling argument
(halo wider than the tile, ragged edges, trapezoid on both axes) is
tested here even though the CUDA source is not.

Tolerance 2e-5 (f32), the reference suite's own.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stencil_spec as ref_spec
from repro.kernels import ref as jref
from repro.kernels import stencil2d as jst
from repro_torch.core import stencil_spec as tspec
from repro_torch.kernels import stencil2d as st
from repro_torch.kernels.taps import engine_for

SPECS_2D = [n for n, s in tspec.TABLE2.items() if s.ndim == 2]
TOL = 2e-5


def field(shape, seed=0):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def padded(x: np.ndarray, hp: int, wp: int) -> torch.Tensor:
    xp = torch.zeros((hp, wp), dtype=torch.float32)
    xp[:x.shape[0], :x.shape[1]] = torch.from_numpy(x)
    return xp


def emulate_tiles(xp, spec, t, height, width, bh, bw):
    """The CUDA kernel's per-CTA schedule, replayed tile by tile."""
    bh, bw, halo = st.strip_geometry(spec, t, bh, bw)
    rad = spec.radius
    hp, wp = xp.shape
    eng = engine_for(spec.taps, 2)
    out = torch.empty_like(xp)
    for r0 in range(0, hp, bh):
        for c0 in range(0, wp, bw):
            rows = torch.arange(r0 - halo, r0 + bh + halo)
            cols = torch.arange(c0 - halo, c0 + bw + halo)
            rin = (rows >= 0) & (rows < height)
            cin = (cols >= 0) & (cols < width)
            win = torch.zeros((len(rows), len(cols)), dtype=xp.dtype)
            sub = xp[rows.clamp(0, hp - 1)][:, cols.clamp(0, wp - 1)]
            win = torch.where(rin[:, None] & cin[None, :], sub, win)
            for s in range(1, t + 1):
                win = eng.step(win, crops=(rad, rad))
                lo = s * rad
                m = (rin[lo:len(rows) - lo, None]
                     & cin[None, lo:len(cols) - lo])
                win = win * m
            out[r0:r0 + bh, c0:c0 + bw] = win
    return out


def jax_sweep(x: np.ndarray, name: str, t: int) -> np.ndarray:
    """The reference's Pallas strip kernel (interpret mode) on ``x``."""
    spec = ref_spec.get(name)
    bh, _ = jst.strip_geometry(spec, t, 16)
    hp, wp = jst.padded_shape_2d(spec, t, bh, *x.shape)
    xp = jnp.zeros((hp, wp), jnp.float32).at[:x.shape[0], :x.shape[1]].set(x)
    out = jst.ebisu2d_padded(xp, spec, t, height=x.shape[0],
                             width=x.shape[1], bh=bh, interpret=True)
    return np.asarray(out)[:x.shape[0], :x.shape[1]]


@pytest.mark.parametrize("name", SPECS_2D)
@pytest.mark.parametrize("shape", [(37, 53), (64, 96)])
def test_plain_padded_sweep_matches_pallas_kernel(name, shape):
    t = 2
    x = field(shape, seed=3)
    spec = tspec.get(name)
    hp, wp = st.padded_shape_2d(spec, t, 16, 32, *shape)
    got = st.ebisu2d_padded(padded(x, hp, wp), spec, t, height=shape[0],
                            width=shape[1], bh=16, bw=32)
    np.testing.assert_allclose(got[:shape[0], :shape[1]].numpy(),
                               jax_sweep(x, name, t), atol=TOL, rtol=TOL)
    assert not got[shape[0]:].any() and not got[:, shape[1]:].any()


@pytest.mark.parametrize("name", SPECS_2D)
def test_ebisu2d_matches_pallas_ebisu2d(name):
    x = field((40, 56), seed=5)
    want = np.asarray(jst.ebisu2d(jnp.asarray(x), ref_spec.get(name), 3,
                                  bh=16, interpret=True))
    got = st.ebisu2d(torch.from_numpy(x), tspec.get(name), 3, bh=16, bw=32)
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", SPECS_2D)
@pytest.mark.parametrize("shape,t,bh,bw", [
    ((37, 53), 2, 16, 32),     # height and width not tile multiples
    ((40, 64), 1, 8, 32),      # t = 1
    ((33, 70), 4, 3, 32),      # halo (4·rad) > bh = 3
    ((29, 31), 3, 3, 1),       # bw rounds up to one warp (32)
])
def test_tile_schedule_matches_oracle(name, shape, t, bh, bw):
    spec = tspec.get(name)
    x = field(shape, seed=t)
    hp, wp = st.padded_shape_2d(spec, t, bh, bw, *shape)
    xp = padded(x, hp, wp)
    tiles = emulate_tiles(xp, spec, t, shape[0], shape[1], bh, bw)
    plain = st.ebisu2d_padded_plain(xp, spec, t, height=shape[0],
                                    width=shape[1])
    torch.testing.assert_close(tiles, plain, atol=1e-6, rtol=0)
    want = np.asarray(jref.reference_unrolled(jnp.asarray(x),
                                              ref_spec.get(name), t))
    np.testing.assert_allclose(tiles[:shape[0], :shape[1]].numpy(), want,
                               atol=TOL, rtol=TOL)
    assert not tiles[shape[0]:].any() and not tiles[:, shape[1]:].any()


def test_geometry():
    spec = tspec.get("j2d9pt")                     # radius 2
    assert st.strip_geometry(spec, 3, 5, 40) == (5, 64, 6)
    assert st.padded_shape_2d(spec, 3, 5, 40, 37, 53) == (40, 64)
    assert st.padded_shape_2d(spec, 1, 8, 32, 64, 64) == (64, 64)
    with pytest.raises(ValueError):
        st.strip_geometry(spec, 0, 8, 32)


def test_zero_outside_domain_even_from_dirty_padding():
    """The sweep masks its input too: garbage in the padding never leaks
    into the domain, and the padding comes back zero."""
    spec = tspec.get("j2d5pt")
    x = field((30, 40))
    hp, wp = st.padded_shape_2d(spec, 2, 8, 32, 30, 40)
    clean = padded(x, hp, wp)
    dirty = clean.clone()
    dirty[30:] = 7.0
    dirty[:, 40:] = -3.0
    a = st.ebisu2d_padded(clean, spec, 2, height=30, width=40, bh=8, bw=32)
    b = st.ebisu2d_padded(dirty, spec, 2, height=30, width=40, bh=8, bw=32)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not a[30:].any() and not a[:, 40:].any()


def test_wrapper_checks_and_counts():
    spec = tspec.get("j2d5pt")
    xp = torch.zeros((32, 64))
    before = st.ebisu2d_padded.launches
    out = torch.empty_like(xp)
    assert st.ebisu2d_padded(xp, spec, 1, height=30, width=60, bh=8, bw=32,
                             out=out) is out
    assert st.ebisu2d_padded.launches == before      # CPU: no kernel
    with pytest.raises(ValueError, match="multiple of the tile"):
        st.ebisu2d_padded(xp, spec, 1, height=30, width=60, bh=12, bw=32)
    with pytest.raises(ValueError, match="hold the"):
        st.ebisu2d_padded(xp, spec, 1, height=40, width=60, bh=8, bw=32)
    with pytest.raises(ValueError, match="cuda or cpu"):
        st.ebisu2d_padded(torch.zeros((32, 64), device="meta"), spec, 1,
                          height=30, width=60, bh=8, bw=32)


def test_kernel_taps_order_and_limits():
    dy, dx, c = st.kernel_taps(tspec.get("j2d9pt").taps)   # star, radius 2
    assert (dy[0], dx[0]) == (0, 0)                        # center first
    assert list(dx[1:5]) == [0, 0, 0, 0]                   # then axis 0
    assert list(dy[5:]) == [0, 0, 0, 0]                    # then axis 1
    assert abs(c.sum() - 1.0) < 1e-12
    box = tspec.get("j2d25pt").taps                        # tap order
    dy, dx, _ = st.kernel_taps(box)
    assert [(int(a), int(b)) for a, b in zip(dy, dx)] == [o for o, _ in box]
    with pytest.raises(ValueError, match="at most"):
        st.kernel_taps(tspec.box_taps(2, 6))               # 169 taps
