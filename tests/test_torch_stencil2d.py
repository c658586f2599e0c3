"""The 2-D sweep of the port (``repro_torch.kernels.stencil2d``): its plain
version against the reference's Pallas strip kernel (interpret mode), the
launch geometry, the tap-set header generator, and the CUDA kernel's tile
schedule.

The CUDA kernel itself runs only on a card (tests marked ``cuda`` in
``tests/test_torch_cuda.py``).  On the CPU its schedule is held by
:func:`emulate_tiles`, which replays what every CTA does: load the tile
around its ``bh × bw`` output (zero outside the domain in an edge CTA,
no test at all in an interior one), then per step cut the live region
into blocks of ``R`` rows by column (the last block of a column
overlapping its neighbour; one row a thread where the region has fewer
than ``R`` rows), and for each block walk its input rows once, read each
column offset of a row once and add it into every accumulator its taps
reach, in the kernel's order (rows ascending, within a row the
generator's column order, within a column ``kernel_taps`` order), then
mask an edge CTA's cells to the domain and store them to the other
buffer, or at the last step to the output.  Each CTA's two buffers start
as NaN, and every cell carries a tag, the step that last wrote it: a
read of a cell the step below did not write (never written, or left from
an earlier step) fails.

Tolerances: 1e-6 between the replay and the plain version (the same
taps, summed in another order), 2e-5 against the reference (its suite's
own).
"""
import dataclasses
import itertools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import define as ref_define
from repro.core import stencil_spec as ref_spec
from repro.kernels import ref as jref
from repro.kernels import stencil2d as jst
from repro_torch.api import define as tdefine
from repro_torch.core import planner as tplanner
from repro_torch.core import roofline as trl
from repro_torch.core import stencil_spec as tspec
from repro_torch.kernels import _build
from repro_torch.kernels import stencil2d as st
from repro_torch.kernels import stencil2d_gen as gen
from repro_torch.launch import stencil_registers as regs

SPECS_2D = [n for n, s in tspec.TABLE2.items() if s.ndim == 2]
TOL = 2e-5


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


def padded(x: np.ndarray, hp: int, wp: int) -> torch.Tensor:
    xp = torch.zeros((hp, wp), dtype=torch.float32)
    xp[:x.shape[0], :x.shape[1]] = torch.from_numpy(x)
    return xp


def fma(c: float, v: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """``c·v + acc`` rounded once to float32, as the kernel's FMA (the
    coefficient first cast to float32)."""
    c32 = float(np.float32(c))
    return (c32 * v.double() + acc.double()).float()


def emulate_tiles(xp, spec, t, height, width, bh, bw, itemsize=4):
    """The CUDA kernel's schedule, replayed CTA by CTA (see the module
    docstring); returns the output and the launch's schedule, whose
    counts the replay checks.  A leading batch axis of ``xp`` is the
    grid's z: CTA ``(cz, cy, cx)`` runs the tile ``(cy, cx)`` of field
    ``cz``, reading and writing that field's layout alone.  ``itemsize``
    picks the rows a thread computes (float64's ``R`` with 8), the
    arithmetic staying float32."""
    bh, bw, halo = st.strip_geometry(spec, t, bh, bw)
    sched = st.tile_schedule(spec, t, bh, bw, height, width, itemsize)
    ry, rx = tplanner.axis_reach(spec, 0), tplanner.axis_reach(spec, 1)
    columns = gen.tap_columns(spec.taps)
    batch = xp.shape[0] if xp.dim() == 3 else 1
    layout = xp.shape
    fields = xp.reshape((batch,) + tuple(xp.shape[-2:]))
    hp, wp = fields.shape[1:]
    sh, sw = bh + 2 * halo, bw + 2 * halo
    outs = torch.full_like(fields, float("nan"))
    interior_ctas = updates = computed = reads = 0

    def inside(rows, cols):
        return (((rows >= 0) & (rows < height))[:, None]
                & ((cols >= 0) & (cols < width))[None, :])

    for cz, cy, cx in itertools.product(range(batch), range(hp // bh),
                                        range(wp // bw)):
        xp, out = fields[cz], outs[cz]
        r0, c0 = cy * bh - halo, cx * bw - halo
        ly, lx = halo - t * ry, halo - t * rx
        rows = torch.arange(r0 + ly, r0 + ly + bh + 2 * t * ry)
        cols = torch.arange(c0 + lx, c0 + lx + bw + 2 * t * rx)
        ok = inside(rows, cols)
        interior = bool(ok.all())
        interior_ctas += interior
        bufs = [torch.full((sh, sw), float("nan")) for _ in range(2)]
        tags = [torch.full((sh, sw), -1) for _ in range(2)]
        sub = xp[rows.clamp(0, hp - 1)][:, cols.clamp(0, wp - 1)]
        region = (slice(ly, ly + len(rows)), slice(lx, lx + len(cols)))
        bufs[0][region] = sub if interior else torch.where(
            ok, sub, torch.zeros(()))
        tags[0][region] = 0
        src = 0
        for step in sched["steps"]:
            s, ny, nx, r = (step[k] for k in ("s", "ny", "nx", "rows"))
            ly, lx = halo - (t - s) * ry, halo - (t - s) * rx
            nb = -(-ny // r)
            starts = ly + torch.clamp(torch.arange(nb) * r, max=ny - r)
            cc = lx + torch.arange(nx)
            acc = [torch.zeros((nb, nx)) for _ in range(r)]
            for i in range(r + 2 * ry):
                rr = (starts - ry + i)[:, None]
                for dx, terms in columns:
                    used = [(i - ry - dy, c) for dy, c in terms
                            if 0 <= i - ry - dy < r]
                    if not used:
                        continue
                    at = (rr, (cc + dx)[None, :])
                    assert (tags[src][at] == s - 1).all(), (s, i, dx)
                    v = bufs[src][at]
                    reads += v.numel()
                    for j, c in used:
                        acc[j] = fma(c, v, acc[j])
            dst = 1 - src
            for j in range(r):
                rj = starts + j
                o = acc[j]
                if not interior:
                    o = torch.where(inside(r0 + rj, c0 + cc), o,
                                    torch.zeros(()))
                if s < t:
                    bufs[dst][rj[:, None], cc[None, :]] = o
                    tags[dst][rj[:, None], cc[None, :]] = s
                else:
                    out[(r0 + rj)[:, None], (c0 + cc)[None, :]] = o
            updates += ny * nx
            computed += nb * r * nx
            src = dst
    assert not outs.isnan().any()           # every cell of the layout
    assert interior_ctas == batch * sched["interior_ctas"]
    assert (updates, computed, reads) == (
        batch * sched["cell_updates"], batch * sched["computed_updates"],
        batch * sched["shared_reads"])
    return outs.reshape(layout), sched


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


# (shape, t, bh, bw): ragged height and width, t = 1, a halo wider than
# the tile (the last steps run one row a thread), bw rounded up to one
# warp, interior CTAs beside a rim whose loaded tile crosses the domain's
# edge by less than the halo, and row blocks R does not divide
TILINGS = [((37, 53), 2, 16, 32),
           ((40, 64), 1, 8, 32),
           ((33, 70), 4, 3, 32),
           ((29, 31), 3, 3, 1),
           ((95, 140), 2, 16, 32),
           ((61, 97), 3, 13, 64)]


@pytest.mark.parametrize("name", SPECS_2D)
@pytest.mark.parametrize("shape,t,bh,bw", TILINGS)
def test_tile_schedule_matches_oracle(name, shape, t, bh, bw):
    spec = tspec.get(name)
    x = field(shape, seed=t)
    hp, wp = st.padded_shape_2d(spec, t, bh, bw, *shape)
    xp = padded(x, hp, wp)
    tiles, _ = emulate_tiles(xp, spec, t, shape[0], shape[1], bh, bw)
    plain = st.ebisu2d_padded_plain(xp, spec, t, height=shape[0],
                                    width=shape[1])
    torch.testing.assert_close(tiles, plain, atol=1e-6, rtol=0)
    want = np.asarray(jref.reference_unrolled(jnp.asarray(x),
                                              ref_spec.get(name), t))
    np.testing.assert_allclose(tiles[:shape[0], :shape[1]].numpy(), want,
                               atol=TOL, rtol=TOL)
    assert not tiles[shape[0]:].any() and not tiles[:, shape[1]:].any()


# custom tap sets: asymmetric at radius 4, a 128-tap set at radius 8 (the
# kernel's bounds), and sets with no reach along one axis
ASYM_R4 = tspec.define_stencil(
    [((0, 0), 0.3), ((-4, 1), 0.05), ((3, -2), 0.07), ((1, 4), 0.06),
     ((-2, -3), 0.08), ((0, 2), 0.1), ((2, 0), 0.09), ((-1, -1), 0.11)],
    name="asym-r4", normalize=True)
ROWS_ONLY = tspec.define_stencil([((0, 0), 0.5), ((0, 2), 0.25),
                                  ((0, -1), 0.25)], name="x-only")
COLUMNS_ONLY = tspec.define_stencil([((0, 0), 0.5), ((3, 0), 0.25),
                                     ((-1, 0), 0.25)], name="y-only")
CUSTOM = {s.name: s for s in (ASYM_R4, regs.dense_spec(8, ndim=2),
                              ROWS_ONLY, COLUMNS_ONLY)}
# the sets past the 128 taps of earlier libraries, as the user builds them
LARGE = {"box-r6": (tdefine.box(2, radius=6), ref_define.box(2, radius=6)),
         "blur-r8": (tdefine.blur(2, radius=8),
                     ref_define.blur(2, radius=8))}


@pytest.mark.parametrize("name", list(CUSTOM))
@pytest.mark.parametrize("shape,t,bh,bw", [((37, 53), 1, 16, 32),
                                           ((50, 70), 2, 5, 32)])
def test_tile_schedule_custom_taps(name, shape, t, bh, bw):
    spec = CUSTOM[name]
    x = field(shape, seed=7)
    hp, wp = st.padded_shape_2d(spec, t, bh, bw, *shape)
    xp = padded(x, hp, wp)
    xp[shape[0]:] = 7.0                   # dirty padding reads as 0
    xp[:, shape[1]:] = -3.0
    tiles, _ = emulate_tiles(xp, spec, t, shape[0], shape[1], bh, bw)
    plain = st.ebisu2d_padded_plain(xp, spec, t, height=shape[0],
                                    width=shape[1])
    torch.testing.assert_close(tiles, plain, atol=1e-6, rtol=0)
    rspec = ref_spec.define_stencil(spec.taps, name=spec.name)
    want = np.asarray(jref.reference_unrolled(jnp.asarray(x), rspec, t))
    np.testing.assert_allclose(tiles[:shape[0], :shape[1]].numpy(), want,
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name,t,itemsize,updates", [
    ("j2d5pt", 12, 4, 1.04e9), ("j2d9pt", 8, 4, 7.07e8),
    ("j2d9pt-gol", 6, 4, 5.16e8), ("j2d25pt", 4, 4, 3.39e8),
    ("j2d5pt", 12, 8, None)])
def test_tile_schedule_at_the_paper_plans(name, t, itemsize, updates):
    """The counts ``chip_smoke.py``'s ``[model]`` lines print, at the
    planner's tile of each Table-2 stencil at its EBISU depth: the
    trapezoid's cell-updates (1.25×, 1.36×, 1.10× and 1.12× the outputs
    in f32), the interior CTAs (j2d5pt in f32: all but the 344 of the
    rim), and the shared reads per cell-update at ``R`` rows a thread."""
    spec = tspec.get(name)
    bh, bw, _ = tplanner.fit_tile_2d(spec, t, spec.domain, trl.H100,
                                     itemsize)
    sched = st.tile_schedule(spec, t, bh, bw, *spec.domain, itemsize)
    r = sched["rows_per_thread"]
    assert r == tplanner.rows_per_thread_2d(spec.radius, itemsize,
                                            len(spec.taps)) == 8
    rad = spec.radius
    assert sched["cell_updates"] == sched["ctas"] * sum(
        (bh + 2 * k * rad) * (bw + 2 * k * rad) for k in range(t))
    if updates is not None:
        assert float(f"{sched['cell_updates']:.3g}") == updates
    if (name, itemsize) == ("j2d5pt", 4):
        assert (sched["ctas"], sched["interior_ctas"]) == (7569, 7569 - 344)
    assert sched["interior_ctas"] > 0.9 * sched["ctas"]
    spans = [max(y for y, _ in terms) - min(y for y, _ in terms)
             for _, terms in gen.tap_columns(spec.taps)]
    full = sum(r + sp for sp in spans) / r     # reads a cell-update at R
    assert (full <= sched["shared_reads"] / sched["cell_updates"]
            <= full * sched["computed_updates"] / sched["cell_updates"])
    assert all(0 < s["lane_use"] <= 1 and s["rows"] == r
               for s in sched["steps"])


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
    # every set validate_spec accepts: up to the 17 x 17 box of radius 8
    assert st.MAX_TAPS == (2 * tspec.MAX_RADIUS + 1) ** 2 == 289
    for taps in (tspec.box_taps(2, 6), tspec.box_taps(2, 8)):  # 169, 289
        dy, dx, c = st.kernel_taps(taps)
        assert len(c) == len(taps) and abs(c.sum() - 1.0) < 1e-12
    with pytest.raises(ValueError, match="at most 289 taps"):
        st.kernel_taps(tspec.box_taps(2, 9))               # 361 taps


# ------------------------------------------------ the tap-set header ----
def header_taps(text):
    """``[(dy, dx, coef)]`` of a generated header, in its order."""
    out = []
    for dx, body in re.findall(r"COLUMN\((-?\d+), (.*)\) \\", text):
        for dy, lit in re.findall(r"TAP\((-?\d+), ([-+0-9a-fA-Fxp.]+)\)",
                                  body):
            out.append((int(dy), int(dx), float.fromhex(lit)))
    return out


def define(text, name):
    return int(re.search(rf"#define {name} (\d+)", text).group(1))


@pytest.mark.parametrize("spec", [tspec.get(n) for n in SPECS_2D]
                         + list(CUSTOM.values())
                         + regs.probe_specs(ndim=2)
                         + [mine for mine, _ in LARGE.values()],
                         ids=lambda s: s.name)
def test_header_holds_kernel_taps_bit_exact(spec):
    text = gen.header(spec.taps)
    got = header_taps(text)
    dy, dx, c = st.kernel_taps(spec.taps)
    want = list(zip(map(int, dy), map(int, dx), map(float, c)))
    assert sorted(got) == sorted(want)          # bit-exact coefficients
    # within each column, the terms keep kernel_taps order
    for col in {q[1] for q in want}:
        assert ([q for q in got if q[1] == col]
                == [q for q in want if q[1] == col])
    assert [x for x, _ in gen.tap_columns(spec.taps)] == list(
        dict.fromkeys(q[1] for q in want))
    assert define(text, "ST2_RADIUS") == spec.radius
    assert define(text, "ST2_NTAPS") == len(want)
    assert define(text, "ST2_REACH_Y") == tplanner.axis_reach(spec, 0)
    assert define(text, "ST2_REACH_X") == tplanner.axis_reach(spec, 1)
    assert define(text, "ST2_ROWS_F32") == tplanner.rows_per_thread_2d(
        spec.radius, 4, len(want))
    assert define(text, "ST2_ROWS_F64") == tplanner.rows_per_thread_2d(
        spec.radius, 8, len(want))
    assert define(text, "ST2_THREADS") == tplanner.THREADS


def test_tapset_library_path_keys_on_the_tap_set():
    j5 = tspec.get("j2d5pt")
    path = _build.library_path("stencil2d", st.tapset_header(j5))
    same = tspec.define_stencil(j5.taps, name="another-name")
    assert _build.library_path("stencil2d", st.tapset_header(same)) == path
    bumped = [(off, c * (1 + 2 ** -40)) for off, c in j5.taps]
    assert _build.library_path("stencil2d",
                               gen.header(tuple(bumped))) != path
    paths = {_build.library_path("stencil2d", st.tapset_header(s))
             for s in [tspec.get(n) for n in SPECS_2D] + list(CUSTOM.values())}
    assert len(paths) == len(SPECS_2D) + len(CUSTOM)
    assert path.name.startswith("libstencil2d-")
    with pytest.raises(ValueError, match="template"):
        _build.library_path("stencil2d")
    big = tspec.define_stencil(tspec.box_taps(2, 8))       # 289 taps
    assert _build.library_path("stencil2d", st.tapset_header(big)) != path
    over = dataclasses.replace(big, taps=tuple(tspec.box_taps(2, 9)))
    with pytest.raises(ValueError, match="at most"):
        st.tapset_header(over)                             # 361 taps


def test_register_probe_tap_sets_2d():
    """The 2-D tap sets the register probe and the card tests build: a
    star and a dense set at each radius 1–8, within the kernel's tap
    limit, and headers at the planner's ``R`` or another."""
    specs = regs.probe_specs(ndim=2)
    assert [s.radius for s in specs] == [r for r in range(1, 9)
                                         for _ in (0, 1)]
    assert all(s.ndim == 2 and len(s.taps) <= st.MAX_TAPS for s in specs)
    dense = regs.dense_spec(8, ndim=2)
    assert len(dense.taps) == 128 and dense.radius == 8
    assert len(regs.dense_spec(2, ndim=2).taps) == 25      # the whole box
    text, r32, r64 = regs.header_at_2d(dense, None)
    assert text == gen.header(dense.taps) and (r32, r64) == (8, 4)
    text, r32, r64 = regs.header_at_2d(dense, 16)
    assert define(text, "ST2_ROWS_F32") == define(text, "ST2_ROWS_F64") == 16


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("name", list(LARGE))
def test_tile_schedule_large_tap_sets_with_a_batch(name, itemsize):
    """The 169- and 289-tap sets (radius 6 and 8) replayed on a batch of
    two fields, one grid z per field, at the rows a thread of the f32
    and the f64 instantiation computes: the replay equals the plain
    version, each field equals its own sweep, and the reference within
    2e-5."""
    spec, rspec = LARGE[name]
    shape, t, bh, bw = (29, 41), 1, 16, 32
    hp, wp = st.padded_shape_2d(spec, t, bh, bw, *shape)
    xs = [field(shape, seed=11 + i) for i in range(2)]
    xp = torch.stack([padded(x, hp, wp) for x in xs])
    xp[:, shape[0]:] = 5.0                 # dirty padding reads as 0
    tiles, sched = emulate_tiles(xp, spec, t, shape[0], shape[1], bh, bw,
                                 itemsize)
    assert sched["rows_per_thread"] == tplanner.rows_per_thread_2d(
        spec.radius, itemsize, len(spec.taps))
    assert sched["rows_per_thread"] == (
        8 if itemsize == 4 else 4 if len(spec.taps) <= 169 else 1)
    plain = st.ebisu2d_padded_plain(xp, spec, t, height=shape[0],
                                    width=shape[1])
    torch.testing.assert_close(tiles, plain, atol=1e-6, rtol=0)
    for i, x in enumerate(xs):
        one = st.ebisu2d_padded_plain(xp[i], spec, t, height=shape[0],
                                      width=shape[1])
        assert torch.equal(plain[i], one)
        want = np.asarray(jref.reference_unrolled(jnp.asarray(x), rspec, t))
        np.testing.assert_allclose(tiles[i, :shape[0], :shape[1]].numpy(),
                                   want, atol=TOL, rtol=TOL)


def test_wrapper_takes_a_batch_axis():
    """``(B, hp, wp)`` is B fields in one call (one launch on the card);
    the launch count does not move on the CPU; a batch beyond the grid's
    z extent and a 4-D buffer are refused."""
    spec = tspec.get("j2d9pt")
    xs = torch.from_numpy(np.stack([field((32, 64), seed=i)
                                    for i in range(3)]))
    before = st.ebisu2d_padded.launches
    out = st.ebisu2d_padded(xs, spec, 2, height=30, width=60, bh=8, bw=32)
    assert st.ebisu2d_padded.launches == before
    for i in range(3):
        assert torch.equal(out[i], st.ebisu2d_padded(
            xs[i], spec, 2, height=30, width=60, bh=8, bw=32))
    with pytest.raises(ValueError, match="batch axis"):
        st.ebisu2d_padded(xs[None], spec, 2, height=30, width=60, bh=8,
                          bw=32)
    with pytest.raises(ValueError, match="1 to 65535 fields"):
        st.ebisu2d_padded(torch.zeros((0, 32, 64)), spec, 2, height=30,
                          width=60, bh=8, bw=32)
