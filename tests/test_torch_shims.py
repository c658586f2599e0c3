"""The port's deprecated shims (``repro_torch.kernels.ops``,
``repro_torch.kernels.sweep``) and ``compile_stencil(plan=None)``, the
request-default tiles they keep, against the reference package.

Ports of ``tests/test_program.py``'s shim tests and ``tests/
test_sweep.py``'s: every program runs with ``device="cpu"``, so each
sweep takes the kernel's plain version, on numpy-seeded fields handed to
both packages, and each shim is held to the reference's own shim (Pallas
interpret mode, at the reference's small shapes) or to its oracle
(``repro.kernels.ref.reference_unrolled``) within 2e-5.  The warnings
fire at call time and never at import.
"""
import dataclasses
import importlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stencil_spec as ref_spec
from repro.kernels import ops as rops
from repro.kernels import ref as jref
from repro.kernels import sweep as rsweep
from repro_torch.api import program
from repro_torch.api.program import (ProgramCache, TileRequest, cache_stats,
                                     compile_stencil, resolve_geometry)
from repro_torch.core import planner as tplanner
from repro_torch.core import roofline as trl
from repro_torch.core import stencil_spec as tspec
from repro_torch.kernels import ops, sweep
from repro_torch.kernels import stencil2d as st

F32 = 2e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny tensors: one intra-op thread keeps this module from
    oversubscribing the CPU the test workers share."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def field(shape, seed=0):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def oracle(x, name, steps):
    return np.asarray(jref.reference_unrolled(jnp.asarray(x),
                                              ref_spec.get(name), steps))


def close(got, want, tol=F32):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


# ============================================================== shims ==
def test_legacy_shims_warn_and_match():
    """``ops.ebisu_stencil`` is ``compile_stencil(plan=None).apply`` bit
    for bit and ``sweep.run_sweeps`` is ``.run``; both warn and both
    equal the reference's shims (interpret mode) within 2e-5."""
    spec = tspec.get("j2d5pt")
    xn = field((40, 36))
    x = torch.from_numpy(xn)
    prog = compile_stencil(spec, x.shape, t=3, plan=None, device="cpu")
    with pytest.warns(DeprecationWarning, match="ebisu_stencil"):
        legacy = ops.ebisu_stencil(x, spec, 3)
    assert torch.equal(legacy, prog.apply(x))
    with pytest.warns(DeprecationWarning, match="ebisu_stencil"):
        want = rops.ebisu_stencil(jnp.asarray(xn), ref_spec.get("j2d5pt"),
                                  3, interpret=True)
    close(legacy, want)
    with pytest.warns(DeprecationWarning, match="run_sweeps"):
        legacy = sweep.run_sweeps(x, spec, 7, t=3)
    close(legacy, prog.run(x, 7), 1e-6)
    with pytest.warns(DeprecationWarning, match="run_sweeps"):
        want = rsweep.run_sweeps(jnp.asarray(xn), ref_spec.get("j2d5pt"), 7,
                                 t=3, interpret=True)
    close(legacy, want)


def test_planned_shim_threads_mode_and_hw():
    """``ebisu_stencil_planned`` threads ``mode`` and ``hw`` through to
    the program, as the reference's does."""
    spec = tspec.get("j2d9pt")
    xn = field((40, 36), 1)
    x = torch.from_numpy(xn)
    with pytest.warns(DeprecationWarning):
        y_scratch, p = ops.ebisu_stencil_planned(x, spec, t=2,
                                                 mode="scratch")
    assert p is not None
    close(y_scratch, oracle(xn, "j2d9pt", 2))
    other = dataclasses.replace(trl.H100, name="h100-other")
    with pytest.warns(DeprecationWarning):
        _, p_other = ops.ebisu_stencil_planned(x, spec, t=2, hw=other)
    assert p_other.hw_name == "h100-other"


def test_resolve_geometry_is_sole_path():
    """``ops.launch_geometry`` is a pure delegate of ``resolve_geometry``
    at the request-default tiles, and a ``plan=None`` program launches
    what it says."""
    spec = tspec.get("j2d5pt")
    for mode in ("fused", "stream"):
        g = ops.launch_geometry(spec, 4, (96, 80), mode=mode)
        assert g == resolve_geometry(spec, 4, (96, 80), mode=mode,
                                     plan=TileRequest(mode == "stream"))
        assert g == compile_stencil(spec, (96, 80), t=4, plan=None,
                                    mode=mode, device="cpu").geometry()
        assert g["tile_request"]["clipped"] is None
    assert ops.launch_geometry(spec, 4, (96, 80))["block"][0] == \
        program.DEFAULT_BH_2D
    assert ops.launch_geometry(spec, 4, (96, 80), mode="stream")[
        "block"][0] == program.DEFAULT_ZC_STREAM_2D


# ===================================================== request tiles ==
@pytest.mark.parametrize("name,shape,t", [
    ("j2d5pt", (40, 36), 3), ("j2d25pt", (37, 53), 2),
    ("j3d7pt", (20, 9, 13), 3), ("j3d27pt", (14, 10, 12), 2)])
def test_plan_none_matches_reference(name, shape, t):
    """``compile_stencil(plan=None)``: the request-default tile (the
    reference's leading dimension, floored at the halo), depth ``t``
    (default 1), ``apply`` and ``run`` equal to the oracle."""
    spec = tspec.get(name)
    xn = field(shape, 2)
    x = torch.from_numpy(xn)
    prog = compile_stencil(spec, shape, t=t, plan=None, device="cpu")
    assert prog.plan is None and isinstance(prog.tile_plan, TileRequest)
    lead = program.DEFAULT_BH_2D if spec.ndim == 2 else program.DEFAULT_ZC_3D
    assert prog.geometry()["block"][0] == max(lead, spec.halo(t))
    close(prog.apply(x), oracle(xn, name, t))
    close(prog.run(x, 2 * t + 1), oracle(xn, name, 2 * t + 1))
    assert compile_stencil(spec, shape, plan=None, device="cpu").t == 1


def test_request_tile_clipped_where_the_kernel_refuses():
    """A request-default tile the shared-memory limit refuses is
    clipped, and ``geometry()`` says so; the floor at the halo holds."""
    spec = tspec.get("j2d25pt")
    prog = compile_stencil(spec, (8640, 8640), t=30, plan=None,
                           device="cpu")
    g = prog.geometry()
    assert g["tile_request"]["requested"] == 128
    assert "128 -> 64" in g["tile_request"]["clipped"]
    assert g["block"] == (64, 32)
    assert g["smem_bytes"] <= trl.H100.onchip_bytes
    # no halo past a default fits the H100's shared memory; on a model
    # with room for one, the rows are floored at the halo
    roomy = dataclasses.replace(trl.H100, onchip_bytes=4 * 2 ** 20)
    deep = resolve_geometry(tspec.get("j2d5pt"), 130, (512, 512), hw=roomy,
                            plan=TileRequest())
    assert deep["tile_request"]["requested"] == 130
    assert deep["block"][0] == 130 and deep["tile_request"]["clipped"] is None


def test_shims_warn_at_call_time_only():
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        importlib.reload(ops)
        importlib.reload(sweep)
    assert not [w for w in seen if issubclass(w.category,
                                              DeprecationWarning)]


# ================================================= test_sweep's ports ==
def test_sweep_schedule():
    assert sweep.sweep_schedule(24, 6) == (6, 6, 6, 6)
    assert sweep.sweep_schedule(25, 6) == (6, 6, 6, 6, 1)
    assert sweep.sweep_schedule(5, 8) == (5,)
    assert sweep.sweep_schedule(0, 4) == ()
    assert sum(sweep.sweep_schedule(37, 5)) == 37


@pytest.mark.parametrize("name,shape,total,t", [
    ("j2d5pt", (97, 83), 25, 6),     # remainder sweep (25 % 6 != 0)
    ("j2d9pt", (64, 60), 10, 4),
    ("j3d7pt", (20, 9, 13), 10, 4),
    ("j3d27pt", (14, 10, 12), 7, 3),
])
def test_run_sweeps_matches_reference(name, shape, total, t):
    xn = field(shape, 3)
    with pytest.warns(DeprecationWarning):
        got = sweep.run_sweeps(torch.from_numpy(xn), tspec.get(name), total,
                               t=t)
    close(got, oracle(xn, name, total))


def test_run_sweeps_plan_depth_default():
    """t=None: per-sweep depth comes from the shape-bucketed §6 plan."""
    spec = tspec.get("j2d5pt")
    xn = field((48, 40), 4)
    p = sweep.plan_bucketed(spec, xn.shape)
    total = p.t + 2                       # forces a remainder sweep too
    with pytest.warns(DeprecationWarning):
        got = sweep.run_sweeps(torch.from_numpy(xn), spec, total)
    close(got, oracle(xn, "j2d5pt", total))


def test_run_sweeps_zero_steps_identity():
    x = torch.from_numpy(field((16, 16)))
    with pytest.warns(DeprecationWarning):
        assert sweep.run_sweeps(x, tspec.get("j2d5pt"), 0, t=4) is x


def test_padded_layout_contract():
    """The padded layout is closed under chained sweeps: out-of-domain
    cells are zero after every sweep, and the uniform-depth padded chain
    equals the oracle on the domain."""
    spec = tspec.get("j2d5pt")
    t, total = 3, 9
    height, width = 45, 70
    xn = field((height, width), 5)
    bh = 64
    bw = program._widest_columns(spec, t, bh, width,
                                 int(trl.H100.onchip_bytes), 4)
    hp, wp = st.padded_shape_2d(spec, t, bh, bw, height, width)
    xp = torch.zeros((hp, wp))
    xp[:height, :width] = torch.from_numpy(xn)
    out = sweep.run_sweeps_padded(xp, spec, total, t=t, height=height,
                                  width=width, bh=bh)
    assert out.shape == (hp, wp)
    close(out[:height, :width], oracle(xn, "j2d5pt", total))
    pad = out.clone()
    pad[:height, :width] = 0.0
    assert torch.all(pad == 0.0)
    with pytest.raises(ValueError, match="padded layout"):
        sweep.run_sweeps_padded(xp[:, :-1], spec, total, t=t, height=height,
                                width=width, bh=bh)


def test_sweep_tile_3d_fits_the_shared_memory_budget():
    """``_sweep_tile_3d`` returns the port's CUDA tile, within the
    ``smem_bytes_3d`` budget and the kernel's thread bound, at every 3-D
    Table-2 stencil's plan depth, in float32 and float64 models."""
    for hw in (trl.H100, dataclasses.replace(trl.H100, s_cell=8)):
        for spec in (s for s in tspec.TABLE2.values() if s.ndim == 3):
            shape = spec.domain
            p = sweep.plan_bucketed(spec, shape, hw)
            zc, ty, tx, batch = sweep._sweep_tile_3d(spec, p.t, shape, hw,
                                                     p)
            ty, tx = ty or shape[1], tx or shape[2]
            assert tplanner.smem_bytes_3d(spec, p.t, shape, ty, tx,
                                          hw.s_cell) <= hw.onchip_bytes
            assert tplanner.kernel_threads_3d(spec, p.t, shape, ty, tx,
                                              hw.s_cell) is not None
            assert batch == tplanner.planes_per_barrier(spec.radius)
            assert zc >= 1


def test_sweep_tile_3d_rejects_over_budget_depth():
    """A depth past what the kernel holds raises instead of launching a
    tile the model says does not fit."""
    spec = tspec.get("j3d7pt")
    shape = spec.domain
    p = sweep.plan_bucketed(spec, shape, trl.H100)
    with pytest.raises(ValueError, match="does not fit"):
        sweep._sweep_tile_3d(spec, tplanner.MAX_DEPTH_3D + 1, shape,
                             trl.H100, p)
    assert sweep._sweep_tile_2d(tspec.get("j2d5pt"), p.t, (512, 512),
                                trl.H100, None) >= 8


def test_run_sweeps_rejects_stream_mode():
    x = torch.from_numpy(field((16, 16)))
    with pytest.raises(ValueError, match="stream"), \
            pytest.warns(DeprecationWarning):
        sweep.run_sweeps(x, tspec.get("j2d5pt"), 4, t=2, mode="stream")


def test_launch_cache_reuse():
    x = torch.from_numpy(field((12, 8, 10), 6))
    spec = tspec.get("j3d7pt")
    with pytest.warns(DeprecationWarning):
        a = sweep.run_sweeps(x, spec, 8, t=4)
    n_cached = len(sweep._LAUNCH_CACHE)
    with pytest.warns(DeprecationWarning):
        b = sweep.run_sweeps(x, spec, 8, t=4)
    assert len(sweep._LAUNCH_CACHE) == n_cached   # second call hits cache
    assert torch.equal(a, b)


def test_global_caches_exposed_and_bounded():
    stats = cache_stats()
    for name in ("programs", "plans", "runners"):
        assert stats[name]["size"] <= stats[name]["maxsize"]
    assert sweep._LAUNCH_CACHE is program.RUNNER_CACHE
    assert sweep._PLAN_CACHE is program.PLAN_CACHE
    assert isinstance(sweep._LAUNCH_CACHE, ProgramCache)


def test_naive_stencil_is_the_oracle():
    xn = field((21, 19), 7)
    close(ops.naive_stencil(torch.from_numpy(xn), tspec.get("j2d9pt"), 3),
          oracle(xn, "j2d9pt", 3))
