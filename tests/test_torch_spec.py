"""The port's own copies of the spec layer, roofline and planner, held
against the reference package, plus the port's import gate."""
import dataclasses
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro.api import define as ref_define
from repro.core import roofline as ref_rl
from repro.core import stencil_spec as ref_spec
from repro.stencils import data as ref_data
from repro_torch.api import define as tdefine
from repro_torch.core import planner as tplanner
from repro_torch.core import roofline as trl
from repro_torch.core import stencil_spec as tspec
from repro_torch.stencils import data as tdata

SPECS_2D = [n for n, s in tspec.TABLE2.items() if s.ndim == 2]
SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.mark.parametrize("name", list(ref_spec.TABLE2))
def test_table2_copy_matches_reference(name):
    ref = ref_spec.get(name)
    mine = tspec.get(name)
    assert tspec.spec_from_reference(ref).signature == mine.signature
    assert tspec.spec_from_reference(ref) == mine
    assert (mine.domain, mine.radius, mine.shape_kind) == (
        ref.domain, ref.radius, ref.shape_kind)


def test_table3_depths_and_names_match_reference():
    assert tspec.TABLE3_DEPTHS == ref_spec.TABLE3_DEPTHS
    assert tspec.names() == ref_spec.names()


def test_spec_from_reference_takes_a_mapping():
    ref = ref_spec.get("j2d25pt")
    spec = tspec.spec_from_reference(dataclasses.asdict(ref))
    assert spec.signature == ref.signature
    with pytest.raises(ValueError):
        tspec.spec_from_reference({**dataclasses.asdict(ref), "radius": 3})


@pytest.mark.parametrize("taps,normalize", [
    ([((0, 0), 0.6), ((0, 1), 0.15), ((0, -1), 0.05), ((1, 0), 0.1),
      ((-1, 0), 0.1)], False),
    ([((0, 0), 2.0), ((1, 1), 1.0), ((-2, 0), 1.0)], True),
    ([((0, 0, 0), 1.0), ((1, 0, 0), 0.5), ((0, -1, 1), 0.5)], True),
])
def test_define_stencil_derives_what_the_reference_derives(taps, normalize):
    ref = ref_spec.define_stencil(taps, normalize=normalize)
    mine = tspec.define_stencil(taps, normalize=normalize)
    assert mine.signature == ref.signature
    assert (mine.name, mine.domain, mine.shape_kind) == (
        ref.name, ref.domain, ref.shape_kind)


@pytest.mark.parametrize("bad", [[], [((0, 0), 1.0)],
                                 [((0, 0), 1.0), ((0, 0), 2.0)],
                                 [((0, 0), 1.0), ((0, 9), 1.0)]])
def test_define_stencil_refuses_what_the_reference_refuses(bad):
    with pytest.raises(ValueError):
        ref_spec.define_stencil(bad)
    with pytest.raises(ValueError):
        tspec.define_stencil(bad)


@pytest.mark.parametrize("kind,params", [
    ("laplacian", dict(ndim=2, radius=2)),
    ("diffusion", dict(ndim=2, alpha=0.2)),
    ("blur", dict(radius=1, sigma=0.8)),
    ("star", dict(radius=3)),
    ("box", dict(ndim=3)),
])
def test_operators_match_reference(kind, params):
    ref = ref_define.from_operator(kind, **params)
    mine = tdefine.from_operator(kind, **params)
    assert (mine.signature, mine.name) == (ref.signature, ref.name)


def test_json_adapters_match_reference():
    text = '[[[0,0],0.6],[[0,1],0.1],[[0,-1],0.1],[[1,0],0.1],[[-1,0],0.1]]'
    assert tdefine.parse_taps(text) == ref_define.parse_taps(text)
    obj = {"taps": [[[0, 0], 2.0], [[1, 0], 1.0], [[-1, 0], 1.0]],
           "name": "mine", "normalize": True, "domain": [300, 200],
           "a_sm": 7}
    ref, mine = ref_define.spec_from_json(obj), tdefine.spec_from_json(obj)
    assert (mine.signature, mine.name, mine.domain) == (
        ref.signature, ref.name, ref.domain)
    op = {"operator": {"kind": "diffusion", "ndim": 2, "alpha": 0.1}}
    assert (tdefine.spec_from_json(op).signature
            == ref_define.spec_from_json(op).signature)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tdefine.spec_from_json({"fields": {}})
    with pytest.raises(ValueError):
        tdefine.parse_taps('[[0, 1]]')


@pytest.mark.parametrize("name", SPECS_2D)
def test_reduced_domain_and_seeded_init(name):
    assert (tdata.reduced_domain(tspec.get(name), 64)
            == ref_data.reduced_domain(ref_spec.get(name), 64))
    a = tdata.init_domain(tspec.get(name), (20, 30), seed=3)
    b = tdata.init_domain(tspec.get(name), (20, 30), seed=3)
    assert a.dtype == torch.float32 and torch.equal(a, b)
    assert 0.0 <= float(a.min()) and float(a.max()) < 1.0


@pytest.mark.parametrize("name", SPECS_2D)
def test_roofline_copy_matches_reference(name):
    hw_ref = ref_rl.A100_FP64
    hw = trl.HardwareModel(**{f.name: getattr(hw_ref, f.name)
                              for f in dataclasses.fields(trl.HardwareModel)
                              if hasattr(hw_ref, f.name)})
    ref, mine = ref_spec.get(name), tspec.get(name)
    for t in (1, 4, 12):
        a = ref_rl.attainable(ref, t, hw_ref, v=0.7)
        b = trl.attainable(mine, t, hw, v=0.7)
        assert (a.bottleneck, a.pp_cells_per_s, a.gflops) == (
            b.bottleneck, b.pp_cells_per_s, b.gflops)
    assert trl.desired_depth(mine, hw) == ref_rl.desired_depth(ref, hw_ref)
    assert trl.min_tile_width(mine, hw) == ref_rl.min_tile_width(ref, hw_ref)


@pytest.mark.parametrize("name", SPECS_2D)
@pytest.mark.parametrize("itemsize", [4, 8])
def test_h100_plan_fits_shared_memory(name, itemsize):
    spec = tspec.get(name)
    p = tplanner.plan(spec, trl.H100, itemsize=itemsize)
    assert 1 <= p.t <= 32
    assert p.smem_bytes <= 232448
    assert p.smem_bytes == tplanner.smem_bytes_2d(spec, p.t, *p.block,
                                                  itemsize)
    assert 0 < p.pp.v < 1 and math.isfinite(p.pp.pp_cells_per_s)
    # the paper's own EBISU depth (Table 3) also fits, at the paper domain
    t = tspec.TABLE3_DEPTHS[name]["ebisu"]
    bh, bw, resident = tplanner.fit_tile_2d(spec, t, spec.domain, trl.H100,
                                            itemsize)
    assert bw % tplanner.COL_ALIGN == 0 and bh % tplanner.ROW_ALIGN == 0
    smem = tplanner.smem_bytes_2d(spec, t, bh, bw, itemsize)
    assert resident * (smem + 1024) <= 233472    # the SM's shared memory


def test_h100_depth_follows_eq17():
    spec = tspec.get("j2d5pt")
    want = math.ceil(trl.desired_depth(spec, trl.H100))
    assert tplanner.plan(spec, trl.H100).t == want


def test_planner_refuses_3d_and_oversized_depth():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tplanner.plan(tspec.get("j3d7pt"), trl.H100)
    assert tplanner.fit_tile_2d(tspec.get("j2d25pt"), 32, (8640, 8640),
                                trl.H100, 8) is None


def test_hardware_for_cpu_is_the_datasheet_model():
    assert trl.hardware_for("cpu") == trl.H100
    assert trl.H100.onchip_bytes == 232448 and trl.H100.sm_count == 132


def test_import_gate():
    """``import repro_torch`` (and its API) pulls in no jax, no triton,
    nothing of the reference package, and initializes no CUDA."""
    code = textwrap.dedent("""
        import sys
        import repro_torch, repro_torch.api, repro_torch.launch.stencil_run
        import torch
        roots = ("jax", "jaxlib", "triton", "repro")
        bad = sorted(m for m in sys.modules if m.split(".")[0] in roots)
        assert not bad, bad
        assert not torch.cuda.is_initialized()
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
