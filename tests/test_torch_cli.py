"""The port's command-line runner (``repro_torch.launch.stencil_run``) on
its custom-spec and system paths, against the reference's
(``repro.launch.stencil_run``).

Each run goes through ``main`` with ``--device cpu``, so every sweep
runs the kernel's plain version.  A saved field (``--out``) is held
within 2e-5 against what the reference's ``run_single`` computes for the
same spec, domain and depth: its program (``compile_stencil(...)
.apply``, or ``.run`` past the plan's depth, Pallas interpret mode) on
the port's seeded field, since the reference seeds its own with
``jax.random``.  The ``[spec]`` line's hardware-free fields equal the
reference's (its hardware fields come from the port's H100 model, the
reference's from its TPU model).
"""
import json
import re

import numpy as np
import pytest
import torch

from repro.api import Boundary as RefBoundary
from repro.api import compile_stencil as ref_compile
from repro.api import define_stencil as ref_define_stencil
from repro.api import parse_taps as ref_parse_taps
from repro.api import spec_from_json as ref_spec_from_json
from repro.core import stencil_spec as ref_spec
from repro.launch import stencil_run as ref_run
from repro_torch.core import stencil_spec as tspec
from repro_torch.launch import stencil_run
from repro_torch.stencils.data import init_domain

TAPS = "[[[0,0],3],[[0,1],1],[[0,-2],0.5],[[1,0],1],[[-1,1],0.5]]"
SCALE = "256"                       # 8192 / 256: a 32 × 32 domain
TOL = 2e-5


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny tensors: torch's default intra-op threads only oversubscribe
    the CPU the other test workers share."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def ref_single(spec, t, boundary=None):
    """The reference's ``run_single`` steps on the port's seeded field:
    its program at the plan's depth, one sweep of ``t`` or ``.run`` past
    the plan's depth (zero Dirichlet and periodic take no depth cap)."""
    import jax.numpy as jnp

    shape = ref_run.reduced_domain(spec, int(SCALE))
    port = tspec.spec_from_reference(spec)
    x = init_domain(port, shape, device="cpu").numpy()
    prog = ref_compile(spec, shape, boundary=boundary, interpret=True)
    xj = jnp.asarray(x)
    y = prog.run(xj, t) if t > prog.t else prog.apply(xj, t=t)
    return np.asarray(y)


def hardware_free(line: str) -> str:
    """The ``[spec]`` line up to its hardware-dependent Eq 17/23 part."""
    return line.rsplit("|", 1)[0]


def spec_line(out: str) -> str:
    return next(ln for ln in out.splitlines() if ln.startswith("[spec]"))


def test_taps_normalize_name_out_run(tmp_path, capsys):
    out = tmp_path / "y.npy"
    stencil_run.main(["--taps", TAPS, "--normalize", "--name", "mine",
                      "--t", "3", "--scale", SCALE, "--out", str(out),
                      "--device", "cpu"])
    text = capsys.readouterr().out
    assert "[stencil] mine" in text and "maxerr=" in text
    got = np.load(out)
    spec = ref_define_stencil(ref_parse_taps(TAPS), normalize=True,
                              name="mine")
    want = ref_single(spec, 3)
    assert got.shape == want.shape == (32, 32)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    assert hardware_free(spec_line(text)) == hardware_free(
        ref_run.cost_summary_line(spec))
    assert re.search(r"eq17 t\*=\S+ eq23 w_min=\d+", spec_line(text))


def test_spec_json_run(tmp_path, capsys):
    obj = {"taps": [[[0, 0], 2.0], [[1, 0], 1.0], [[-1, 0], 1.0],
                    [[0, 2], 0.5]], "name": "from-json", "normalize": True,
           "a_sm": 7}
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(obj))
    out = tmp_path / "y.npy"
    stencil_run.main(["--spec-json", str(path), "--t", "2", "--scale", SCALE,
                      "--boundary", "periodic", "--out", str(out),
                      "--device", "cpu"])
    text = capsys.readouterr().out
    spec = ref_spec_from_json(obj)
    line = spec_line(text)
    assert "overrides=a_sm" in line
    assert hardware_free(line) == hardware_free(
        ref_run.cost_summary_line(spec))
    want = ref_single(spec, 2, RefBoundary.periodic())
    np.testing.assert_allclose(np.load(out), want, atol=TOL, rtol=TOL)


def test_table2_out_and_system_run(tmp_path, capsys):
    """``--out`` on one Table-2 name, and a ``--system gray-scott`` run
    with its ``[system]`` line and the lockstep check."""
    out = tmp_path / "j.npy"
    stencil_run.main(["--stencil", "j2d9pt", "--scale", SCALE, "--t", "2",
                      "--out", str(out), "--device", "cpu"])
    want = ref_single(ref_spec.get("j2d9pt"), 2)
    np.testing.assert_allclose(np.load(out), want, atol=TOL, rtol=TOL)
    stencil_run.main(["--system", "gray-scott", "--t", "2", "--T", "5",
                      "--scale", "24", "--device", "cpu"])
    line = next(ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("[system]"))
    assert "gray-scott" in line and "domain=(24, 24) T=5 t=2" in line
    assert float(line.split("maxerr_vs_lockstep=")[1]) < 2e-5


@pytest.mark.parametrize("argv,message", [
    (["--taps", TAPS, "--spec-json", "x.json"], "mutually exclusive"),
    (["--system", "gray-scott", "--taps", TAPS], "--system runs"),
    (["--stencil", "j2d5pt,j2d9pt", "--out", "y.npy"], "one field"),
    # the mesh and campaign flags are ported: their ids hold the
    # refusals of those flags that remain
    (["--mesh", "2", "--distributed"], "mutually exclusive"),
    (["--distributed", "--checkpoint-dir", "ck"], "drives compiled"),
    (["--system", "gray-scott", "--checkpoint-dir", "ck"], "--system runs"),
    (["--resume", "sometimes"], "invalid choice"),
    (["--stencil", "j2d5pt,j2d9pt", "--checkpoint-dir", "ck", "--every",
      "2"], "name one stencil"),
    (["--kill-after-leg", "1"], "--kill-after-leg needs --checkpoint-dir"),
    (["--taps", TAPS, "--distributed"], "custom specs run single-device"),
    (["--system", "gray-scott", "--mesh", "2"], "--system runs"),
], ids=["taps-and-json", "system-and-taps", "out-of-two", "mesh",
        "distributed", "checkpoint-dir", "resume", "every",
        "kill-after-leg", "distributed-custom", "system-and-mesh"])
def test_refusals(argv, message, capsys):
    """The reference's ``ap.error`` refusals (and the port's one for a
    campaign of more than one stencil)."""
    with pytest.raises(SystemExit) as exc:
        stencil_run.main(argv + ["--device", "cpu"])
    assert exc.value.code == 2
    assert message in capsys.readouterr().err


def test_spec_json_with_fields_is_refused_as_a_stencil(tmp_path):
    from repro_torch.systems import get_system, system_to_json

    path = tmp_path / "sys.json"
    path.write_text(json.dumps(system_to_json(get_system("gray-scott"))))
    with pytest.raises(SystemExit):
        stencil_run.main(["--spec-json", str(path), "--device", "cpu"])


def test_mesh_run_against_reference_oracle(tmp_path, capsys):
    """``--mesh 2x2 --device cpu``: four CPU shards, the ``[sharded]``
    line with the devices and the exchange count, and ``--out`` within
    2e-5 of the reference's per-step oracle on the same field."""
    import jax.numpy as jnp

    from repro.api.boundary import Boundary as RB
    from repro.kernels import ref as jref

    out = tmp_path / "y.npy"
    stencil_run.main(["--stencil", "j2d9pt", "--mesh", "2x2", "--T", "7",
                      "--boundary", "periodic", "--scale", SCALE,
                      "--out", str(out), "--device", "cpu"])
    line = next(ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("[sharded]"))
    assert "mesh=2x2 devices=cpux4 T=7" in line
    rounds = int(line.split("exchanges=")[1].split()[0])
    assert f"ppermutes={rounds * 2 * 2}" in line
    shape = tuple(int(n) for n in line.split("domain=(")[1].split(")")[0]
                  .split(","))
    spec = tspec.get("j2d9pt")
    x = init_domain(spec, shape, device="cpu").numpy()
    want = np.asarray(jref.reference_unrolled(
        jnp.asarray(x), ref_spec.get("j2d9pt"), 7, boundary=RB.periodic()))
    np.testing.assert_allclose(np.load(out), want, atol=TOL, rtol=TOL)


def test_distributed_and_campaign_runs(tmp_path, capsys):
    """``--distributed`` (one CPU shard, the oracle check inside), and a
    two-leg-wide campaign whose ``--out`` equals the program's ``.run``
    bit for bit."""
    from repro_torch.api import compile_stencil
    from repro_torch.stencils.data import reduced_domain

    stencil_run.main(["--stencil", "j3d7pt", "--distributed", "--scale",
                      "64", "--device", "cpu"])
    line = next(ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("[stencil-dist]"))
    assert "shards=1 devices=cpu" in line
    assert float(line.split("maxerr=")[1]) < 1e-4
    out = tmp_path / "c.npy"
    stencil_run.main(["--stencil", "j2d5pt", "--checkpoint-dir",
                      str(tmp_path / "ck"), "--every", "2", "--T", "9",
                      "--t", "2", "--scale", SCALE, "--out", str(out),
                      "--device", "cpu"])
    line = next(ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("[campaign] j2d5pt"))
    assert "T=9 t=2 legs=3 every=2" in line and "ckpts=4" in line
    spec = tspec.get("j2d5pt")
    shape = reduced_domain(spec, int(SCALE))
    prog = compile_stencil(spec, shape, t=2, device="cpu")
    want = prog.run(init_domain(spec, shape, device="cpu"), 9)
    assert (np.load(out) == want.numpy()).all()
