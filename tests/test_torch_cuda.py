"""The port's CUDA kernel on a card: each test is marked ``cuda`` and skips
without a CUDA device (the kernel has no CPU mode).  This file imports
no JAX, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The kernel is held against its plain version on the same padded input,
and whole programs against the port's oracle.  Tolerances: 2e-5 for f32
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
    spec = tspec.get(name)
    hp, wp = st.padded_shape_2d(spec, t, bh, bw, *shape)
    xp = torch.zeros((hp, wp), dtype=dtype, device=cuda_device)
    xp[:shape[0], :shape[1]] = field(shape).to(cuda_device)
    before = st.ebisu2d_padded.launches
    got = st.ebisu2d_padded(xp, spec, t, height=shape[0], width=shape[1],
                            bh=bh, bw=bw)
    torch.cuda.synchronize()
    assert st.ebisu2d_padded.launches == before + 1
    want = st.ebisu2d_padded_plain(xp, spec, t, height=shape[0],
                                   width=shape[1])
    tol = 2e-5 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)


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
