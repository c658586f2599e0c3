"""The port's int8 compressed all-reduce (``train/compress.py``) on an
8-shard CPU mesh, held to the reference's three contracts
(``tests/multidev_compress_child.py``): the error of one sum within
``n · max|x| / 127``, its mean over 64 seeds within a tenth of that bound
of the true sum (stochastic rounding is unbiased), and data-parallel SGD
through it reaching a loss under 0.05 in 200 steps.  The reference's
``jax.random`` bits cannot be matched: each shard draws from its own
``torch.Generator``.  The inputs are the reference test's shapes, drawn
with numpy."""
import numpy as np
import pytest
import torch

from repro_torch.core import distributed as D
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.params import NamedSharding
from repro_torch.train.compress import (compressed_psum, compressed_psum_tree,
                                        dequantize,
                                        make_compressed_allreduce_step,
                                        quantize_int8, shard_generators)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh((8,), ("data",), devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def x():
    return torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 256)).astype(np.float32))


def _bound(x):
    return 8 * float(x.abs().max()) / 127.0


def test_compressed_psum_error_bound(mesh, x):
    """Every shard gets the sum within ``n_shards · max|x| / 127``, one
    ``pmax`` and one int32 ``psum`` over ``data``."""
    xs = NamedSharding(mesh, ("data",)).split(x)
    D.reset_collectives()
    got = compressed_psum(xs, "data", mesh, shard_generators(mesh, 1))
    assert D.collective_counts() == {"psum": {"data": 1},
                                     "pmax": {"data": 1}}
    want = x.sum(dim=0, keepdim=True)
    for g in got.flat:
        assert g.dtype == torch.float32 and g.shape == (1, 256)
        assert float((g - want).abs().max()) <= _bound(x) + 1e-5
    assert all(torch.equal(g, got.flat[0]) for g in got.flat)


def test_compressed_psum_is_unbiased(mesh, x):
    xs = NamedSharding(mesh, ("data",)).split(x)
    samples = [compressed_psum(xs, "data", mesh,
                               shard_generators(mesh, 100 + i)).flat[0]
               for i in range(64)]
    bias = float((torch.stack(samples).mean(0)
                  - x.sum(dim=0, keepdim=True)).abs().max())
    assert bias < 0.1 * _bound(x), (bias, _bound(x))


def test_compressed_dp_sgd_converges(mesh):
    rng = np.random.default_rng(2)
    w_true = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
    X = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32))
    Y = X @ w_true

    def loss_fn(params, batch):
        xb, yb = batch
        return torch.mean((xb @ params["w"] - yb) ** 2)

    params = {"w": torch.zeros(16)}
    step = make_compressed_allreduce_step(loss_fn, mesh, "data", lr=0.05)
    for i in range(200):
        params = step(params, (X, Y), i)
    final = float(loss_fn(params, (X, Y)))
    assert final < 0.05, final


def test_quantize_int8_and_tree(mesh, x):
    """One shard's codes are within the scale of ``x`` and exact zeros
    stay zero; the tree form reduces each leaf with its own scale."""
    q, scale = quantize_int8(x, torch.Generator().manual_seed(0))
    assert q.dtype == torch.int8 and int(q.abs().max()) <= 127
    assert float((dequantize(q, scale) - x).abs().max()) <= float(scale)
    z, _ = quantize_int8(torch.zeros(5), torch.Generator().manual_seed(0))
    assert not z.any()
    xs = NamedSharding(mesh, ("data",)).split(x)
    zs = NamedSharding(mesh, ("data",)).split(torch.zeros(8, 3))
    out = compressed_psum_tree({"x": xs, "z": zs}, "data", mesh,
                               shard_generators(mesh, 3))
    assert not out["z"].flat[0].any()
    assert float((out["x"].flat[0] - x.sum(0, keepdim=True)).abs().max()) \
        <= _bound(x) + 1e-5
