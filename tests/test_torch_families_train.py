"""The port's other LM families against the JAX reference, on the CPU:
training.  The six configs of ``tests/test_torch_families.py``
(mamba2-130m, zamba2-2.7b, granite-moe-3b-a800m, qwen3-moe-235b-a22b,
hubert-xlarge, internvl2-1b) at ``reduced()`` size, with the reference's
``tree_init`` weights carried across by ``params_from_jax``
(``tests/families_ref.py``):

  * ``train_loss`` (the encoder's masked, unshifted loss against its
    head; the MoE's aux loss) and its gradients against
    ``jax.value_and_grad``, with and without remat, at the reference's
    own ``batch_for_step`` batch;
  * ``batch_for_step`` equal array for array, frames, mask and patches
    drawn in the reference's order, and ``launch/train.reduced_shapes``
    and ``train_shapes`` against the reference's;
  * ``launch.train.train`` for two steps.

Tolerances: 2e-5 for the loss, 1e-4 for gradients.
"""
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro_torch.configs as TC
from families_ref import F32, FAMILIES, GRAD, cfgs, port, to_torch, \
    train_reference
from repro.launch import train as RLT
from repro.train import data as RD
from repro_torch.launch import train as tlaunch
from repro_torch.models.params import params_from_jax
from repro_torch.train import data as TD
from repro_torch.train import train_step as TTS


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are tiny: one intra-op thread keeps this module
    from oversubscribing the CPU the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("remat", [False, True], ids=["noremat", "remat"])
@pytest.mark.parametrize("name", FAMILIES)
def test_train_loss_and_grads_match_reference(name, remat):
    ref = train_reference(name)
    tcfg, model = port(name, ref, remat=remat)
    batch = to_torch(ref["batch"])
    loss = TTS.loss_fn(tcfg, model, batch)
    names, leaves = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - ref["loss"]) < F32
    want = params_from_jax(ref["grads"])
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), atol=GRAD,
                                   rtol=GRAD, err_msg=n)


@pytest.mark.parametrize("name", FAMILIES)
def test_batch_for_step_matches_reference(name):
    """Array for array, in the reference's draw order; and the shapes of
    a full training cell against ``input_specs``."""
    rcfg, tcfg = cfgs(name)
    shapes = RLT.reduced_shapes(rcfg, 3, 20)
    got_shapes = tlaunch.reduced_shapes(tcfg, 3, 20)
    assert list(got_shapes) == list(shapes)
    assert got_shapes == {k: v.shape for k, v in shapes.items()}
    for seed, step in ((0, 0), (3, 7)):
        want = RD.batch_for_step(rcfg, "train_4k", step, seed, shapes)
        got = TD.batch_for_step(tcfg, "train_4k", step, seed, got_shapes,
                                device="cpu")
        assert list(got) == list(want)
        for k in want:
            assert str(got[k].dtype).removeprefix("torch.") == \
                np.asarray(want[k]).dtype.name, k
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    full = RC.get_config(name).input_specs("train_4k")
    assert TD.train_shapes(TC.get_config(name), "train_4k") == {
        k: v.shape for k, v in full.items()}


@pytest.mark.parametrize("name", FAMILIES)
def test_launch_train_runs_on_cpu(name):
    _, state, losses = tlaunch.train(name, steps=2, batch=2, seq=32,
                                     lr=1e-3, seed=1, device="cpu",
                                     log_every=10)
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert int(state["count"]) == 2
