"""The port's mixture-of-experts block (``repro_torch.models.moe``) against
the JAX reference (``repro.models.moe``), on the CPU.

Numpy-seeded tokens and weights go through both packages' dense
dispatch:

  * ``moe_defs`` pads the experts to a multiple of 16 (40 → 48);
  * ``apply_moe`` and its aux loss for each ``act``, at the reduced
    configs' drop-free capacity (16.0) and at ``capacity_factor=1.0``,
    where slots are dropped: the same slots must drop (the port's kept
    slots are compared with the reference's rank rule, and the outputs
    of the tokens that lost a slot differ from the drop-free run);
  * the phantom experts of a padded router receive no token;
  * the capacity rule, with its rounding to multiples of 256;
  * ``apply_moe``'s gradients against ``jax.vjp``.

Tolerances: the reference suite's 2e-5 for forwards, 1e-4 for
gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as RM
from repro_torch.models import moe as TM

F32, GRAD = 2e-5, 1e-4
D_MODEL, D_FF = 32, 48


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are tiny: one intra-op thread keeps this module
    from oversubscribing the CPU the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(n_experts, act, seed=0):
    defs, e = TM.moe_defs(D_MODEL, D_FF, n_experts, act=act)
    rng = np.random.default_rng(seed)
    p = {k: (rng.standard_normal(d.shape) * d.fan_in() ** -0.5)
         .astype(np.float32) for k, d in defs.items()}
    return e, p


def _x(b, s, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, s, D_MODEL), dtype=np.float32)


def _both(x, p, **kw):
    want_y, want_aux = jax.jit(lambda x, p: RM.apply_moe(x, p, **kw))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()})
    got_y, got_aux = TM.apply_moe(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()},
        **kw)
    return (got_y, got_aux), (want_y, want_aux)


def test_moe_defs_pad_to_16():
    defs, e = TM.moe_defs(1536, 512, 40)
    want, we = RM.moe_defs(1536, 512, 40)
    assert e == we == 48
    assert {k: d.shape for k, d in defs.items()} == \
        {k: d.shape for k, d in want.items()}
    assert "w_gate" not in TM.moe_defs(8, 8, 16, act="gelu")[0]


@pytest.mark.parametrize("cap", [16.0, 1.0], ids=["dropfree", "cap1"])
@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "silu"])
def test_apply_moe_matches_reference(act, cap):
    e, p = _weights(8, act)
    x = _x(2, 24)
    kw = dict(n_experts=8, n_padded=e, top_k=2, act=act,
              capacity_factor=cap)
    (y, aux), (want_y, want_aux) = _both(x, p, **kw)
    assert y.dtype == torch.float32 and y.shape == x.shape
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=F32,
                               rtol=F32)
    assert abs(float(aux) - float(want_aux)) < F32


def _reference_keep(x, router, n_experts, top_k, cap):
    """The reference's kept slots, by its own rank rule
    (``repro/models/moe.py:57-72``) on its own router logits."""
    logits = jnp.asarray(x.reshape(-1, D_MODEL)) @ jnp.asarray(router)
    n_padded = router.shape[1]
    logits = jnp.where(jnp.arange(n_padded)[None] >= n_experts, -1e30,
                       logits)
    _, ids = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), top_k)
    flat = ids.reshape(-1)
    onehot = jax.nn.one_hot(flat, n_padded, dtype=jnp.int32)
    rank = jnp.cumsum(onehot, axis=0) - onehot
    my_rank = jnp.take_along_axis(rank, flat[:, None], axis=1)[:, 0]
    return np.asarray(my_rank < cap), np.asarray(flat)


def test_capacity_one_drops_the_reference_slots():
    """At ``capacity_factor=1.0`` 48 tokens × top-2 over 8 experts get
    12 slots an expert: the port keeps exactly the reference's slots,
    some slots drop, and the tokens that lost one differ from the
    drop-free run while the others do not."""
    e, p = _weights(8, "swiglu", seed=3)
    x = _x(2, 24, seed=4)
    cap = TM.capacity(48, 2, 8, 1.0)
    assert cap == 12
    logits = torch.from_numpy(x.reshape(-1, D_MODEL)) @ torch.from_numpy(
        p["router"])
    _, ids, e_idx, c_idx, keep = TM.route(logits, 8, 2, cap)
    want_keep, want_ids = _reference_keep(x, p["router"], 8, 2, cap)
    np.testing.assert_array_equal(ids.reshape(-1).numpy(), want_ids)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert 0 < int((~keep).sum()) < keep.numel()
    kept = keep.numpy()
    assert len(set(zip(e_idx.numpy()[kept], c_idx.numpy()[kept]))) == \
        int(kept.sum())                       # kept slots never collide
    kw = dict(n_experts=8, n_padded=e, top_k=2)
    xt = torch.from_numpy(x)
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    y1, _ = TM.apply_moe(xt, pt, capacity_factor=1.0, **kw)
    y16, _ = TM.apply_moe(xt, pt, capacity_factor=16.0, **kw)
    lost = (~keep).reshape(48, 2).any(dim=1).reshape(2, 24)
    moved = (y1 - y16).abs().amax(dim=-1) > 1e-6
    assert torch.equal(moved, lost)


def test_phantom_experts_receive_no_token():
    """6 experts padded to 16: the router's 10 phantom columns are
    masked, so every slot goes to a real expert and the phantoms'
    buckets stay empty (their weights get no gradient)."""
    e, p = _weights(6, "swiglu", seed=5)
    assert e == 16
    p["router"][:, 6:] += 100.0     # phantoms would win every token
    x = _x(2, 20, seed=6)
    cap = TM.capacity(40, 2, 6)
    logits = torch.from_numpy(x.reshape(-1, D_MODEL)) @ torch.from_numpy(
        p["router"])
    _, ids, e_idx, _, keep = TM.route(logits, 6, 2, cap)
    assert int(ids.max()) < 6 and bool(keep.all()) and int(e_idx.max()) < 6
    pt = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    y, aux = TM.apply_moe(torch.from_numpy(x), pt, n_experts=6, n_padded=16,
                          top_k=2)
    (y.sum() + aux).backward()
    for k in ("w_up", "w_gate", "w_down"):
        assert not pt[k].grad[6:].any() and pt[k].grad[:6].any()
    (want_y, want_aux) = _both(x, p, n_experts=6, n_padded=16, top_k=2)[1]
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               atol=F32, rtol=F32)


def test_capacity_rule():
    assert TM.capacity(4, 2, 8) == 4                 # the floor
    assert TM.capacity(48, 2, 8, 1.0) == 12
    assert TM.capacity(8192, 8, 40) == 2048          # 256-aligned already
    assert TM.capacity(1000, 8, 40) == 250           # up to 256: as it is
    assert TM.capacity(4096, 8, 128) == 512          # 320 → 512
    assert TM.capacity(32768, 8, 40) == 8192


@pytest.mark.parametrize("cap", [16.0, 1.0], ids=["dropfree", "cap1"])
def test_apply_moe_grads_match_jax_vjp(cap):
    e, p = _weights(8, "geglu", seed=7)
    x = _x(2, 24, seed=8)
    ct = np.random.default_rng(9).standard_normal(x.shape, dtype=np.float32)
    kw = dict(n_experts=8, n_padded=e, top_k=2, act="geglu",
              capacity_factor=cap)

    def ref(x, p, ct):
        (y, aux), vjp = jax.vjp(lambda x, p: RM.apply_moe(x, p, **kw), x, p)
        return vjp((ct, jnp.float32(0.5)))

    want_dx, want_dp = jax.jit(ref)(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
        jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_(True)
    pt = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    y, aux = TM.apply_moe(xt, pt, **kw)
    names = list(pt)
    grads = torch.autograd.grad((y * torch.from_numpy(ct)).sum() + 0.5 * aux,
                                [xt] + [pt[k] for k in names])
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(want_dx),
                               atol=GRAD, rtol=GRAD)
    for k, g in zip(names, grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(want_dp[k]),
                                   atol=GRAD, rtol=GRAD, err_msg=k)
