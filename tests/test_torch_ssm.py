"""The port's mamba2 / SSD mixer (``repro_torch.models.ssm``) against the
JAX reference (``repro.models.ssm``), on the CPU.

Numpy-seeded inputs go through both packages:

  * ``ssd_chunked`` at several ``(s, chunk)``, among them sequences that
    are no multiple of the chunk (the zero-padded tail) and a chunk
    longer than the sequence; and against the sequential recurrence of
    ``ssd_decode_step`` (the port's counterpart of
    ``tests/test_ssm_properties.py``), whose chunk size must not matter;
  * ``ssd_decode_step``, ``apply_ssm``, ``apply_ssm_with_state`` (its
    conv tail left-padded when ``S < 4``, its float32 state) and
    ``ssm_decode``, in float32 and bfloat16;
  * ``apply_ssm``'s gradients against ``jax.vjp``.

Tolerances: the reference suite's 2e-5 for float32 forwards (2e-4 for
the chunked-vs-sequential recurrence, ``tests/test_ssm_properties.py``'s
own), 1e-4 for gradients, 0.06 for bfloat16.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro_torch.configs as TC
from repro.models import ssm as RS
from repro_torch.models import ssm as TS

F32, GRAD = 2e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are tiny: one intra-op thread keeps this module
    from oversubscribing the CPU the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scan_inputs(b, s, h, p, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h) * 0.3).astype(np.float32)
    B = (rng.standard_normal((b, s, h, n)) * 0.5).astype(np.float32)
    C = (rng.standard_normal((b, s, h, n)) * 0.5).astype(np.float32)
    D = (rng.standard_normal(h) * 0.5 + 1).astype(np.float32)
    return x, dt, A, B, C, D


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=what)


# ----------------------------------------------------------------- scan ----
@pytest.mark.parametrize("s,chunk", [(32, 8), (37, 8), (45, 16), (20, 32),
                                     (7, 3)])
def test_ssd_chunked_matches_reference(s, chunk):
    args = _scan_inputs(2, s, 3, 4, 5, seed=s)
    y, state = TS.ssd_chunked(*_t(*args), chunk=chunk)
    want_y, want_state = jax.jit(RS.ssd_chunked, static_argnames="chunk")(
        *_j(*args), chunk=chunk)
    assert y.shape == (2, s, 3, 4) and state.shape == (2, 3, 5, 4)
    assert y.dtype == state.dtype == torch.float32
    _close(y, want_y, F32, "y")
    _close(state, want_state, F32, "final state")


def _sequential(x, dt, A, B, C, D):
    b, s, h, p = x.shape
    state = torch.zeros((b, h, B.shape[-1], p))
    ys = []
    for i in range(s):
        y, state = TS.ssd_decode_step(state, x[:, i], dt[:, i], A, B[:, i],
                                      C[:, i], D)
        ys.append(y)
    return torch.stack(ys, dim=1), state


@pytest.mark.parametrize("s,chunks", [(24, (2, 5, 24)), (33, (4, 16, 64))])
def test_ssd_chunked_equals_sequential_recurrence(s, chunks):
    """Blocked == unblocked: every chunk size gives the step-by-step
    recurrence's outputs and final state."""
    args = _t(*_scan_inputs(2, s, 3, 4, 5, seed=7))
    y_seq, st_seq = _sequential(*args)
    for chunk in chunks:
        y, st = TS.ssd_chunked(*args, chunk=chunk)
        torch.testing.assert_close(y, y_seq, atol=2e-4, rtol=2e-4)
        torch.testing.assert_close(st, st_seq, atol=2e-4, rtol=2e-4)


def test_ssd_decode_step_matches_reference():
    rng = np.random.default_rng(3)
    b, h, p, n = 2, 3, 4, 5
    state = rng.standard_normal((b, h, n, p), dtype=np.float32)
    x = rng.standard_normal((b, h, p), dtype=np.float32)
    dt = np.abs(rng.standard_normal((b, h), dtype=np.float32))
    A = -np.abs(rng.standard_normal(h, dtype=np.float32))
    B, C = (rng.standard_normal((b, h, n), dtype=np.float32) for _ in "BC")
    D = rng.standard_normal(h, dtype=np.float32)
    args = (state, x, dt, A, B, C, D)
    y, st = TS.ssd_decode_step(*_t(*args))
    want_y, want_st = jax.jit(RS.ssd_decode_step)(*_j(*args))
    _close(y, want_y, F32)
    _close(st, want_st, F32)


# ---------------------------------------------------------------- mixer ----
def _mixer(dtype="float32", seed=0):
    """The reduced mamba2-130m config pair (chunk 8) and one set of
    mixer weights (A_log, D and dt_bias drawn, not their 0/1 inits)."""
    r = dataclasses.replace(RC.get_config("mamba2-130m").reduced(),
                            ssm_chunk=8, ssm_groups=2)
    t = dataclasses.replace(TC.get_config("mamba2-130m").reduced(),
                            ssm_chunk=8, ssm_groups=2)
    defs = TS.ssm_defs(t.d_model, t.ssm_inner, t.ssm_heads, t.ssm_state,
                       t.ssm_groups)
    rng = np.random.default_rng(seed)
    p = {}
    for name, d in defs.items():
        scale = d.scale if d.scale is not None else d.fan_in() ** -0.5
        p[name] = (rng.standard_normal(d.shape) * scale).astype(np.float32)
    p["norm"] += 1
    p["D"] += 1
    jp = {k: jnp.asarray(v, dtype) for k, v in p.items()}
    tp = {k: torch.from_numpy(v).to(getattr(torch, dtype))
          for k, v in p.items()}
    if dtype != "float32":
        r = dataclasses.replace(r, activ_dtype=jnp.bfloat16,
                                param_dtype=jnp.bfloat16)
        t = dataclasses.replace(t, activ_dtype=torch.bfloat16,
                                param_dtype=torch.bfloat16)
    return r, t, jp, tp


def _x(b, s, d, dtype, seed=1):
    x = np.random.default_rng(seed).standard_normal((b, s, d),
                                                    dtype=np.float32)
    return jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch,
                                                                 dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [3, 21])
def test_apply_ssm_with_state_matches_reference(s, dtype):
    """The output, the conv tail (the last 4 pre-conv rows, left-padded
    with zeros when S < 4) and the float32 final state; ``apply_ssm``'s
    output is the same."""
    tol = F32 if dtype == "float32" else 0.06
    r, t, jp, tp = _mixer(dtype)
    jx, tx = _x(2, s, t.d_model, dtype)
    y, tail, state = TS.apply_ssm_with_state(tx, tp, t, chunk=t.ssm_chunk)
    want_y, want_tail, want_state = jax.jit(
        lambda x, p: RS.apply_ssm_with_state(x, p, r, chunk=r.ssm_chunk))(
        jx, jp)
    assert y.dtype == tx.dtype and tail.dtype == tx.dtype
    assert tail.shape == (2, 4, t.ssm_inner)
    assert state.dtype == torch.float32
    _close(y, want_y, tol, "out")
    _close(tail, want_tail, tol, "conv tail")
    _close(state, want_state, tol, "state")
    if s < 4:
        assert not tail[:, :4 - s].any()
    torch.testing.assert_close(TS.apply_ssm(tx, tp, t, chunk=t.ssm_chunk), y)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_decode_matches_reference(dtype):
    """Two decode steps from a random conv and SSM state."""
    tol = F32 if dtype == "float32" else 0.06
    r, t, jp, tp = _mixer(dtype)
    rng = np.random.default_rng(4)
    conv = rng.standard_normal((2, 4, t.ssm_inner), dtype=np.float32)
    state = rng.standard_normal((2, t.ssm_heads, t.ssm_state,
                                 t.ssm_head_dim), dtype=np.float32)
    jc, js = jnp.asarray(conv, dtype), jnp.asarray(state)
    tc, ts = torch.from_numpy(conv).to(getattr(torch, dtype)), \
        torch.from_numpy(state)
    decode = jax.jit(lambda x, p, c, st: RS.ssm_decode(x, p, r, c, st))
    for step in range(2):
        jx, tx = _x(2, 1, t.d_model, dtype, seed=10 + step)
        want, jc, js = decode(jx, jp, jc, js)
        got, tc, ts = TS.ssm_decode(tx, tp, t, tc, ts)
        _close(got, want, tol, f"step {step} out")
        _close(tc, jc, tol, f"step {step} conv")
        _close(ts, js, tol, f"step {step} state")


def test_apply_ssm_grads_match_jax_vjp():
    r, t, jp, tp = _mixer("float32", seed=5)
    jx, tx = _x(2, 19, t.d_model, "float32", seed=6)
    ct = np.random.default_rng(8).standard_normal(
        (2, 19, t.d_model), dtype=np.float32)
    def ref(x, p, ct):
        out, vjp = jax.vjp(lambda x, p: RS.apply_ssm(x, p, r, chunk=8), x, p)
        return out, vjp(ct)

    out, (want_dx, want_dp) = jax.jit(ref)(jx, jp, jnp.asarray(ct))
    tx.requires_grad_(True)
    leaves = {k: v.requires_grad_(True) for k, v in tp.items()}
    got = TS.apply_ssm(tx, leaves, t, chunk=8)
    _close(got, out, F32, "out")
    names = list(leaves)
    grads = torch.autograd.grad(got, [tx] + [leaves[k] for k in names],
                                torch.from_numpy(ct))
    _close(grads[0], want_dx, GRAD, "dx")
    for k, g in zip(names, grads[1:]):
        _close(g, want_dp[k], GRAD, f"d{k}")


def test_boundary_stub_refused():
    """``ssm_impl="boundary_stub"`` is ported (no longer refused): the
    mixer without its scan (the B/C/dt projections folded in at
    ``1e-30``, a zero state, the real conv tail) against the reference's
    stub, and decode runs the real step, as the reference's does."""
    r, t, jp, tp = _mixer()
    r = dataclasses.replace(r, ssm_impl="boundary_stub")
    t = dataclasses.replace(t, ssm_impl="boundary_stub")
    jx, tx = _x(2, 21, t.d_model, "float32")
    y, tail, state = TS.apply_ssm_with_state(tx, tp, t, chunk=t.ssm_chunk)
    want_y, want_tail, want_state = jax.jit(
        lambda x, p: RS.apply_ssm_with_state(x, p, r, chunk=r.ssm_chunk))(
        jx, jp)
    _close(y, want_y, F32, "out")
    _close(tail, want_tail, F32, "tail")
    assert state.dtype == torch.float32 and not torch.any(state)
    assert state.shape == tuple(want_state.shape)
    _close(TS.apply_ssm(tx, tp, t, chunk=t.ssm_chunk), want_y, F32, "apply")
    conv = torch.from_numpy(np.asarray(want_tail))
    got = TS.ssm_decode(tx[:, :1], tp, t, conv, state)
    want = jax.jit(lambda x, p, c, s: RS.ssm_decode(x, p, r, c, s))(
        jx[:, :1], jp, want_tail, want_state)
    for g, w, what in zip(got, want, ("out", "conv", "state")):
        _close(g, w, F32, what)
