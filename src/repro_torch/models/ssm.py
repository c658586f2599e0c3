"""Mamba2 / SSD (state-space duality) mixer: chunked scan and O(1) decode.

Counterpart of the reference's ``repro/models/ssm.py``; plain torch, as
the reference is plain ``jnp`` (no Pallas kernel).  The SSD recurrence
``h_{s+1} = exp(dt·A)·h_s + dt·B x_s`` streamed over the sequence is a
1-D stencil in time, and the chunked algorithm is temporal blocking: each
chunk of ``chunk`` steps is one dense (quadratic-in-chunk) pass, and the
state is carried from chunk to chunk by one scan step per chunk.  Decode
keeps the ``(h, n, p)`` state resident across steps.

The reference's simplifications hold here too: the causal conv runs on x
only (not xBC), and the B/C groups are expanded to heads first.  Every
scan product is float32.  The reference's four-operand einsum of the
intra-chunk term is two products in a fixed order, ``(C·Bᵀ) ∘ L`` then
``· (x·dt)``, so no temporary is larger than one ``(b, nc, h, q, q)``
float32 tensor; its ``lax.scan`` over chunks is a Python loop that
emits each chunk's state *before* the chunk, as the scan does.

On a mesh (``models/parallel.py``, :func:`apply_ssm_mesh`) each model
shard holds whole SSM heads: ``wz``, ``wx``, ``conv_w`` are split by
columns and ``out_proj`` by rows over ``model``; ``wB``, ``wC``,
``wdt``, ``A_log``, ``D``, ``dt_bias`` and ``norm`` are replicated, and
each shard takes its heads' slice.  The gated RMSNorm runs over the
whole ``d_inner``, so its sum of squares is ``psum``med over ``model``
before the scale; a second ``psum`` completes the row-parallel
``out_proj``.

``ssm_impl="boundary_stub"`` is the reference's dry-run stand-in for a
fused SSD kernel: the projections, conv, gated norm and ``out_proj``
run, the chunked scan does not, and a prefill hands decode a zero state
(decode itself runs the real step, as in the reference).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.distributed import psum, smap, unzip
from repro_torch.models.layers import matmul, rms_norm
from repro_torch.models.params import ParamDef


def ssm_defs(d_model: int, d_inner: int, n_heads: int, d_state: int,
             n_groups: int, d_conv: int = 4):
    return {
        "wz": ParamDef((d_model, d_inner), (None, "model")),
        "wx": ParamDef((d_model, d_inner), (None, "model")),
        "wB": ParamDef((d_model, n_groups * d_state), ()),
        "wC": ParamDef((d_model, n_groups * d_state), ()),
        "wdt": ParamDef((d_model, n_heads), ()),
        "conv_w": ParamDef((d_conv, d_inner), (None, "model"), "normal",
                           scale=0.5),
        "A_log": ParamDef((n_heads,), (), "zeros"),
        "D": ParamDef((n_heads,), (), "ones"),
        "dt_bias": ParamDef((n_heads,), (), "zeros"),
        "norm": ParamDef((d_inner,), (), "ones"),
        "out_proj": ParamDef((d_inner, d_model), ("model", None)),
    }


def _causal_conv(x, w):
    """Depthwise causal conv over seq. x: (B,S,C); w: (K,C).  The taps
    are summed in the reference's order, oldest first."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    return out


def _segsum(dA):
    """dA: (..., Q) -> (..., Q, Q) log-decay matrix: sum_{j<i<=q} dA_i,
    -inf above the diagonal."""
    q = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]          # (..., q_i, q_j)
    idx = torch.arange(q, device=dA.device)
    mask = idx[:, None] >= idx[None, :]
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt, A, B, C, D, *, chunk: int = 128):
    """Chunked SSD. x:(b,s,h,p) dt:(b,s,h) A:(h,) B,C:(b,s,h,n) D:(h,).

    Returns y:(b,s,h,p) float32 and the final state (b,h,n,p) float32.
    A sequence that is no multiple of ``chunk`` is zero-padded (dt = 0
    leaves the state as it is), as in the reference.
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    chunk = min(chunk, s)
    if s % chunk:
        pad = chunk - s % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    sp = x.shape[1]
    nc = sp // chunk

    xr = x.reshape(b, nc, chunk, h, p).float()
    dtr = dt.reshape(b, nc, chunk, h).float()
    Br = B.reshape(b, nc, chunk, h, n).float()
    Cr = C.reshape(b, nc, chunk, h, n).float()

    dA_h = (dtr * A).permute(0, 1, 3, 2)                 # (b,nc,h,q) ≤ 0
    cs = torch.cumsum(dA_h, dim=-1)

    # intra-chunk: (C_q · B_k) ∘ L_qk, then times x_k·dt_k
    L = torch.exp(_segsum(dA_h))                         # (b,nc,h,q,k)
    xdt = xr * dtr[..., None]                            # (b,nc,k,h,p)
    scores = torch.einsum("bcqhn,bckhn->bchqk", Cr, Br) * L
    y = torch.einsum("bchqk,bckhp->bcqhp", scores, xdt)
    del scores, L

    # per-chunk end states: sum_k exp(cs_end - cs_k) dt_k B_k ⊗ x_k
    decay_to_end = torch.exp(cs[..., -1:] - cs)          # (b,nc,h,k)
    states = torch.einsum("bckhn,bckhp->bchnp",
                          Br * decay_to_end.permute(0, 1, 3, 2)[..., None],
                          xdt)

    # inter-chunk scan, one step per chunk; keeps the state before each
    chunk_decay = torch.exp(cs[..., -1])                 # (b,nc,h)
    carry = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
    before = []
    for c in range(nc):
        before.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(before, dim=1)             # (b,nc,h,n,p)

    in_decay = torch.exp(cs).permute(0, 1, 3, 2)         # (b,nc,q,h)
    y = y + torch.einsum("bcqhn,bchnp->bcqhp", Cr * in_decay[..., None],
                         prev_states)

    y = y.reshape(b, sp, h, p)[:, :s]
    y = y + x[:, :s].float() * D[None, None, :, None]
    return y, carry


def ssd_decode_step(state, x, dt, A, B, C, D):
    """One-token SSD update. state:(b,h,n,p) x:(b,h,p) dt:(b,h) B,C:(b,h,n)."""
    x32, dt32 = x.float(), dt.float()
    dA = torch.exp(dt32 * A[None, :])                    # (b,h)
    inc = torch.einsum("bhn,bhp->bhnp", B.float() * dt32[..., None], x32)
    state = state * dA[..., None, None] + inc
    y = torch.einsum("bhn,bhnp->bhp", C.float(), state)
    return y + x32 * D[None, :, None], state


def _dt_A_D(p, dt_in):
    dt = F.softplus(dt_in.float() + p["dt_bias"].float())
    return dt, -torch.exp(p["A_log"].float()), p["D"].float()


def _heads(t, g, hpg):
    """(..., g·n) → (..., g·hpg, n): each group's B/C repeated over its
    heads (``jnp.repeat`` on the group axis)."""
    t = t.reshape(*t.shape[:-1], g, -1)
    return torch.repeat_interleave(t, hpg, dim=-2)


def _head_range(p, cfg, m: int) -> tuple:
    """``(h0, hl)``: the heads whose ``wz`` columns ``p`` holds, for model
    shard ``m`` (all of them where ``wz`` is whole)."""
    hl = p["wz"].shape[1] // cfg.ssm_head_dim
    return m * hl if hl < cfg.ssm_heads else 0, hl


def _sl(t, h0: int, hl: int, n: int, dim: int = -1):
    """Heads ``h0 .. h0 + hl`` of ``t`` along ``dim`` (``t`` itself when
    they are all ``n``)."""
    return t if hl == n else t.narrow(dim, h0, hl)


def _gated(x, p, cfg, chunk, heads):
    """The mixer on (B, S, d) up to its gated norm, for the ``heads``
    ``(h0, hl)`` whose columns ``p`` holds: ``(y·silu(z), xin, final
    state)``.  Under ``ssm_impl="boundary_stub"`` (the dry run's stand-in
    for a fused SSD kernel) the scan is left out: the B/C/dt projections
    stay alive folded in at ``1e-30``, and the final state is zero."""
    h, hd, g = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups
    h0, hl = heads
    b, s, _ = x.shape
    z = matmul(x, p["wz"])
    xin = matmul(x, p["wx"])
    xs = F.silu(_causal_conv(xin, p["conv_w"]))
    if getattr(cfg, "ssm_impl", "chunked_jnp") == "boundary_stub":
        small = (matmul(x, p["wB"]).mean() + matmul(x, p["wC"]).mean()
                 + matmul(x, p["wdt"]).mean()) * 1e-30
        state = torch.zeros((b, hl, cfg.ssm_state, hd), dtype=torch.float32,
                            device=x.device)
        return xs * F.silu(z) + small, xin, state
    B = _sl(_heads(matmul(x, p["wB"]), g, h // g), h0, hl, h, -2)
    C = _sl(_heads(matmul(x, p["wC"]), g, h // g), h0, hl, h, -2)
    dt, A, D = (_sl(t, h0, hl, h) for t in _dt_A_D(p, matmul(x, p["wdt"])))
    y, final = ssd_chunked(xs.reshape(b, s, hl, hd), dt, A, B, C, D,
                           chunk=chunk)
    y = y.reshape(b, s, hl * hd).to(x.dtype)
    return y * F.silu(z), xin, final


def _mix(x, p, cfg, chunk):
    """The mixer on (B, S, d): (out, xin, final state)."""
    y, xin, final = _gated(x, p, cfg, chunk, (0, cfg.ssm_heads))
    y = rms_norm(y, p["norm"])
    return matmul(y, p["out_proj"]), xin, final


def _tail(xin, k: int):
    """The last ``k`` rows of the pre-conv input, left-padded with zeros
    when there are fewer."""
    s = xin.shape[1]
    return xin[:, -k:] if s >= k else F.pad(xin, (0, 0, k - s, 0))


def _norm_out(gs, ps, cfg, mesh, heads):
    """The gated RMSNorm over the whole ``d_inner`` and the row-parallel
    ``out_proj`` on a mesh: one ``psum`` of the sums of squares and one
    of the partial products, both over ``model``."""
    hd = cfg.ssm_head_dim
    ss = psum(smap(lambda g: (g.float() * g.float()).sum(-1, keepdim=True),
                   gs), "model", mesh)

    def local(g, s, p, hr):
        y = (g.float() * torch.rsqrt(s / cfg.ssm_inner + 1e-6)).to(g.dtype)
        y = y * p["norm"].narrow(0, hr[0] * hd, hr[1] * hd)
        return matmul(y, p["out_proj"])

    return psum(smap(local, gs, ss, ps, heads), "model", mesh)


def _mesh_heads(ps, cfg, mesh) -> np.ndarray:
    """Each position's ``(h0, hl)`` (:func:`_head_range` at its index
    over ``model``)."""
    k = mesh.axis_names.index("model") if "model" in mesh.axis_names \
        else None
    heads = np.empty(ps.shape, dtype=object)
    for c in np.ndindex(*ps.shape):
        heads[c] = _head_range(ps[c], cfg, 0 if k is None else c[k])
    return heads


def apply_ssm_mesh(xs, ps, cfg, mesh, *, chunk: int = 128):
    """The mixer over ``mesh`` on each position's (B, S, d) →
    ``(outs, tails, finals)`` as :func:`apply_ssm_with_state` gives them,
    each shard's for its heads.  Unsplit heads (``ssm_heads`` not
    divisible by the ``model`` axis) run whole on every shard."""
    heads = _mesh_heads(ps, cfg, mesh)
    k = ps.flat[0]["conv_w"].shape[0]
    if heads.flat[0][1] == cfg.ssm_heads:
        out = smap(lambda x, p: _mix(x, p, cfg, chunk), xs, ps)
        outs, xins, finals = unzip(out, 3)
    else:
        out = smap(lambda x, p, hr: _gated(x, p, cfg, chunk, hr), xs, ps,
                   heads)
        gs, xins, finals = unzip(out, 3)
        outs = _norm_out(gs, ps, cfg, mesh, heads)
    return outs, smap(lambda t: _tail(t, k), xins), finals


def ssm_decode_mesh(xs, ps, cfg, mesh, convs, states):
    """:func:`ssm_decode` over ``mesh``, each shard for its heads →
    ``(outs, convs, states)``."""
    heads = _mesh_heads(ps, cfg, mesh)
    if heads.flat[0][1] == cfg.ssm_heads:
        return unzip(smap(lambda x, p, cv, st: ssm_decode(x, p, cfg, cv, st),
                          xs, ps, convs, states), 3)
    out = smap(lambda x, p, cv, st, hr: _gated_decode(x, p, cfg, cv, st, hr),
               xs, ps, convs, states, heads)
    gs, convs, states = unzip(out, 3)
    return _norm_out(gs, ps, cfg, mesh, heads), convs, states


def apply_ssm(x, p, cfg, *, chunk: int = 128):
    """Full mamba2 mixer on (B, S, d_model) -> (B, S, d_model)."""
    return _mix(x, p, cfg, chunk)[0]


def apply_ssm_with_state(x, p, cfg, *, chunk: int = 128):
    """Like :func:`apply_ssm` but also returns ``(conv_tail,
    final_ssm_state)`` so a prefill can hand off to O(1) decode: the tail
    is the last ``K`` rows of the pre-conv input, left-padded with zeros
    when ``S < K``; the state is float32."""
    out, xin, final = _mix(x, p, cfg, chunk)
    return out, _tail(xin, p["conv_w"].shape[0]), final


def ssm_decode(x, p, cfg, conv_state, ssm_state):
    """Single-token mixer. x: (B, 1, d). Carries (conv_state, ssm_state)
    and returns ``(out, conv_state, ssm_state)``."""
    y, conv_state, ssm_state = _gated_decode(x, p, cfg, conv_state,
                                             ssm_state, (0, cfg.ssm_heads))
    y = rms_norm(y, p["norm"])
    return matmul(y, p["out_proj"]), conv_state, ssm_state


def _gated_decode(x, p, cfg, conv_state, ssm_state, heads):
    """:func:`ssm_decode` up to its gated norm, for the ``heads``
    ``(h0, hl)`` whose columns ``p`` (and the caches) hold."""
    h, hd, g = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups
    h0, hl = heads
    b = x.shape[0]
    z = matmul(x, p["wz"])
    xin = matmul(x, p["wx"])[:, 0]                       # (B, d_inner)
    cat = torch.promote_types(conv_state.dtype, xin.dtype)
    conv_state = torch.cat([conv_state[:, 1:].to(cat), xin[:, None].to(cat)],
                           dim=1)
    prod = torch.promote_types(cat, p["conv_w"].dtype)
    xs = F.silu(torch.einsum("bkc,kc->bc", conv_state.to(prod),
                             p["conv_w"].to(prod)))
    B = _sl(_heads(matmul(x, p["wB"])[:, 0], g, h // g), h0, hl, h, -2)
    C = _sl(_heads(matmul(x, p["wC"])[:, 0], g, h // g), h0, hl, h, -2)
    dt, A, D = (_sl(t, h0, hl, h)
                for t in _dt_A_D(p, matmul(x, p["wdt"])[:, 0]))
    y, ssm_state = ssd_decode_step(ssm_state, xs.reshape(b, hl, hd), dt, A,
                                   B, C, D)
    y = y.reshape(b, 1, hl * hd).to(x.dtype)
    return y * F.silu(z), conv_state, ssm_state
