"""Core NN layers of the port: norms, RoPE, MLPs, embeddings.

Counterpart of the reference's ``repro/models/layers.py``.  The order of
casts is the reference's, because it decides the bf16 roundings:

  * ``rms_norm``/``layer_norm`` reduce in float32, cast back to the
    input dtype, *then* apply ``scale`` (and ``bias``), so a float32
    scale promotes a bf16 input to float32 as ``jnp`` does;
  * RoPE is the half-rotation convention with frequencies
    ``theta ** (arange(half) / half)`` in float32, rotated in float32
    and cast back once;
  * ``jax.nn.gelu`` defaults to the tanh approximation, so the GeGLU and
    GELU MLPs use ``F.gelu(approximate="tanh")``.

``p`` is anything indexable by the reference's leaf names: a
``ParamModule`` or a dict of tensors.  On a mesh, :func:`shard` is where
activations are split over the DP axes (the reference's ``shard``
constraint), and ``models/parallel.py`` runs these layers per shard.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.params import NamedSharding, ParamDef


def shard(x, mesh, dp):
    """``x`` split along its batch dim over the DP axes ``dp`` (whole
    where ``dp`` is ``None``), replicated over the other mesh axes: a
    mesh-shaped array of per-position tensors on their devices."""
    return NamedSharding(mesh, (dp,)).split(x)


def matmul(x, w):
    """``x @ w`` with ``jnp``'s type promotion (torch refuses mixed
    dtypes): a float32 operand promotes a bf16 one."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


# ------------------------------------------------------------------- norms --
def rms_norm(x, scale, eps=1e-6):
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale


def layer_norm(x, scale, bias, eps=1e-5):
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * scale + bias


def norm_defs(d_model: int, kind: str):
    if kind == "ln":
        return {"scale": ParamDef((d_model,), (), "ones"),
                "bias": ParamDef((d_model,), (), "zeros")}
    return {"scale": ParamDef((d_model,), (), "ones")}


def apply_norm(x, p, kind: str, eps=1e-6):
    if kind == "ln":
        return layer_norm(x, p["scale"], p["bias"], eps)
    return rms_norm(x, p["scale"], eps)


# -------------------------------------------------------------------- RoPE --
def rope_cos_sin(positions, head_dim: int, theta: float):
    """positions: (...,) int -> cos/sin (..., head_dim/2) float32."""
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32,
                            device=positions.device) / half
    freqs = 1.0 / (torch.tensor(theta, dtype=torch.float32,
                                device=positions.device) ** exponent)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, S, H, hd); cos/sin: (B, S, hd/2) — half-rotation convention."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# --------------------------------------------------------------------- MLP --
def mlp_defs(d_model: int, d_ff: int, act: str):
    defs = {"w_up": ParamDef((d_model, d_ff), (None, "model")),
            "w_down": ParamDef((d_ff, d_model), ("model", None))}
    if act in ("swiglu", "geglu"):
        defs["w_gate"] = ParamDef((d_model, d_ff), (None, "model"))
    return defs


def apply_mlp(x, p, act: str):
    up = matmul(x, p["w_up"])
    if act == "swiglu":
        up = F.silu(matmul(x, p["w_gate"])) * up
    elif act == "geglu":
        up = F.gelu(matmul(x, p["w_gate"]), approximate="tanh") * up
    elif act == "gelu":
        up = F.gelu(up, approximate="tanh")
    else:
        up = F.silu(up)
    return matmul(up, p["w_down"])


# -------------------------------------------------------------- embeddings --
def embed_defs(vocab: int, d_model: int):
    # 0.02 std (GPT-2 convention) keeps tied-embedding logits sane at init
    return {"table": ParamDef((vocab, d_model), (None, "model"), "normal",
                              scale=0.02)}


def embed_lookup(tokens, table):
    return table[tokens]


# --------------------------------------------------------- chunked CE loss --
def _ce_from_logits(logits, l_c, m_c):
    """(sum of masked losses, mask count) of one chunk's float32 logits,
    stacked in one tensor."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, l_c[..., None].long())[..., 0]
    return torch.stack([((lse - gold) * m_c).sum(), m_c.sum()])


def _ce_chunk(h_c, table32, l_c, m_c):
    return _ce_from_logits(torch.einsum("bsd,vd->bsv", h_c.float(), table32),
                           l_c, m_c)


def chunked_ce_loss(hidden, table, labels, mask=None, chunk: int = 512):
    """Cross-entropy against ``table``'s logits over sequence chunks of
    ``chunk`` (and a remainder chunk), as the reference's scan does.
    Logits and logsumexp are float32.  Each chunk runs under
    ``torch.utils.checkpoint``, so its ``(B, chunk, V)`` logits are
    recomputed in the backward and the ``(B, S, V)`` tensor never lives
    whole.  The table is cast to float32 once, so its gradient sums over
    the chunks in float32.

    hidden: (B, S, d); table: (V, d); labels: (B, S) int; mask: (B, S).
    """
    b, s, _ = hidden.shape
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=hidden.device)
    chunk = min(chunk, s)
    table32 = table.float()
    tot = cnt = 0.0
    for c0 in range(0, s, chunk):
        t, c = checkpoint(_ce_chunk, hidden[:, c0:c0 + chunk], table32,
                          labels[:, c0:c0 + chunk], mask[:, c0:c0 + chunk],
                          use_reentrant=False).unbind()
        tot, cnt = tot + t, cnt + c
    return tot / torch.clamp(cnt, min=1.0)
