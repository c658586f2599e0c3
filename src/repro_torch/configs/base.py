"""ArchConfig: the port's twin of the reference's architecture config.

The port keeps its own copy because the reference's ``configs/base.py``
imports jax.  Field names and defaults are the reference's; dtypes are
``torch`` dtypes.  The sharding helpers are the reference's:
``with_mesh`` fills the mesh hints (``dp_axes``, ``mesh_dp``,
``mesh_model``) from a :class:`~repro_torch.launch.mesh.Mesh`,
``input_specs`` gives each input of a shape cell as a ``(shape, dtype)``
pair and ``input_pspecs`` its spec (a tuple, the reference's
``PartitionSpec`` as data).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}

_REGISTRY: dict[str, "ArchConfig"] = {}


def register(cfg: "ArchConfig") -> "ArchConfig":
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> "ArchConfig":
    return _REGISTRY[name]


def list_archs() -> list[str]:
    return sorted(_REGISTRY)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense|moe|ssm|hybrid|encoder|vlm
    n_layers: int
    d_model: int
    n_heads: int = 1
    kv_heads: int = 1
    head_dim: int = 64
    d_ff: int = 0
    vocab: int = 32000
    act: str = "swiglu"
    norm: str = "rms"
    qk_norm: bool = False
    swa_window: int | None = None
    rope_theta: float | None = 10000.0
    embed_scale: bool = False
    tie_embeddings: bool = True
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_aux_weight: float = 0.01
    moe_capacity: float = 1.25
    # SSM
    ssm_state: int = 0
    ssm_inner: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 128
    # hybrid
    attn_every: int = 6
    # vlm stub frontend
    vlm_patch_dim: int = 1024
    vlm_patches: int = 256
    # execution
    activ_dtype: Any = torch.bfloat16
    param_dtype: Any = torch.bfloat16
    remat: bool = True
    attention_impl: str = "flash_jnp"   # flash_jnp | flash_pallas |
    # boundary_stub; flash_pallas runs the port's CUDA flash kernel
    ssm_impl: str = "chunked_jnp"
    q_chunk: int = 512
    kv_chunk: int = 1024
    loss_chunk: int = 512
    microbatches: int = 1
    schedule: str = "cosine"         # cosine | wsd (minicpm)
    sharding: str = "tp"
    # mesh hints, set by with_mesh
    dp_axes: Any = ("data",)
    mesh_dp: int = 1
    mesh_model: int = 1
    source: str = ""                 # provenance note

    # ------------------------------------------------------------- derived --
    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim if self.ssm_inner else 0

    @property
    def n_experts_padded(self) -> int:
        if not self.n_experts:
            return 0
        return ((self.n_experts + 15) // 16) * 16

    def n_params(self) -> int:
        from repro_torch.models import transformer
        from repro_torch.models.params import tree_count
        return tree_count(transformer.param_defs(self))

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: top_k of the padded experts
        count as active, the rest not)."""
        n = self.n_params()
        if self.family == "moe":
            per_expert = self.d_model * self.d_ff * (
                3 if self.act in ("swiglu", "geglu") else 2)
            n -= self.n_layers * per_expert * (self.n_experts_padded
                                               - self.top_k)
        return n

    # ------------------------------------------------------------- shaping --
    def supports(self, shape_name: str) -> tuple[bool, str]:
        kind = SHAPES[shape_name]["kind"]
        if self.family == "encoder" and kind == "decode":
            return False, "encoder-only: no decode step"
        if shape_name == "long_500k":
            subq = self.family in ("ssm", "hybrid") or self.swa_window
            if not subq:
                return False, "pure full-attention: long_500k skipped"
        return True, ""

    def with_mesh(self, mesh) -> "ArchConfig":
        axes = dict(zip(mesh.axis_names, mesh.devices.shape))
        if self.sharding == "fsdp":
            dp = tuple(a for a in ("pod", "data", "model") if a in axes)
            return dataclasses.replace(
                self, dp_axes=dp, microbatches=1,
                mesh_dp=math.prod(axes.values()), mesh_model=1)
        dp = tuple(a for a in ("pod", "data") if a in axes)
        return dataclasses.replace(
            self, dp_axes=dp if len(dp) > 1 else (dp[0] if dp else None),
            mesh_dp=math.prod(v for k, v in axes.items()
                              if k in ("pod", "data")),
            mesh_model=axes.get("model", 1))

    def input_specs(self, shape_name: str) -> dict:
        """``(shape, dtype)`` of every model input of this cell."""
        info = SHAPES[shape_name]
        return self.inputs_for(info["kind"], info["batch"], info["seq"])

    def inputs_for(self, kind: str, b: int, s: int) -> dict:
        """``input_specs`` of a ``kind`` cell (train, prefill, decode) at
        any batch ``b`` and sequence ``s``."""
        i32 = torch.int32
        patches = ((b, self.vlm_patches, self.vlm_patch_dim),
                   self.activ_dtype)
        st = s - self.vlm_patches
        if kind == "train":
            if self.family == "encoder":
                return {"frames": ((b, s, self.d_model), self.activ_dtype),
                        "mask": ((b, s), torch.bool),
                        "labels": ((b, s), i32)}
            if self.family == "vlm":
                return {"tokens": ((b, st), i32), "patches": patches,
                        "labels": ((b, st), i32)}
            return {"tokens": ((b, s), i32), "labels": ((b, s), i32)}
        if kind == "prefill":
            if self.family == "encoder":
                return {"frames": ((b, s, self.d_model), self.activ_dtype)}
            if self.family == "vlm":
                return {"tokens": ((b, st), i32), "patches": patches}
            return {"tokens": ((b, s), i32)}
        # decode: one new token against a seq-long cache
        return {"tokens": ((b, 1), i32)}

    def input_pspecs(self, shape_name: str) -> dict:
        b = SHAPES[shape_name]["batch"]
        bs = (self.dp_axes if (self.mesh_dp > 1 and b % self.mesh_dp == 0)
              else None)
        return {k: (bs,) + (None,) * (len(shape) - 1)
                for k, (shape, _) in self.input_specs(shape_name).items()}

    def reduced(self) -> "ArchConfig":
        """CPU-sized config of the same family for smoke tests."""
        kw = dict(
            n_layers=4 if self.family == "hybrid" else 2,
            d_model=64, n_heads=4, kv_heads=2, head_dim=16,
            d_ff=128, vocab=256,
            activ_dtype=torch.float32, param_dtype=torch.float32,
            remat=False, q_chunk=64, kv_chunk=64, loss_chunk=64,
            ssm_chunk=16, attn_every=2,
            vlm_patch_dim=32, vlm_patches=8, microbatches=1,
        )
        if self.family == "moe":
            kw.update(n_experts=8, top_k=2, moe_capacity=16.0)
        if self.family in ("ssm", "hybrid"):
            kw.update(ssm_inner=128, ssm_head_dim=32, ssm_state=16,
                      ssm_groups=1)
        if self.family == "encoder":
            kw.update(kv_heads=4)   # hubert is MHA
        if self.kv_heads == self.n_heads:
            kw.update(kv_heads=4)
        return dataclasses.replace(self, **kw)
