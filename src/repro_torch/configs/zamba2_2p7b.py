"""zamba2-2.7b [hybrid]: 54 mamba2 layers + shared attention block.

[arXiv:2411.15242; hf] 54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64.  The shared transformer block (one set of weights)
is applied every ``attn_every`` mamba layers — per-invocation LoRA deltas of
the original are omitted, as in the reference.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560,
    n_heads=32, kv_heads=32, head_dim=80, d_ff=10240, vocab=32000,
    act="geglu", qk_norm=False,
    ssm_state=64, ssm_inner=5120, ssm_head_dim=64, ssm_groups=1,
    attn_every=6, tie_embeddings=True,
    microbatches=4,
    source="arXiv:2411.15242; hf"))
