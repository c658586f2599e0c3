"""qwen3-moe-235b-a22b [moe]: 128 experts, top-8, qk-norm.

[hf:Qwen/Qwen3-235B-A22B] 94L d_model=4096 64H (GQA kv=4) expert d_ff=1536
vocab=151936.  The whole model does not fit one 80 GB card: on one card
it runs at its full widths with the depth cut.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096,
    n_heads=64, kv_heads=4, head_dim=128, d_ff=1536, vocab=151936,
    n_experts=128, top_k=8, qk_norm=True, rope_theta=1e6,
    tie_embeddings=False, microbatches=8,
    source="hf:Qwen/Qwen3-235B-A22B"))
