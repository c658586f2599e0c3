"""qwen3-14b [dense]: qk-norm + GQA.

[hf:Qwen/Qwen3-14B] 40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120,
    n_heads=40, kv_heads=8, head_dim=128, d_ff=17408, vocab=151936,
    qk_norm=True, rope_theta=1e6, tie_embeddings=False,
    microbatches=8,
    source="hf:Qwen/Qwen3-14B"))
